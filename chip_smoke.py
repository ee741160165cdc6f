#!/usr/bin/env python3
"""On-card smoke test of dqmc_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase (8 to 9 minutes)
    python3 chip_smoke.py --phases 1,6    # a subset, for iterating
    python3 chip_smoke.py --registers     # ptxas registers per kernel

Phases (each prints lines starting "phase N"; the first failed check exits
non-zero):

1. the card's name and power limit (nvidia-smi), then the nvcc build of
   dqmc_tpu_torch/csrc/*.cu (one nvcc per source, in parallel) and its
   seconds;
2. K1 (the CGS2 QR kernel) against its plain torch twin on the card, and
   at the 32x32 lattice's size (4, 1024, 1024) in float32 against the
   factorization thresholds of tests/test_qr_kernel.py and torch.linalg.qr;
3. K2 (the fused-block wrap GEMM and site-loop kernels) against the plain
   twin on the card, both sweep directions, at the examples/basic and the
   headline shapes;
4. the fused main path through its normal entry point
   (dqmc_tpu_torch.run.main, what ``python -m dqmc_tpu_torch`` runs) on
   examples/basic/parameters.in with the sweep counts cut, checking the
   kernels' launch counters, acceptance, the steady self-check error and
   the measured observables;
5. the headline shape (16x16, beta=8, nt=160, n_stab=5, W=16, float32) for
   three sweep pairs, printing walker-sweep-pairs/s;
6. the per-slice engine's site-update kernels (#3 delayed in both order
   modes, #5 submatrix, #6 rank-1) against their twins, one slice each, at
   (W=4, ns=36, k=4) and the stretch shape (W=4, ns=1024, k=32), and each
   kernel timed alone at the stretch shape;
7. the stretch configuration (32x32, beta=16, nt=320, n_stab=5, U=4, W=4,
   float32) through run_simulation, with the default site update (#3) and
   with site_update = submatrix (#5);
8. examples/basic through the per-slice engine with site_update = scan
   (#6) and delayed (#3);
9. under torch.profiler, device time by kernel and the device's idle
   share: the first stretch sweep pair with the default site update (#3),
   and three pairs of the repulsive preset on each engine;
10. the 2-flavor and submatrix kernels against their twins: #4 (the
    per-slice 2-flavor delayed update) one slice at (W=4, ns=36, k=4), the
    repulsive preset's (32, 64, 32) and (4, 1024, 32); #2b (the fused block
    with two flavors) forward and backward at the preset's (32, 64, 5
    slices) and (16, 256, 5); #2c (the fused block's submatrix scheme) at
    (4, 36) and (16, 256); doped cases of #4 and #2b (U=6, mu=-0.8) must
    flip a sign; each new kernel timed alone, and the fused site loops
    with one and two flavors, 1 and 16 walkers, both float types;
11. the repulsive preset (8x8, beta=4, nt=80, n_stab=5, U=4, mu=0, W=32,
    float32) through run_simulation with engine = auto (fused: #2b + K1)
    and engine = slice (#4 + K1): every walker's sign must stay +1; then a
    doped run (U=6, mu=-0.8) that prints the mean sign;
12. the headline shape with model = repulsive, three timed sweep pairs on
    the fused engine;
13. examples/basic with fused_update = submatrix (#2c) on the fused engine.

Every phase that drives a main path (4, 5, 7, 8, 11, 12, 13) sets the
launch counters to 0 just before and reads them just after.  The line
before the last is one JSON object describing every kernel; the last line
is the result object.  Tolerances are stated where they are checked.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the bench headline (ns = 256), examples/basic (ns = 36) and the repulsive
# preset (2 W = 64 matrices of ns = 64)
QR_SHAPES = ((16, 256), (4, 36), (64, 64))
BLOCK_SHAPES = ((4, 6, 4.0, 40, 10), (16, 16, 8.0, 160, 5))  # W L beta nt n
# the per-slice engine's site-update shapes: (W, L, k)
SITE_SHAPES = ((4, 6, 4), (4, 32, 32))
# #4's shapes: those, and the repulsive preset's (W=32, 8x8, two blocks of
# 32 visits, one column per thread)
SITE_SHAPES_2F = ((4, 6, 4), (32, 8, 32), (4, 32, 32))

# the card's peaks (NVIDIA H100 SXM data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

# launches of every main-path run (phases 4, 5, 7, 8)
TOTALS = Counter()


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take for ops
    float32 operations and nbytes of traffic (each input read once, each
    output written once)."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def record(report, name, *, max_abs_err, ms, plain_ms, ops, nbytes,
           library_ms=None):
    bound_ms, bound_by = bound(ops, nbytes)
    report[name] = dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graded(gen, B, n, dtype, spread=12.0):
    """Column-graded, column-max-normalized matrices (the fold inputs'
    structure; tests/test_qr_kernel.py's generator)."""
    import torch
    base = torch.randn((B, n, n), generator=gen, device="cuda",
                       dtype=torch.float64)
    grade = torch.exp((torch.rand((B, n), generator=gen, device="cuda",
                                  dtype=torch.float64) - 0.5) * spread)
    M = base * grade[:, None, :]
    return (M / M.abs().amax(dim=1, keepdim=True)).to(dtype)


def phase_qr(torch, gen, report):
    from dqmc_tpu_torch.ops import qr_kernel as qk
    # the preset's case draws from a generator of its own, so the inputs of
    # the cases and phases after it do not move
    own = torch.Generator(device="cuda")
    own.manual_seed(64)
    # f64: kernel and twin run the same algorithm in another summation
    # order; Q and R agree to 1e-12 absolute, R^{-1} to 1e-12 relative to
    # its largest entry (its scale grows with cond(A))
    for B, n in QR_SHAPES:
        A = torch.randn((B, n, n), generator=gen if n != 64 else own,
                        device="cuda", dtype=torch.float64)
        got = qk.cgs2_qr_inv(A)
        want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
        torch.cuda.synchronize()
        eq = float((got[0] - want[0]).abs().max())
        er = float((got[1] - want[1]).abs().max())
        ew = float((got[2] - want[2]).abs().max() / want[2].abs().max())
        say(f"phase 2: K1 f64 ({B}, {n}, {n}) |dQ| {eq:.3e} |dR| {er:.3e} "
            f"|dRinv|/max {ew:.3e}")
        if not max(eq, er, ew) < 1e-12:
            fail(f"K1 f64 disagrees with its twin at ({B}, {n})")
    # f32 factorization quality at tests/test_qr_kernel.py's thresholds,
    # then the gap to the twin and the times, at the headline shape and at
    # the 32x32 lattice's n = 1024 (float32 only: the f64 panel would not
    # fit in shared memory, and the engine's f64 QR is Householder)
    qr_quality(torch, qk, graded(gen, 4, 64, torch.float32))
    for (B, n), reps in (((16, 256), 20), ((4, 1024), 5)):
        A = graded(gen, B, n, torch.float32)
        if n == 1024:
            qr_quality(torch, qk, A)
        got = qk.cgs2_qr_inv(A)
        want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        ms = cuda_ms(lambda: qk.cgs2_qr_inv(A), reps)
        plain_ms = cuda_ms(lambda: qk.padded_qr(A, True, qk.cgs2_qr_plain),
                           1)
        lib_ms = cuda_ms(lambda: torch.linalg.qr(A), reps)
        record(report, "cgs2_qr", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               ops=(4 + 1 / 3) * n ** 3 * B, nbytes=4 * B * n * n * 4,
               library_ms=lib_ms)
        r = report["cgs2_qr"]
        say(f"phase 2: K1 f32 ({B}, {n}, {n}) |d(Q,R)| vs twin {err:.3e}; "
            f"kernel {ms:.3f} ms per cgs2_qr_inv, twin {plain_ms:.3f} ms, "
            f"torch.linalg.qr {lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if not err < 1e-3:
            fail(f"K1 f32 disagrees with its twin at ({B}, {n})")


def qr_quality(torch, qk, A):
    """K1's float32 factorization of graded A against
    tests/test_qr_kernel.py's thresholds."""
    B, n, _ = A.shape
    Q, R = qk.cgs2_qr(A)
    Q64, R64 = Q.double(), R.double()
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    orth = float((Q64.mT @ Q64 - eye).abs().max())
    recon = float((Q64 @ R64 - A.double()).abs().max())
    low = float(torch.tril(R64, -1).abs().max())
    dmin = float(torch.diagonal(R64, dim1=-2, dim2=-1).min())
    say(f"phase 2: K1 f32 ({B}, {n}, {n}) graded: orth {orth:.3e} (< 2e-4) "
        f"recon {recon:.3e} (< 5e-6) tril {low:.1e} min diag {dmin:.3e}")
    if not (orth < 2e-4 and recon < 5e-6 and low == 0.0 and dmin >= 0.0):
        fail(f"K1 f32 factorization quality at n = {n}")


def block_inputs(torch, gen, W, L, beta, nt, n_slices, dtype,
                 model="attractive", U=4.0, mu=-0.1, seed=11):
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    model = MODEL_REGISTRY[model].build(square_lattice(L, L), U=U, t=1.0,
                                        mu=mu, beta=beta, nt=nt, dtype=dtype,
                                        device="cuda")
    cfg = EngineConfig(nt=nt, n_stab=n_slices)
    states = init_state(model, cfg, make_generators(seed, W, "cuda"))
    ns = model.n_sites
    order = torch.argsort(torch.rand((n_slices, ns), generator=gen,
                                     device="cuda"), dim=-1)
    props = torch.randint(0, 3, (W, n_slices, ns), generator=gen,
                          device="cuda")
    us = torch.rand((W, n_slices, ns), generator=gen, device="cuda",
                    dtype=dtype)
    return model, states, order, props, us


def phase_block(torch, gen, report):
    from dqmc_tpu_torch.engine import fused
    for W, L, beta, nt, n in BLOCK_SHAPES:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            model, states, order, props, us = block_inputs(
                torch, gen, W, L, beta, nt, n, dtype)
            for forward in (True, False):
                fb = states.fields[:, :n] if forward else states.fields[:, -n:]
                args = (model, order, props, us, states.G, fb)
                kw = dict(n_slices=n, forward=forward)
                Gk, fk, bk, ak, _ = fused.fused_block(*args, **kw)
                Gp, fp, bp, ap, _ = fused.fused_block_plain(*args, **kw)
                torch.cuda.synchronize()
                mism = int((fk != fp).sum())
                dG = float((Gk - Gp).abs().max())
                dB = float((bk - bp).abs().max() / max(1.0, bp.abs().max()))
                tag = (f"phase 3: K2 {str(dtype)[6:]} W={W} ns={ns} "
                       f"n_slices={n} k={fused._k_delay(ns)} "
                       f"{'fwd' if forward else 'bwd'}")
                if dtype == torch.float64:
                    # decisions identical; Bbar to 1e-11 relative to
                    # max(1, |Bbar|); G to 1e-6: naive propagation over the
                    # block amplifies reordered rounding -- the JAX
                    # package's own fused kernel and its pure-JAX oracle
                    # differ by 4.9e-8 (fwd) and 3.2e-7 (bwd) at the
                    # examples/basic block shape (CPU, f64)
                    say(f"{tag}: mismatched decisions {mism}, |dG| "
                        f"{dG:.3e} (< 1e-6), |dBbar| {dB:.3e} (< 1e-11)")
                    if mism or not (dG < 1e-6 and dB < 1e-11):
                        fail("K2 f64 disagrees with its twin")
                    continue
                # f32: two correct f32 arithmetics diverge along a block
                # (the f64 gap above shows ~1e8 amplification of rounding
                # over 10 naive slices and near-singular accepted moves),
                # so late decisions may flip; a broken kernel flips about
                # half -- more than 1% mismatched is a fault
                rel = dG / float(Gp.abs().max())
                ms = cuda_ms(lambda: fused.fused_block(*args, **kw), 5)
                plain_ms = cuda_ms(
                    lambda: fused.fused_block_plain(*args, **kw), 1)
                say(f"{tag}: mismatched decisions {mism} of {fk.numel()}, "
                    f"G relative gap {rel:.3e}; block kernel {ms:.3f} ms, "
                    f"twin {plain_ms:.3f} ms")
                if mism > 0.01 * fk.numel():
                    fail("K2 f32 decisions disagree with the twin")
    # per-kernel times and gaps at the headline shape (f32)
    W, L, beta, nt, n = BLOCK_SHAPES[1]
    model, states, order, props, us = block_inputs(
        torch, gen, W, L, beta, nt, n, torch.float32)
    ns = L * L
    G = states.G[:, 0].contiguous()
    ev = torch.rand((W, ns), generator=gen, device="cuda") + 0.5
    iev = 1.0 / ev
    wk = lambda: fused.wrap_gemm_cuda(
        fused.wrap_gemm_cuda(model.expK, G), model.invexpK, rv=ev, cv=iev)
    wp = lambda: fused.wrap_gemm_plain(
        fused.wrap_gemm_plain(model.expK, G), model.invexpK, rv=ev, cv=iev)
    werr = float((wk() - wp()).abs().max())
    wms, wpms = cuda_ms(wk, 20), cuda_ms(wp, 20)
    lib_ms = cuda_ms(lambda: torch.matmul(model.expK, G), 20)
    record(report, "fused_wrap", max_abs_err=werr, ms=wms / 2,
           plain_ms=wpms / 2, ops=2 * ns ** 3 * W,
           nbytes=4 * (ns * ns + 2 * W * ns * ns + 2 * W * ns),
           library_ms=lib_ms)
    say(f"phase 3: wrap GEMM f32 (16, 256, 256) |dG| {werr:.3e}; kernel "
        f"{wms / 2:.4f} ms/GEMM, plain {wpms / 2:.4f} ms/GEMM, one "
        f"torch.matmul {lib_ms:.4f} ms, bound "
        f"{report['fused_wrap']['bound_ms']:.4f} ms "
        f"({report['fused_wrap']['bound_by']})")
    if not werr < 1e-4 * float(wp().abs().max()):
        fail("wrap GEMM disagrees with its plain version")
    # the site loop alone, one slice: checked in its f64 instantiation
    # (decisions identical, G to 1e-9: one slice, no propagation), timed in
    # f32 (the main path's type)
    k = fused._k_delay(ns)
    for dtype in (torch.float64, torch.float32):
        model, states, order, props, us = block_inputs(
            torch, gen, W, L, beta, nt, n, dtype)
        _, _, gb, delta, _, _ = fused.site_factors(
            model, states.fields[:, :n], props, dtype)
        u_ = us.reshape(W, -1).contiguous()
        o32 = order.to(torch.int32).contiguous()
        G0 = states.G[:, 0].contiguous()

        def run_sites(fn):
            Gc = G0.clone()
            m = torch.zeros((W, n * ns), dtype=dtype, device="cuda")
            fn(Gc, m, o32, gb, delta, u_, 0, k)
            return Gc, m
        (Gs, ms_), (Gq, mq) = run_sites(fused.site_loop_cuda), \
            run_sites(fused.site_loop_plain)
        torch.cuda.synchronize()
        serr = float((Gs - Gq).abs().max())
        smis = int((ms_ != mq).sum())
        if dtype == torch.float64:
            say(f"phase 3: site loop f64 W={W} ns={ns} k={k} one slice: "
                f"mismatched decisions {smis}, |dG| {serr:.3e} (< 1e-9)")
            if smis or not serr < 1e-9:
                fail("site-loop kernel disagrees with its plain version")
            site_err = serr
            continue
        sms = cuda_ms(lambda: run_sites(fused.site_loop_cuda), 10)
        spms = cuda_ms(lambda: run_sites(fused.site_loop_plain), 1)
        say(f"phase 3: site loop f32 W={W} ns={ns} k={k} one slice: "
            f"mismatched decisions {smis}, |dG| {serr:.3e}; kernel "
            f"{sms:.3f} ms, twin {spms:.3f} ms")
    record(report, "fused_sites", max_abs_err=site_err, ms=sms,
           plain_ms=spms,
           ops=W * (ns // k * 2 * ns * k * (k - 1) + 2 * ns ** 3),
           nbytes=4 * W * (2 * ns * ns + 5 * ns))
    say(f"phase 3: site loop bound {report['fused_sites']['bound_ms']:.4f} "
        f"ms ({report['fused_sites']['bound_by']}); no single library call")


def phase_main(torch):
    """examples/basic through the entry point, sweep counts cut.  With
    h5py installed this is the CLI's main(); without it, run_simulation
    with no output directory, which stops before the HDF5 write."""
    import importlib.util
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import main as cli_main, run_simulation
    params = Parameters(str(REPO / "examples" / "basic" / "parameters.in"))
    # sweep counts cut to about a minute; n_stab cut from 10 to 2: the
    # float32 naive-vs-stabilized error of this workload is heavy-tailed --
    # its max over 600 pairs read 1.7e2 at n_stab=10 (the JAX package's own
    # f32 engine reads 6.1 on the CPU), 1.4e-2 at 3 and 2.0e-3 at 2 (80
    # pairs) on the card, against err_warn = 1e-2
    cut = dict(n_therms=100, n_bins=8, n_sweeps=40, n_stab=2)
    for key, val in cut.items():
        params.set("simulation", key, val)
    has_h5py = importlib.util.find_spec("h5py") is not None
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "parameters.in").write_text(params.dumps())
        os.chdir(tmp)
        try:
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            if has_h5py:
                summary = cli_main(["--device", "cuda"])
                written = sorted(p.name for p in
                                 (Path(tmp) / "results").glob("data_*.h5"))
            else:
                summary = run_simulation(params, out_dir=None,
                                         device="cuda")
                written = []
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in _cuda.LAUNCHES.items()
                        if k in ("cgs2_qr", "fused_wrap", "fused_sites")}
            TOTALS.update(_cuda.LAUNCHES)
        finally:
            os.chdir(cwd)
    obs = summary.observables
    how = (f"python -m dqmc_tpu_torch wrote {len(written)} HDF5 files"
           if has_h5py else "h5py is not installed here: run_simulation "
           "stopped before the HDF5 write")
    say(f"phase 4: examples/basic "
        f"({', '.join(f'{k}={v}' for k, v in cut.items())}) in {dt:.1f} s, "
        f"{how}: launches {launches}, acceptance {summary.acc_rate:.4f}, "
        f"steady self-check max {summary.max_precision_error:.3e} "
        f"(< 1e-2), " + ", ".join(f"{k} {v:.5f}" for k, v in obs.items()))
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    if not 0.0 < summary.acc_rate < 1.0:
        fail("acceptance outside (0, 1)")
    if not summary.max_precision_error < 1e-2:
        fail("steady self-check error above the f32 err_warn of 1e-2")
    finite = all(v == v and abs(v) < 1e6 for v in obs.values())
    if not (finite and {"density", "swave"} <= set(obs)):
        fail(f"observables missing or not finite: {obs}")
    if has_h5py and len(written) != summary.n_walkers:
        fail(f"expected {summary.n_walkers} HDF5 files, found {written}")


def phase_headline(torch, card):
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine.fused import sweep_pair_fused
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state, reset_error_stats
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    W, L, beta, nt, n_stab = 16, 16, 8.0, 160, 5
    model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                    mu=0.0, beta=beta, nt=nt,
                                    dtype=torch.float32, device="cuda")
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    states = init_state(model, cfg, make_generators(42, W, "cuda"))
    states = sweep_pair_fused(model, cfg, states)        # warm-up pair
    states = reset_error_stats(states)
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        states = sweep_pair_fused(model, cfg, states)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    TOTALS.update(_cuda.LAUNCHES)
    launches = {k: _cuda.LAUNCHES[k]
                for k in ("cgs2_qr", "fused_wrap", "fused_sites")}
    err = float(states.err_max.max())
    rate = 3 * W / dt
    say(f"phase 5: headline 16x16 beta=8 nt=160 n_stab=5 W=16 f32: "
        f"{rate:.3f} walker-sweep-pairs/s (3 pairs, {dt:.2f} s), self-check "
        f"max {err:.3e}, launches {launches} on {card}")
    if not err == err or min(launches.values()) <= 0:
        fail("headline sweep pairs")


def slice_inputs(torch, gen, W, L, dtype):
    """One slice's inputs at the stretch dtau = 0.05 (beta = 1, nt = 20):
    a physical G (W, 1, ns, ns) from fresh walkers, slice-start fields,
    per-walker visit orders, proposal draws and uniforms (W, ns), and
    distinct per-walker couplings (g, alpha) (W,)."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                    mu=0.0, beta=1.0, nt=20, dtype=dtype,
                                    device="cuda")
    states = init_state(model, EngineConfig(nt=20, n_stab=5),
                        make_generators(5, W, "cuda"))
    ns = model.n_sites
    orders = torch.argsort(torch.rand((W, ns), generator=gen, device="cuda"),
                           dim=-1)
    props = torch.randint(0, 3, (W, ns), generator=gen, device="cuda")
    us = torch.rand((W, ns), generator=gen, device="cuda", dtype=dtype)
    scale = 1.0 + 0.05 * torch.linspace(-1.0, 1.0, W, device="cuda",
                                        dtype=dtype)
    return (states.G, states.fields[:, 0], orders, props, us,
            model.g * scale, model.alpha.expand(W))


SITE_CASES = (  # (label, wrapper, shared order, rank keyword)
    ("#3 shared", "metropolis_slice_update_batched", True, "k_delay"),
    ("#3 per-walker", "metropolis_slice_update_batched", False, "k_delay"),
    ("#5 shared", "metropolis_slice_update_submatrix", True, "k_sub"),
    ("#6 per-walker", "metropolis_slice_update", False, None),
)


def phase_sites(torch, gen, report):
    """#3, #5 and #6 against their twins, one slice each."""
    from dqmc_tpu_torch.ops import kernels as tk
    slice_err = {}
    for W, L, k in SITE_SHAPES:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            G, fields, orders, props, us, g, alpha = slice_inputs(
                torch, gen, W, L, dtype)
            for label, name, shared, rank_kw in SITE_CASES:
                fn = getattr(tk, name)
                kw = {}
                if rank_kw:
                    kw = {rank_kw: k, "exact_rank": not shared}
                args = (g, alpha, orders[0] if shared else orders, props,
                        us, G, fields)
                Gk, fk, ak = fn(*args, **kw)
                Gp, fp, ap = fn(*args, plain=True, **kw)
                torch.cuda.synchronize()
                mism = int((fk != fp).sum())
                dacc = int(((ak - ap).abs() * ns).round().sum())
                gap = float((Gk - Gp).abs().max())
                rel = gap / float(Gp.abs().max())
                tag = (f"phase 6: {label} {str(dtype)[6:]} W={W} ns={ns} "
                       f"k={k if rank_kw else 1}")
                accepted = int((ap * ns).round().sum())
                if dtype == torch.float64:
                    # one slice, no propagation: the same decisions, G to
                    # 1e-9 of its largest entry
                    say(f"{tag}: {accepted} of {W * ns} accepted, "
                        f"mismatched fields {mism}, accept-count gap {dacc}, "
                        f"|dG|/max|G| {rel:.3e} (< 1e-9)")
                    if mism or dacc or not rel < 1e-9:
                        fail(f"{label} kernel disagrees with its twin (f64)")
                    if ns == SITE_SHAPES[-1][1] ** 2:
                        slice_err[label] = gap
                    continue
                line = (f"{tag}: {accepted} of {W * ns} accepted, mismatched "
                        f"decisions {mism}, G relative gap {rel:.3e}")
                if ns == SITE_SHAPES[-1][1] ** 2:
                    ms = cuda_ms(lambda: fn(*args, **kw), 3)
                    plain_ms = cuda_ms(lambda: fn(*args, plain=True, **kw),
                                       1)
                    line += (f"; slice through the kernels {ms:.3f} ms, "
                             f"twin {plain_ms:.3f} ms")
                say(line)
                # two correct f32 arithmetics may flip a marginal decision;
                # a broken kernel flips about half
                if mism > 0.01 * fk.numel():
                    fail(f"{label} f32 decisions disagree with the twin")
    time_site_kernels(torch, gen, tk, report, slice_err)


def _shared_order_rows(torch, K, P, G3, args, W, n, k):
    """(kernel, plain, library, ops, bytes, scheme) per kernel of #3 and
    #5 at the first block of a shared-order slice."""
    acc, order, gb, delta, us = args
    buf = lambda *shape: torch.zeros((W,) + shape, dtype=G3.dtype,
                                     device="cuda")
    U, V, Wm, Ut, M = buf(k, n), buf(k, n), buf(k, k), buf(k, n), buf(k, n)
    blk = (acc, order, gb, delta, us, 0, k)
    Gw = G3.clone()
    K.delayed_block(G3, U, V, *blk)
    K.submatrix_decide(G3, Wm, *blk)
    n_acc = int(acc[:, :k].sum())
    K.submatrix_prep(G3, Wm, Ut, M, order, 0, k)
    flush_ops, flush_bytes = 2 * W * k * n * n, 4 * W * (2 * k * n
                                                         + 2 * n * n)
    return {
        "delayed_sites": (
            lambda: K.delayed_block(G3, U, V, *blk),
            lambda: P.delayed_block(G3, U.clone(), V.clone(), *blk), None,
            W * 2 * n * k * (k - 1), 4 * W * (4 * k * n + 5 * k),
            "#3 shared"),
        "delayed_flush": (
            lambda: K.delayed_flush(Gw, U, V, k),
            lambda: P.delayed_flush(Gw, U, V, k),
            lambda: Gw.baddbmm_(U.mT, V), flush_ops, flush_bytes,
            "#3 shared"),
        "submatrix_decide": (
            lambda: K.submatrix_decide(G3, Wm, *blk),
            lambda: P.submatrix_decide(G3, Wm.clone(), *blk), None,
            W * k * 4 * k * k + 3 * k * k * n_acc,
            4 * W * (2 * k * k + 5 * k), "#5 shared"),
        "submatrix_prep": (
            lambda: K.submatrix_prep(G3, Wm, Ut, M, order, 0, k),
            lambda: P.submatrix_prep(G3, Wm, Ut.clone(), M.clone(), order,
                                     0, k), None,
            2 * W * k * k * n, 4 * W * (4 * k * n + k * k), "#5 shared"),
        "submatrix_flush": (
            lambda: K.submatrix_flush(Gw, Ut, M, k),
            lambda: P.submatrix_flush(Gw, Ut, M, k),
            lambda: Gw.baddbmm_(Ut.mT, M), flush_ops, flush_bytes,
            "#5 shared"),
    }


def _per_walker_rows(torch, K, P, G3, args, W, n):
    """The same for #6 (a whole slice, each walker its own order)."""
    acc, order, gb, delta, us = args
    K.rank1(G3.clone(), acc, order, gb, delta, us)
    n_acc = int(acc.sum())
    return {"rank1_sites": (
        lambda: K.rank1(G3.clone(), acc, order, gb, delta, us),
        lambda: P.rank1(G3.clone(), acc.clone(), order, gb, delta, us),
        None, 2 * n * n * n_acc, 4 * W * (2 * n * n + 5 * n),
        "#6 per-walker")}


def time_site_kernels(torch, gen, tk, report, slice_err):
    """Each site-update kernel alone at the stretch shape in float32, one
    launch, against its plain piece, with its bound; max_abs_err is the
    float64 slice gap of its scheme above."""
    W, L, k = SITE_SHAPES[-1]
    n = L * L
    dt = torch.float32
    G, fields, orders, props, us, g, alpha = slice_inputs(torch, gen, W, L,
                                                          dt)
    G3 = G[:, 0].contiguous()

    def args(order):
        order = order.to(torch.int32).contiguous()
        _, gb, delta = tk.visit_factors(g, alpha, fields,
                                        order.long().expand(W, n), props, dt)
        acc = torch.empty((W, n), dtype=dt, device="cuda")
        return acc, order, gb.contiguous(), delta.contiguous(), us

    K, P = tk.KERNELS, tk.PLAIN
    rows = _shared_order_rows(torch, K, P, G3, args(orders[0]), W, n, k)
    rows.update(_per_walker_rows(torch, K, P, G3, args(orders), W, n))
    for name, (kern, plain, lib, ops, nbytes, scheme) in rows.items():
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 1)
        lib_ms = cuda_ms(lib, 5) if lib else None
        record(report, name, max_abs_err=slice_err[scheme], ms=ms,
               plain_ms=plain_ms, ops=ops, nbytes=nbytes, library_ms=lib_ms)
        r = report[name]
        say(f"phase 6: {name} f32 W={W} ns={n} k={k}, one launch: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, "
            + (f"one torch.baddbmm {lib_ms:.4f} ms, " if lib else
               "no single library call, ")
            + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def run_params(torch, text: str, label: str, need, phase: str):
    """Drive run_simulation (the ``python -m dqmc_tpu_torch`` path, no
    output files: the card machine has no h5py) on a parameter string;
    reset the launch counters just before, read them just after, and check
    that every kernel in ``need`` ran."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(text)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_simulation(params, out_dir=None, device="cuda",
                             verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    TOTALS.update(_cuda.LAUNCHES)
    obs = summary.observables
    say(f"{phase}: {label} in {dt:.1f} s: {summary.sweeps_per_sec:.4f} "
        f"walker-sweep-pairs/s over the measured pairs, self-check max "
        f"{summary.max_precision_error:.3e} mean "
        f"{summary.mean_precision_error:.3e}, acceptance "
        f"{summary.acc_rate:.4f}, "
        + ", ".join(f"{k} {v:.5f}" for k, v in obs.items())
        + f", peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}")
    finite = all(v == v and abs(v) < 1e6 for v in obs.values())
    err = summary.max_precision_error
    if not (finite and err == err and abs(err) < float("inf")
            and {"density", "swave"} <= set(obs)):
        fail(f"{label}: observables or self-check not finite: {obs}, {err}")
    if not 0.0 < summary.acc_rate < 1.0:
        fail(f"{label}: acceptance outside (0, 1)")
    return summary


STRETCH = """
[Lattice]
L1 = 32
L2 = 32
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 16.0
nt = 320
n_stab = 5
n_therms = 1
n_bins = 1
n_sweeps = 1
dtype = float32
seed = 42
[walkers]
n_walkers = 4
"""


def phase_stretch(torch):
    """bench.py's stretch configuration through the entry point: the
    per-slice engine (ns = 1024 > 512), #3 by default and #5 with
    site_update = submatrix; K1 stabilizes both."""
    site = ("delayed_sites", "delayed_flush")
    sub = ("submatrix_decide", "submatrix_prep", "submatrix_flush")
    run_params(torch, STRETCH, "stretch 32x32 beta=16 nt=320 n_stab=5 W=4 "
               "f32, engine = auto (per slice, site_update = pallas: #3), "
               "1 + 1 pairs", ("cgs2_qr",) + site, "phase 7")
    run_params(torch, STRETCH + "[simulation]\nsite_update = submatrix\n",
               "stretch, site_update = submatrix (#5), 1 + 1 pairs",
               ("cgs2_qr",) + sub, "phase 7")


def phase_basic_slice(torch):
    """examples/basic through the per-slice engine: the rank-1 scan (#6)
    and the per-walker delayed scheme (#3 at delay_rank = 32, a short last
    block of 4 at ns = 36).  n_stab cut from 10 to 5 (the f32 self-check
    at 10 is O(1e2), PERF.md); 20 + 2 x 10 pairs."""
    text = (REPO / "examples" / "basic" / "parameters.in").read_text()
    cut = ("[simulation]\nengine = slice\nn_therms = 20\nn_bins = 2\n"
           "n_sweeps = 10\nn_stab = 5\ndtype = float32\n")
    run_params(torch, text + cut + "site_update = scan\n",
               "examples/basic, engine = slice, site_update = scan (#6), "
               "n_stab=5, 20 + 2x10 pairs", ("rank1_sites", "cgs2_qr"),
               "phase 8")
    run_params(torch, text + cut + "site_update = delayed\n",
               "examples/basic, engine = slice, site_update = delayed "
               "(#3, per-walker order, k=32), n_stab=5, 20 + 2x10 pairs",
               ("delayed_sites", "delayed_flush", "cgs2_qr"), "phase 8")


def _profiled(torch, label, step, states, n_pairs):
    """``n_pairs`` sweep pairs under torch.profiler: device time by kernel
    and the device's idle share of their wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_pairs):
            states = step(states)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only (kernels and copies), so nothing counts
    # twice through the CPU op that launched it
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev(e) > 0), key=dev, reverse=True)
    busy = sum(dev(e) for e in rows) / 1e6
    say(f"phase 9: {label}, {n_pairs} profiled sweep pair(s): wall "
        f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1.0 - busy / wall:.4f}")
    for e in rows[:8]:
        say(f"phase 9:   {e.key[:60]:60s} {dev(e) / 1e3:10.1f} ms "
            f"({dev(e) / 1e6 / busy:6.1%}) {e.count} calls")


def phase_profile(torch):
    """Where the time goes, under torch.profiler (every kernel is built and
    warm from the phases before): the first stretch sweep pair with the
    default site update (#3), and three pairs of the repulsive preset on
    each engine (fused: #2b; per slice: #4) after a warm-up pair."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.fused import sweep_pair_fused
    from dqmc_tpu_torch.engine.state import make_generators
    from dqmc_tpu_torch.engine.sweep import init_state, sweep_pair
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    from dqmc_tpu_torch.run import make_engine_config
    dev = torch.device("cuda")
    params = Parameters.from_string(STRETCH)
    model = MODEL_REGISTRY["attractive"].from_params(
        params, square_lattice(32, 32), dtype=torch.float32, device=dev)
    cfg = make_engine_config(params, dev, 5)
    states = init_state(model, cfg, make_generators(42, 4, dev))
    _profiled(torch, "stretch, site_update = pallas (#3)",
              lambda s: sweep_pair(model, cfg, s), states, 1)
    params = Parameters.from_string(REPULSIVE)
    model = MODEL_REGISTRY["repulsive"].from_params(
        params, square_lattice(8, 8), dtype=torch.float32, device=dev)
    cfg = make_engine_config(params, dev, 5)
    for label, step in (("fused (#2b)", sweep_pair_fused),
                        ("per slice (#4)", sweep_pair)):
        states = init_state(model, cfg, make_generators(42, 32, dev))
        states = step(model, cfg, states)              # warm-up pair
        _profiled(torch, f"repulsive preset, {label}",
                  lambda s: step(model, cfg, s), states, 3)


def _flipping_seed(torch, make, run_twin, what):
    """The first of a few seeds whose doped inputs make the twin flip a
    sign, with those inputs and the twin's result; fails if none does (the
    sign path would go unexercised)."""
    for seed in range(8):
        inputs = make(seed)
        out = run_twin(inputs)
        if bool((out[-1] < 0).any()):
            return seed, inputs, out
    fail(f"{what}: no sign flip in 8 doped seeds")


def phase_two_flavor_sites(torch, gen, report):
    """#4 against its twin, one slice: physical G of the repulsive model at
    (W=4, ns=36, k=4), the repulsive preset's shape (32, 64, 32) and the
    stretch shape (4, 1024, 32), and doped cases (U=6, mu=-0.8 couplings on
    a fake G, as tests/test_kernels.py) at the first two that must flip a
    sign."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import RepulsiveHubbard
    from dqmc_tpu_torch.ops import kernels as tk
    fn = tk.metropolis_slice_update_batched_2f

    def compare(tag, args, kw, dtype, want=None):
        Gk, fk, ak, sk = fn(*args, **kw)
        Gp, fp, ap, sp = want or fn(*args, plain=True, **kw)
        torch.cuda.synchronize()
        ns = Gp.shape[-1]
        mism = int((fk != fp).sum())
        smis = int((sk != sp).sum())
        rel = float((Gk - Gp).abs().max() / Gp.abs().max())
        flips = int((sp < 0).sum())
        accepted = int((ap * ns).round().sum())
        if dtype == torch.float64:
            # one slice, no propagation: the same decisions and signs, G
            # to 1e-9 of its largest entry
            say(f"{tag}: {accepted} of {fp.numel()} accepted, {flips} "
                f"walkers flipped, mismatched fields {mism}, signs {smis}, "
                f"|dG|/max|G| {rel:.3e} (< 1e-9)")
            if mism or smis or not rel < 1e-9:
                fail(f"{tag}: #4 disagrees with its twin (f64)")
        else:
            say(f"{tag}: {accepted} of {fp.numel()} accepted, {flips} "
                f"walkers flipped, mismatched decisions {mism}, signs "
                f"{smis}, G relative gap {rel:.3e}")
            # two correct f32 arithmetics may flip a marginal decision
            if mism > 0.01 * fk.numel():
                fail(f"{tag}: #4 f32 decisions disagree with the twin")
        return float((Gk - Gp).abs().max())

    slice_err = None
    for W, L, k in SITE_SHAPES_2F:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            model = RepulsiveHubbard.build(
                square_lattice(L, L), U=4.0, t=1.0, mu=0.0, beta=1.0, nt=20,
                dtype=dtype, device="cuda")
            states = init_state(model, EngineConfig(nt=20, n_stab=5),
                                make_generators(5, W, "cuda"))
            order = torch.argsort(torch.rand((ns,), generator=gen,
                                             device="cuda"))
            props = torch.randint(0, 3, (W, ns), generator=gen,
                                  device="cuda")
            us = torch.rand((W, ns), generator=gen, device="cuda",
                            dtype=dtype)
            args = (model.g.expand(W), model.alpha.expand(W), order, props,
                    us, states.G, states.fields[:, 0])
            err = compare(f"phase 10: #4 {str(dtype)[6:]} W={W} ns={ns} "
                          f"k={k} mu=0", args, dict(k_delay=k), dtype)
            if dtype == torch.float64 and ns == SITE_SHAPES_2F[-1][1] ** 2:
                slice_err = err
    # the sign path: doped couplings (g of U=6, dtau=0.25) on a fake G
    for W, L, k in SITE_SHAPES_2F[:2]:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            def make(seed):
                g = torch.Generator(device="cuda")
                g.manual_seed(100 + seed)
                kw = dict(generator=g, device="cuda")
                G = (0.3 * torch.randn((W, 2, ns, ns), dtype=dtype, **kw)
                     + 0.5 * torch.eye(ns, dtype=dtype, device="cuda"))
                return (torch.full((W,), 0.75 ** 0.5, dtype=dtype,
                                   device="cuda"),
                        torch.zeros((W,), dtype=dtype, device="cuda"),
                        torch.argsort(torch.rand((ns,), **kw)),
                        torch.randint(0, 3, (W, ns), **kw),
                        torch.rand((W, ns), dtype=dtype, **kw), G,
                        torch.randint(0, 4, (W, ns), **kw))
            seed, args, want = _flipping_seed(
                torch, make, lambda a: fn(*a, plain=True, k_delay=k),
                "#4 doped")
            compare(f"phase 10: #4 {str(dtype)[6:]} W={W} ns={ns} k={k} "
                    f"doped fake G (seed {seed})", args, dict(k_delay=k),
                    dtype, want)

    # one launch of 32 visits at the stretch shape, f32, both flavors
    W, L, k = SITE_SHAPES[-1]
    n = L * L
    dt = torch.float32
    model = RepulsiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                   mu=0.0, beta=1.0, nt=20, dtype=dt,
                                   device="cuda")
    states = init_state(model, EngineConfig(nt=20, n_stab=5),
                        make_generators(5, W, "cuda"))
    order = torch.argsort(torch.rand((n,), generator=gen, device="cuda")
                          ).to(torch.int32)
    props = torch.randint(0, 3, (W, n), generator=gen, device="cuda")
    us = torch.rand((W, n), generator=gen, device="cuda", dtype=dt)
    _, gb, delta = tk.visit_factors(
        model.g.expand(W), model.alpha.expand(W), states.fields[:, 0],
        order.long().expand(W, n), props, dt, 2)
    gb, delta = gb.contiguous(), delta.contiguous()
    G = states.G.contiguous()
    U = torch.zeros((W, 2, k, n), dtype=dt, device="cuda")
    V = torch.zeros_like(U)
    acc = torch.empty((W, n), dtype=dt, device="cuda")
    sgn = torch.ones((W,), dtype=dt, device="cuda")
    blk = (acc, order, gb, delta, us, 0, k, sgn)
    K, P = tk.KERNELS, tk.PLAIN
    ms = cuda_ms(lambda: K.delayed_block(G, U, V, *blk), 5)
    plain_ms = cuda_ms(lambda: P.delayed_block(G, U.clone(), V.clone(),
                                               *blk), 1)
    record(report, "delayed_sites_2f", max_abs_err=slice_err, ms=ms,
           plain_ms=plain_ms, ops=W * 2 * 2 * n * k * (k - 1),
           nbytes=4 * W * (8 * k * n + 6 * k))
    Gw = G.clone()
    fms = cuda_ms(lambda: K.delayed_flush(Gw, U, V, k), 5)
    lib = cuda_ms(lambda: Gw.view(2 * W, n, n).baddbmm_(
        U.view(2 * W, k, n).mT, V.view(2 * W, k, n)), 5)
    r = report["delayed_sites_2f"]
    say(f"phase 10: delayed_sites_2f f32 W={W} ns={n} k={k}, one launch: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, no single library "
        f"call, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); its flush "
        f"over 2W matrices (delayed_flush) {fms:.4f} ms, one torch.baddbmm "
        f"{lib:.4f} ms")


# W, L, beta, nt, n_slices of the fused 2-flavor and submatrix checks
# (#2b: the repulsive preset's block, then the headline shape)
BLOCK_SHAPES_2F = ((32, 8, 4.0, 80, 5), (16, 16, 8.0, 160, 5))
BLOCK_SHAPES_SUB = ((4, 6, 4.0, 40, 5), (16, 16, 8.0, 160, 5))


def _diverged(torch, fa, fb, forward):
    """Decisions (W, n_slices, ns) of two runs of one block: the mismatches
    per slice in processing order, and per walker the first slice (as
    processed) with a mismatch, n_slices where it has none."""
    mm = fa != fb
    if not forward:
        mm = mm.flip(1)
    hit = mm.any(dim=2)
    n = hit.shape[1]
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), n)
    return mm.sum(dim=(0, 2)).tolist(), first


def _hold_block(torch, fused, tag, args, kw, dtype, want=None,
                f32_walkers=0.0, exact=None):
    """fused_block (kernels) against fused_block_plain on the card, at
    phase 3's tolerances; returns the G gap.  In float32 at most 1% of the
    decisions may differ, or (doped inputs) the decisions of a share
    ``f32_walkers`` of the walkers, and no walker's in the first half of
    the block's slices.  ``exact`` is the float64 twin's decisions on the
    same inputs: how far float32 rounding alone takes the float32 twin from
    them is printed beside the kernel's gap."""
    Gk, fk, bk, ak, sk = fused.fused_block(*args, **kw)
    Gp, fp, bp, ap, sp = want or fused.fused_block_plain(*args, **kw)
    torch.cuda.synchronize()
    mism = int((fk != fp).sum())
    smis = int((sk != sp).sum())
    dG = float((Gk - Gp).abs().max())
    dB = float((bk - bp).abs().max() / max(1.0, bp.abs().max()))
    flips = int((sp < 0).sum())
    if dtype == torch.float64:
        # decisions and signs identical; Bbar to 1e-11 relative to
        # max(1, |Bbar|); G to 1e-6 (naive propagation over the block
        # amplifies reordered rounding, as in phase 3)
        say(f"{tag}: mismatched decisions {mism}, signs {smis}, {flips} "
            f"walkers flipped, |dG| {dG:.3e} (< 1e-6), |dBbar| {dB:.3e} "
            f"(< 1e-11)")
        if mism or smis or not (dG < 1e-6 and dB < 1e-11):
            fail(f"{tag}: the block disagrees with its twin (f64)")
        return dG
    W, n = fk.shape[:2]
    per_slice, first = _diverged(torch, fk, fp, kw["forward"])
    left = first < n
    n_left = int(left.sum())
    # G of the walkers whose decisions all agree, against its largest entry
    same = (Gk - Gp)[~left]
    rel = float(same.abs().max() / Gp.abs().max()) if len(same) else 0.0
    line = (f"{tag}: mismatched decisions {mism} of {fk.numel()} (by slice "
            f"as processed: {per_slice}) in {n_left} of {W} walkers, signs "
            f"{smis}, {flips} walkers flipped, G relative gap of the other "
            f"walkers {rel:.3e}")
    if exact is not None:
        _, first_x = _diverged(torch, fp, exact, kw["forward"])
        line += (f"; the float32 twin leaves the float64 twin in "
                 f"{int((first_x < n).sum())} of {W} walkers (first at slice "
                 f"{int(first_x.min())})")
    say(line)
    # two correct f32 arithmetics diverge along a block (phase 3): a walker
    # whose rounding flipped one marginal decision late in the block differs
    # in about half of its later ones.  A broken kernel differs in every
    # walker from the first slice on.
    if n_left and int(first.min()) < n // 2:
        fail(f"{tag}: f32 decisions differ in the first half of the block")
    if mism > 0.01 * fk.numel() and n_left > f32_walkers * W:
        fail(f"{tag}: f32 decisions disagree with the twin")
    return dG


def phase_two_flavor_block(torch, gen, report):
    """#2b: the fused block with two flavors, forward and backward, at
    half filling and (the preset's shape) doped with a sign flip
    required."""
    from dqmc_tpu_torch.engine import fused
    for W, L, beta, nt, n in BLOCK_SHAPES_2F:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            need = fused.site_loop_smem(ns, 8 if dtype == torch.float64
                                        else 4, 2)
            if need > fused._SMEM_BYTES:
                # both flavors' U/V of a walker stay in one CTA: float64 at
                # ns = 256 is outside the kernel's shapes (supports_fused
                # says so and the per-slice engine serves it)
                say(f"phase 10: #2b {str(dtype)[6:]} W={W} ns={ns}: {need} "
                    f"bytes of U/V exceed one CTA's {fused._SMEM_BYTES}; "
                    f"not a shape of the kernel, skipped")
                continue
            model, states, order, props, us = block_inputs(
                torch, gen, W, L, beta, nt, n, dtype, "repulsive", 4.0, 0.0)
            for forward in (True, False):
                fb = states.fields[:, :n] if forward else states.fields[:, -n:]
                _hold_block(
                    torch, fused,
                    f"phase 10: #2b {str(dtype)[6:]} W={W} ns={ns} "
                    f"n_slices={n} k={fused._k_delay(ns)} mu=0 "
                    f"{'fwd' if forward else 'bwd'}",
                    (model, order, props, us, states.G, fb),
                    dict(n_slices=n, forward=forward), dtype)
    # doped, physical G: U=6, mu=-0.8 on the 8x8 lattice
    W, L, beta, nt, n = BLOCK_SHAPES_2F[0]
    for dtype in (torch.float64, torch.float32):
        for forward in (True, False):
            def make(seed):
                model, states, order, props, us = block_inputs(
                    torch, gen, W, L, beta, nt, n, dtype, "repulsive", 6.0,
                    -0.8, seed=20 + seed)
                fb = states.fields[:, :n] if forward else states.fields[:, -n:]
                return (model, order, props, us, states.G, fb)
            kw = dict(n_slices=n, forward=forward)
            seed, args, want = _flipping_seed(
                torch, make, lambda a: fused.fused_block_plain(*a, **kw),
                "#2b doped")
            exact = None
            if dtype == torch.float32:
                # the same walkers and streams through the float64 twin:
                # what float32 rounding alone does to the decisions
                m64, s64 = block_inputs(torch, gen, W, L, beta, nt, n,
                                        torch.float64, "repulsive", 6.0,
                                        -0.8, seed=20 + seed)[:2]
                fb = s64.fields[:, :n] if forward else s64.fields[:, -n:]
                if not torch.equal(fb, args[5]):
                    fail("#2b doped: the float64 walkers start elsewhere")
                exact = fused.fused_block_plain(
                    m64, args[1], args[2], args[3].double(), s64.G, fb,
                    **kw)[1]
            # doped: an accepted move with R < 0 has a small |r|, and its
            # prefac = delta / r amplifies rounding by 1/|r|, so a walker
            # can leave the twin late in the block; at most an eighth of
            # the walkers may
            _hold_block(torch, fused,
                        f"phase 10: #2b {str(dtype)[6:]} W={W} ns={L * L} "
                        f"doped U=6 mu=-0.8 (seed {seed}) "
                        f"{'fwd' if forward else 'bwd'}", args, kw, dtype,
                        want, f32_walkers=0.125, exact=exact)
    # the 2-flavor site loop alone, one slice: checked in float64 at the
    # small shape (the headline shape's float64 buffers do not fit), timed
    # in float32 at the headline shape
    for dtype, shape in ((torch.float64, BLOCK_SHAPES_2F[0]),
                         (torch.float32, BLOCK_SHAPES_2F[1])):
        W, L, beta, nt, n = shape
        ns = L * L
        k = fused._k_delay(ns)
        model, states, order, props, us = block_inputs(
            torch, gen, W, L, beta, nt, n, dtype, "repulsive", 4.0, 0.0)
        _, _, gb, delta, _, _ = fused.site_factors(
            model, states.fields[:, :n], props, dtype)
        delta = delta.contiguous()
        u_ = us.reshape(W, -1).contiguous()
        o32 = order.to(torch.int32).contiguous()
        G0 = states.G.contiguous()

        def run_sites(fn):
            Gc = G0.clone()
            m = torch.zeros((W, n * ns), dtype=dtype, device="cuda")
            sg = torch.ones((W,), dtype=dtype, device="cuda")
            fn(Gc, m, o32, gb, delta, u_, 0, k, sg)
            return Gc, m, sg
        (Gs, m1, s1), (Gq, m2, s2) = run_sites(fused.site_loop_cuda), \
            run_sites(fused.site_loop_plain)
        torch.cuda.synchronize()
        serr = float((Gs - Gq).abs().max())
        smis = int((m1 != m2).sum()) + int((s1 != s2).sum())
        if dtype == torch.float64:
            say(f"phase 10: 2-flavor site loop f64 W={W} ns={ns} k={k} one "
                f"slice: mismatched decisions and signs {smis}, |dG| "
                f"{serr:.3e} (< 1e-9)")
            if smis or not serr < 1e-9:
                fail("2-flavor site-loop kernel disagrees with its twin")
            site_err = serr
            continue
        sms = cuda_ms(lambda: run_sites(fused.site_loop_cuda), 10)
        spms = cuda_ms(lambda: run_sites(fused.site_loop_plain), 1)
    record(report, "fused_sites_2f", max_abs_err=site_err, ms=sms,
           plain_ms=spms,
           ops=2 * W * (ns // k * 2 * ns * k * (k - 1) + 2 * ns ** 3),
           nbytes=4 * W * (4 * ns * ns + 6 * ns))
    r = report["fused_sites_2f"]
    say(f"phase 10: 2-flavor site loop f32 W={W} ns={ns} k={k} one slice: "
        f"mismatched {smis}, |dG| {serr:.3e}; kernel {sms:.3f} ms, twin "
        f"{spms:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); no "
        f"single library call")


def phase_submatrix_block(torch, gen, report):
    """#2c: the fused block's submatrix scheme, forward and backward."""
    from dqmc_tpu_torch.engine import fused
    for W, L, beta, nt, n in BLOCK_SHAPES_SUB:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            model, states, order, props, us = block_inputs(
                torch, gen, W, L, beta, nt, n, dtype)
            for forward in (True, False):
                fb = states.fields[:, :n] if forward else states.fields[:, -n:]
                _hold_block(
                    torch, fused,
                    f"phase 10: #2c {str(dtype)[6:]} W={W} ns={ns} "
                    f"n_slices={n} k={fused._k_delay(ns)} "
                    f"{'fwd' if forward else 'bwd'}",
                    (model, order, props, us, states.G, fb),
                    dict(n_slices=n, forward=forward, update="submatrix"),
                    dtype)
    W, L, beta, nt, n = BLOCK_SHAPES_SUB[1]
    ns = L * L
    k = fused._k_delay(ns)
    for dtype in (torch.float64, torch.float32):
        model, states, order, props, us = block_inputs(
            torch, gen, W, L, beta, nt, n, dtype)
        _, _, gb, delta, _, _ = fused.site_factors(
            model, states.fields[:, :n], props, dtype)
        u_ = us.reshape(W, -1).contiguous()
        o32 = order.to(torch.int32).contiguous()
        G0 = states.G[:, 0].contiguous()

        def run_sites(fn):
            Gc = G0.clone()
            m = torch.zeros((W, n * ns), dtype=dtype, device="cuda")
            fn(Gc, m, o32, gb, delta, u_, 0, k)
            return Gc, m
        (Gs, m1), (Gq, m2) = run_sites(fused.site_loop_sub_cuda), \
            run_sites(fused.site_loop_sub_plain)
        torch.cuda.synchronize()
        serr = float((Gs - Gq).abs().max())
        smis = int((m1 != m2).sum())
        n_acc = int(m2[:, :ns].sum())
        if dtype == torch.float64:
            say(f"phase 10: submatrix site loop f64 W={W} ns={ns} k={k} one "
                f"slice: mismatched decisions {smis}, |dG| {serr:.3e} "
                f"(< 1e-9)")
            if smis or not serr < 1e-9:
                fail("submatrix site-loop kernel disagrees with its twin")
            site_err = serr
            continue
        sms = cuda_ms(lambda: run_sites(fused.site_loop_sub_cuda), 10)
        spms = cuda_ms(lambda: run_sites(fused.site_loop_sub_plain), 1)
    record(report, "fused_sites_sub", max_abs_err=site_err, ms=sms,
           plain_ms=spms,
           ops=W * (4 * ns * k * k + 2 * k * ns * ns + 2 * ns ** 3)
           + 3 * k * k * n_acc,
           nbytes=4 * W * (2 * ns * ns + 5 * ns))
    r = report["fused_sites_sub"]
    say(f"phase 10: submatrix site loop f32 W={W} ns={ns} k={k} one slice "
        f"({n_acc} accepted): mismatched {smis}, |dG| {serr:.3e}; kernel "
        f"{sms:.3f} ms, twin {spms:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); no single library call")


# the fused site loops alone: W, ns, flavors, submatrix, float type
LOOP_CASES = ((16, 256, 1, False, "float32"), (16, 256, 2, False, "float32"),
              (1, 256, 2, False, "float32"), (16, 256, 1, True, "float32"),
              (32, 64, 1, False, "float32"), (32, 64, 2, False, "float32"),
              (16, 448, 2, False, "float32"), (16, 224, 1, False, "float64"),
              (16, 224, 2, False, "float64"))


def time_site_loops(torch):
    """One slice per launch of the fused block's site loops (K2, #2b, #2c)
    at k = 32 on synthetic inputs (G = I/2 + noise, every ratio positive):
    one flavor against two, one walker against sixteen, both float types."""
    from dqmc_tpu_torch.engine import fused
    for W, ns, nfl, sub, dtype in LOOP_CASES:
        kw = dict(device="cuda", dtype=getattr(torch, dtype))
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        shape = (W, ns, ns) if nfl == 1 else (W, 2, ns, ns)
        G = 0.5 * torch.eye(ns, **kw) + 0.01 * torch.randn(shape,
                                                            generator=g, **kw)
        gb = torch.ones((W, ns), **kw)
        delta = torch.full((W, ns) if nfl == 1 else (W, 2, ns), 0.3, **kw)
        if nfl == 2:
            delta[:, 1] = -0.25
        us = torch.rand((W, ns), generator=g, **kw)
        order = torch.argsort(torch.rand((1, ns), generator=g,
                                         device="cuda"), dim=-1
                              ).to(torch.int32)
        mask = torch.zeros((W, ns), **kw)
        sgn = torch.ones((W,), **kw) if nfl == 2 else None
        fn = fused.site_loop_sub_cuda if sub else fused.site_loop_cuda
        ms = cuda_ms(lambda: fn(G, mask, order, gb, delta, us, 0, 32, sgn),
                     10)
        say(f"phase 10: site loop alone, {'submatrix' if sub else 'delayed'}"
            f" {dtype} W={W} ns={ns} flavors={nfl} k=32: {ms:.3f} ms per "
            f"slice")


def phase_new_kernels(torch, report):
    """Phase 10, on a generator of its own: the same inputs whether or not
    the phases before it ran."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    phase_two_flavor_sites(torch, gen, report)
    phase_two_flavor_block(torch, gen, report)
    phase_submatrix_block(torch, gen, report)
    time_site_loops(torch)


REPULSIVE = """
[Lattice]
L1 = 8
L2 = 8
[hubbard]
model = repulsive
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 4.0
nt = 80
n_stab = 5
dtype = float32
seed = 42
measure_spin = true
[walkers]
n_walkers = 32
"""

# gate on the steady float32 self-check of the repulsive preset at
# n_stab = 5: ten times the 3.4e-2 the card measured over 40 pairs (the
# float32 error is heavy-tailed, as on examples/basic); a broken chain reads
# O(1)
REPULSIVE_SELF_CHECK = 0.3


def phase_repulsive(torch):
    """bench.py's repulsive preset through run_simulation on both engines,
    then a doped run."""
    fused_need = ("cgs2_qr", "fused_wrap", "fused_sites_2f")
    slice_need = ("cgs2_qr", "delayed_sites_2f", "delayed_flush")
    runs = (
        ("n_therms = 20\nn_bins = 4\nn_sweeps = 10\n", "engine = auto "
         "(fused: #2b + K1), 20 + 4x10 pairs", fused_need),
        ("engine = slice\nn_therms = 5\nn_bins = 2\nn_sweeps = 5\n",
         "engine = slice (site_update = pallas: #4 + K1), 5 + 2x5 pairs",
         slice_need))
    for extra, label, need in runs:
        summary = run_params(
            torch, REPULSIVE + "[simulation]\n" + extra,
            "repulsive 8x8 beta=4 nt=80 n_stab=5 U=4 mu=0 W=32 f32, " + label,
            need, "phase 11")
        signs = summary.walker_signs
        say(f"phase 11: walker signs {sorted(set(signs))}, mean sign "
            f"{summary.observables['sign']:.4f}, self-check max "
            f"{summary.max_precision_error:.3e} (< "
            f"{REPULSIVE_SELF_CHECK})")
        if set(signs) != {1.0} or summary.observables["sign"] != 1.0:
            fail("half filling is sign-free: every walker's sign must be +1")
        if not summary.max_precision_error < REPULSIVE_SELF_CHECK:
            fail("repulsive preset: steady self-check above its gate")
    summary = run_params(
        torch, REPULSIVE + "[hubbard]\nU = 6.0\nmu = -0.8\n[simulation]\n"
        "n_therms = 10\nn_bins = 5\nn_sweeps = 4\n",
        "repulsive doped U=6 mu=-0.8, engine = auto (fused), 10 + 5x4 pairs",
        fused_need, "phase 11")
    signs = summary.walker_signs
    if not set(signs) <= {1.0, -1.0}:
        fail(f"doped run: a walker's sign is not +-1: {sorted(set(signs))}")
    mean = summary.observables["sign"]
    say(f"phase 11: doped run: mean sign over bins {mean:.4f}, "
        f"{sum(s < 0 for s in signs)} of {len(signs)} walkers end at -1"
        + ("" if mean < 1.0 or min(signs) < 0 else " (no flip seen)"))


def phase_repulsive_headline(torch, card):
    """The headline shape with the repulsive model, three timed sweep
    pairs on the fused engine (#2b + K1 over 2 W = 32 matrices)."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine.fused import supports_fused, sweep_pair_fused
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state, reset_error_stats
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import RepulsiveHubbard
    W, L, beta, nt, n_stab = 16, 16, 8.0, 160, 5
    model = RepulsiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                   mu=0.0, beta=beta, nt=nt,
                                   dtype=torch.float32, device="cuda")
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    if not supports_fused(model, cfg):
        fail("the fused engine must take the 2-flavor headline shape")
    states = init_state(model, cfg, make_generators(42, W, "cuda"))
    states = sweep_pair_fused(model, cfg, states)        # warm-up pair
    states = reset_error_stats(states)
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        states = sweep_pair_fused(model, cfg, states)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    TOTALS.update(_cuda.LAUNCHES)
    launches = {k: _cuda.LAUNCHES[k]
                for k in ("cgs2_qr", "fused_wrap", "fused_sites_2f")}
    err = float(states.err_max.max())
    say(f"phase 12: repulsive 16x16 beta=8 nt=160 n_stab=5 W=16 f32: "
        f"{3 * W / dt:.3f} walker-sweep-pairs/s (3 pairs, {dt:.2f} s), "
        f"self-check max {err:.3e}, signs "
        f"{sorted(set(states.sign.tolist()))}, launches {launches} on "
        f"{card}")
    # a timing: at beta = 8 and n_stab = 5 the float32 self-check is O(10)
    # (4.8 for the attractive headline too), so a ratio can come out
    # negative and the signs are printed, not held to +1 as in phase 11
    if not err == err or min(launches.values()) <= 0:
        fail("repulsive headline sweep pairs")
    if not set(states.sign.tolist()) <= {1.0, -1.0}:
        fail("a walker's sign is not +-1")


def phase_fused_submatrix(torch):
    """examples/basic on the fused engine with fused_update = submatrix
    (#2c), phase 4's n_stab = 2, 20 + 4x20 pairs."""
    text = (REPO / "examples" / "basic" / "parameters.in").read_text()
    summary = run_params(
        torch, text + "[simulation]\nengine = fused\nfused_update = "
        "submatrix\nn_therms = 20\nn_bins = 4\nn_sweeps = 20\nn_stab = 2\n"
        "dtype = float32\n",
        "examples/basic, engine = fused, fused_update = submatrix (#2c), "
        "n_stab=2, 20 + 4x20 pairs",
        ("cgs2_qr", "fused_wrap", "fused_sites_sub"), "phase 13")
    if not summary.max_precision_error < 1e-2:
        fail("fused submatrix: steady self-check above the f32 err_warn")


def print_registers() -> None:
    """ptxas's registers and spill bytes of every kernel instantiation,
    from one ``nvcc -Xptxas -v`` per source with the build's flags."""
    import re
    from dqmc_tpu_torch import _cuda
    with tempfile.TemporaryDirectory() as tmp:
        for src in _cuda.sources():
            out = subprocess.run(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", str(Path(tmp) / (src.stem + ".o")), str(src)],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                fail(f"nvcc -Xptxas -v {src.name}: {out.stderr[-2000:]}")
            text = out.stderr
            if shutil.which("c++filt"):
                text = subprocess.run(["c++filt"], input=text,
                                      capture_output=True, text=True).stdout
            for name, spill, regs in re.findall(
                    r"Compiling entry function '(.*?)' for.*?(\d+) bytes "
                    r"spill stores.*?Used (\d+) registers", text, re.S):
                name = re.sub(r"\(anonymous namespace\)::|^void |\(.*", "",
                              name)
                say(f"registers: {src.name} {name}: {regs} registers, "
                    f"{spill} bytes spilled")


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "cgs2_qr": ("dqmc_tpu_torch/csrc/cgs2_qr.cu",
                "dqmc_tpu/ops/qr_kernel.py:36"),
    "fused_wrap": ("dqmc_tpu_torch/csrc/fused_block.cu",
                   "dqmc_tpu/engine/fused.py:69"),
    "fused_sites": ("dqmc_tpu_torch/csrc/fused_block.cu",
                    "dqmc_tpu/engine/fused.py:69"),
    "fused_sites_2f": ("dqmc_tpu_torch/csrc/fused_block.cu",
                       "dqmc_tpu/engine/fused.py:69"),
    "fused_sites_sub": ("dqmc_tpu_torch/csrc/fused_block.cu",
                        "dqmc_tpu/engine/fused.py:288"),
    "delayed_sites": ("dqmc_tpu_torch/csrc/site_update.cu",
                      "dqmc_tpu/ops/kernels.py:121"),
    "delayed_sites_2f": ("dqmc_tpu_torch/csrc/site_update.cu",
                         "dqmc_tpu/ops/kernels.py:222"),
    "delayed_flush": ("dqmc_tpu_torch/csrc/site_update.cu",
                      "dqmc_tpu/ops/kernels.py:121"),
    "rank1_sites": ("dqmc_tpu_torch/csrc/site_update.cu",
                    "dqmc_tpu/ops/kernels.py:31"),
    "submatrix_decide": ("dqmc_tpu_torch/csrc/submatrix_update.cu",
                         "dqmc_tpu/ops/kernels.py:584"),
    "submatrix_prep": ("dqmc_tpu_torch/csrc/submatrix_update.cu",
                       "dqmc_tpu/ops/kernels.py:584"),
    "submatrix_flush": ("dqmc_tpu_torch/csrc/submatrix_update.cu",
                        "dqmc_tpu/ops/kernels.py:584"),
}
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--registers", action="store_true",
                    help="print ptxas's registers and spills per kernel "
                    "and stop")
    opts = ap.parse_args(argv)
    phases = {int(x) for x in opts.phases.split(",")}
    if not (REPO / "dqmc_tpu_torch").is_dir():
        fail("run chip_smoke.py from a checkout of the repository "
             "(dqmc_tpu_torch/ not found beside it)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave no output"
    say(card)
    if opts.registers:
        return print_registers()
    from dqmc_tpu_torch import _cuda
    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.lib()
    say(f"phase 1: nvcc build of {len(_cuda.sources())} sources into "
        f"{lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    report = {}
    steps = ((2, lambda: phase_qr(torch, gen, report)),
             (3, lambda: phase_block(torch, gen, report)),
             (4, lambda: phase_main(torch)),
             (5, lambda: phase_headline(torch, card)),
             (6, lambda: phase_sites(torch, gen, report)),
             (7, lambda: phase_stretch(torch)),
             (8, lambda: phase_basic_slice(torch)),
             (9, lambda: phase_profile(torch)),
             (10, lambda: phase_new_kernels(torch, report)),
             (11, lambda: phase_repulsive(torch)),
             (12, lambda: phase_repulsive_headline(torch, card)),
             (13, lambda: phase_fused_submatrix(torch)))
    for phase, run in steps:
        if phase in phases:
            t1 = time.perf_counter()
            run()
            say(f"phase {phase} took {time.perf_counter() - t1:.1f} s")
    if not set(PHASES) <= phases:
        say(f"partial run (phases {sorted(phases)}): no result object")
        return
    missing = [name for name in KERNELS if not TOTALS[name]]
    if missing:
        fail(f"kernels never launched on a main path: {missing}")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=TOTALS[name], **report[name])
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
