#!/usr/bin/env python3
"""On-card smoke test of dqmc_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line; the first failed phase exits non-zero):

1. the card's name and power limit (nvidia-smi), then the nvcc build of
   dqmc_tpu_torch/csrc/*.cu and its seconds;
2. K1 (the CGS2 QR kernel) against its plain torch twin on the card;
3. K2 (the fused-block wrap GEMM and site-loop kernels) against the plain
   twin on the card, both sweep directions, at the examples/basic and the
   headline shapes;
4. the main path through its normal entry point (dqmc_tpu_torch.run.main,
   what ``python -m dqmc_tpu_torch`` runs) on examples/basic/parameters.in
   with the sweep counts cut, checking the kernels' launch counters,
   acceptance, the steady self-check error and the measured observables;
5. the headline shape (16x16, beta=8, nt=160, n_stab=5, W=16, float32) for
   three sweep pairs, printing walker-sweep-pairs/s.

The line before the last is one JSON object describing every kernel of the
main path; the last line is the result object.  Tolerances are stated where
they are checked.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# examples/basic (ns = 36) and the bench headline (ns = 256) shapes
QR_SHAPES = ((16, 256), (4, 36))
BLOCK_SHAPES = ((4, 6, 4.0, 40, 10), (16, 16, 8.0, 160, 5))  # W L beta nt n


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
    # f64: kernel and twin run the same algorithm in another summation
    # order; Q and R agree to 1e-12 absolute, R^{-1} to 1e-12 relative to
    # its largest entry (its scale grows with cond(A))
    for B, n in QR_SHAPES:
        A = torch.randn((B, n, n), generator=gen, device="cuda",
                        dtype=torch.float64)
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
    # f32 factorization quality at tests/test_qr_kernel.py's thresholds
    A = graded(gen, 4, 64, torch.float32)
    Q, R = qk.cgs2_qr(A)
    Q64, R64 = Q.double(), R.double()
    eye = torch.eye(64, dtype=torch.float64, device="cuda")
    orth = float((Q64.mT @ Q64 - eye).abs().max())
    recon = float((Q64 @ R64 - A.double()).abs().max())
    low = float(torch.tril(R64, -1).abs().max())
    dmin = float(torch.diagonal(R64, dim1=-2, dim2=-1).min())
    say(f"phase 2: K1 f32 (4, 64, 64) graded: orth {orth:.3e} (< 2e-4) "
        f"recon {recon:.3e} (< 5e-6) tril {low:.1e} min diag {dmin:.3e}")
    if not (orth < 2e-4 and recon < 5e-6 and low == 0.0 and dmin >= 0.0):
        fail("K1 f32 factorization quality")
    # f32 at the headline shape: gap to the twin, and times
    B, n = QR_SHAPES[0]
    A = graded(gen, B, n, torch.float32)
    got = qk.cgs2_qr_inv(A)
    want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    ms = cuda_ms(lambda: qk.cgs2_qr_inv(A), 20)
    plain_ms = cuda_ms(lambda: qk.padded_qr(A, True, qk.cgs2_qr_plain), 2)
    say(f"phase 2: K1 f32 ({B}, {n}, {n}) |d(Q,R)| {err:.3e}; kernel "
        f"{ms:.3f} ms, twin {plain_ms:.3f} ms")
    if not err < 1e-3:
        fail("K1 f32 disagrees with its twin at the headline shape")
    report["cgs2_qr"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def block_inputs(torch, gen, W, L, beta, nt, n_slices, dtype):
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                    mu=-0.1, beta=beta, nt=nt, dtype=dtype,
                                    device="cuda")
    cfg = EngineConfig(nt=nt, n_stab=n_slices)
    states = init_state(model, cfg, make_generators(11, W, "cuda"))
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
    report["fused_wrap"] = dict(max_abs_err=werr, ms=wms / 2,
                                plain_ms=wpms / 2)
    say(f"phase 3: wrap GEMM f32 (16, 256, 256) |dG| {werr:.3e}; kernel "
        f"{wms / 2:.4f} ms/GEMM, torch.matmul {wpms / 2:.4f} ms/GEMM")
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
    report["fused_sites"] = dict(max_abs_err=site_err, ms=sms, plain_ms=spms)


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
            launches = dict(_cuda.LAUNCHES)
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
    return launches


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
    err = float(states.err_max.max())
    rate = 3 * W / dt
    say(f"phase 5: headline 16x16 beta=8 nt=160 n_stab=5 W=16 f32: "
        f"{rate:.3f} walker-sweep-pairs/s (3 pairs, {dt:.2f} s), self-check "
        f"max {err:.3e}, launches {dict(_cuda.LAUNCHES)} on {card}")
    if not err == err or min(_cuda.LAUNCHES.values()) <= 0:
        fail("headline sweep pairs")


def main() -> None:
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
    phase_qr(torch, gen, report)
    phase_block(torch, gen, report)
    launches = phase_main(torch)
    phase_headline(torch, card)

    meta = {
        "cgs2_qr": ("dqmc_tpu_torch/csrc/cgs2_qr.cu",
                    "dqmc_tpu/ops/qr_kernel.py:36"),
        "fused_wrap": ("dqmc_tpu_torch/csrc/fused_block.cu",
                       "dqmc_tpu/engine/fused.py:69"),
        "fused_sites": ("dqmc_tpu_torch/csrc/fused_block.cu",
                        "dqmc_tpu/engine/fused.py:69"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **report[name])
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
