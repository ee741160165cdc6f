#!/usr/bin/env python3
"""On-card smoke test of dqmc_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 1,6    # a subset, for iterating
    python3 chip_smoke.py --registers     # ptxas registers per kernel

Phases (each prints lines starting "phase N"; the first failed check exits
non-zero):

1. the card's name and power limit (nvidia-smi), then the nvcc build of
   dqmc_tpu_torch/csrc/*.cu (one nvcc per source, in parallel) and its
   seconds;
2. K1 (the CGS2 QR kernel) against its plain torch twin on the card
   (float64 and float32), the factorization thresholds of
   tests/test_qr_kernel.py in float32, the same bits on a second call, at
   (16, 256), (4, 36), (64, 64) and the 32x32 lattice's (4, 1024) (float32
   only); times at (16, 256) and (4, 1024) beside torch.linalg.qr, and
   K1's device time by stage (torch.profiler);
3. K2 (the fused-block wrap GEMM and site-loop kernels) against the plain
   twin on the card, both sweep directions, at the examples/basic and the
   headline shapes (float32 decisions also counted against the twin in
   float64, not gated), then the same blocks with every slice's site loop
   held against the float32 twin's from the kernel's own state before that
   slice (<= 1% mismatched), the same bits on a second call; the site loop
   alone for one slice; the wrap GEMM alone at the headline's,
   examples/basic's and the repulsive preset's shapes, in device time
   beside torch.matmul;
4. the fused main path through its normal entry point
   (dqmc_tpu_torch.run.main, what ``python -m dqmc_tpu_torch`` runs) on
   examples/basic/parameters.in with the sweep counts cut, checking the
   kernels' launch counters, acceptance, the steady self-check error and
   the measured observables; beside it, in worker processes, the same
   configuration at seeds 1-7 (scripts/selfcheck_seeds.py): the median of
   the eight steady maxima and the largest steady mean are gated;
5. the headline shape (16x16, beta=8, nt=160, n_stab=5, W=16, float32) for
   three sweep pairs, printing walker-sweep-pairs/s, then one more pair
   under torch.profiler (device time by kernel, idle share);
6. the per-slice engine's site-update kernels (#3 delayed, #5 submatrix
   and #6 rank-1, each in both order modes) against their twins, one slice
   each, at (W=4, ns=36, k=4), (16, 256, 32) and the stretch shape (W=4,
   ns=1024, k=32), and #3 and #5 per walker at rank 32 (groups of 32 + 4
   at ns = 36); #5 also gives the same bits on a second call, rejects and
   accepts in every case, and accepts a whole group somewhere; the host's
   copies of the kernels' cluster and shared-memory budgets against the
   library's; each kernel timed alone at the stretch shape (#3's slice,
   and #5's group kernel and flush over a slice, in device time, the flush
   beside torch.baddbmm in device time), and #6 at (W=4, ns=36), (16, 256)
   and (4, 1024) in both float types in device time, each beside its
   bound and the parent's time;
7. the stretch configuration (32x32, beta=16, nt=320, n_stab=5, U=4, W=4,
   float32) through run_simulation, with the default site update (#3),
   with site_update = submatrix (#5) and with site_update = scan (#6), one
   pair each, then one more scan pair under torch.profiler (device busy
   time per pair);
8. examples/basic through the per-slice engine with site_update = scan
   (#6) and delayed (#3), then five scan pairs under torch.profiler
   (device busy time per pair);
9. under torch.profiler, device time by kernel and the device's idle
   share: the first stretch sweep pair with the default site update (#3),
   and three pairs of the repulsive preset on each engine;
10. the 2-flavor and submatrix kernels against their twins: #4 (the
    per-slice 2-flavor delayed update) one slice at (W=4, ns=36, k=4), the
    repulsive preset's (32, 64, 32) and (4, 1024, 32), and per walker at
    (4, 36) with groups of 32 + 4, its whole slice timed at (4, 1024, 32)
    in device time; #2b (the fused block
    with two flavors) forward and backward at the preset's (32, 64, 5
    slices) and (16, 256, 5) in both float types; the #2b site loop alone
    in float64 up to ns = 512; #2c (the fused block's submatrix scheme) at
    (4, 36) and (16, 256) in both float types and at 22x22 and 16x32
    (ns = 512) in float64, and on one CTA per walker at 4x4 (k = 4 and 16,
    float64) and 5x5 (k = 5 and 25, both float types), its site loop alone
    the same bits on a second call and timed in device time; doped cases
    of #4 and #2b (U=6, mu=-0.8) must flip a sign; each new kernel timed alone, and the
    fused site loops with one and two flavors, 1 and 16 walkers, both
    float types, up to ns = 512;
11. the repulsive preset (8x8, beta=4, nt=80, n_stab=5, U=4, mu=0, W=32,
    float32) through run_simulation with engine = auto (fused: #2b + K1)
    and engine = slice (#4 + K1): every walker's sign must stay +1; then a
    doped run (U=6, mu=-0.8) in float32 and in float64 (#2b f64, its
    steady self-check < 1e-6), printing the mean sign, density and
    doubleOcc of both;
12. the headline shape with model = repulsive, three timed sweep pairs on
    the fused engine, then one more pair under torch.profiler;
13. examples/basic with fused_update = submatrix (#2c) on the fused engine,
    then the headline shape with fused_update = submatrix as phase 5 runs
    it (three timed pairs, one profiled);
14. the multiword panel kernels #7 (df32) and #8 (tf32) against their plain
    twin, bit for bit, on graded panels at (16, 32, 256), (16, 32, 64),
    (4, 32, 512) and (4, 32, 32), a panel with zero rows and one whose
    first digits of y, q and e reach 128 (the carry planes); each timed in
    device time at the first three shapes, at (16, 32, 256) beside its
    twin, its bound and torch.linalg.qr in float64;
15. the df32 headline (16x16, beta=8, nt=160, n_stab=5, W=16, dtype =
    df32) through run_simulation (#3, K1, #7), G_df of the final fields
    against the native float64 rebuild (< 1e-7), two blocks profiled;
16. examples/tpu_production's tier split with unequal-time measurement
    and the spin and charge sets (the fused float32 engine; every
    measurement rebuilds the tau-resolved triplet at tf32 through #8 and
    K1, its G00 the equal-time G; n_stab = auto; the checkpoint and spool
    keys off): the tier of the final fields against the native float64 tau
    sweep at n_stab = 1, every tau, and its G00 against the float64
    rebuild (<= 1e-9 of max|G|); then a short measure_precision = df32 run
    (#7), held likewise at 1e-7;
17. the engine-grade tau path (engine/uneqtime.py): (a) free fermions at
    the headline shape in float64 and float32 against the exact
    propagators (1e-10, 1e-2), with the boundary identities; (b) the
    headline with unequal-time measurement through run_simulation, 2 + 3
    pairs in float32 (its rate and err_uneq_max; the float32 tau sweep of
    the final fields against float64, per walker <= 5e-2 of its max|G|;
    one measured iteration and its tau sweep under torch.profiler), then
    1 + 1 pairs in float64 (err_uneq_max < 1e-6); (d)
    examples/repulsive_spin through the CLI with its sweep counts cut
    (#2b + K1), at its n_stab = 10 (printed) and at 2 (signs +1,
    err_uneq_max < 1e-2), and on its fields (c) the
    tau = 0 identities in float64 (<= 1e-12); then the df32 headline with
    unequal-time measurement, 1 + 1 pairs, the tau sweep on the walkers'
    float32 view against float64 (as in (b), <= 5e-2 of max|G|).

Every phase that drives a main path (4, 5, 7, 8, 11, 12, 13, 15, 16, 17)
sets the launch counters to 0 just before and reads them just after; the
tau runs also count the launches made inside their tau sweeps.  The line
before the last is one JSON object describing every kernel; the last line
is the result object.  Tolerances are stated where they are checked.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the bench headline (ns = 256), examples/basic (ns = 36) and the repulsive
# preset (2 W = 64 matrices of ns = 64)
QR_SHAPES = ((16, 256), (4, 36), (64, 64))
BLOCK_SHAPES = ((4, 6, 4.0, 40, 10), (16, 16, 8.0, 160, 5))  # W L beta nt n
# the per-slice engine's site-update shapes: (W, L, k); the df32
# headline's float32 view (16, 256, 32) runs the delayed slice on its
# four-CTA clusters of 256 threads; the last is the stretch shape
SITE_SHAPES = ((4, 6, 4), (16, 16, 32), (4, 32, 32))
# #4's shapes: those, and the repulsive preset's (W=32, 8x8, two blocks of
# 32 visits, one column per thread)
SITE_SHAPES_2F = ((4, 6, 4), (32, 8, 32), (4, 32, 32))

# the card's peaks (NVIDIA H100 SXM data sheet): FP32 outside the tensor
# cores, int8 in the tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12

# phase 4's seed, then the others of scripts/selfcheck_seeds.py
SELFCHECK_SEEDS = (42, 1, 2, 3, 4, 5, 6, 7)

# launches of every main-path run (phases 4, 5, 7, 8)
TOTALS = Counter()


def bound(ops: float, nbytes: float, ops_int8: float = 0.0,
          ops_f64: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take for ops
    float32 operations, ops_int8 int8 operations, ops_f64 float64
    operations and nbytes of traffic (each input read once, each output
    written once)."""
    t_ops = ops / PEAK_F32 + ops_int8 / PEAK_INT8 + ops_f64 / PEAK_F64
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def record(report, name, *, max_abs_err, ms, plain_ms, ops, nbytes,
           library_ms=None, ops_int8=0.0, ops_f64=0.0, shape=None,
           main=True):
    """Set a kernel's entry of the ``kernels`` line.  With ``shape``, the
    numbers are also kept under the entry's ``shapes`` list, and only a
    ``main`` shape sets the entry's own keys."""
    bound_ms, bound_by = bound(ops, nbytes, ops_int8, ops_f64)
    entry = dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    old = report.get(name, {})
    if shape is not None:
        shapes = old.get("shapes", []) + [dict(shape=list(shape), **entry)]
        if not main and old:
            entry = {k: v for k, v in old.items() if k != "shapes"}
        entry["shapes"] = shapes
    report[name] = entry


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


def device_ms(fn, reps: int = 30) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph and replayed between two CUDA events, so the host's launch
    time -- which events around a loop of calls include whenever the host,
    not the device, sets the pace -- drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def same_bits(outs_a, outs_b) -> bool:
    """Two calls' outputs equal bit for bit."""
    import torch
    return all(torch.equal(x, y) for x, y in zip(outs_a, outs_b))


K1_STAGES = (("block_dot_kernel", "block passes: C = P Q^T, R"),
             ("block_update_kernel", "block passes: P -= C Q"),
             ("panel_kernel", "in-panel loop and S"),
             ("x_kernel", "R^-1: X = R[:p0, P] S"),
             ("cross_kernel", "R^-1: -W[:p0, :p0] X"),
             ("Memset", "zero fill of R, R^-1"),
             ("Memcpy", "copy of A^T"))


def k1_stage_split(torch, qk, A, reps=3):
    """Device time of K1's launches by stage over ``reps`` calls of
    cgs2_qr_inv, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    qk.cgs2_qr_inv(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            qk.cgs2_qr_inv(A)
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    times, counts = Counter(), Counter()
    for e in prof.key_averages():
        for key, _ in K1_STAGES:
            if key in e.key and dev(e) > 0:
                times[key] += dev(e) / 1e3 / reps
                counts[key] += e.count / reps
    busy = sum(times.values())
    B, n, _ = A.shape
    say(f"phase 2: K1 f32 ({B}, {n}, {n}) stage split (torch.profiler, "
        f"{reps} calls): device busy {busy:.3f} ms per cgs2_qr_inv")
    for key, what in K1_STAGES:
        say(f"phase 2:   {what:30s} {times[key]:8.3f} ms "
            f"({times[key] / max(busy, 1e-9):6.1%}) {counts[key]:.1f} "
            f"launches")


def phase_qr(torch, gen, report):
    from dqmc_tpu_torch.ops import qr_kernel as qk
    # the preset's case draws from a generator of its own, so the inputs of
    # the cases and phases after it do not move
    own = torch.Generator(device="cuda")
    own.manual_seed(64)
    # f64: kernel and twin run the same algorithm in another summation
    # order; Q and R agree to 1e-12 absolute, R^{-1} to 1e-12 relative to
    # its largest entry (its scale grows with cond(A)); two calls give the
    # same bits
    for B, n in QR_SHAPES:
        A = torch.randn((B, n, n), generator=gen if n != 64 else own,
                        device="cuda", dtype=torch.float64)
        got = qk.cgs2_qr_inv(A)
        again = qk.cgs2_qr_inv(A)
        want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
        torch.cuda.synchronize()
        eq = float((got[0] - want[0]).abs().max())
        er = float((got[1] - want[1]).abs().max())
        ew = float((got[2] - want[2]).abs().max() / want[2].abs().max())
        same = same_bits(got, again)
        say(f"phase 2: K1 f64 ({B}, {n}, {n}) |dQ| {eq:.3e} |dR| {er:.3e} "
            f"|dRinv|/max {ew:.3e}; two calls bit-equal: {same}")
        if not max(eq, er, ew) < 1e-12:
            fail(f"K1 f64 disagrees with its twin at ({B}, {n})")
        if not same:
            fail(f"K1 f64 gives other bits on a second call at ({B}, {n})")
    # f32 factorization quality at tests/test_qr_kernel.py's thresholds,
    # the gap to the twin (< 1e-3 in Q and R), the same bits on a second
    # call, at the QR_SHAPES and at the 32x32 lattice's n = 1024 (float32
    # only: the f64 panel would not fit in shared memory, and the engine's
    # f64 QR is Householder)
    qr_quality(torch, qk, graded(gen, 4, 64, torch.float32))
    for B, n in QR_SHAPES + ((4, 1024),):
        timed = (B, n) in ((16, 256), (4, 1024))
        A = graded(gen if timed else own, B, n, torch.float32)
        qr_quality(torch, qk, A)
        got = qk.cgs2_qr_inv(A)
        again = qk.cgs2_qr_inv(A)
        want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        same = same_bits(got, again)
        say(f"phase 2: K1 f32 ({B}, {n}, {n}) |d(Q,R)| vs twin {err:.3e}; "
            f"two calls bit-equal: {same}")
        if not err < 1e-3:
            fail(f"K1 f32 disagrees with its twin at ({B}, {n})")
        if not same:
            fail(f"K1 f32 gives other bits on a second call at ({B}, {n})")
        if not timed:
            continue
        # the times, at the headline's and the stretch's shapes; the entry
        # of the kernels line keeps the stretch's as before, both under
        # "shapes"
        reps = 20 if n == 256 else 10
        ms = cuda_ms(lambda: qk.cgs2_qr_inv(A), reps)
        plain_ms = cuda_ms(lambda: qk.padded_qr(A, True, qk.cgs2_qr_plain),
                           1)
        lib_ms = cuda_ms(lambda: torch.linalg.qr(A), reps)
        record(report, "cgs2_qr", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               ops=(4 + 1 / 3) * n ** 3 * B, nbytes=4 * B * n * n * 4,
               library_ms=lib_ms, shape=(B, n, n), main=n == 1024)
        r = report["cgs2_qr"]["shapes"][-1]
        say(f"phase 2: K1 f32 ({B}, {n}, {n}): kernel {ms:.3f} ms per "
            f"cgs2_qr_inv, twin {plain_ms:.3f} ms, torch.linalg.qr "
            f"{lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        k1_stage_split(torch, qk, A)


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
    """A fused block's inputs on an L x L lattice (L = (L1, L2): L1 x L2):
    the model, fresh walkers, and the block's streams."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    L1, L2 = L if isinstance(L, tuple) else (L, L)
    model = MODEL_REGISTRY[model].build(square_lattice(L1, L2), U=U, t=1.0,
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


# the wrap GEMM's other shapes on the fused engine: (matrices, L) of
# examples/basic (W = 4, ns = 36) and the repulsive preset (2 W = 64 flavor
# chains, ns = 64)
WRAP_SHAPES = ((4, 6), (64, 8))


def check_wrap_gemm(torch, fused, model, G, ev, report, main):
    """The wrap GEMM at one shape: a forward wrap (expK G invexpK scaled by
    diag(ev), diag(1/ev)) and a backward one (invexpK (diag(1/ev) G
    diag(ev) expK)) against the plain version (< 1e-4 relative), the same
    bits on a second call, and the times beside torch.matmul of the same
    product: the A-shared GEMM (expK G), and the B-shared one that the
    kernel tiles as one tall GEMM."""
    W, ns, _ = G.shape
    iev = 1.0 / ev
    eK, ieK = model.expK, model.invexpK
    fwd = lambda g: g.wrap_gemm(g.wrap_gemm(eK, G), ieK, rv=ev, cv=iev)
    bwd = lambda g: g.wrap_gemm(ieK, g.wrap_gemm(G, eK, rv=iev, mv=ev))
    kern = SimpleNamespace(wrap_gemm=fused.wrap_gemm_cuda)
    plain = SimpleNamespace(wrap_gemm=fused.wrap_gemm_plain)
    werr = 0.0
    for chain in (fwd, bwd):
        got, want = chain(kern), chain(plain)
        err = float((got - want).abs().max() / want.abs().max())
        werr = max(werr, float((got - want).abs().max()))
        if not err < 1e-4:
            fail(f"wrap GEMM disagrees with its plain version at ({W}, "
                 f"{ns}, {ns}): {err:.3e}")
        if not torch.equal(got, chain(kern)):
            fail(f"wrap GEMM gives other bits on a second call at ({W}, "
                 f"{ns}, {ns})")
    X = fused.wrap_gemm_cuda(eK, G)
    a_fn = lambda: fused.wrap_gemm_cuda(eK, G)
    b_fn = lambda: fused.wrap_gemm_cuda(X, ieK, rv=ev, cv=iev)
    la_fn, lb_fn = lambda: torch.matmul(eK, G), lambda: torch.matmul(X, ieK)
    # CUDA events per call (host launch time included where the host sets
    # the pace) and device time per call (a CUDA graph of the calls); the
    # kernels line keeps the device times
    a_ev, b_ev, la_ev, lb_ev = (cuda_ms(f, 50)
                                for f in (a_fn, b_fn, la_fn, lb_fn))
    a_ms, b_ms, lib_a, lib_b = (device_ms(f, 20)
                                for f in (a_fn, b_fn, la_fn, lb_fn))
    plain_ms = cuda_ms(lambda: fwd(plain), 20) / 2
    ms = (a_ms + b_ms) / 2
    record(report, "fused_wrap", max_abs_err=werr, ms=ms, plain_ms=plain_ms,
           ops=2 * ns ** 3 * W,
           nbytes=4 * (ns * ns + 2 * W * ns * ns + 2 * W * ns),
           library_ms=lib_a, shape=(W, ns, ns), main=main)
    r = report["fused_wrap"]["shapes"][-1]
    say(f"phase 3: wrap GEMM f32 ({W}, {ns}, {ns}) |dG| fwd/bwd {werr:.3e}, "
        f"two calls bit-equal; device time: kernel {a_ms:.4f} ms (expK G, "
        f"A shared), {b_ms:.4f} ms (G invexpK, B shared), torch.matmul "
        f"{lib_a:.4f} / {lib_b:.4f} ms; CUDA events: kernel {a_ev:.4f} / "
        f"{b_ev:.4f} ms, torch.matmul {la_ev:.4f} / {lb_ev:.4f} ms; plain "
        f"{plain_ms:.4f} ms/GEMM; bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")


def _slice_by_slice(fused, args, kw):
    """fused_block through the kernels, where each slice's site loop is also
    run by the plain twin on a copy of the kernel's G, mask and sign just
    before it; returns the mismatched decisions of each slice, in the order
    the block processes them."""
    per = []

    def sites(G, mask, order, gb, delta, us, l, k, sgn=None):
        n = G.shape[-1]
        Gc, mc = G.clone(), mask.clone()
        sc = None if sgn is None else sgn.clone()
        fused.site_loop_plain(Gc, mc, order, gb, delta, us, l, k, sc)
        fused.site_loop_cuda(G, mask, order, gb, delta, us, l, k, sgn)
        sl = slice(l * n, (l + 1) * n)
        per.append(int((mask[:, sl] != mc[:, sl]).sum()))

    prims = SimpleNamespace(gemm=fused.wrap_gemm_cuda, sites=sites,
                            sites_sub=None)
    model, order, props, us, G, fb = args
    fused._block(prims, model, order, props, us, G, fb, kw["n_slices"],
                 kw["forward"], fused._K, "delayed")
    return per


def phase_block(torch, gen, report):
    from dqmc_tpu_torch.engine import fused
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    for W, L, beta, nt, n in BLOCK_SHAPES:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            model, states, order, props, us = block_inputs(
                torch, gen, W, L, beta, nt, n, dtype)
            for forward in (True, False):
                fb = states.fields[:, :n] if forward else states.fields[:, -n:]
                args = (model, order, props, us, states.G, fb)
                kw = dict(n_slices=n, forward=forward)
                got = fused.fused_block(*args, **kw)
                Gk, fk, bk, ak, _ = got
                Gp, fp, bp, ap, _ = fused.fused_block_plain(*args, **kw)
                # the block's kernels (wrap GEMM, site loop) give the same
                # bits on a second call
                if not same_bits(got, fused.fused_block(*args, **kw)):
                    fail(f"K2 {dtype} W={W} ns={ns} gives other bits on a "
                         f"second call")
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
                # half -- more than 1% mismatched is a fault.  The counts of
                # both against the twin in float64 (same upcast inputs) are
                # printed beside it, to show how far f32 rounding alone goes
                rel = dG / float(Gp.abs().max())
                m64 = MODEL_REGISTRY["attractive"].build(
                    square_lattice(L, L), U=4.0, t=1.0, mu=-0.1, beta=beta,
                    nt=nt, dtype=torch.float64, device="cuda")
                _, f64, _, _, _ = fused.fused_block_plain(
                    m64, order, props, us.double(), states.G.double(), fb,
                    **kw)
                ms = cuda_ms(lambda: fused.fused_block(*args, **kw), 5)
                plain_ms = cuda_ms(
                    lambda: fused.fused_block_plain(*args, **kw), 1)
                say(f"{tag}: mismatched decisions {mism} of {fk.numel()} "
                    f"(<= 1%); against the float64 twin: kernel "
                    f"{int((fk != f64).sum())}, float32 twin "
                    f"{int((fp != f64).sum())}; G relative gap {rel:.3e}; "
                    f"block kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
                if mism > 0.01 * fk.numel():
                    fail("K2 f32 decisions disagree with the twin")
                # the same block with every slice's site loop held against
                # the float32 twin's from the kernel's own state before
                # that slice: no divergence carries over from slice to slice
                per = _slice_by_slice(fused, args, kw)
                say(f"{tag}: slice by slice from the kernel's state, "
                    f"mismatched decisions {sum(per)} of {fk.numel()} "
                    f"(<= 1%; by slice as processed: {per})")
                if sum(per) > 0.01 * fk.numel():
                    fail("K2 f32 site loop disagrees with the twin slice by "
                         "slice")
    # per-kernel times and gaps at the headline shape (f32)
    W, L, beta, nt, n = BLOCK_SHAPES[1]
    model, states, order, props, us = block_inputs(
        torch, gen, W, L, beta, nt, n, torch.float32)
    ns = L * L
    G = states.G[:, 0].contiguous()
    ev = torch.rand((W, ns), generator=gen, device="cuda") + 0.5
    check_wrap_gemm(torch, fused, model, G, ev, report, main=True)
    # the other shapes the fused engine runs, on a generator of their own
    # (the inputs of the checks after these do not move)
    own = torch.Generator(device="cuda")
    own.manual_seed(3)
    for C, Lw in WRAP_SHAPES:
        wmodel = MODEL_REGISTRY["attractive"].build(
            square_lattice(Lw, Lw), U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=40,
            dtype=torch.float32, device="cuda")
        Gw = torch.randn((C, Lw * Lw, Lw * Lw), generator=own,
                         device="cuda") * 0.1
        evw = torch.rand((C, Lw * Lw), generator=own, device="cuda") + 0.5
        check_wrap_gemm(torch, fused, wmodel, Gw, evw, report, main=False)
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
            f"mismatched decisions {smis} of {W * ns} (<= 1%), |dG| "
            f"{serr:.3e}; kernel {sms:.3f} ms, twin {spms:.3f} ms")
        if smis > 0.01 * W * ns:
            fail("site-loop kernel f32 decisions disagree with the twin")
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
    # the same configuration at the other seeds of scripts/selfcheck_seeds.py,
    # in worker processes beside this run (the runs are host-bound)
    sys.path.insert(0, str(REPO / "scripts"))
    from selfcheck_seeds import CUT, run_seed
    if CUT != cut:
        fail(f"scripts/selfcheck_seeds.py runs {CUT}, phase 4 {cut}")
    pool = mp.get_context("spawn").Pool(len(SELFCHECK_SEEDS) - 1)
    others = pool.map_async(run_seed, SELFCHECK_SEEDS[1:])
    with pool, tempfile.TemporaryDirectory() as tmp:
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
        rows = others.get(timeout=900)
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
    # one seed's max is one tail event of one chain: the distribution over
    # eight seeds separates two float32 arithmetics better.  Gates: the
    # median of the eight steady maxima < 1e-2 and the largest steady mean
    # < 5e-5 (the parent kernels read 6.14e-3 and 1.862e-5)
    maxima = [summary.max_precision_error] + [r[1] for r in rows]
    means = [summary.mean_precision_error] + [r[2] for r in rows]
    med = statistics.median(maxima)
    say(f"phase 4: seeds {', '.join(map(str, SELFCHECK_SEEDS))}: sorted "
        f"steady self-check maxima "
        f"{', '.join(f'{m:.3e}' for m in sorted(maxima))}; median {med:.3e} "
        f"(< 1e-2), {sum(m >= 1e-2 for m in maxima)} of {len(maxima)} at or "
        f"above 1e-2; largest steady mean {max(means):.3e} (< 5e-5); "
        f"acceptance {', '.join(f'{r[3]:.4f}' for r in rows)}")
    if not (med < 1e-2 and max(means) < 5e-5):
        fail("the steady self-check over eight seeds is above its gates")


def headline_pairs(torch, card, phase, update="delayed"):
    """The bench headline (16x16, beta=8, nt=160, n_stab=5, W=16, float32)
    on the fused engine with the in-slice scheme ``update``: a warm-up
    pair, three timed pairs with the launch counters set to 0 just before
    and read just after, then one pair under torch.profiler."""
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
    cfg = EngineConfig(nt=nt, n_stab=n_stab, fused_update=update)
    sites = "fused_sites_sub" if update == "submatrix" else "fused_sites"
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
    launches = {k: _cuda.LAUNCHES[k] for k in ("cgs2_qr", "fused_wrap",
                                               sites)}
    err = float(states.err_max.max())
    rate = 3 * W / dt
    say(f"{phase}: headline 16x16 beta=8 nt=160 n_stab=5 W=16 f32, "
        f"fused_update = {update}: {rate:.3f} walker-sweep-pairs/s (3 "
        f"pairs, {dt:.2f} s), self-check max {err:.3e}, launches "
        f"{launches} on {card}")
    if not err == err or min(launches.values()) <= 0:
        fail(f"headline sweep pairs ({update})")
    # where a pair's time goes: device time by kernel, idle share
    _profiled(torch, f"headline, fused engine, {update}",
              lambda s: sweep_pair_fused(model, cfg, s), states, 1,
              phase=phase)


def phase_headline(torch, card):
    headline_pairs(torch, card, "phase 5")


# #6's timed shapes (W, L): examples/basic (site_update = scan), the
# headline's view (16, 16 x 16) and the stretch (4, 32 x 32)
RANK1_SHAPES = ((4, 6), (16, 16), (4, 32))
# the parent's device ms per launch (one CTA per walker, G in global
# memory; scripts/seed_split.py rank1 --parts times, PERF.md)
RANK1_PARENT_MS = {(4, 36, "float32"): "0.0920-0.0927",
                   (16, 256, "float32"): "11.555-11.567",
                   (4, 1024, "float32"): "199.98-201.40",
                   (4, 36, "float64"): "0.0922-0.0926",
                   (16, 256, "float64"): "12.113-12.114",
                   (4, 1024, "float64"): "290.32-290.86"}


def time_rank1(torch, gen, tk, report, slice_err):
    """#6 alone at RANK1_SHAPES in both float types (per-walker orders, one
    launch per slice), in device time with the copy of G the call makes,
    beside the parent's time, its plain piece and its bound; kept under
    the entry's ``shapes``, the stretch in float32 as the entry's own."""
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        for W, L in RANK1_SHAPES:
            n = L * L
            G, fields, orders, props, us, g, alpha = slice_inputs(
                torch, gen, W, L, dt)
            order = orders.to(torch.int32).contiguous()
            _, gb, delta = tk.visit_factors(g, alpha, fields, orders, props,
                                            dt)
            acc = torch.empty((W, n), dtype=dt, device="cuda")
            kern, plain, _, ops, nbytes, _ = _per_walker_rows(
                torch, tk.KERNELS, tk.PLAIN, G[:, 0].contiguous(),
                (acc, order, gb.contiguous(), delta.contiguous(), us), W,
                n)["rank1_sites"]
            n_acc = int(acc.sum())
            ms = device_ms(kern, 2 if n > 512 else 20)
            plain_ms = cuda_ms(plain, 1)
            main = (n, dt) == (SITE_SHAPES[-1][1] ** 2, torch.float32)
            f64 = dt == torch.float64
            record(report, "rank1_sites",
                   max_abs_err=slice_err["#6 per-walker"] if main else None,
                   ms=ms, plain_ms=plain_ms, ops=0.0 if f64 else ops,
                   ops_f64=ops if f64 else 0.0, nbytes=nbytes,
                   shape=(W, n, name), main=main)
            b = report["rank1_sites"]["shapes"][-1]
            say(f"phase 6: rank1_sites {name} W={W} ns={n}, one launch: "
                f"kernel {ms:.4f} ms (device time, with a copy of G), "
                f"parent {RANK1_PARENT_MS[(W, n, name)]} ms (PERF.md), "
                f"plain {plain_ms:.3f} ms, {n_acc} of {W * n} accepted, "
                f"bound {b['bound_ms']:.6f} ms ({b['bound_by']})")


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


SITE_CASES = (  # (label, wrapper, shared order, rank keyword, fixed rank)
    ("#3 shared", "metropolis_slice_update_batched", True, "k_delay", None),
    ("#3 per-walker", "metropolis_slice_update_batched", False, "k_delay",
     None),
    # the engine's per-walker scheme at delay_rank = 32: at ns = 36 a group
    # of 32 and a short one of 4 (examples/basic, phase 8)
    ("#3 per-walker k=32", "metropolis_slice_update_batched", False,
     "k_delay", 32),
    ("#5 shared", "metropolis_slice_update_submatrix", True, "k_sub", None),
    ("#5 per-walker", "metropolis_slice_update_submatrix", False, "k_sub",
     None),
    ("#5 per-walker k=32", "metropolis_slice_update_submatrix", False,
     "k_sub", 32),
    ("#6 shared", "metropolis_slice_update", True, None, None),
    ("#6 per-walker", "metropolis_slice_update", False, None, None),
)


def check_site_budget(tk):
    """The host's copy of the site loop's cluster and shared-memory budget
    (ops/kernels.py slice_cluster, delayed_slice_smem) against the
    library's (dqmc_site_cluster, dqmc_site_smem_bytes) at every shape the
    two engines give it: the fused loop (R <= 32, ns <= 512) and the
    delayed slice (R <= 64, ns <= 1024), k <= 32, one or two flavors,
    float32 or float64; the submatrix loop's (submatrix_slice_smem against
    dqmc_sub_smem_bytes, ns <= 512) and #5's CTAs per walker
    (submatrix_group_ctas against dqmc_submatrix_group_ctas, ns <= 4096)."""
    from dqmc_tpu_torch import _cuda
    lib = _cuda.lib()
    shapes, bad = 0, []
    for rmax, top in ((32, 512), (64, tk.MAX_SITES)):
        for ns in range(1, top + 1):
            if lib.dqmc_site_cluster(ns, rmax) != tk.slice_cluster(ns,
                                                                   rmax)[0]:
                bad.append((rmax, ns))
            for k in range(1, tk.KMAX + 1):
                for nfl in (1, 2):
                    for itemsize in (4, 8):
                        shapes += 1
                        if lib.dqmc_site_smem_bytes(
                                ns, k, nfl, itemsize, rmax) != \
                                tk.delayed_slice_smem(ns, itemsize, nfl, k,
                                                      rmax):
                            bad.append((rmax, ns, k, nfl, itemsize))
    # the submatrix loop's cluster (#2c, R <= 32) and #5's group grid
    for ns in range(1, 513):
        for k in range(1, tk.KMAX + 1):
            for itemsize in (4, 8):
                shapes += 1
                if lib.dqmc_sub_smem_bytes(ns, k, itemsize) != \
                        tk.submatrix_slice_smem(ns, itemsize, k):
                    bad.append(("sub", ns, k, itemsize))
    for ns in range(1, 4097):
        shapes += 1
        if lib.dqmc_submatrix_group_ctas(ns) != tk.submatrix_group_ctas(ns):
            bad.append(("group", ns))
    say(f"phase 6: site-loop budget, host copy against the library at "
        f"{shapes} shapes: {len(bad)} disagree {bad[:4]}")
    if bad:
        fail("the host's copy of the site-loop budget disagrees with the "
             "library's")


def phase_sites(torch, gen, report):
    """#3, #5 and #6 against their twins, one slice each."""
    from dqmc_tpu_torch.ops import kernels as tk
    check_site_budget(tk)
    slice_err = {}
    full_groups = 0  # #5 groups with every visit accepted
    for W, L, k in SITE_SHAPES:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            G, fields, orders, props, us, g, alpha = slice_inputs(
                torch, gen, W, L, dtype)
            for label, name, shared, rank_kw, fixed in SITE_CASES:
                if fixed is not None and fixed == k:
                    continue  # the case above at this shape
                fn = getattr(tk, name)
                kw = {}
                if rank_kw:
                    kw = {rank_kw: fixed or k, "exact_rank": not shared}
                args = (g, alpha, orders[0] if shared else orders, props,
                        us, G, fields)
                Gk, fk, ak = fn(*args, **kw)
                Gp, fp, ap = fn(*args, plain=True, **kw)
                torch.cuda.synchronize()
                sub = label.startswith("#5")
                if sub:
                    # the same bits on a second call; the twin rejects
                    # somewhere, and some group accepts every visit
                    if not same_bits((Gk, fk, ak), fn(*args, **kw)):
                        fail(f"{label}: a second call gives other bits")
                    kk = fixed or k
                    old = torch.gather(fields, 1, orders[0].expand(W, ns)
                                       if shared else orders)
                    new = torch.gather(fp, 1, orders[0].expand(W, ns)
                                       if shared else orders)
                    took = (old != new)[:, :ns // kk * kk].view(W, -1, kk)
                    full_groups += int(took.all(dim=2).sum())
                    if bool(took.all()) or int(took.sum()) == 0:
                        fail(f"{label}: the twin's decisions need "
                             f"rejections and acceptances")
                mism = int((fk != fp).sum())
                dacc = int(((ak - ap).abs() * ns).round().sum())
                gap = float((Gk - Gp).abs().max())
                rel = gap / float(Gp.abs().max())
                tag = (f"phase 6: {label} {str(dtype)[6:]} W={W} ns={ns} "
                       f"k={(fixed or k) if rank_kw else 1}")
                accepted = int((ap * ns).round().sum())
                if dtype == torch.float64:
                    # one slice, no propagation: the same decisions, G to
                    # 1e-9 of its largest entry (#5: 1e-12)
                    tol = 1e-12 if sub else 1e-9
                    say(f"{tag}: {accepted} of {W * ns} accepted, "
                        f"mismatched fields {mism}, accept-count gap {dacc}, "
                        f"|dG|/max|G| {rel:.3e} (< {tol:.0e})")
                    if mism or dacc or not rel < tol:
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
    say(f"phase 6: #5 groups with every visit accepted (twin): "
        f"{full_groups}")
    if not full_groups:
        fail("#5: no group accepted every visit, so no check held a full-"
             "rank W")
    time_site_kernels(torch, gen, tk, report, slice_err)


def slice_bound(W, n, k, nfl, itemsize=4):
    """(operations, bytes) of one delayed slice (#3, #4): every group's
    visits (2 n t FLOPs per dot, two dots per visit, t < k) and flush
    (2 k n^2 FLOPs) per walker and flavor; G read once and written once,
    the order, gb, delta and us read and the flags written once."""
    ops, v0 = 0, 0
    while v0 < n:
        cnt = min(k, n - v0)
        ops += 2 * n * cnt * (cnt - 1) + 2 * cnt * n * n
        v0 += cnt
    return (W * nfl * ops,
            itemsize * W * (2 * nfl * n * n + (4 + nfl) * n))


def sub_slice_bound(W, n, k, n_acc, itemsize=4):
    """(operations, bytes) of one slice of the submatrix scheme (#5, #2c)
    by part, per group of cnt visits and walker: the decisions (two k-long
    matrix-vector products per visit, 4 cnt^2 FLOPs, and the bordered
    update of W, 3 cnt^2 per accepted visit, n_acc of them in the slice),
    M = W (G[I, :] - E_I) (2 cnt^2 n) and the flush (2 cnt n^2).  Bytes:
    the decisions and operands read G[I, I], G[:, I] and G[I, :] and write
    Ut and M (cnt^2 + 4 cnt n elements), the slice's order, gb, delta and
    u read and its flags written (5 n); the flushes read and write G once
    per slice (each input read once, each output written once) and read
    every group's Ut and M.  Returns ((ops, bytes) of the decisions and
    operands, (ops, bytes) of the flushes)."""
    dec_ops = dec_el = fl_ops = 0
    fl_el = 2 * n * n
    for v0 in range(0, n, k):
        cnt = min(k, n - v0)
        dec_ops += 4 * cnt ** 3 + 2 * cnt * cnt * n
        dec_el += cnt * cnt + 4 * cnt * n
        fl_ops += 2 * cnt * n * n
        fl_el += 2 * cnt * n
    return ((W * dec_ops + 3 * k * k * n_acc,
             itemsize * W * (dec_el + 5 * n)),
            (W * fl_ops, itemsize * W * fl_el))


def _shared_order_rows(torch, K, P, G3, args, W, n, k):
    """(kernel, plain, library, ops, bytes, scheme) per kernel of #3 (the
    whole slice) and #5 (its group kernel and its flush, every group of a
    slice) on a shared-order slice; the kernel and library times of #3
    and #5 are device times."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import kernels as tk
    acc, order, gb, delta, us = args
    buf = lambda *shape: torch.zeros((W,) + shape, dtype=G3.dtype,
                                     device="cuda")
    Wm, Ut, M = buf(k, k), buf(k, n), buf(k, n)
    Gw, Gs = G3.clone(), G3.clone()
    K.submatrix_slice(Gs, acc, order, gb, delta, us, k)
    n_acc = int(acc.sum())
    groups = [(v0, min(k, n - v0)) for v0 in range(0, n, k)]
    grp = _cuda.lib().dqmc_submatrix_group_f32
    P_ = _cuda.ptr

    def group_kernels():
        for v0, cnt in groups:
            _cuda.call(grp, P_(G3), P_(acc), P_(order), 0, P_(gb),
                       P_(delta), P_(us), P_(Ut), P_(M), n, k, v0, cnt, W,
                       _cuda.stream(G3.device))

    def group_plain():
        for v0, cnt in groups:
            tk.submatrix_decide_plain(G3, Wm, acc.clone(), order, gb, delta,
                                      us, v0, cnt)
            tk.submatrix_prep_plain(G3, Wm, Ut.clone(), M.clone(), order,
                                    v0, cnt)
    (g_ops, g_bytes), (f_ops, f_bytes) = sub_slice_bound(W, n, k, n_acc)
    sl = (acc, order, gb, delta, us, k)
    return {
        "delayed_slice": (
            lambda: K.delayed_slice(Gs, *sl),
            lambda: P.delayed_slice(Gs.clone(), acc.clone(), *sl[1:]), None,
            *slice_bound(W, n, k, 1), "#3 shared"),
        "submatrix_group": (group_kernels, group_plain, None, g_ops, g_bytes,
                            "#5 shared"),
        "submatrix_flush": (
            lambda: [K.submatrix_flush(Gw, Ut, M, cnt) for _, cnt in groups],
            lambda: [P.submatrix_flush(Gw, Ut, M, cnt) for _, cnt in groups],
            lambda: [Gw.baddbmm_(Ut[:, :cnt].mT, M[:, :cnt])
                     for _, cnt in groups], f_ops, f_bytes, "#5 shared"),
    }


def _per_walker_rows(torch, K, P, G3, args, W, n):
    """The same for #6 (a whole slice, each walker its own order): 2 n^2
    operations per accepted visit; G read and written once, the order, gb,
    delta and us read and the flags written once."""
    acc, order, gb, delta, us = args
    K.rank1(G3.clone(), acc, order, gb, delta, us)
    n_acc = int(acc.sum())
    return {"rank1_sites": (
        lambda: K.rank1(G3.clone(), acc, order, gb, delta, us),
        lambda: P.rank1(G3.clone(), acc.clone(), order, gb, delta, us),
        None, 2 * n * n * n_acc,
        G3.element_size() * W * (2 * n * n + 5 * n), "#6 per-walker")}


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
    time_rank1(torch, gen, tk, report, slice_err)
    # device time (a CUDA graph of calls) where one launch is short enough
    # for events around it to time the host
    graphed = {"delayed_slice": 5, "submatrix_group": 3,
               "submatrix_flush": 3}
    for name, (kern, plain, lib, ops, nbytes, scheme) in rows.items():
        reps = graphed.get(name)
        ms = device_ms(kern, reps) if reps else cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 1)
        lib_ms = device_ms(lib, reps) if lib else None
        record(report, name, max_abs_err=slice_err[scheme], ms=ms,
               plain_ms=plain_ms, ops=ops, nbytes=nbytes, library_ms=lib_ms)
        r = report[name]
        say(f"phase 6: {name} f32 W={W} ns={n} k={k}, one slice: kernel "
            f"{ms:.4f} ms{' (device time)' if reps else ''}, plain "
            f"{plain_ms:.3f} ms, "
            + (f"one torch.baddbmm {lib_ms:.4f} ms (device time), " if lib
               else "no single library call, ")
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
n_therms = 0
n_bins = 1
n_sweeps = 1
dtype = float32
seed = 42
[walkers]
n_walkers = 4
"""


def phase_stretch(torch):
    """bench.py's stretch configuration through the entry point: the
    per-slice engine (ns = 1024 > 512), #3 by default, #5 with
    site_update = submatrix and #6 with site_update = scan (then one more
    scan pair profiled); K1 stabilizes all three."""
    site = ("delayed_slice",)
    sub = ("submatrix_group", "submatrix_flush")
    run_params(torch, STRETCH, "stretch 32x32 beta=16 nt=320 n_stab=5 W=4 "
               "f32, engine = auto (per slice, site_update = pallas: #3), "
               "0 + 1 pairs", ("cgs2_qr",) + site, "phase 7")
    run_params(torch, STRETCH + "[simulation]\nsite_update = submatrix\n",
               "stretch, site_update = submatrix (#5), 0 + 1 pairs",
               ("cgs2_qr",) + sub, "phase 7")
    scan = STRETCH + "[simulation]\nsite_update = scan\n"
    run_params(torch, scan, "stretch, site_update = scan (#6), 0 + 1 pairs",
               ("cgs2_qr", "rank1_sites"), "phase 7")
    # device activity alone: the host's records of a stretch pair take
    # about a minute to aggregate
    profile_params(torch, scan, "stretch, site_update = scan (#6)", 0, 1,
                   "phase 7", cpu=False)


def profile_params(torch, text, label, warm, n_pairs, phase, cpu=True):
    """``n_pairs`` per-slice sweep pairs of the float32 attractive model
    of a parameter string, after ``warm`` pairs, under torch.profiler
    (_profiled; ``cpu=False``: device activity alone), printing the device
    busy time per pair."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.state import make_generators
    from dqmc_tpu_torch.engine.sweep import init_state, sweep_pair
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    from dqmc_tpu_torch.run import make_engine_config
    dev = torch.device("cuda")
    params = Parameters.from_string(text)
    lat = square_lattice(params.get_int("Lattice", "L1"),
                         params.get_int("Lattice", "L2"))
    model = MODEL_REGISTRY["attractive"].from_params(
        params, lat, dtype=torch.float32, device=dev)
    cfg = make_engine_config(params, dev,
                             params.get_int("simulation", "n_stab"))
    states = init_state(model, cfg, make_generators(
        params.get_int("simulation", "seed", 42),
        params.get_int("walkers", "n_walkers"), dev))
    for _ in range(warm):
        states = sweep_pair(model, cfg, states)
    busy, wall = _profiled(torch, label, lambda s: sweep_pair(model, cfg, s),
                           states, n_pairs, phase, cpu=cpu)
    say(f"{phase}: {label}: device busy {busy / n_pairs:.4f} s per pair, "
        f"wall {wall / n_pairs:.4f} s per pair (profiled)")


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
    profile_params(torch, text + cut + "site_update = scan\n",
                   "examples/basic, site_update = scan (#6)", 2, 5,
                   "phase 8")
    run_params(torch, text + cut + "site_update = delayed\n",
               "examples/basic, engine = slice, site_update = delayed "
               "(#3, per-walker order, k=32), n_stab=5, 20 + 2x10 pairs",
               ("delayed_slice", "cgs2_qr"), "phase 8")


def _profiled(torch, label, step, states, n_pairs, phase="phase 9",
              cpu=True, unit="sweep pair(s)"):
    """``n_pairs`` sweep pairs under torch.profiler: device time by kernel
    and the device's idle share of their wall time.  ``cpu=False`` records
    the device's activity alone (a df32 pair launches ~10^6 operations, and
    the host's records would take minutes to aggregate)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
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
    say(f"{phase}: {label}, {n_pairs} profiled {unit}: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1.0 - busy / wall:.4f}, {sum(e.count for e in rows)} device "
        f"operations")
    for e in rows[:8]:
        say(f"{phase}:   {e.key[:60]:60s} {dev(e) / 1e3:10.1f} ms "
            f"({dev(e) / 1e6 / busy:6.1%}) {e.count} calls")
    return busy, wall


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
              lambda s: sweep_pair(model, cfg, s), states, 1, cpu=False)
    params = Parameters.from_string(REPULSIVE)
    model = MODEL_REGISTRY["repulsive"].from_params(
        params, square_lattice(8, 8), dtype=torch.float32, device=dev)
    cfg = make_engine_config(params, dev, 5)
    for label, step in (("fused (#2b)", sweep_pair_fused),
                        ("per slice (#4)", sweep_pair)):
        states = init_state(model, cfg, make_generators(42, 32, dev))
        states = step(model, cfg, states)              # warm-up pair
        _profiled(torch, f"repulsive preset, {label}",
                  lambda s: step(model, cfg, s), states, 3, cpu=False)


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
    # the shapes of SITE_SHAPES_2F with one shared order at JAX's rank, then
    # examples/basic's per-walker scheme at delay_rank = 32 (groups of 32 +
    # 4)
    for W, L, k, shared in [s + (True,) for s in SITE_SHAPES_2F] + [
            (4, 6, 32, False)]:
        ns = L * L
        for dtype in (torch.float64, torch.float32):
            model = RepulsiveHubbard.build(
                square_lattice(L, L), U=4.0, t=1.0, mu=0.0, beta=1.0, nt=20,
                dtype=dtype, device="cuda")
            states = init_state(model, EngineConfig(nt=20, n_stab=5),
                                make_generators(5, W, "cuda"))
            order = torch.argsort(torch.rand((ns,) if shared else (W, ns),
                                             generator=gen, device="cuda"),
                                  dim=-1)
            props = torch.randint(0, 3, (W, ns), generator=gen,
                                  device="cuda")
            us = torch.rand((W, ns), generator=gen, device="cuda",
                            dtype=dtype)
            args = (model.g.expand(W), model.alpha.expand(W), order, props,
                    us, states.G, states.fields[:, 0])
            err = compare(f"phase 10: #4 {str(dtype)[6:]} W={W} ns={ns} "
                          f"k={k} mu=0"
                          + ("" if shared else " per-walker order"), args,
                          dict(k_delay=k, exact_rank=not shared), dtype)
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

    # one whole slice at the stretch shape, f32, both flavors
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
    acc = torch.empty((W, n), dtype=dt, device="cuda")
    sgn = torch.ones((W,), dtype=dt, device="cuda")
    sl = (acc, order, gb, delta, us, k, sgn)
    K, P = tk.KERNELS, tk.PLAIN
    ms = device_ms(lambda: K.delayed_slice(G, *sl), 5)
    plain_ms = cuda_ms(lambda: P.delayed_slice(G.clone(), acc.clone(),
                                               *sl[1:-1], sgn.clone()), 1)
    ops, nbytes = slice_bound(W, n, k, 2)
    record(report, "delayed_slice_2f", max_abs_err=slice_err, ms=ms,
           plain_ms=plain_ms, ops=ops, nbytes=nbytes)
    r = report["delayed_slice_2f"]
    say(f"phase 10: delayed_slice_2f f32 W={W} ns={n} k={k}, one slice: "
        f"kernel {ms:.4f} ms (device time), plain {plain_ms:.3f} ms, no "
        f"single library call, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")


# W, L, beta, nt, n_slices of the fused 2-flavor and submatrix checks
# (#2b: the repulsive preset's block, then the headline shape)
BLOCK_SHAPES_2F = ((32, 8, 4.0, 80, 5), (16, 16, 8.0, 160, 5))
# the largest shape of the 2-flavor site loop: ns = 512 on a 16 x 32 lattice
SITES_2F_LARGEST = (4, (16, 32), 4.0, 40, 1)
BLOCK_SHAPES_SUB = ((4, 6, 4.0, 40, 5), (16, 16, 8.0, 160, 5))
# #2c's largest shapes, float64 only (the one-CTA loop refused float64 from
# ns = 448): 22 x 22 (k = 4) and 16 x 32 (ns = 512)
BLOCK_SHAPES_SUB_F64 = ((16, 22, 4.0, 40, 5), (16, (16, 32), 4.0, 40, 5))
# #2c on one CTA per walker (ns <= 32: 32 threads, whose one warp both
# decides and loads the flush operands): W, L, beta, nt, n_slices, the
# ranks, the float types; 4 x 4 is tests/test_torch_cuda.py's input
BLOCK_CASES_SUB_ONE_CTA = ((2, 4, 3.0, 12, 3, (4, 16), ("float64",)),
                           (4, 5, 4.0, 40, 5, (5, 25),
                            ("float64", "float32")))


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
                f32_walkers=0.0, exact=None, g_tol=1e-6, g_host=None):
    """fused_block (kernels) against fused_block_plain on the card, at
    phase 3's tolerances; returns the G gap.  In float32 at most 1% of the
    decisions may differ, or (doped inputs) the decisions of a share
    ``f32_walkers`` of the walkers, and no walker's in the first half of
    the block's slices.  ``exact`` is the float64 twin's decisions on the
    same inputs: how far float32 rounding alone takes the float32 twin from
    them is printed beside the kernel's gap.  ``g_tol``: the float64 G
    tolerance.  ``g_host``: the float64 twin's G computed on the CPU; then
    G is held to the nearer of the two twins, within g_tol or, where the
    twins lie farther apart, within twice their spread (three results of
    equal accuracy, the kernel's with its own summation order), and the
    spread itself to 1e-7 of max|G|."""
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
        near, tol, spread_ok, twins = dG, g_tol, True, ""
        if g_host is not None:
            spread = float((Gp.cpu() - g_host).abs().max())
            gmax = float(Gp.abs().max())
            near = min(dG, float((Gk.cpu() - g_host).abs().max()))
            tol = max(g_tol, 2 * spread)
            spread_ok = spread <= 1e-7 * gmax
            twins = (f"; the twin on the CPU against the twin on the card "
                     f"|dG| {spread:.3e} (<= 1e-7 max|G| = {1e-7 * gmax:.3e})"
                     f", the kernel to the nearer twin {near:.3e}")
        say(f"{tag}: mismatched decisions {mism}, signs {smis}, {flips} "
            f"walkers flipped, |dG| {dG:.3e}{twins} (< {tol:.3e}), |dBbar| "
            f"{dB:.3e} (< 1e-11)")
        if mism or smis or not (near < tol and dB < 1e-11 and spread_ok):
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
    # preset's, the headline's and the largest shape (ns = 512), timed in
    # float32 at the headline shape
    site_err = 0.0
    for dtype, shape in ((torch.float64, BLOCK_SHAPES_2F[0]),
                         (torch.float64, BLOCK_SHAPES_2F[1]),
                         (torch.float64, SITES_2F_LARGEST),
                         (torch.float32, BLOCK_SHAPES_2F[1])):
        W, L, beta, nt, n = shape
        ns = L[0] * L[1] if isinstance(L, tuple) else L * L
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
            # the twin on the CPU against the twin on the card: how far a
            # change of summation order alone moves G on these inputs.  The
            # kernel is held to 1e-9, or to that spread where it is wider
            # (the headline shape: accepted moves with small ratios leave
            # max|G| ~ 3e4 after the slice)
            Gh, mh = G0.cpu(), torch.zeros((W, n * ns), dtype=dtype)
            fused.site_loop_plain(Gh, mh, o32.cpu(), gb.cpu(), delta.cpu(),
                                  u_.cpu(), 0, k,
                                  torch.ones((W,), dtype=dtype))
            spread = float((Gh - Gq.cpu()).abs().max())
            tol = max(1e-9, spread)
            say(f"phase 10: 2-flavor site loop f64 W={W} ns={ns} k={k} one "
                f"slice: mismatched decisions and signs {smis}, |dG| "
                f"{serr:.3e} (< {tol:.3e}), max|G| "
                f"{float(Gq.abs().max()):.3e}; the twin on the CPU against "
                f"the twin on the card: mismatched decisions "
                f"{int((mh != m2.cpu()).sum())}, |dG| {spread:.3e}")
            if smis or int((mh != m2.cpu()).sum()) or not serr < tol:
                fail("2-flavor site-loop kernel disagrees with its twin")
            site_err = max(site_err, serr)
            continue
        sms = cuda_ms(lambda: run_sites(fused.site_loop_cuda), 10)
        spms = cuda_ms(lambda: run_sites(fused.site_loop_plain), 1)
    record(report, "fused_sites_2f", max_abs_err=site_err, ms=sms,
           plain_ms=spms,
           ops=2 * W * (ns // k * 2 * ns * k * (k - 1) + 2 * ns ** 3),
           nbytes=4 * W * (4 * ns * ns + 6 * ns))
    r = report["fused_sites_2f"]
    say(f"phase 10: 2-flavor site loop f32 W={W} ns={ns} k={k} one slice: "
        f"mismatched decisions and signs {smis} of {W * ns} (<= 1%), |dG| "
        f"{serr:.3e}; kernel {sms:.3f} ms, twin {spms:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); no single library call")
    if smis > 0.01 * W * ns:
        fail("2-flavor site-loop kernel f32 decisions disagree with the twin")


def phase_submatrix_block(torch, gen, report):
    """#2c: the fused block's submatrix scheme, forward and backward."""
    from dqmc_tpu_torch.engine import fused
    cases = [(shape, dtype) for shape in BLOCK_SHAPES_SUB
             for dtype in (torch.float64, torch.float32)]
    cases += [(shape, torch.float64) for shape in BLOCK_SHAPES_SUB_F64]
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    for (W, L, beta, nt, n), dtype in cases:
        ns = L[0] * L[1] if isinstance(L, tuple) else L * L
        model, states, order, props, us = block_inputs(
            torch, gen, W, L, beta, nt, n, dtype)
        for forward in (True, False):
            fb = states.fields[:, :n] if forward else states.fields[:, -n:]
            args = (model, order, props, us, states.G, fb)
            kw = dict(n_slices=n, forward=forward, update="submatrix")
            tag = (f"phase 10: #2c {str(dtype)[6:]} W={W} ns={ns} "
                   f"n_slices={n} k={fused._k_delay(ns)} "
                   f"{'fwd' if forward else 'bwd'}")
            g_host = None
            if ns > 256 and dtype == torch.float64:
                # the largest shapes: a change of summation order alone
                # moves G after five slices of wraps by ~1e-6 at ns = 512
                # (the twin on the CPU against the twin on the card: 6.8e-7
                # backward), so G is held to the nearer of the two twins
                # within twice their spread (the site loop is held to
                # 1e-12 of max|G| below)
                L1, L2 = L if isinstance(L, tuple) else (L, L)
                host = AttractiveHubbard.build(
                    square_lattice(L1, L2), U=4.0, t=1.0, mu=-0.1,
                    beta=beta, nt=nt, dtype=dtype, device="cpu")
                g_host = fused.fused_block_plain(
                    host, order.cpu(), props.cpu(), us.cpu(),
                    states.G.cpu(), fb.cpu(), **kw)[0]
            _hold_block(torch, fused, tag, args, kw, dtype, g_host=g_host)
    site_err = 0.0
    for (W, L, beta, nt, n), dtype in (
            [(BLOCK_SHAPES_SUB[1], torch.float64)]
            + [(shape, torch.float64) for shape in BLOCK_SHAPES_SUB_F64]
            + [(BLOCK_SHAPES_SUB[1], torch.float32)]):
        ns = L[0] * L[1] if isinstance(L, tuple) else L * L
        k = fused._k_delay(ns)
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
        if not same_bits((Gs, m1), run_sites(fused.site_loop_sub_cuda)):
            fail("submatrix site loop: a second call gives other bits")
        torch.cuda.synchronize()
        serr = float((Gs - Gq).abs().max())
        smis = int((m1 != m2).sum())
        n_acc = int(m2[:, :ns].sum())
        if dtype == torch.float64:
            # the twin on the CPU against the twin on the card: how far a
            # change of summation order alone moves G on these inputs.  The
            # kernel is held to 1e-9 and to 1e-12 of max|G| from the twin,
            # or, where the two twins are farther apart than that (accepted
            # moves with small ratios leave max|G| ~1e3 here), to lie no
            # farther from the nearer twin than the twins lie apart, and
            # never farther than 1e-11 of max|G|
            Gh, mh = G0.cpu(), torch.zeros((W, n * ns), dtype=dtype)
            fused.site_loop_sub_plain(Gh, mh, o32.cpu(), gb.cpu(),
                                      delta.cpu(), u_.cpu(), 0, k)
            gmax = float(Gq.abs().max())
            spread = float((Gh - Gq.cpu()).abs().max())
            near = min(serr, float((Gs.cpu() - Gh).abs().max()))
            tol = max(1e-9, spread)
            rtol = min(max(1e-12, spread / gmax), 1e-11)
            if tol == 1e-9 and rtol == 1e-12:
                # the twins agree: the card's twin is the yardstick
                near = serr
            say(f"phase 10: submatrix site loop f64 W={W} ns={ns} k={k} one "
                f"slice ({n_acc} of {W * ns} accepted): mismatched decisions "
                f"{smis}, |dG| {serr:.3e} and to the nearer twin {near:.3e} "
                f"(<= {tol:.3e}), |dG|/max|G| {serr / gmax:.3e} and "
                f"{near / gmax:.3e} (<= {rtol:.3e}), max|G| {gmax:.3e}; the "
                f"twin on the CPU against the twin on the card: mismatched "
                f"decisions {int((mh != m2.cpu()).sum())}, |dG| {spread:.3e}")
            if smis or int((mh != m2.cpu()).sum()) or not (
                    near <= tol and near / gmax <= rtol):
                fail("submatrix site-loop kernel disagrees with its twin")
            if ns == BLOCK_SHAPES_SUB[1][1] ** 2:
                site_err = serr
            continue
        sms = device_ms(lambda: run_sites(fused.site_loop_sub_cuda), 5)
        spms = cuda_ms(lambda: run_sites(fused.site_loop_sub_plain), 1)
    # one slice: the decisions, M and the flush of every group; G read
    # and written once, the slice's streams read and its mask written
    (d_ops, _), (f_ops, _) = sub_slice_bound(W, ns, k, n_acc)
    record(report, "fused_sites_sub", max_abs_err=site_err, ms=sms,
           plain_ms=spms, ops=d_ops + f_ops,
           nbytes=4 * W * (2 * ns * ns + 5 * ns))
    r = report["fused_sites_sub"]
    say(f"phase 10: submatrix site loop f32 W={W} ns={ns} k={k} one slice "
        f"({n_acc} accepted): mismatched {smis} (<= 1%), |dG| {serr:.3e}; "
        f"kernel {sms:.4f} ms (device time), twin {spms:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); no single library call")
    if smis > 0.01 * W * ns:
        fail("submatrix site-loop kernel f32 decisions disagree with the "
             "twin")
    # one CTA per walker, on a generator of its own (the checks above keep
    # their inputs)
    g1 = torch.Generator(device="cuda")
    g1.manual_seed(16)
    for W, L, beta, nt, n, ranks, dtypes in BLOCK_CASES_SUB_ONE_CTA:
        for dtype in (getattr(torch, x) for x in dtypes):
            model, states, order, props, us = block_inputs(
                torch, g1, W, L, beta, nt, n, dtype)
            for k in ranks:
                for forward in (True, False):
                    fb = (states.fields[:, :n] if forward
                          else states.fields[:, -n:])
                    args = (model, order, props, us, states.G, fb)
                    kw = dict(n_slices=n, forward=forward, k_delay=k,
                              update="submatrix")
                    tag = (f"phase 10: #2c {str(dtype)[6:]} W={W} "
                           f"ns={L * L} n_slices={n} k={k} one CTA per "
                           f"walker {'fwd' if forward else 'bwd'}")
                    # tests/test_torch_cuda.py's tolerances for G
                    _hold_block(torch, fused, tag, args, kw, dtype,
                                g_tol=3e-8 if forward else 2e-6)


# the fused site loops alone: W, ns, flavors, submatrix, float type
LOOP_CASES = ((16, 256, 1, False, "float32"), (16, 256, 2, False, "float32"),
              (1, 256, 2, False, "float32"), (16, 256, 1, True, "float32"),
              (32, 64, 1, False, "float32"), (32, 64, 2, False, "float32"),
              (16, 448, 2, False, "float32"), (16, 224, 1, False, "float64"),
              (16, 224, 2, False, "float64"), (16, 512, 2, False, "float32"),
              (16, 256, 2, False, "float64"))


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
    slice_need = ("cgs2_qr", "delayed_slice_2f")
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
    # the doped run in float32 (engine = auto), then once in float64 on
    # the fused engine (#2b f64; auto takes it in float32 only), whose
    # steady self-check is held to the float64 err_warn of 1e-6: the
    # float32 run's self-check is printed, not gated
    doped = (REPULSIVE + "[hubbard]\nU = 6.0\nmu = -0.8\n[simulation]\n"
             "n_therms = 10\nn_bins = 5\nn_sweeps = 4\n")
    seen = {}
    # (the float64 engine factors with torch's Householder QR, not K1)
    for dtype, engine, need in (("float32", "auto", fused_need),
                                ("float64", "fused", fused_need[1:])):
        summary = run_params(
            torch, doped + f"dtype = {dtype}\nengine = {engine}\n",
            f"repulsive doped U=6 mu=-0.8 {dtype}, engine = {engine} "
            f"(fused: #2b{' + K1' if need == fused_need else ''}), 10 + "
            f"5x4 pairs", need, "phase 11")
        signs = summary.walker_signs
        if not set(signs) <= {1.0, -1.0}:
            fail(f"doped run: a walker's sign is not +-1: "
                 f"{sorted(set(signs))}")
        obs = summary.observables
        seen[dtype] = obs
        say(f"phase 11: doped run {dtype}: mean sign over bins "
            f"{obs['sign']:.4f}, {sum(s < 0 for s in signs)} of "
            f"{len(signs)} walkers end at -1"
            + ("" if obs["sign"] < 1.0 or min(signs) < 0 else
               " (no flip seen)")
            + f", density {obs['density']:.5f}, doubleOcc "
            f"{obs['doubleOcc']:.5f}, steady self-check max "
            f"{summary.max_precision_error:.3e}"
            + (" (< 1e-6)" if dtype == "float64" else " (not gated)"))
        if dtype == "float64" and not summary.max_precision_error < 1e-6:
            fail("doped float64 run: steady self-check above 1e-6")
    say("phase 11: doped, float32 against float64: "
        + ", ".join(f"{key} {seen['float32'][key]:.5f} / "
                    f"{seen['float64'][key]:.5f}"
                    for key in ("sign", "density", "doubleOcc")))


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
    # where a pair's time goes: device time by kernel, idle share
    _profiled(torch, "repulsive headline, fused engine",
              lambda s: sweep_pair_fused(model, cfg, s), states, 1,
              phase="phase 12")


def phase_fused_submatrix(torch, card):
    """examples/basic on the fused engine with fused_update = submatrix
    (#2c), phase 4's n_stab = 2, 20 + 4x20 pairs; then the headline with
    fused_update = submatrix, as phase 5 runs it."""
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
    headline_pairs(torch, card, "phase 13", "submatrix")


# #7 and #8 against their twins: the multiword engines' and tiers' panel
# shape at the headline (B = 16 walkers, n = 256), examples' n = 64 and the
# kernels' largest n = 512 (tf32's shared-memory ceiling), each timed; the
# bit checks add the smallest n = 32 and the rare branches (panel_cases)
PANEL_SHAPES = ((16, 256), (16, 64), (4, 512))
PANEL_CHECK_SHAPES = PANEL_SHAPES + ((4, 32),)
# float32 operations per element per column of one panel, from the kernel's
# loops: four digit extractions (NP x (4 + one multiword subtraction)), two
# updates (NP-term recombination + subtraction) and the normalization; the
# multiword add costs 20 (df32) / 45 (tf32) float32 operations, the multiply
# 26 / 80
_MW_ADD = {2: 20, 3: 45}
_MW_MUL = {2: 26, 3: 80}


def panel_inputs(torch, gen, nm, B, n):
    """A graded multiword panel (B, 32, n): rows = columns of A scaled over
    e^+-6, words split from float64."""
    dev = gen.device
    base = torch.randn((B, 32, n), generator=gen, device=dev,
                       dtype=torch.float64)
    grade = torch.exp((torch.rand((B, 32, 1), generator=gen, device=dev,
                                  dtype=torch.float64) - 0.5) * 12.0)
    return nm.from_f64(base * grade)


def panel_cases(torch, gen, nm):
    """(label, P) of every panel #7 and #8 are held on: a graded panel at
    each of PANEL_CHECK_SHAPES; one with exactly zero rows 0 and 9 (the
    zero-norm branch); and one that takes the saturated first digits (the
    carry planes) of y, q and e.  There row 0 is the unit vector e_0, so
    q_0 = e_0 exactly; row 1 is alpha e_0 plus a part on lanes 1 .. n/2-1
    with alpha = 2 - 2^-8, so its first pass reads y_0 / s_y = 1 - 2^-9
    (first y digit 128) and e_0 = alpha (first e digit 128); row 2 is
    (1 - 2^-9) e_{n/2} plus a part below 2^-9 on lanes n/2+1 .. n-1,
    orthogonal to rows 0 and 1 exactly, so its y and its q = y / |y|
    (q_{n/2} > 1 - 2^-8) take a first digit of 128.  The other rows are
    graded."""
    cases = [(f"graded ({B}, 32, {n})", panel_inputs(torch, gen, nm, B, n))
             for B, n in PANEL_CHECK_SHAPES]
    dev = gen.device
    zero = nm.to_f64(panel_inputs(torch, gen, nm, 4, 64))
    zero[:, [0, 9]] = 0.0
    cases.append(("zero rows 0, 9 (4, 32, 64)", nm.from_f64(zero)))
    B, n, h = 4, 128, 64
    P = nm.to_f64(panel_inputs(torch, gen, nm, B, n))
    u = lambda *s: torch.rand(s, generator=gen, device=dev,
                              dtype=torch.float64) - 0.5
    P[:, :3] = 0.0
    P[:, 0, 0] = 1.0
    P[:, 1, 0] = 2.0 - 2.0 ** -8
    P[:, 1, 1:h] = u(B, h - 1)
    P[:, 2, h] = 1.0 - 2.0 ** -9
    P[:, 2, h + 1:] = u(B, n - h - 1) * 2.0 ** -9
    cases.append((f"carries of y, q, e ({B}, 32, {n})", nm.from_f64(P)))
    return cases


def first_digit_max(V, nm):
    """The largest first digit of the rows of V (B, 32, n) as the kernels
    split them (each row scaled by its own max-abs hi word)."""
    from dqmc_tpu_torch.ops import df_qr_kernel as dk
    planes, _ = dk._extract_planes(V, nm, 1)
    return int(planes[0].max())


def phase_mw_panels(torch, gen, report):
    """#7 and #8 against their plain twins on the card, bit for bit, on
    every panel of panel_cases; each timed at PANEL_SHAPES in device time
    beside its twin, its bound and torch.linalg.qr in float64 of the same
    panel (and of the whole (16, 256, 256) matrix, printed)."""
    from dqmc_tpu_torch.ops import df_qr_kernel as dk, df32, tf32
    for name, nm, words in (("df_qr_panel", df32, 2),
                            ("tf_qr_panel", tf32, 3)):
        npl = nm.N_PLANES
        tag = f"#{7 if words == 2 else 8} {name}"
        for label, P in panel_cases(torch, gen, nm):
            Qk, Rk = dk.panel_cuda(P, words)
            Qp, Rp = dk.panel_plain(P, nm)
            torch.cuda.synchronize()
            diff = sum(int((a != b).sum()) for a, b in
                       zip(tuple(Qk) + tuple(Rk), tuple(Qp) + tuple(Rp)))
            gap = max(float((nm.to_f64(a) - nm.to_f64(b)).abs().max())
                      for a, b in ((Qk, Qp), (Rk, Rp)))
            # orthonormality of the multiword Q rows, in float64
            q64 = nm.to_f64(Qk)
            eye = torch.eye(32, dtype=torch.float64, device="cuda")
            if label.startswith("zero"):
                eye[[0, 9], [0, 9]] = 0.0
            orth = float((q64 @ q64.mT - eye).abs().max())
            say(f"phase 14: {tag} {label}: words differing from the twin "
                f"{diff} (bit for bit: 0), max |d| {gap:.3e}, |Q Q^T - I| "
                f"{orth:.3e}")
            if diff:
                fail(f"{name} disagrees with its plain twin on {label}")
            if label.startswith("carries"):
                dq = first_digit_max(Qk, nm)
                dy = first_digit_max(P, nm)
                say(f"phase 14: {tag} {label}: largest first digit of the "
                    f"rows of P {dy}, of Q {dq} (both 128)")
                if dq != 128 or dy != 128:
                    fail(f"{name}: the carry panel took no carry")
        for B, n in PANEL_SHAPES:
            P = panel_inputs(torch, gen, nm, B, n)
            ms = device_ms(lambda: dk.panel_cuda(P, words), 10)
            if (B, n) != PANEL_SHAPES[0]:
                say(f"phase 14: {name} ({B}, 32, {n}): kernel {ms:.4f} ms "
                    f"per panel (device time)")
                continue
            Qk, Rk = dk.panel_cuda(P, words)
            Qp, Rp = dk.panel_plain(P, nm)
            gap = max(float((nm.to_f64(a) - nm.to_f64(b)).abs().max())
                      for a, b in ((Qk, Qp), (Rk, Rp)))
            plain_ms = cuda_ms(lambda: dk.panel_plain(P, nm), 1)
            A64 = nm.to_f64(P).mT.contiguous()
            lib_ms = cuda_ms(lambda: torch.linalg.qr(A64), 5)
            full = torch.randn((B, n, n), generator=gen, device="cuda",
                               dtype=torch.float64)
            full_ms = cuda_ms(lambda: torch.linalg.qr(full), 3)
            pairs = npl * npl + npl * (npl + 1) // 2
            ops_int8 = 2 * B * n * (2 * 496 * pairs
                                    + 32 * npl * (npl + 1) // 2)
            per_elem = (4 * npl * (4 + _MW_ADD[words])
                        + 2 * (npl * (2 + _MW_ADD[words]) + words
                               + _MW_ADD[words]) + _MW_MUL[words])
            record(report, name, max_abs_err=gap, ms=ms, plain_ms=plain_ms,
                   ops=B * 32 * n * per_elem, ops_int8=ops_int8,
                   nbytes=4 * words * B * (2 * 32 * n + 32 * 32),
                   library_ms=lib_ms)
            r = report[name]
            say(f"phase 14: {name} ({B}, 32, {n}): kernel {ms:.4f} ms per "
                f"panel (device time), twin {plain_ms:.1f} ms, "
                f"torch.linalg.qr float64 of the panel {lib_ms:.3f} ms (of "
                f"the whole ({B}, {n}, {n}): {full_ms:.3f} ms), bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']})")


HEADLINE_DF32 = """
[Lattice]
L1 = 16
L2 = 16
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 8.0
nt = 160
n_stab = 5
n_therms = 1
n_bins = 1
n_sweeps = 1
dtype = df32
seed = 42
[walkers]
n_walkers = 16
"""


def _f64_rebuild(torch, params, fields, symmetric=False):
    """G(0, 0) of the fields (W, nt, ns) from the native float64 chain at
    n_stab = 1 (the most stabilizations), half-warped when asked."""
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.engine.sweep import (half_warp,
                                             rebuild_stack_and_greens)
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    L = params.get_int("Lattice", "L1")
    model = AttractiveHubbard.from_params(params, square_lattice(L, L),
                                          dtype=torch.float64, device="cuda")
    cfg = EngineConfig(nt=params.get_int("simulation", "nt"), n_stab=1)
    _, G, _ = rebuild_stack_and_greens(model, cfg, fields)
    return (half_warp(model, G) if symmetric else G), model


def phase_df32_headline(torch):
    """bench.py's df32 companion of the headline (16x16, beta=8, nt=160,
    n_stab=5, W=16, dtype = df32) through run_simulation: #3 site updates,
    K1 in the refined solves, #7 in every fold; 1 + 1 pairs.  G_df of the
    final fields against the native float64 rebuild; two blocks
    profiled."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.ops import df32
    summary = run_params(
        torch, HEADLINE_DF32, "df32 headline 16x16 beta=8 nt=160 n_stab=5 "
        "W=16, dtype = df32, 1 + 1 pairs",
        ("df_qr_panel", "cgs2_qr", "delayed_slice"),
        "phase 15")
    G64, _ = _f64_rebuild(torch, Parameters.from_string(HEADLINE_DF32),
                          summary.states.fields)
    gap = float((df32.to_f64(summary.states.G_df) - G64).abs().max())
    say(f"phase 15: df32 headline: walker-sweep-pairs/s "
        f"{summary.sweeps_per_sec:.4f}, acceptance {summary.acc_rate:.4f}, "
        f"steady self-check max {summary.max_precision_error:.3e} (the "
        f"float32 drift between stabilizations), max |G_df - G_f64| of the "
        f"final fields {gap:.3e} (< 1e-7)")
    if not gap < 1e-7:
        fail("df32 headline: G_df disagrees with the float64 rebuild")
    # where a df32 pair's time goes, per block (every kernel is warm from
    # the run): a forward sweep of two blocks of 5 slices at the headline's
    # width and dtau (beta = 0.5, nt = 10), device activity only -- a whole
    # headline sweep is ~10^6 device operations, whose records take
    # minutes to aggregate
    from dqmc_tpu_torch.engine.df_sweep import (df_aux_build, df_sweep,
                                                init_state_df)
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    params = Parameters.from_string(HEADLINE_DF32 + "[simulation]\n"
                                    "beta = 0.5\nnt = 10\n")
    lat = square_lattice(16, 16)
    model = AttractiveHubbard.from_params(params, lat, dtype=torch.float32,
                                          device="cuda")
    aux = df_aux_build(lat, U=4.0, t=1.0, mu=0.0, beta=0.5, nt=10,
                       device="cuda")
    cfg = EngineConfig(nt=10, n_stab=5, use_pallas=True)
    states = init_state_df(model, aux, cfg, make_generators(42, 16, "cuda"))
    _profiled(torch, "df32, headline width and dtau",
              lambda s: df_sweep(model, aux, cfg, s, forward=True), states,
              1, phase="phase 15", cpu=False,
              unit="forward sweep of 2 blocks (1/32 of a headline pair)")


class TauLaunches:
    """The kernel launches made inside a run's unequal-time sweeps: wraps
    dqmc_tpu_torch.run's sweep_unequal_time and the steps its
    measurement_uneq_fn builds, adding each call's launches to
    ``counts``."""

    def __enter__(self):
        from dqmc_tpu_torch import _cuda, run
        self.counts = Counter()
        self._run = run
        self._saved = (run.sweep_unequal_time, run.measurement_uneq_fn)

        def counted(fn):
            def call(*args, **kw):
                before = Counter(_cuda.LAUNCHES)
                try:
                    return fn(*args, **kw)
                finally:
                    self.counts.update(Counter(_cuda.LAUNCHES) - before)
            return call

        def uneq_fn(*args, **kw):
            step = self._saved[1](*args, **kw)
            wrapped = counted(step)
            wrapped.n_stab = step.n_stab
            return wrapped

        run.sweep_unequal_time = counted(self._saved[0])
        run.measurement_uneq_fn = uneq_fn
        return self

    def __exit__(self, *exc):
        self._run.sweep_unequal_time, self._run.measurement_uneq_fn = \
            self._saved


def run_tau(torch, text, label, need, tau_need, phase):
    """run_params with the launches inside the tau sweeps counted: every
    kernel in ``tau_need`` must have launched there."""
    with TauLaunches() as tau:
        summary = run_params(torch, text, label, need, phase)
    say(f"{phase}: {label}: launches inside the tau sweeps "
        f"{dict(tau.counts)}, tau self-check max (err_uneq_max) "
        f"{summary.err_uneq_max:.3e}")
    missing = [k for k in tau_need if not tau.counts[k]]
    if missing:
        fail(f"{label}: not launched inside the tau sweep: {missing}")
    return summary


def f64_states(torch, params, fields, n_stab, device="cuda"):
    """The float64 model of a parameter set, and WalkerStates of the fields
    (W, nt, ns) as a rebuild at ``n_stab`` leaves them (the suffix stack
    and G(0, 0) the tau sweep starts from)."""
    from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
    from dqmc_tpu_torch.engine.sweep import rebuild_stack_and_greens
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    model = MODEL_REGISTRY[params.get_str("hubbard", "model",
                                          "attractive")].from_params(
        params, make_lattice_of(params), dtype=torch.float64, device=device)
    cfg = EngineConfig(nt=params.get_int("simulation", "nt"), n_stab=n_stab)
    stack, G, log_det = rebuild_stack_and_greens(model, cfg, fields)
    z = torch.zeros(fields.shape[0], dtype=torch.float64, device=device)
    return model, cfg, WalkerState(
        fields=fields, G=G, stack=stack, log_det_M=log_det, gens=[],
        acc_sum=z, sign=z + 1.0, err_max=z, err_sum=z, err_count=z)


def tau_gap(torch, ref, order=None):
    """A tau sweep's measure_fn that holds each emitted batch of taus
    against the same taus of a reference stream (iter_unequal_time's
    chunks, on the host), batch by batch, so no whole (nt + 1)-tau stack
    is held.  ``order`` yields the taus of each call (by default they run
    consecutively).  Returns (measure_fn, record): record.gap is the
    largest |dG| over Gtt, Gt0 and G0t, record.gmax the reference's
    max|G|, record.gap_w and record.gmax_w the same per walker (W,) and
    record.rel() the largest gap_w / gmax_w."""
    rec = SimpleNamespace(buf={}, next=0, gap=0.0, gmax=0.0, taus=0,
                          gap_w=0.0, gmax_w=0.0)
    rec.rel = lambda: float((rec.gap_w / rec.gmax_w).max())

    def pull(taus):
        while max(taus) >= rec.next:
            _, chunk = next(ref)
            for j in range(chunk[0].shape[1]):
                rec.buf[rec.next] = [x[:, j] for x in chunk]
                rec.next += 1
        return [torch.stack(xs, dim=1)
                for xs in zip(*(rec.buf.pop(t) for t in taus))]

    def measure(Gtt, Gt0, G0t, G00):
        k = Gtt.shape[1]
        taus = (list(range(rec.taus, rec.taus + k)) if order is None
                else next(order))
        for a, b in zip((Gtt, Gt0, G0t), pull(taus)):
            b = b.to(a.device)
            gap = (a.double() - b).abs().flatten(1).amax(1).cpu()
            gmax = b.abs().flatten(1).amax(1).cpu()
            rec.gap_w = torch.maximum(torch.as_tensor(rec.gap_w), gap)
            rec.gmax_w = torch.maximum(torch.as_tensor(rec.gmax_w), gmax)
            rec.gap = max(rec.gap, float(gap.max()))
            rec.gmax = max(rec.gmax, float(gmax.max()))
        rec.taus += k
        return {}
    return measure, rec


def tier_order(nt, n_stab):
    """The taus of the tau tier's emits, call by call: tau 0, then per
    group of blocks the taus inside its blocks step by step, then its
    block ends (engine/parity.measurement_uneq_fn)."""
    from dqmc_tpu_torch.engine.parity import _BLOCK_GROUP
    yield [0]
    n_stack = nt // n_stab
    for g0 in range(0, n_stack, _BLOCK_GROUP):
        ks = range(g0, min(g0 + _BLOCK_GROUP, n_stack))
        for i in range(1, n_stab + 1):
            yield [k * n_stab + i for k in ks]


def f64_tau_stream(torch, params, fields, n_stab, warp=False):
    """The native float64 tau sweep of the fields at ``n_stab``, chunk by
    chunk on the host, and its G(0, 0)."""
    from dqmc_tpu_torch.engine.uneqtime import iter_unequal_time
    model, cfg, states = f64_states(torch, params, fields, n_stab)
    return iter_unequal_time(model, cfg, states, tau_chunk=16,
                             warp=warp), states.G, model


# phase 17's gate on the float32 tau sweep against float64, per walker
# over the walker's own max|G|: its largest |dG| over every tau and its
# self-check.  scripts/tau_f32_witness.py read (NVIDIA H100 80GB HBM3,
# 700.00 W) 3.4e-3 to 1.4e-2 at the headline's fields (n_stab 5 and 2,
# seeds 42 and 7, K1 and Householder alike; 1.1e-2 on the df32 engine's
# float32 view) and 0.9 to 4e3 with a wrong suffix slot or one slice's
# fields shifted; max|G| runs to ~190 there, which is why an absolute
# float32 limit does not hold
TAU_F32_REL = 5e-2


def hold_tau(torch, phase, label, states, model, cfg, params, warp=False,
             f32_view=False):
    """The engine-grade float32 tau sweep of final walker states against
    the native float64 tau sweep of their fields at the same n_stab, every
    tau: per walker, max |dG| and the self-check <= TAU_F32_REL of the
    walker's max|G|."""
    from dqmc_tpu_torch.engine.df_sweep import f32_view as view
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    ref, _, _ = f64_tau_stream(torch, params, states.fields, cfg.n_stab,
                               warp)
    measure, rec = tau_gap(torch, ref)
    _, err = sweep_unequal_time(model, cfg, view(states) if f32_view
                                else states, measure_fn=measure, warp=warp)
    err_rel = float((err.double().cpu() / rec.gmax_w).max())
    say(f"{phase}: {label}: the float32 tau sweep of the final fields "
        f"against the float64 one at n_stab = {cfg.n_stab}, {rec.taus} "
        f"taus: max |dG| {rec.gap:.3e}, max|G| {rec.gmax:.3e}, self-check "
        f"{float(err.max()):.3e}; per walker over its max|G|: |dG| "
        f"{rec.rel():.3e}, self-check {err_rel:.3e} (<= {TAU_F32_REL:.0e})")
    if not (rec.taus == cfg.nt + 1 and rec.rel() <= TAU_F32_REL
            and err_rel <= TAU_F32_REL):
        fail(f"{label}: the float32 tau sweep disagrees with float64")


def _production_params(extra: str = "", walkers: int = 16):
    """examples/tpu_production/parameters.in with unequal-time measurement
    and the spin and charge sets on, the keys the port takes later
    (checkpoints, the spool sink) off, the sweep counts cut and
    ``walkers`` walkers."""
    from dqmc_tpu_torch.config import Parameters
    params = Parameters(str(REPO / "examples" / "tpu_production" /
                            "parameters.in"))
    params.set("simulation", "checkpoint_every", 0)
    params.set("io", "sink", "h5")
    params.set("walkers", "n_devices", 1)
    params.set("walkers", "n_walkers", walkers)
    for key, val in dict(n_therms=4, n_bins=1, n_sweeps=1,
                         isMeasureUnequalTime="true", measure_spin="true",
                         measure_charge="true").items():
        params.set("simulation", key, val)
    return Parameters.from_string(params.dumps() + extra)


class TierCheck:
    """Holds a run's tau-tier measurements against the native float64 tau
    sweep at n_stab = 1 of the fields each one measures, every tau, block
    by block, as the run makes them: wraps dqmc_tpu_torch.run's
    measurement_uneq_fn so that the measure_fn it builds also feeds
    ``tau_gap``, and its step starts the float64 reference from the states
    it is handed and holds the tier's G00 (the equal-time measurement's G)
    against the float64 rebuild.  The run's time then includes the
    reference's."""

    def __init__(self, torch, params):
        self.torch, self.params = torch, params
        self.calls, self.taus = 0, 0
        self.gap = self.g_gap = self.gmax = self.err = 0.0

    def __enter__(self):
        from dqmc_tpu_torch import run
        from dqmc_tpu_torch.engine.sweep import half_warp
        torch, params, check = self.torch, self.params, self
        symmetric = params.get_bool("simulation", "symmetric", False)
        self._run, self._saved = run, run.measurement_uneq_fn

        def uneq_fn(model64, cfg, nm, measure_fn, **kw):
            slot = {}

            def both(Gtt, Gt0, G0t, G00):
                slot["cmp"](Gtt, Gt0, G0t, G00)
                return measure_fn(Gtt, Gt0, G0t, G00)
            step = check._saved(model64, cfg, nm, both, **kw)
            check.stride, check.name = step.n_stab, nm.__name__.rsplit(
                ".", 1)[-1]

            def checked(states):
                ref, G64, m64 = f64_tau_stream(torch, params, states.fields,
                                               1, symmetric)
                slot["cmp"], rec = tau_gap(torch, ref,
                                           tier_order(cfg.nt, step.n_stab))
                out = step(states)
                if symmetric:
                    G64 = half_warp(m64, G64)
                check.calls += 1
                check.taus = rec.taus
                check.gap = max(check.gap, rec.gap)
                check.g_gap = max(check.g_gap,
                                  float((out[2] - G64).abs().max()))
                check.gmax = max(check.gmax, rec.gmax,
                                 float(G64.abs().max()))
                check.err = max(check.err, float(out[1].max()))
                return out
            checked.n_stab = step.n_stab
            return checked

        run.measurement_uneq_fn = uneq_fn
        return self

    def __exit__(self, *exc):
        self._run.measurement_uneq_fn = self._saved

    def hold(self, phase, W, nt, tol):
        """Print the record; fail unless every tau of every measurement
        and G00 lie within tol max|G| of float64."""
        say(f"{phase}: {self.name} tau tier, W = {W}, stride {self.stride}, "
            f"{self.calls} measurement(s) of {self.taus} taus against the "
            f"float64 tau sweep at n_stab = 1: max |dG| {self.gap:.3e}, G00 "
            f"{self.g_gap:.3e} (<= {tol:.0e} max|G| = "
            f"{tol * self.gmax:.3e}), tier self-check {self.err:.3e}")
        if not (self.calls and self.taus == nt + 1
                and max(self.gap, self.g_gap) <= tol * self.gmax):
            fail(f"the {self.name} tau tier disagrees with the float64 tau "
                 f"sweep")


def tier_alone(torch, params, states, n_stab):
    """One tf32 tau-tier measurement of the walkers as the run makes it
    (the manager's emit of every tau observable): its wall time and peak
    device memory, then the same under torch.profiler (device activity
    only: its records take minutes to aggregate)."""
    from dqmc_tpu_torch.engine.parity import measurement_uneq_fn
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.measure.manager import MeasurementManager
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.ops import tf32
    lat = make_lattice_of(params)
    manager = MeasurementManager(lat, n_walkers=states.fields.shape[0],
                                 out_dir=None, device="cuda",
                                 measure_unequal=True)
    manager.add_defaults()
    manager.add_spin()
    manager.add_charge()
    model64 = AttractiveHubbard.from_params(params, lat, dtype=torch.float64,
                                            device="cuda")
    fn = measurement_uneq_fn(
        model64, EngineConfig(nt=params.get_int("simulation", "nt"),
                              n_stab=n_stab), tf32, manager.uneq_measure_fn,
        symmetric=params.get_bool("simulation", "symmetric", False),
        emit_greens=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(states)
    torch.cuda.synchronize()
    say(f"phase 16: one tf32 tau-tier measurement of "
        f"{states.fields.shape[0]} walkers at stride {fn.n_stab}: "
        f"{time.perf_counter() - t0:.2f} s wall, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profiled(torch, "tf32 tau tier, one measurement of the walkers",
              lambda s: (fn(s), s)[1], states, 1, phase="phase 16",
              cpu=False, unit="measurement")


# thermalization pairs of phase 16's df32-tier run
DF32_TIER_THERMS = 40
# phase 16's walkers, cut from the example's 16 for the float64 reference's
# time (the tier itself is host-bound)
TIER_WALKERS = 8


def phase_tier_split(torch, profile=False, walkers=TIER_WALKERS):
    """examples/tpu_production's tier split with unequal-time measurement:
    the fused float32 engine (K2 + K1) samples, every measurement rebuilds
    the tau-resolved triplet at tf32 (#8 in every fold, K1 in every
    refined solve), whose G00 is the equal-time G; n_stab = auto; 4 + 1x1
    pairs.  The run's tier measurement against the native float64 tau
    sweep at n_stab = 1 of the same fields (every tau, <= 1e-9 of
    max|G|); with ``profile``, one tier measurement timed alone and under
    torch.profiler.  Then a measure_precision = df32 run of the same
    configuration (#7 through the tier) after DF32_TIER_THERMS pairs,
    held likewise at 1e-7."""
    params = _production_params(walkers=walkers)
    W = params.get_int("walkers", "n_walkers")
    with TierCheck(torch, params) as check:
        summary = run_tau(
            torch, params.dumps(), f"tpu_production 16x16 beta=8 nt=160 "
            f"W={W}, float32 fused engine, measure_precision = tf32 with "
            f"isMeasureUnequalTime, spin and charge sets, symmetric, n_stab "
            f"= auto, 4 + 1x1 pairs (the float64 reference inside)",
            ("tf_qr_panel", "cgs2_qr", "fused_wrap", "fused_sites"),
            ("tf_qr_panel", "cgs2_qr"), "phase 16")
    nt = params.get_int("simulation", "nt")
    check.hold("phase 16", W, nt, 1e-9)
    if profile:
        tier_alone(torch, params, summary.states, summary.n_stab)
    # the df32 tier's grade holds on equilibrated fields (the JAX package's
    # note at its stride rule: from near-random fields its float32-seeded
    # refinement can lose orders at any stride), so this chain is
    # thermalized first
    params = _production_params(
        f"[simulation]\nmeasure_precision = df32\nn_therms = "
        f"{DF32_TIER_THERMS}\n", walkers)
    with TierCheck(torch, params) as check:
        run_tau(torch, params.dumps(), f"tpu_production with "
                f"measure_precision = df32 and isMeasureUnequalTime, "
                f"{DF32_TIER_THERMS} + 1x1 pairs (the float64 reference "
                f"inside)", ("df_qr_panel", "cgs2_qr"),
                ("df_qr_panel", "cgs2_qr"), "phase 16")
    check.hold("phase 16", W, nt, 1e-7)


HEADLINE_UNEQ = """
[Lattice]
L1 = 16
L2 = 16
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 8.0
nt = 160
n_stab = 5
n_therms = 2
n_bins = 1
n_sweeps = 3
dtype = float32
isMeasureUnequalTime = true
measure_spin = true
measure_charge = true
seed = 42
[walkers]
n_walkers = 16
"""


def tau_free_fermions(torch):
    """(a) U = 0 at the headline shape (16x16, beta=8, nt=160, n_stab=5,
    W=2) in float64 and float32: Gt0(tau) and Gtt(tau) against the exact
    e^{-tau K} (I + e^{-beta K})^{-1} and G, and the boundary identities
    G0t(0) = G - I, G0t(beta) = -G, Gt0(beta) = I - G, every tau, at
    1e-10 (float64) and 1e-2 (float32); K1 must launch inside the float32
    sweep."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.models.attractive_hubbard import build_kinetic_matrix
    L, beta, nt, n_stab, W = 16, 8.0, 160, 5, 2
    lat = square_lattice(L, L)
    K = torch.as_tensor(build_kinetic_matrix(lat, 1.0, 0.0), device="cuda")
    lam, V = torch.linalg.eigh(K)
    G = (V / (1.0 + torch.exp(-beta * lam))) @ V.T      # exact G(0, 0)
    eye = torch.eye(L * L, dtype=torch.float64, device="cuda")
    dtau = beta / nt
    # float32: the float32 err_warn.  The stabilized triplet's own float32
    # floor at this shape is ~1e-3, in the JAX package too (its float32 tau
    # sweep reads 2.8e-3 here on the CPU: scripts/tau_free_fermions.py)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-2)):
        model = AttractiveHubbard.build(lat, U=0.0, t=1.0, mu=0.0, beta=beta,
                                        nt=nt, dtype=dtype, device="cuda")
        cfg = EngineConfig(nt=nt, n_stab=n_stab)
        states = init_state(model, cfg, make_generators(3, W, "cuda"))
        rec = SimpleNamespace(tau=0, gap=0.0, ident=0.0)

        def measure(Gtt, Gt0, G0t, G00):
            for j in range(Gtt.shape[1]):
                tau = rec.tau + j
                # in the eigenbasis: e^{-tau K} and G apart would meet
                # e^{+-beta |lambda|} in one product
                gt0 = (V * (torch.exp(-tau * dtau * lam)
                            / (1.0 + torch.exp(-beta * lam)))) @ V.T
                rec.gap = max(rec.gap,
                              float((Gt0[:, j].double() - gt0).abs().max()),
                              float((Gtt[:, j].double() - G).abs().max()))
                if tau in (0, nt):
                    want = ((G - eye, G) if tau == 0 else (-G, eye - G))
                    rec.ident = max(
                        rec.ident,
                        float((G0t[:, j].double() - want[0]).abs().max()),
                        float((Gt0[:, j].double() - want[1]).abs().max()))
            rec.tau += Gtt.shape[1]
            return {}
        _cuda.reset_launch_counts()
        _, err = sweep_unequal_time(model, cfg, states, measure_fn=measure)
        torch.cuda.synchronize()
        k1 = _cuda.LAUNCHES["cgs2_qr"]
        TOTALS.update(_cuda.LAUNCHES)
        say(f"phase 17: (a) free fermions {L}x{L} beta={beta:g} nt={nt} "
            f"n_stab={n_stab} W={W} {str(dtype)[6:]}: {rec.tau} taus, max "
            f"|Gt0 - exact|, |Gtt - G| {rec.gap:.3e}, boundary identities "
            f"{rec.ident:.3e} (<= {tol:.0e}), self-check "
            f"{float(err.max()):.3e}, K1 launches {k1}")
        if not (rec.tau == nt + 1 and max(rec.gap, rec.ident) <= tol):
            fail(f"free-fermion tau sweep ({dtype})")
        if dtype == torch.float32 and not k1:
            fail("K1 did not launch inside the float32 tau sweep")


# the stride of phase 17's gated float32 runs of examples/repulsive_spin:
# at the example's n_stab = 10 the float32 naive-vs-stabilized error is
# O(1) (phase 4 cuts examples/basic's n_stab from 10 to 2 for the same
# reason), and the tau sweep shares those numerics
TAU_GATED_N_STAB = 2


def tau_headline(torch):
    """(b) the headline with isMeasureUnequalTime, measure_spin and
    measure_charge through run_simulation on the fused engine, 2 + 3
    pairs: in float32 its rate and err_uneq_max (printed: absolute, and
    max|G| reaches ~190 here), and the float32 tau sweep of the final
    fields against the float64 one at the same n_stab, gated per walker
    over its max|G| (hold_tau, TAU_F32_REL), then one more measured
    iteration and its tau sweep alone under torch.profiler; then the same
    configuration in float64 on the fused engine for 1 + 1 pairs,
    err_uneq_max < 1e-6 (the float64 err_warn)."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.fused import sweep_pair_fused
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.measure.manager import MeasurementManager
    from dqmc_tpu_torch.models import AttractiveHubbard
    summary = run_tau(torch, HEADLINE_UNEQ, "headline 16x16 beta=8 nt=160 "
                      "n_stab=5 W=16 f32 with isMeasureUnequalTime, spin and "
                      "charge sets, 2 + 1x3 pairs",
                      ("cgs2_qr", "fused_wrap", "fused_sites"), ("cgs2_qr",),
                      "phase 17")
    say(f"phase 17: (b) headline with tau measurement: "
        f"{summary.sweeps_per_sec:.4f} walker-sweep-pairs/s (phase 5: the "
        f"same shape without it), err_uneq_max {summary.err_uneq_max:.3e} "
        f"(absolute; gated below over max|G|)")
    params = Parameters.from_string(HEADLINE_UNEQ)
    lat = square_lattice(16, 16)
    model = AttractiveHubbard.from_params(params, lat, dtype=torch.float32,
                                          device="cuda")
    cfg = EngineConfig(nt=params.get_int("simulation", "nt"),
                       n_stab=params.get_int("simulation", "n_stab"))
    hold_tau(torch, "phase 17", "(b) headline", summary.states, model, cfg,
             params)
    manager = MeasurementManager(lat, n_walkers=16, out_dir=None,
                                 device="cuda", measure_unequal=True)
    manager.add_defaults()
    manager.add_spin()
    manager.add_charge()
    emit = manager.uneq_measure_fn

    def tau_sweep(s):
        return sweep_unequal_time(model, cfg, s, measure_fn=emit)

    def iteration(s):
        s = sweep_pair_fused(model, cfg, s)
        manager.increments(s.G, uneq=tau_sweep(s))
        return s
    busy_it, _ = _profiled(torch, "headline, one measured iteration (pair, "
                           "tau sweep, measurement)", iteration,
                           summary.states, 1, phase="phase 17", cpu=False,
                           unit="measured iteration")
    busy_tau, _ = _profiled(torch, "headline, the tau sweep alone",
                            lambda s: (tau_sweep(s), s)[1], summary.states, 1,
                            phase="phase 17", cpu=False, unit="tau sweep")
    say(f"phase 17: (b) the tau sweep's share of a measured iteration's "
        f"device busy time: {busy_tau / max(busy_it, 1e-12):.3f}")
    # 1 + 1 pairs: float64 QR makes a pair ~8 s here
    text = HEADLINE_UNEQ + ("[simulation]\ndtype = float64\nengine = fused\n"
                            "n_therms = 1\nn_sweeps = 1\n")
    summary = run_tau(torch, text, "headline in float64 on the fused engine "
                      "with isMeasureUnequalTime, 1 + 1x1 pairs",
                      ("fused_wrap", "fused_sites"), (), "phase 17")
    say(f"phase 17: (b) headline in float64: err_uneq_max "
        f"{summary.err_uneq_max:.3e} (< 1e-6)")
    if not summary.err_uneq_max < 1e-6:
        fail("headline tau sweep self-check above the float64 err_warn")


REPULSIVE_SPIN_CUT = dict(n_therms=20, n_bins=2, n_sweeps=5)


def tau_repulsive_spin(torch):
    """(d) examples/repulsive_spin through the CLI's main() (run_simulation
    with no output directory where h5py is missing) with its sweep counts
    cut: #2b + K1; at its n_stab = 10 the signs and err_uneq_max are
    printed (the float32 envelope), at n_stab = TAU_GATED_N_STAB every
    sign must stay +1 and err_uneq_max below 1e-2.  (c) On the final
    fields in float64: spinzzTau(0) = spinZZCorr, spinxxTau(0) =
    spinXXCorr, densityTau(0) = the textbook densityCorr (<= 1e-12)."""
    import importlib.util
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.measure import observables as obs
    from dqmc_tpu_torch.measure.context import make_context
    from dqmc_tpu_torch.run import main as cli_main, run_simulation
    has_h5py = importlib.util.find_spec("h5py") is not None
    how = "the CLI" if has_h5py else "run_simulation, no h5py here"
    cwd = os.getcwd()
    for n_stab in (None, TAU_GATED_N_STAB):
        params = Parameters(str(REPO / "examples" / "repulsive_spin" /
                                "parameters.in"))
        cut = dict(REPULSIVE_SPIN_CUT, **({} if n_stab is None
                                          else dict(n_stab=n_stab)))
        for key, val in cut.items():
            params.set("simulation", key, val)
        with tempfile.TemporaryDirectory() as tmp, TauLaunches() as tau:
            (Path(tmp) / "parameters.in").write_text(params.dumps())
            os.chdir(tmp)
            try:
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                summary = (cli_main(["--device", "cuda"]) if has_h5py else
                           run_simulation(params, out_dir=None,
                                          device="cuda"))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
                TOTALS.update(_cuda.LAUNCHES)
            finally:
                os.chdir(cwd)
        gate = ("(< 1e-2; signs +1)" if n_stab
                else "(the float32 envelope, not gated)")
        say(f"phase 17: (d) examples/repulsive_spin "
            f"({', '.join(f'{k}={v}' for k, v in cut.items())}) in "
            f"{dt:.1f} s ({how}): launches {launches}, inside the tau "
            f"sweeps {dict(tau.counts)}, signs {summary.walker_signs}, "
            f"err_uneq_max {summary.err_uneq_max:.3e} {gate}, self-check "
            f"max {summary.max_precision_error:.3e}, "
            + ", ".join(f"{k} {v:.5f}"
                        for k, v in summary.observables.items()))
        if not (launches.get("fused_sites_2f") and launches.get("cgs2_qr")
                and tau.counts["cgs2_qr"]):
            fail("repulsive_spin: #2b or K1 (in the tau sweep) not launched")
        # at the example's n_stab = 10 the float32 error (~1e2) flips
        # signs even at half filling: gated at TAU_GATED_N_STAB only
        if n_stab and any(s != 1.0 for s in summary.walker_signs):
            fail("repulsive_spin: a sign left +1 at half filling")
        if n_stab and not summary.err_uneq_max < 1e-2:
            fail("repulsive_spin: tau sweep self-check above 1e-2")
    # (c) the tau = 0 identities on these fields, in float64
    _, _, states = f64_states(torch, params, summary.states.fields,
                              params.get_int("simulation", "n_stab"))
    G = states.G
    ctx = make_context(make_lattice_of(params), "cuda")
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device="cuda")
    gap = {}
    for tau_fn, eq_fn in ((obs.spinzz_tau, obs.spin_zz_corr),
                          (obs.spinxx_tau, obs.spin_xx_corr)):
        gap[tau_fn.__name__] = float(
            (tau_fn(G, G, G - eye, G, ctx) - eq_fn(G, ctx)).abs().max())
    g = G.transpose(0, 1)                        # (flavor, W, ns, ns)
    n = sum(1.0 - torch.diagonal(x, dim1=-2, dim2=-1) for x in g)
    text = (n[:, :, None] * n[:, None, :]
            + sum((eye - x.transpose(-1, -2)) * x for x in g)
            - (n.mean(-1) ** 2)[:, None, None])
    gap["density_tau"] = float(
        (obs.density_tau(G, G, G - eye, G, ctx) - text).abs().max())
    say(f"phase 17: (c) tau = 0 identities in float64 on these fields "
        f"(max|G| {float(G.abs().max()):.3e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()) + " (<= 1e-12)")
    if max(gap.values()) > 1e-12:
        fail("a tau observable at tau = 0 differs from its equal-time form")


def make_lattice_of(params):
    from dqmc_tpu_torch.lattice import make_lattice
    return make_lattice(params.get_str("Lattice", "geometry", "square"),
                        params.get_int("Lattice", "L1"),
                        params.get_int("Lattice", "L2"))


def tau_df32(torch):
    """(d) the df32 headline with isMeasureUnequalTime, 1 + 1 pairs: #3,
    K1 and #7 in the engine, the float32 tau sweep on the walkers' float32
    view (K1 inside it); its err_uneq_max (printed) and its triplet
    against the float64 tau sweep of the final fields at the same n_stab,
    gated per walker over its max|G| as in (b)."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.models import AttractiveHubbard
    text = HEADLINE_DF32 + ("[simulation]\nisMeasureUnequalTime = true\n"
                            "measure_spin = true\nmeasure_charge = true\n")
    summary = run_tau(torch, text, "df32 headline with isMeasureUnequalTime, "
                      "1 + 1 pairs", ("df_qr_panel", "cgs2_qr",
                                      "delayed_slice"), ("cgs2_qr",),
                      "phase 17")
    say(f"phase 17: (d) df32 headline: err_uneq_max "
        f"{summary.err_uneq_max:.3e} (absolute; gated below over max|G|)")
    params = Parameters.from_string(text)
    model = AttractiveHubbard.from_params(params, make_lattice_of(params),
                                          dtype=torch.float32, device="cuda")
    cfg = EngineConfig(nt=params.get_int("simulation", "nt"),
                       n_stab=params.get_int("simulation", "n_stab"))
    hold_tau(torch, "phase 17", "(d) df32 headline on f32_view",
             summary.states, model, cfg, params, f32_view=True)


def phase_tau(torch):
    """Phase 17: the engine-grade tau path (engine/uneqtime.py)."""
    tau_free_fermions(torch)
    tau_headline(torch)
    tau_repulsive_spin(torch)
    tau_df32(torch)


def print_registers() -> None:
    """ptxas's registers and spill bytes of every kernel instantiation,
    from one ``nvcc -Xptxas -v`` per source with the build's flags."""
    import re
    from dqmc_tpu_torch import _cuda
    with tempfile.TemporaryDirectory() as tmp:
        for src in _cuda.sources():
            out = subprocess.run(
                [_cuda._nvcc(), *_cuda.nvcc_flags(src), "-Xptxas", "-v", "-c",
                 "-o", str(Path(tmp) / (src.stem + ".o")), str(src)],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                fail(f"nvcc -Xptxas -v {src.name}: {out.stderr[-2000:]}")
            text = out.stderr
            if shutil.which("c++filt"):
                text = subprocess.run(["c++filt"], input=text,
                                      capture_output=True, text=True).stdout
            for name, stack, spill, regs in re.findall(
                    r"Compiling entry function '(.*?)' for.*?(\d+) bytes "
                    r"stack frame, (\d+) bytes spill stores.*?Used (\d+) "
                    r"registers", text, re.S):
                name = re.sub(r"\(anonymous namespace\)::|^void |\(.*", "",
                              name)
                say(f"registers: {src.name} {name}: {regs} registers, "
                    f"{spill} bytes spilled, {stack} bytes stack frame")


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
    "delayed_slice": ("dqmc_tpu_torch/csrc/site_update.cu",
                      "dqmc_tpu/ops/kernels.py:121"),
    "delayed_slice_2f": ("dqmc_tpu_torch/csrc/site_update.cu",
                         "dqmc_tpu/ops/kernels.py:222"),
    "rank1_sites": ("dqmc_tpu_torch/csrc/site_update.cu",
                    "dqmc_tpu/ops/kernels.py:31"),
    "submatrix_group": ("dqmc_tpu_torch/csrc/submatrix_update.cu",
                        "dqmc_tpu/ops/kernels.py:584"),
    "submatrix_flush": ("dqmc_tpu_torch/csrc/submatrix_update.cu",
                        "dqmc_tpu/ops/kernels.py:584"),
    "df_qr_panel": ("dqmc_tpu_torch/csrc/mw_qr_panel.cu",
                    "dqmc_tpu/ops/df_qr_kernel.py:154"),
    "tf_qr_panel": ("dqmc_tpu_torch/csrc/mw_qr_panel.cu",
                    "dqmc_tpu/ops/tf_qr_kernel.py:115"),
}
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17)


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
    gen14 = torch.Generator(device="cuda")
    gen14.manual_seed(14)
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
             (13, lambda: phase_fused_submatrix(torch, card)),
             (14, lambda: phase_mw_panels(torch, gen14, report)),
             (15, lambda: phase_df32_headline(torch)),
             (16, lambda: phase_tier_split(torch)),
             (17, lambda: phase_tau(torch)))
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
