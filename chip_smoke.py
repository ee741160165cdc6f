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
7. the stretch configuration (32x32, beta=16, nt=160 -- bench.py's 320
   cut to half -- n_stab=5, U=4, W=4,
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
    steady self-check < 1e-6; 4 + 2x4 pairs, the float32 run's 10 + 5x4),
    printing the mean sign, density and doubleOcc of both;
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
    df32) through run_simulation (#3, K1, #7) with unequal-time
    measurement on (phase 17 holds its tau sweep), G_df of the final
    fields against the native float64 rebuild (< 1e-7), two blocks
    profiled;
16. examples/tpu_production as written, with the spin and charge sets
    (the fused float32 engine; every measurement rebuilds the tau-resolved
    triplet at tf32 through #8 and K1, its G00 the equal-time G; n_stab =
    auto; checkpoint_every = 5 and the spool sink into an output
    directory): the tier of the final fields against the native float64
    tau sweep at n_stab = 1, every tau, and its G00 against the float64
    rebuild (<= 1e-9 of max|G|), every walker's spool log holding its bin
    once under the expected record names; then a short measure_precision
    = df32 run (#7), held likewise at 1e-7; then, with engine-grade
    measurement, 2 bins resumed to 4 against 4 straight (fields, G and
    generator states bit for bit, the bins within 1e-4 of each array's
    largest value: index_add_'s atomics) and a run stopped in
    thermalization under n_stab = auto and resumed (bit for bit, the same
    adapted n_stab);
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
    tau = 0 identities in float64 (<= 1e-12); then phase 15's df32
    headline run (unequal-time measurement on, 1 + 1 pairs; run here if
    phase 15 did not run), the tau sweep on the walkers' float32 view
    against float64 (as in (b), <= 5e-2 of max|G|);
18. checkerboard kinetics on the per-slice engine: bench.py's stretch_cb
    (32x32, beta=16, nt=160 as phase 7's, n_stab=5, W=4, float32) for one pair through
    run_simulation (#3 + K1, finite), its rate beside phase 7's dense
    stretch, one more pair under torch.profiler; the headline's float64
    checkerboard B products on the card against the dense operator
    (<= 1e-12); the headline shape with checkerboard in float64, one
    pair, self-check < 1e-6;
19. parallel tempering (parallel/tempering.py, the per-slice engine on a
    replica-stacked model): (a) #3 with the doped PT ladder's six
    per-walker (g, alpha) and #4 with the repulsive ladder's, one slice at
    (W=6, ns=144, k=32) against the twin (float64 decisions identical, G
    within 1e-9 of max|G|; float32 <= 1% mismatched; the same bits on a
    second call); (c) bench.py's doped PT scale (12x12, nt=120, n_stab=5,
    betas 6.0-5.0, float32 with f64 actions, seed 11, sink = spool) for 20
    + 4x10 pairs through run_simulation (#3 + K1): its rate, exchange rate
    (0 < rate <= 1), steady self-check and launches per pair, six spool
    logs holding every bin, one more pair under torch.profiler, then the
    same ladder with model = repulsive (#4) for 2 + 10 pairs; (b) f64-action
    exchange attempts from (c)'s final replicas against an all-float64
    replica set (the same decisions and fields), and six equal betas (every
    pair accepts, fields and signs swap exactly); (d) examples/tempering at
    its width, stopped in thermalization and in the measurement and
    resumed, against straight (fields, G, generators, the exchange
    generator, attempt and accepted bit for bit; bins within 1e-4); (e)
    one df32 exchange at bench.py's headline PT scale (16x16, nt=160,
    betas 8.0-6.0; #7) against the f64 actions' decisions; (f) a tf32-tier
    PT segment at 8x8, nt=20 (#8), each replica's tier G within 1e-9 of
    max|G| of its float64 rebuild.
20. walkers across devices and processes (parallel/distributed.py,
    parallel/walkers.py): the headline (W = 16) in float32 on the fused
    engine (2 + 1x4 pairs) and in float64 on the per-slice engine (1 +
    1x1) run in one process, with its walkers in two chunks on [cuda:0,
    cuda:0], and in two processes on gloo sharing cuda:0 (8 walkers
    each, spawned, joined with a timeout): fields bit for bit against the
    one-process run, bins within 1e-12 (float64) or 1e-4 (float32, the
    atomics of index_add_) of each array's largest value; the doped PT
    scale (2 + 1x10 pairs) in one process and in two processes of three
    replicas: fields, exchange rate and bins alike; one float32 pair over
    [cuda:0, cuda:0] traced into profile_dir, whose Chrome trace must
    name the fused kernels; the two processes' summed rate against one
    process's, printed.
21. the per-slice engine past the 32x32 lattice: (a) K1 in float32 at
    (2, n) for n = 1156 (padded to 1184), 1600 and its cap 1728, to phase
    2's tolerances, the same bits on a second call and for each matrix
    alone, then timed at (4, 1600) beside its twin and torch.linalg.qr;
    #3 and #6 with one flavor and #4 with two on 34x34 (ns = 1156), 40x40
    and 32x64 (ns = 2048, the cap), W = 2, in float64 and float32 (#3
    and #4 in one shared order at rank 32, #6 in per-walker orders): float64
    decisions and signs identical and G within 1e-9 of max|G|, float32
    decisions <= 1% apart, the same bits on a second call and for each
    walker alone; each timed at (4, 1600, 32) in float32, device time; (b)
    the 40x40 configuration (U=4, mu=0, beta=4, nt=80, n_stab=5, W=4,
    float32, engine = auto: per slice, site_update = pallas, the default
    measurements, sink = spool) through run_simulation for 1 + 2x1 pairs,
    one more pair under torch.profiler (device busy by family: K1, #3,
    the GEMMs), then in float64 at W = 2 (0 + 1x1) and in float32 with
    site_update = scan (#6, 0 + 1x1): the kernels launched, acceptance in
    (0, 1), finite observables, the spool logs holding every bin; float64:
    the steady self-check <= 1e-6; float32: each walker's final G within
    5e-2 of its max|G| of the float64 chain's on the same fields, the
    steady self-check printed beside its err_warn of 1e-2 (this float32
    configuration reads 1e-2 to 1e-1 there, scripts/wide_selfcheck.py).

The phases run in the order 2-3, 5-10, 12-14, then phase 16 in a spawned
process of its own (its launch counts come back to this one) while phases
4, 11 and 15 run here (those four are host-bound, so their rates and
phase 15's profile are taken beside one another), then 17, 18, 19, 20
and 21, alone; every
kernel time of the kernels line is taken in phases 2-14 and 21, alone.  Every phase that drives a
main path (4, 5, 7, 8, 11, 12, 13, 15-21) sets the launch counters to 0
just before and reads them just after; the tau runs also count the
launches made inside their tau sweeps.  The line
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


def device_rows(prof):
    """Device time (us) and launches per name of the device's own records
    (kernels and copies) of a finished torch.profiler run, largest first,
    read from its raw records: key_averages() parses every record into a
    FunctionEvent first, ~0.2 ms each on the card's host, which took ~100
    s over this script's profiles."""
    from torch.autograd import DeviceType
    us, count = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us[e.name()] += e.duration_ns() / 1e3
            count[e.name()] += 1
    return [SimpleNamespace(key=k, us=v, count=count[k])
            for k, v in us.most_common()]


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
    times, counts = Counter(), Counter()
    for e in device_rows(prof):
        for key, _ in K1_STAGES:
            if key in e.key:
                times[key] += e.us / 1e3 / reps
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


def qr_quality(torch, qk, A, phase="phase 2"):
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
    say(f"{phase}: K1 f32 ({B}, {n}, {n}) graded: orth {orth:.3e} (< 2e-4) "
        f"recon {recon:.3e} (< 5e-6) tril {low:.1e} min diag {dmin:.3e}")
    if not (orth < 2e-4 and recon < 5e-6 and low == 0.0 and dmin >= 0.0):
        fail(f"K1 f32 factorization quality at n = {n}")


def block_inputs(torch, gen, W, L, beta, nt, n_slices, dtype,
                 model="attractive", U=4.0, mu=-0.1, seed=11,
                 device="cuda"):
    """A fused block's inputs on an L x L lattice (L = (L1, L2): L1 x L2):
    the model, fresh walkers, and the block's streams."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    L1, L2 = L if isinstance(L, tuple) else (L, L)
    model = MODEL_REGISTRY[model].build(square_lattice(L1, L2), U=U, t=1.0,
                                        mu=mu, beta=beta, nt=nt, dtype=dtype,
                                        device=device)
    cfg = EngineConfig(nt=nt, n_stab=n_slices)
    states = init_state(model, cfg, make_generators(seed, W, device))
    ns = model.n_sites
    order = torch.argsort(torch.rand((n_slices, ns), generator=gen,
                                     device=device), dim=-1)
    props = torch.randint(0, 3, (W, n_slices, ns), generator=gen,
                          device=device)
    us = torch.rand((W, n_slices, ns), generator=gen, device=device,
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
    # sweep counts cut to 130 pairs (eight processes of this run take
    # about a minute on the card's host; 420 pairs took ~170 s); n_stab cut
    # from 10 to 2: the float32 naive-vs-stabilized error of this workload
    # is heavy-tailed -- its max over 600 pairs read 1.7e2 at n_stab=10
    # (the JAX package's own f32 engine reads 6.1 on the CPU), 1.4e-2 at 3
    # and 2.0e-3 at 2 (80 pairs) on the card, against err_warn = 1e-2
    cut = dict(n_therms=50, n_bins=4, n_sweeps=20, n_stab=2)
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
    delayed slice (R <= 64, ns <= 1024, then 16 CTAs of R <= 128 to ns =
    MAX_SITES, the lean layout where the full one does not fit), k <= 32,
    one or two flavors, float32 or float64; the submatrix loop's (submatrix_slice_smem against
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


def run_params(torch, text: str, label: str, need, phase: str,
               out_dir=None):
    """Drive run_simulation (the ``python -m dqmc_tpu_torch`` path) on a
    parameter string, writing into ``out_dir`` (None: no files); reset
    the launch counters just before, read them just after, and check that
    every kernel in ``need`` ran."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(text)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_simulation(params, out_dir=out_dir, device="cuda",
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


# phase 7's dense stretch rate with #3, printed beside phase 18's stretch_cb
STRETCH_RATE = {}

# bench.py's stretch (32x32, beta=16, nt=320, n_stab=5, W=4) at half its
# depth: nt = 160 (dtau 0.1), which halves phases 7, 9 and 18's stretch
# pairs; the widths, beta and the kernels' shapes are the preset's
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
nt = 160
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
    summary = run_params(torch, STRETCH, "stretch 32x32 beta=16 nt=160 "
                         "n_stab=5 W=4 f32, engine = auto (per slice, "
                         "site_update = pallas: #3), 0 + 1 pairs",
                         ("cgs2_qr",) + site, "phase 7")
    STRETCH_RATE["#3"] = summary.sweeps_per_sec
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
    at 10 is O(1e2), PERF.md); 10 + 2 x 5 pairs."""
    text = (REPO / "examples" / "basic" / "parameters.in").read_text()
    cut = ("[simulation]\nengine = slice\nn_therms = 10\nn_bins = 2\n"
           "n_sweeps = 5\nn_stab = 5\ndtype = float32\n")
    run_params(torch, text + cut + "site_update = scan\n",
               "examples/basic, engine = slice, site_update = scan (#6), "
               "n_stab=5, 10 + 2x5 pairs", ("rank1_sites", "cgs2_qr"),
               "phase 8")
    profile_params(torch, text + cut + "site_update = scan\n",
                   "examples/basic, site_update = scan (#6)", 2, 5,
                   "phase 8")
    run_params(torch, text + cut + "site_update = delayed\n",
               "examples/basic, engine = slice, site_update = delayed "
               "(#3, per-walker order, k=32), n_stab=5, 10 + 2x5 pairs",
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
    # device-side rows only (kernels and copies), so nothing counts
    # twice through the CPU op that launched it
    rows = device_rows(prof)
    busy = sum(e.us for e in rows) / 1e6
    say(f"{phase}: {label}, {n_pairs} profiled {unit}: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1.0 - busy / wall:.4f}, {sum(e.count for e in rows)} device "
        f"operations")
    for e in rows[:8]:
        say(f"{phase}:   {e.key[:60]:60s} {e.us / 1e3:10.1f} ms "
            f"({e.us / 1e6 / busy:6.1%}) {e.count} calls")
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
    # (the float64 engine factors with torch's Householder QR, not K1;
    # its run is cut to 4 + 2x4 pairs: ~60 s at 10 + 5x4)
    for dtype, engine, need, depth in (
            ("float32", "auto", fused_need, ""),
            ("float64", "fused", fused_need[1:],
             "n_therms = 4\nn_bins = 2\n")):
        summary = run_params(
            torch, doped + f"dtype = {dtype}\nengine = {engine}\n{depth}",
            f"repulsive doped U=6 mu=-0.8 {dtype}, engine = {engine} "
            f"(fused: #2b{' + K1' if need == fused_need else ''}), "
            + ("4 + 2x4" if depth else "10 + 5x4") + " pairs", need,
            "phase 11")
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
    K1 in the refined solves, #7 in every fold; 1 + 1 pairs, with the tau
    measurement on (df32_headline_tau: phase 17 holds its tau sweep).
    G_df of the final fields against the native float64 rebuild; two
    blocks profiled."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.ops import df32
    summary = df32_headline_tau(torch, "phase 15")
    G64, _ = _f64_rebuild(torch, Parameters.from_string(HEADLINE_DF32),
                          summary.states.fields)
    gap = float((df32.to_f64(summary.states.G_df) - G64).abs().max())
    say(f"phase 15: df32 headline: walker-sweep-pairs/s "
        f"{summary.sweeps_per_sec:.4f}, acceptance {summary.acc_rate:.4f}, "
        f"steady self-check max {summary.max_precision_error:.3e} (the "
        f"float32 drift between stabilizations, and the float32 tau "
        f"sweep's err_uneq_max {summary.err_uneq_max:.3e} folded in), max "
        f"|G_df - G_f64| of the final fields {gap:.3e} (< 1e-7)")
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


def run_tau(torch, text, label, need, tau_need, phase, out_dir=None):
    """run_params with the launches inside the tau sweeps counted: every
    kernel in ``tau_need`` must have launched there."""
    with TauLaunches() as tau:
        summary = run_params(torch, text, label, need, phase, out_dir)
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
    """examples/tpu_production/parameters.in as written (checkpoint_every,
    the spool sink, n_stab = auto, the tf32 tier, the half-warp) with the
    spin and charge sets on, the sweep counts cut and ``walkers``
    walkers."""
    from dqmc_tpu_torch.config import Parameters
    params = Parameters(str(REPO / "examples" / "tpu_production" /
                            "parameters.in"))
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


# the walkers of phase 16's resumes (each checkpoint holds their stack:
# ~90 MB per walker at n_stab = 4)
RESUME_WALKERS = 4
# thermalization pairs of phase 16's df32-tier run
DF32_TIER_THERMS = 40
# phase 16's walkers, cut from the example's 16 for the float64 reference's
# time (the tier itself is host-bound)
TIER_WALKERS = 8


def phase_tier_split(torch, profile=False, walkers=TIER_WALKERS):
    """examples/tpu_production as written, its checkpoints and its spool
    sink on: the fused float32 engine (K2 + K1) samples, every measurement
    rebuilds the tau-resolved triplet at tf32 (#8 in every fold, K1 in
    every refined solve), whose G00 is the equal-time G; n_stab = auto;
    4 + 1x1 pairs into a fresh output directory.  The run's tier
    measurement against the native float64 tau sweep at n_stab = 1 of the
    same fields (every tau, <= 1e-9 of max|G|), every walker's spool log
    holding its bin once under the expected record names, and the
    checkpoint the run left; with ``profile``, one tier measurement timed
    alone and under torch.profiler.  Then a measure_precision = df32 run
    of the same configuration (#7 through the tier) after
    DF32_TIER_THERMS pairs, held likewise at 1e-7; then the resumes
    (production_resumes)."""
    out = Path(tempfile.mkdtemp(prefix="phase16_"))
    try:
        params = _production_params(walkers=walkers)
        W = params.get_int("walkers", "n_walkers")
        with TierCheck(torch, params) as check:
            summary = run_tau(
                torch, params.dumps(), f"tpu_production 16x16 beta=8 "
                f"nt=160 W={W}, float32 fused engine, measure_precision = "
                f"tf32 with isMeasureUnequalTime, spin and charge sets, "
                f"symmetric, n_stab = auto, checkpoint_every = 5, sink = "
                f"spool, 4 + 1x1 pairs (the float64 reference inside)",
                ("tf_qr_panel", "cgs2_qr", "fused_wrap", "fused_sites"),
                ("tf_qr_panel", "cgs2_qr"), "phase 16", out / "flagship")
        nt = params.get_int("simulation", "nt")
        check.hold("phase 16", W, nt, 1e-9)
        hold_logs(params, out / "flagship", W, 1)
        from dqmc_tpu_torch.io.checkpoint import peek_meta
        meta = peek_meta(out / "flagship" / "checkpoint.npz")
        say(f"phase 16: the run's checkpoint: bin {meta['bin']}, "
            f"thermalization done {meta['therm_done']}, n_stab "
            f"{meta['n_stab']}, device {meta['device']}")
        # checkpoint_every = 5 bins: the one bin leaves the checkpoint
        # written at the end of thermalization (n_stab = auto may tighten
        # after the bin)
        if not (meta["therm_done"] and meta["bin"] == 0):
            fail("tpu_production: the checkpoint does not hold the run's "
                 "end of thermalization")
        if profile:
            tier_alone(torch, params, summary.states, summary.n_stab)
        # the df32 tier's grade holds on equilibrated fields (the JAX
        # package's note at its stride rule: from near-random fields its
        # float32-seeded refinement can lose orders at any stride), so
        # this chain is thermalized first
        # (its checkpoints off: the flagship run above holds them, and
        # every 5 of these pairs would save the walkers' ~0.7 GB stack)
        params = _production_params(
            f"[simulation]\nmeasure_precision = df32\nn_therms = "
            f"{DF32_TIER_THERMS}\ncheckpoint_every = 0\n", walkers)
        with TierCheck(torch, params) as check:
            run_tau(torch, params.dumps(), f"tpu_production with "
                    f"measure_precision = df32 and isMeasureUnequalTime, "
                    f"{DF32_TIER_THERMS} + 1x1 pairs (the float64 reference "
                    f"inside)", ("df_qr_panel", "cgs2_qr"),
                    ("df_qr_panel", "cgs2_qr"), "phase 16", out / "df32")
        check.hold("phase 16", W, nt, 1e-7)
        production_resumes(torch, out, RESUME_WALKERS)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def expected_records(params):
    """The spool record names a run of ``params`` writes per bin."""
    from dqmc_tpu_torch.measure.manager import MeasurementManager
    m = MeasurementManager(make_lattice_of(params), out_dir=None,
                           measure_unequal=params.get_bool(
                               "simulation", "isMeasureUnequalTime", False))
    m.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        m.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        m.add_charge()
    return ({f"scalar/{n}" for n in m._scalar_fns}
            | {f"{k}{g}/{n}" for k in ("", "K/")
               for g, fns in (("equaltime", m._eq_fns),
                              ("unequaltime", m._uneq_fns)) for n in fns})


def hold_logs(params, out_dir, W, n_bins, phase="phase 16"):
    """Every walker's spool log (the port's read_spool) holds each of the
    ``n_bins`` bins once, each under the expected record names."""
    from dqmc_tpu_torch.io.spool import read_spool
    want = expected_records(params)
    for w in range(W):
        seen = Counter((name, b) for name, b, _ in
                       read_spool(out_dir / f"data_{w}.spool"))
        per_bin = {b: {n for n, bb in seen if bb == b} for _, b in seen}
        if not (set(seen.values()) == {1} and sorted(per_bin)
                == list(range(n_bins))
                and all(v == want for v in per_bin.values())):
            fail(f"{out_dir.name}: walker {w}'s spool log does not hold "
                 f"bins 0..{n_bins - 1} once each under {sorted(want)}: "
                 f"{sorted(seen.items())[:8]}")
    say(f"{phase}: {out_dir.name}: {W} spool logs, each holding bins "
        f"0..{n_bins - 1} once with {len(want)} records per bin")


# the resumed bins against the uninterrupted ones: the float32
# measurement's displacement sums go through index_add_, whose CUDA
# atomics add in any order, so two runs of the same fields part by up to
# ns float32 roundings (~ns 2^-24 = 1.5e-5 at ns = 256) of an array's
# largest value; a wrong or shifted bin differs at O(1)
RESUME_BIN_REL = 1e-4


class _Stop(Exception):
    pass


# the kernels of examples/tpu_production's engine-grade path
NEED_RESUME = ("cgs2_qr", "fused_wrap", "fused_sites")


def production_resumes(torch, out, walkers):
    """examples/tpu_production stopped and resumed against uninterrupted
    runs, with measure_precision = engine (the chain a checkpoint holds is
    the same whatever measures it, and a tf32 tier measurement costs ~40 s
    of host-bound launches): (1) 2 bins with checkpoint_every = 2, then a
    resume to 4, against 4 straight: fields, G and the walkers' generator
    states bit for bit, the bins within RESUME_BIN_REL of each array's
    largest value; (2) 8 thermalization pairs under n_stab = auto (its
    marks at pairs 2, 4 and 6), checkpointed every 5 as written, stopped
    in the 7th pair and resumed, against the same run straight: fields, G,
    generator states and the adapted n_stab bit for bit."""
    from dqmc_tpu_torch import run as trun
    from dqmc_tpu_torch.io.checkpoint import peek_meta
    need = NEED_RESUME
    base = ("[simulation]\nmeasure_precision = engine\n"
            "checkpoint_every = 2\nn_therms = 2\n")
    params = _production_params(base, walkers)
    W = params.get_int("walkers", "n_walkers")

    def with_bins(n):
        return params.dumps() + f"[simulation]\nn_bins = {n}\n"
    straight = run_params(torch, with_bins(4), "tpu_production, engine "
                          "measurement, checkpoint_every = 2, 2 + 4x1 "
                          "pairs straight", need, "phase 16",
                          out / "straight")
    run_params(torch, with_bins(2), "the same, 2 + 2x1 pairs", need,
               "phase 16", out / "resumed")
    resumed = run_params(torch, with_bins(4), "the same resumed from its "
                         "checkpoint at bin 2 to 4 bins", need, "phase 16",
                         out / "resumed")
    hold_logs(params, out / "straight", W, 4)
    hold_chain(torch, "2 bins, resumed to 4, against 4 straight",
               straight.states, resumed.states)
    hold_bins(out / "straight", out / "resumed", W, 4)

    text = _production_params(
        "[simulation]\nmeasure_precision = engine\nn_therms = 8\n",
        walkers).dumps()
    straight = run_params(torch, text, "tpu_production, engine measurement, "
                          "n_stab = auto, 8 + 1x1 pairs straight", need,
                          "phase 16", out / "auto_straight")
    real, calls = trun.sweep_pair_fused, []

    def stop_in_7th(*args, **kw):
        calls.append(1)
        if len(calls) == 7:
            raise _Stop
        return real(*args, **kw)
    trun.sweep_pair_fused = stop_in_7th
    try:
        run_params(torch, text, "the same, stopped in its 7th pair", (),
                   "phase 16", out / "auto_resumed")
        fail("the stopped run was not stopped")
    except _Stop:
        pass
    finally:
        trun.sweep_pair_fused = real
    meta = peek_meta(out / "auto_resumed" / "checkpoint.npz")
    if (meta["therm_done"], meta["therm_sweep"]) != (False, 5):
        fail(f"the stopped run's checkpoint is not at thermalization pair "
             f"5: {meta}")
    resumed = run_params(torch, text, f"the same resumed from thermalization "
                         f"pair 5 at n_stab {meta['n_stab']}", need,
                         "phase 16", out / "auto_resumed")
    hold_chain(torch, "stopped at thermalization pair 7 (checkpoint at 5) "
               "and resumed, against straight", straight.states,
               resumed.states)
    say(f"phase 16: n_stab auto: straight {straight.n_stab}, resumed "
        f"{resumed.n_stab}")
    if straight.n_stab != resumed.n_stab:
        fail("the resumed run adapted n_stab elsewhere")


def hold_chain(torch, label, a, b, phase="phase 16", **extra):
    """Fields, G and every walker's generator state bit for bit (and the
    ``extra`` equalities given)."""
    same = dict(
        fields=torch.equal(a.fields, b.fields), G=torch.equal(a.G, b.G),
        generators=all(torch.equal(x.get_state(), y.get_state())
                       for x, y in zip(a.gens, b.gens)), **extra)
    say(f"{phase}: {label}: bit for bit {same}")
    if not all(same.values()):
        fail(f"{label}: the resumed chain differs")


def hold_bins(dir_a, dir_b, W, n_bins, phase="phase 16"):
    """The bins of two runs' spool logs (the last record of a bin wins),
    every array within RESUME_BIN_REL of its largest value."""
    import numpy as np
    from dqmc_tpu_torch.io.spool import read_bins
    worst, exact, total = 0.0, 0, 0
    for w in range(W):
        A = read_bins(dir_a / f"data_{w}.spool")
        B = read_bins(dir_b / f"data_{w}.spool")
        if sorted(A) != sorted(B) or sorted(A) != list(range(n_bins)):
            fail(f"walker {w}: bins {sorted(A)} against {sorted(B)}")
        for b in A:
            for group, vals in A[b].items():
                if set(vals) != set(B[b][group]):
                    fail(f"walker {w} bin {b}: {group} names differ")
                for name, x in vals.items():
                    x, y = np.asarray(x), np.asarray(B[b][group][name])
                    scale = max(float(np.abs(x).max()), 1e-300)
                    worst = max(worst, float(np.abs(x - y).max()) / scale)
                    exact += bool(np.array_equal(x, y))
                    total += 1
    say(f"{phase}: resumed bins against straight: {exact} of {total} "
        f"arrays bit for bit, the largest gap {worst:.3e} of its array's "
        f"largest value (<= {RESUME_BIN_REL:.0e}: index_add_'s atomics)")
    if worst > RESUME_BIN_REL:
        fail("the resumed bins differ from the uninterrupted ones")


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


HEADLINE_DF32_TAU = HEADLINE_DF32 + (
    "[simulation]\nisMeasureUnequalTime = true\nmeasure_spin = true\n"
    "measure_charge = true\n")
# the one run of HEADLINE_DF32_TAU, shared by phases 15 and 17 (a df32
# headline pair takes ~70 s of host-bound launches)
_DF32_TAU_RUN = {}


def df32_headline_tau(torch, phase):
    """The df32 headline with isMeasureUnequalTime and the spin and charge
    sets through run_simulation, 1 + 1 pairs (run_tau: #7, K1 and #3 in
    the engine, K1 inside the tau sweep), run once for phases 15 and 17."""
    if "summary" not in _DF32_TAU_RUN:
        _DF32_TAU_RUN["summary"] = run_tau(
            torch, HEADLINE_DF32_TAU, "df32 headline 16x16 beta=8 nt=160 "
            "n_stab=5 W=16, dtype = df32, with isMeasureUnequalTime, spin "
            "and charge sets, 1 + 1 pairs",
            ("df_qr_panel", "cgs2_qr", "delayed_slice"), ("cgs2_qr",), phase)
    else:
        say(f"{phase}: the df32 headline with isMeasureUnequalTime: phase "
            f"15's run")
    return _DF32_TAU_RUN["summary"]


def tau_df32(torch):
    """(d) the df32 headline with isMeasureUnequalTime, 1 + 1 pairs: #3,
    K1 and #7 in the engine, the float32 tau sweep on the walkers' float32
    view (K1 inside it); its err_uneq_max (printed) and its triplet
    against the float64 tau sweep of the final fields at the same n_stab,
    gated per walker over its max|G| as in (b)."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.models import AttractiveHubbard
    text = HEADLINE_DF32_TAU
    summary = df32_headline_tau(torch, "phase 17")
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


HEADLINE_CB64 = """
[Lattice]
L1 = 16
L2 = 16
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
checkerboard = true
[simulation]
beta = 8.0
nt = 160
n_stab = 5
n_therms = 0
n_bins = 1
n_sweeps = 1
dtype = float64
seed = 42
[walkers]
n_walkers = 16
"""


def checkerboard_matrix(lat, t, mu, dtau):
    """The dense matrix of the checkerboard operator, e^{dtau mu} G_3 G_2
    G_1 G_0 with each group's exponential taken by scipy's expm of its
    bond matrix (group 0 acts first, as models/kinetic.py applies them)."""
    import numpy as np
    import scipy.linalg
    from dqmc_tpu_torch.models.kinetic import build_checkerboard
    perms, masks, _, _ = build_checkerboard(lat, t, dtau)
    ns = lat.n_sites
    P = np.exp(dtau * mu) * np.eye(ns)
    for g in range(4):
        Kg = np.zeros((ns, ns))
        for i in range(ns):
            j = perms[g][i]
            if masks[g][i] and j > i:
                Kg[i, j] = Kg[j, i] = -t
        P = scipy.linalg.expm(-dtau * Kg) @ P
    return P


def checkerboard_products(torch, device="cuda"):
    """The four B products of the headline's float64 checkerboard model on
    the card (W = 16, random fields, X of unit-order entries) against B
    and B^{-1} formed from the dense matrix of the operator: <= 1e-12."""
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.models import kinetic
    lat = square_lattice(16, 16)
    model = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=0.0, beta=8.0,
                                    nt=160, dtype=torch.float64,
                                    device=device, checkerboard=True)
    P = torch.as_tensor(checkerboard_matrix(lat, 1.0, 0.0, 8.0 / 160),
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    X = torch.randn((16, 1, 256, 256), generator=gen, dtype=torch.float64,
                    device=device) / 16.0
    f = torch.randint(0, 4, (16, 256), generator=gen, device=device)
    ev = model.expV_diag(f)
    B = ev[..., :, None] * P
    Bi = torch.linalg.inv(P) / ev[..., None, :]
    want = dict(apply_B_left=B @ X, apply_B_right=X @ B,
                apply_invB_left=Bi @ X, apply_invB_right=X @ Bi)
    gaps = {name: float((getattr(kinetic, name)(model, f, X) - w).abs().max())
            for name, w in want.items()}
    say(f"phase 18: headline checkerboard float64 B products on the card "
        f"against the operator's dense matrix (max|B X| "
        f"{float(want['apply_B_left'].abs().max()):.3f}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + " (<= 1e-12)")
    if max(gaps.values()) > 1e-12:
        fail("a checkerboard B product disagrees with the dense operator")


def phase_checkerboard(torch):
    """Phase 18: checkerboard kinetics (models/kinetic.py, the group
    application in plain torch) on the per-slice engine.  bench.py's
    stretch_cb (32x32, beta=16, nt=320, n_stab=5, W=4, float32) for one
    pair through run_simulation (#3 + K1; finite, as phase 7's dense
    stretch, whose rate is printed beside), then one pair under
    torch.profiler; the headline's float64 checkerboard B products
    against the dense operator; the headline shape (16x16, beta=8,
    nt=160, W=16) with checkerboard in float64 on the per-slice engine
    (#3), one pair, its self-check < 1e-6."""
    text = STRETCH + "[hubbard]\ncheckerboard = true\n"
    summary = run_params(torch, text, "stretch_cb 32x32 beta=16 nt=160 "
                         "n_stab=5 W=4 f32, checkerboard, engine = auto "
                         "(per slice, site_update = pallas: #3), 0 + 1 "
                         "pairs", ("cgs2_qr", "delayed_slice"), "phase 18")
    say(f"phase 18: stretch_cb {summary.sweeps_per_sec:.4f} "
        f"walker-sweep-pairs/s; the dense stretch with #3 (phase 7) "
        + (f"{STRETCH_RATE['#3']:.4f}" if "#3" in STRETCH_RATE
           else "not run"))
    profile_params(torch, text, "stretch_cb, checkerboard (#3)", 0, 1,
                   "phase 18", cpu=False)
    checkerboard_products(torch)
    summary = run_params(torch, HEADLINE_CB64, "headline 16x16 beta=8 "
                         "nt=160 n_stab=5 W=16 float64, checkerboard, per "
                         "slice (#3), 0 + 1 pairs", ("delayed_slice",),
                         "phase 18")
    if not summary.max_precision_error < 1e-6:
        fail("checkerboard headline float64: self-check not below 1e-6")


# ----------------------------------------------------------------------
# phase 19: parallel tempering
# ----------------------------------------------------------------------

# bench.py's doped PT scale (bench.py:396-440) as written, its depth cut
PT_BETAS = (6.0, 5.8, 5.6, 5.4, 5.2, 5.0)
PT_DOPED = f"""
[Lattice]
L1 = 12
L2 = 12
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 6.0
nt = 120
n_therms = 20
n_sweeps = 10
n_bins = 4
n_stab = 5
seed = 11
dtype = float32
[io]
sink = spool
[ParallelTempering]
enabled = true
sweep_steps = 10
betas = {', '.join(map(str, PT_BETAS))}
"""
# bench.py's headline PT scale: the df32 exchange (#7 at ns = 256)
PT_HEADLINE = (16, 160, (8.0, 7.6, 7.2, 6.8, 6.4, 6.0))
# the kernels of the float32 PT path: K1 and #3 (#4 for the repulsive
# ladder)
NEED_PT = ("cgs2_qr", "delayed_slice")


def ladder(torch, model_cls, dtype, L, nt, betas, mu=0.0):
    """A replica-stacked model on the card, one beta per replica."""
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.parallel.walkers import stack_models
    return stack_models([model_cls.build(
        square_lattice(L, L), U=4.0, t=1.0, mu=mu, beta=b, nt=nt,
        dtype=dtype, device="cuda") for b in betas])


def f64_walkers(torch, models64, cfg, fields):
    """float64 walker states of ``fields`` under a float64 ladder."""
    from dqmc_tpu_torch.engine.state import WalkerState
    from dqmc_tpu_torch.engine.sweep import rebuild_stack_and_greens
    stack, G, ld = rebuild_stack_and_greens(models64, cfg, fields)
    z = torch.zeros(fields.shape[0], dtype=torch.float64, device="cuda")
    return WalkerState(fields=fields.clone(), G=G, stack=stack,
                       log_det_M=ld, gens=[], acc_sum=z, sign=z + 1.0,
                       err_max=z, err_sum=z, err_count=z)


def pt_sites(torch, gen):
    """(a) #3 with the ladder's six per-walker (g, alpha), then #4 with the
    repulsive ladder's, one slice at (W=6, ns=144, k=32) from the ladder's
    fresh walkers, against the twin: float64 decisions (and signs)
    identical and G within 1e-9 of max|G|, float32 <= 1% mismatched
    decisions, the same bits on a second call."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import _couplings, init_state
    from dqmc_tpu_torch.models import AttractiveHubbard, RepulsiveHubbard
    from dqmc_tpu_torch.ops import kernels as tk
    for cls, fn, tag in (
            (AttractiveHubbard, tk.metropolis_slice_update_batched, "#3"),
            (RepulsiveHubbard, tk.metropolis_slice_update_batched_2f, "#4")):
        for dtype in (torch.float64, torch.float32):
            models = ladder(torch, cls, dtype, 12, 120, PT_BETAS)
            states = init_state(models, EngineConfig(nt=120, n_stab=5),
                                make_generators(11, 6, "cuda"))
            W, ns = 6, models.n_sites
            g, alpha = _couplings(models, W)
            args = (g, alpha, torch.argsort(torch.rand(
                ns, generator=gen, device="cuda")),
                torch.randint(0, 3, (W, ns), generator=gen, device="cuda"),
                torch.rand((W, ns), generator=gen, device="cuda",
                           dtype=dtype), states.G, states.fields[:, 0])
            a, b, p = fn(*args), fn(*args), fn(*args, plain=True)
            torch.cuda.synchronize()
            mism = int((a[1] != p[1]).sum())
            smis = int((a[3] != p[3]).sum()) if len(a) > 3 else 0
            rel = float((a[0] - p[0]).abs().max() / p[0].abs().max())
            acc = int((p[2] * ns).round().sum())
            say(f"phase 19: {tag} {str(dtype)[6:]} (W={W}, ns={ns}, k=32), "
                f"the doped ladder's g {[round(float(x), 6) for x in g]}: "
                f"{acc} of {W * ns} accepted, mismatched decisions {mism}, "
                f"signs {smis}, |dG|/max|G| {rel:.3e}, same bits on a "
                f"second call {same_bits(a, b)}")
            if not same_bits(a, b):
                fail(f"phase 19: {tag} differs between two calls")
            if not 0 < acc < W * ns:
                fail(f"phase 19: {tag}: no accept or no reject")
            if dtype == torch.float64 and (mism or smis or not rel < 1e-9):
                fail(f"phase 19: {tag} disagrees with its twin (f64)")
            if mism > 0.01 * W * ns:
                fail(f"phase 19: {tag} f32 decisions disagree with the twin")


def run_pt(torch, text, label, need, out_dir=None, phase="phase 19"):
    """Drive a parallel-tempering run through run_simulation, counting its
    launches as run_params does; returns (summary, params, steady replica
    sweep pairs/s from the run's log, launches)."""
    import contextlib
    import io
    import re
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(text)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = run_simulation(params, out_dir=out_dir, device="cuda",
                                 verbose=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    TOTALS.update(_cuda.LAUNCHES)
    m = re.search(r"\(([-\d.na]+) steady", buf.getvalue())
    steady = float(m.group(1)) if m else float("nan")
    obs = summary.observables
    say(f"{phase}: {label} in {dt:.1f} s: {summary.sweeps_per_sec:.4f} "
        f"replica-sweep-pairs/s over the measured pairs, {steady:.4f} "
        f"steady (the pairs before the first exchange attempt left out), "
        f"exchange rate {summary.exchange_rate:.4f}, acceptance "
        f"{summary.acc_rate:.4f}, steady self-check max "
        f"{summary.max_precision_error:.3e} mean "
        f"{summary.mean_precision_error:.3e}, replica 0: "
        + ", ".join(f"{k} {v:.5f}" for k, v in obs.items())
        + f", launches {launches}")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}")
    nums = list(obs.values()) + [summary.max_precision_error,
                                 summary.sweeps_per_sec]
    if not all(v == v and abs(v) < float("inf") for v in nums):
        fail(f"{label}: a number is not finite: {obs}")
    if not 0.0 < summary.acc_rate < 1.0:
        fail(f"{label}: acceptance outside (0, 1)")
    return summary, params, steady, launches


def pt_doped(torch):
    """(c) the doped PT run (spool sink) with its rate, exchange rate,
    steady self-check and launches per pair; one more sweep pair of its
    final replicas under torch.profiler; then a short repulsive run of
    the same ladder (#4)."""
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.engine.sweep import sweep_pair
    from dqmc_tpu_torch.models import AttractiveHubbard
    out = Path(tempfile.mkdtemp(prefix="phase19_"))
    try:
        summary, params, _, launches = run_pt(
            torch, PT_DOPED, "the doped PT scale (12x12, nt=120, n_stab=5, "
            "6 betas 6.0-5.0, float32, f64 actions, sink = spool), 20 + "
            "4x10 pairs, 4 exchange attempts", NEED_PT, out / "doped")
        if not 0.0 < summary.exchange_rate <= 1.0:
            fail(f"phase 19: exchange rate {summary.exchange_rate} outside "
                 f"(0, 1]")
        hold_logs(params, out / "doped", 6, 4, phase="phase 19")
        pairs = 20 + 40
        say("phase 19: doped PT launches per replica-batch sweep pair: "
            + ", ".join(f"{k} {v / pairs:.1f}" for k, v in launches.items()))
        models = ladder(torch, AttractiveHubbard, torch.float32, 12, 120,
                        PT_BETAS)
        cfg = EngineConfig(nt=120, n_stab=5, use_pallas=True)
        _profiled(torch, "the doped PT ladder (6 replicas)",
                  lambda s: sweep_pair(models, cfg, s), summary.states, 1,
                  phase="phase 19", cpu=False)
        text = PT_DOPED + ("[hubbard]\nmodel = repulsive\n[simulation]\n"
                           "n_therms = 2\nn_bins = 1\n")
        rep, _, _, rl = run_pt(torch, text, "the same ladder, model = "
                               "repulsive, 2 + 1x10 pairs, 1 attempt",
                               ("cgs2_qr", "delayed_slice_2f"),
                               out / "repulsive")
        say("phase 19: repulsive PT launches per sweep pair: "
            + ", ".join(f"{k} {v / 12:.1f}" for k, v in rl.items()))
        return summary
    finally:
        shutil.rmtree(out, ignore_errors=True)


def pt_exchange(torch, states32):
    """(b) f64-action exchange attempts on the card from the doped run's
    final replicas, against an all-float64 replica set of the same fields
    with the same uniforms: the same decisions and fields; then six equal
    betas, where every pair must accept, the fields swap exactly and the
    signs travel."""
    import dataclasses
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.parallel import tempering as tt
    cfg = EngineConfig(nt=120, n_stab=5, use_pallas=True)
    m32 = ladder(torch, AttractiveHubbard, torch.float32, 12, 120, PT_BETAS)
    m64 = ladder(torch, AttractiveHubbard, torch.float64, 12, 120, PT_BETAS)
    s32, s64 = states32, f64_walkers(torch, m64, cfg, states32.fields)
    gen = tt.exchange_generator(19, 6)
    for attempt in (5, 6, 7, 8):
        u = tt.exchange_uniforms(gen, 6)
        t0 = time.perf_counter()
        s32, a32 = tt.replica_exchange(m32, cfg, s32, attempt, u,
                                       f64_actions=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        S = tt.exchange_actions(m64, cfg, s64, tt.partner_indices(6, attempt))
        s64, a64 = tt.replica_exchange(m64, cfg, s64, attempt, u)
        same = torch.equal(a32, a64) and torch.equal(s32.fields, s64.fields)
        say(f"phase 19: f64-action attempt {attempt} in {dt * 1e3:.1f} ms: "
            f"decisions {a32.int().tolist()}, all-float64 "
            f"{a64.int().tolist()}, S_cross - S_self "
            f"{[round(float(x), 3) for x in S[1] - S[0]]}, same {same}")
        if not same:
            fail("phase 19: the f64-action decisions differ from the "
                 "all-float64 replica set's")
    eq = ladder(torch, AttractiveHubbard, torch.float32, 12, 120, (5.5,) * 6)
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0, 1.0, -1.0], device="cuda")
    s = dataclasses.replace(states32, sign=signs)
    for attempt in (1, 2):
        p = tt.partner_indices(6, attempt).cuda()
        before = s
        s, acc = tt.replica_exchange(eq, cfg, s, attempt,
                                     tt.exchange_uniforms(gen, 6),
                                     f64_actions=True)
        ok = (bool(acc.all()) and torch.equal(s.fields, before.fields[p])
              and torch.equal(s.sign, before.sign[p]))
        say(f"phase 19: six equal betas, attempt {attempt}: every pair "
            f"accepted, fields and signs swapped exactly: {ok}")
        if not ok:
            fail("phase 19: equal betas did not swap exactly")


def pt_resume(torch):
    """(d) examples/tempering at its width (6x6, six betas, nt=50,
    n_stab=10; float32 with f64 actions, spool sink) at a cut depth with
    checkpoint_every = 1: straight, and stopped in thermalization pair 6
    (checkpoint after 5) and again in measured sweep 12 (checkpoint after
    bin 2), resumed each time: fields, G, every generator, the exchange
    generator, attempt and accepted bit for bit, the bins within
    RESUME_BIN_REL."""
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.io.checkpoint import peek_meta
    from dqmc_tpu_torch.parallel import tempering as tt
    params = Parameters(str(REPO / "examples" / "tempering" /
                            "parameters.in"))
    text = params.dumps() + ("[simulation]\nn_therms = 6\nn_sweeps = 5\n"
                             "n_bins = 4\ncheckpoint_every = 1\n"
                             "[io]\nsink = spool\n")
    need = NEED_PT
    out = Path(tempfile.mkdtemp(prefix="phase19r_"))
    real, calls = tt.sweep_pair, []

    def stopping(at):
        def step(*a, **k):
            calls.append(1)
            if len(calls) == at:
                raise _Stop
            return real(*a, **k)
        return step
    try:
        straight, *_ = run_pt(torch, text, "examples/tempering, 6 + 4x5 "
                              "pairs straight", need, out / "straight")
        for at in (6, 13):
            calls.clear()
            tt.sweep_pair = stopping(at)
            try:
                run_pt(torch, text, "stopped", (), out / "resumed")
                fail("phase 19: the stopped run was not stopped")
            except _Stop:
                pass
            finally:
                tt.sweep_pair = real
            meta = peek_meta(out / "resumed" / "checkpoint.npz")
            say(f"phase 19: stopped in its pair {at}: checkpoint at bin "
                f"{meta['bin']}, therm_done {meta['therm_done']}, therm "
                f"pair {meta['therm_sweep']}")
        resumed, *_ = run_pt(torch, text, "the same resumed", need,
                             out / "resumed")
        ma, mb = (peek_meta(out / d / "checkpoint.npz")
                  for d in ("straight", "resumed"))
        hold_chain(torch, "examples/tempering stopped twice and resumed, "
                   "against straight", straight.states, resumed.states,
                   phase="phase 19", **{k: ma[k] == mb[k] for k in (
                       "attempt", "accepted", "exchange_gen")})
        hold_bins(out / "straight", out / "resumed", 6, 4, phase="phase 19")
    finally:
        tt.sweep_pair = real
        shutil.rmtree(out, ignore_errors=True)


def pt_df_exchange(torch):
    """(e) one replica_exchange_df attempt at bench.py's headline PT scale
    (16x16, nt=160, betas 8.0-6.0), #7 in its df rebuilds, against the
    f64 actions' decisions on the same fields and uniforms."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine.df_sweep import (df_aux_build, init_state_df,
                                                stack_aux)
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.parallel import tempering as tt
    L, nt, betas = PT_HEADLINE
    cfg = EngineConfig(nt=nt, n_stab=5, use_pallas=True)
    m32 = ladder(torch, AttractiveHubbard, torch.float32, L, nt, betas)
    m64 = ladder(torch, AttractiveHubbard, torch.float64, L, nt, betas)
    aux = stack_aux([df_aux_build(square_lattice(L, L), U=4.0, t=1.0,
                                  mu=0.0, beta=b, nt=nt, device="cuda")
                     for b in betas])
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sdf = init_state_df(m32, aux, cfg, make_generators(11, 6, "cuda"))
    s64 = f64_walkers(torch, m64, cfg, sdf.fields)
    u = tt.exchange_uniforms(tt.exchange_generator(11, 6), 6)
    sdf, adf = tt.replica_exchange_df(aux, cfg, sdf, 1, u)
    s64, a64 = tt.replica_exchange(m64, cfg, s64, 1, u)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    TOTALS.update(_cuda.LAUNCHES)
    same = torch.equal(adf, a64) and torch.equal(sdf.fields, s64.fields)
    say(f"phase 19: df32 exchange at 16x16, nt=160, betas 8.0-6.0 "
        f"({time.perf_counter() - t0:.1f} s with the df init): decisions "
        f"{adf.int().tolist()}, f64 actions {a64.int().tolist()}, same "
        f"{same}, launches {launches}")
    if not same or not launches.get("df_qr_panel"):
        fail("phase 19: the df32 exchange disagrees or #7 did not launch")


PT_TIER = """
[Lattice]
L1 = 8
L2 = 8
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 4.0
nt = 20
n_therms = 1
n_sweeps = 1
n_bins = 1
n_stab = 5
seed = 11
dtype = float32
measure_precision = tf32
[ParallelTempering]
enabled = true
sweep_steps = 1
betas = 4.0, 3.8, 3.6, 3.4, 3.2, 3.0
"""


def pt_tier(torch):
    """(f) one tf32-tier measured segment of a PT run at 8x8, nt=20 (ns =
    64, so #8 runs in every fold) through run_simulation; then the stacked
    tier's G of the final fields, each replica against its own float64
    rebuild at n_stab = 1 (<= 1e-9 of its max|G|)."""
    import dataclasses
    from dqmc_tpu_torch.engine.parity import measurement_greens_fn_stacked
    from dqmc_tpu_torch.engine.state import EngineConfig
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.ops import tf32
    summary, *_ = run_pt(torch, PT_TIER, "8x8, nt=20, six betas 4.0-3.0, "
                         "measure_precision = tf32, 1 + 1x1 pairs",
                         NEED_PT + ("tf_qr_panel",))
    cfg = EngineConfig(nt=20, n_stab=5, use_pallas=True)
    m64 = ladder(torch, AttractiveHubbard, torch.float64, 8, 20,
                 (4.0, 3.8, 3.6, 3.4, 3.2, 3.0))
    G = measurement_greens_fn_stacked(m64, cfg, tf32)(summary.states)
    ref = f64_walkers(torch, m64, dataclasses.replace(cfg, n_stab=1),
                      summary.states.fields).G
    gap = ((G - ref).abs().amax(dim=(1, 2, 3))
           / ref.abs().amax(dim=(1, 2, 3)))
    say(f"phase 19: the stacked tf32 tier against each replica's float64 "
        f"rebuild: |dG|/max|G| per replica "
        f"{[f'{float(x):.2e}' for x in gap]} (<= 1e-9)")
    if not (gap <= 1e-9).all():
        fail("phase 19: the stacked tf32 tier disagrees with float64")


def phase_tempering(torch):
    """Phase 19: parallel tempering (parallel/tempering.py) on the card,
    parts (a)-(f) as the module docstring lists them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)

    def timed(part, fn):
        t0 = time.perf_counter()
        out = fn()
        say(f"phase 19 ({part}) took {time.perf_counter() - t0:.1f} s")
        return out
    timed("a", lambda: pt_sites(torch, gen))
    doped = timed("c", lambda: pt_doped(torch))
    timed("b", lambda: pt_exchange(torch, doped.states))
    timed("d", lambda: pt_resume(torch))
    timed("e", lambda: pt_df_exchange(torch))
    timed("f", lambda: pt_tier(torch))


# phase 20: walkers and replicas across devices and processes.  The
# headline (bench.py:31) at a cut depth: float32 on the fused engine
# (2 + 1x4 pairs), float64 on the per-slice engine (1 + 1x1 pairs); the
# doped PT scale at 2 + 1x10 pairs (one exchange attempt)
SPLIT_HEADLINE = """
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
n_bins = 1
seed = 20
[io]
sink = spool
[walkers]
n_walkers = 16
"""
SPLIT_CASES = (  # (label, extra keys, kernels of the path)
    ("float32 fused", "[simulation]\ndtype = float32\nengine = fused\n"
     "n_therms = 2\nn_sweeps = 4\n", ("cgs2_qr", "fused_wrap",
                                      "fused_sites")),
    ("float64 per slice", "[simulation]\ndtype = float64\nengine = slice\n"
     "n_therms = 1\nn_sweeps = 1\n", ("delayed_slice",)))
SPLIT_PT = PT_DOPED + "[simulation]\nn_therms = 2\nn_bins = 1\n"
# the float64 bins of two splits: index_add_'s float64 atomics add in any
# order, a wrong walker differs at O(1)
SPLIT_BIN_REL_F64 = 1e-12
SPLIT_JOIN_S = 300


def _split_rank(rank: int, port: int, jobs, go, conn) -> None:
    """One process of phase 20's two-process runs on the card: it reaches
    the card, waits for ``go``, then runs ``jobs`` (parameter text, output
    directory) in the group [distributed] forms and sends back each run's
    fields, summary and launch counts (a failed run exits non-zero)."""
    import torch
    sys.path.insert(0, str(REPO))
    exact_matmuls(torch)
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    _cuda.lib()
    torch.zeros(1, device="cuda")
    go.wait()
    out = []
    for text, out_dir in jobs:
        params = Parameters.from_string(
            text + f"[distributed]\nnum_processes = 2\nprocess_id = "
            f"{rank}\ncoordinator_address = 127.0.0.1:{port}\n"
            f"timeout = 120\n")
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        s = run_simulation(params, out_dir=out_dir, device="cuda",
                           verbose=False)
        torch.cuda.synchronize()
        out.append(dict(fields=s.states.fields.cpu().numpy(),
                        rate=s.sweeps_per_sec, acc=s.acc_rate,
                        err=s.max_precision_error,
                        exchange=s.exchange_rate,
                        launches=dict(_cuda.LAUNCHES)))
    conn.send(out)


class SplitRanks:
    """Phase 20's two processes (spawned, daemons), sharing cuda:0."""

    def __init__(self, jobs):
        import socket
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.go = ctx.Event()
        self.procs, self.conns = [], []
        for rank in range(2):
            conn, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_split_rank, daemon=True,
                            args=(rank, port, jobs, self.go, child))
            p.start()
            child.close()
            self.procs.append(p)
            self.conns.append(conn)

    def run(self):
        """Start the jobs and wait for both processes; a process that
        fails or outlives SPLIT_JOIN_S fails the phase."""
        self.go.set()
        t0 = time.perf_counter()
        outs = []
        for rank, (p, conn) in enumerate(zip(self.procs, self.conns)):
            left = max(1.0, SPLIT_JOIN_S - (time.perf_counter() - t0))
            try:
                if not conn.poll(left):
                    raise EOFError
                outs.append(conn.recv())
            except EOFError:
                p.join(5)
                for q in self.procs:
                    q.terminate()
                fail(f"phase 20: process {rank} of 2 sent nothing in "
                     f"{SPLIT_JOIN_S} s (exit code {p.exitcode})")
            p.join(30)
            if p.is_alive() or p.exitcode != 0:
                p.terminate()
                fail(f"phase 20: process {rank} of 2 exited with "
                     f"{p.exitcode}")
        for out in outs:
            for job in out:
                TOTALS.update(job["launches"])
        return time.perf_counter() - t0, outs


def split_run(torch, text, out_dir, need, devices=None):
    """One in-process run of phase 20 (``devices``: its chunks), the
    launch counters set to 0 just before and read just after."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    s = run_simulation(Parameters.from_string(text), out_dir=out_dir,
                       device="cuda", verbose=False, devices=devices)
    torch.cuda.synchronize()
    TOTALS.update(_cuda.LAUNCHES)
    missing = [k for k in need if not _cuda.LAUNCHES[k]]
    if missing:
        fail(f"phase 20: kernels of the path not launched: {missing}")
    return s


def split_bins(dir_a, dir_b, W):
    """(arrays bit for bit, arrays, the largest gap of an array over its
    largest value, that array's name) between two runs' spool logs."""
    import numpy as np
    from dqmc_tpu_torch.io.spool import read_bins
    worst, exact, total, where = 0.0, 0, 0, ""
    for w in range(W):
        A = read_bins(dir_a / f"data_{w}.spool")
        B = read_bins(dir_b / f"data_{w}.spool")
        if sorted(A) != sorted(B) or not A:
            fail(f"phase 20: walker {w}: bins {sorted(A)} against "
                 f"{sorted(B)}")
        for b in A:
            for group, vals in A[b].items():
                for name, x in vals.items():
                    x, y = np.asarray(x), np.asarray(B[b][group][name])
                    scale = max(float(np.abs(x).max()), 1e-300)
                    g = float(np.abs(x - y).max()) / scale
                    if g > worst:
                        worst, where = g, f"{group}/{name}"
                    exact += bool(np.array_equal(x, y))
                    total += 1
    return exact, total, worst, where


def phase_split(torch, card):
    """Phase 20: the headline split three ways, one process, its walkers
    in two chunks on [cuda:0, cuda:0], and two processes on gloo sharing
    cuda:0 with 8 walkers each, in float32 (fused) and float64 (per
    slice), and one more float32 pair on [cuda:0, cuda:0] traced into
    profile_dir; the doped PT scale
    in one process and in two processes of 3 replicas.  float64: fields
    bit for bit, bins within SPLIT_BIN_REL_F64 of each array's largest
    value; float32 and PT: fields bit for bit, bins within
    RESUME_BIN_REL; PT's exchange rate equal; the trace names the fused
    kernels; the two processes' summed rate against one process's,
    printed."""
    import numpy as np
    out = Path(tempfile.mkdtemp(prefix="phase20_"))
    jobs = [(SPLIT_HEADLINE + extra, str(out / f"mp{i}"))
            for i, (_, extra, _) in enumerate(SPLIT_CASES)]
    jobs.append((SPLIT_PT, str(out / "mp_pt")))
    ranks = SplitRanks(jobs)
    try:
        # the one-process float32 run, whose rate (d) compares, last,
        # when the two processes wait on the card with their imports done
        one, two = {}, {}
        t0 = time.perf_counter()
        for i, (label, extra, need) in enumerate(SPLIT_CASES):
            two[i] = split_run(torch, SPLIT_HEADLINE + extra,
                               str(out / f"dev{i}"), need,
                               devices=["cuda:0", "cuda:0"])
        # (c) one measured float32 pair over [cuda:0, cuda:0], traced
        t1 = time.perf_counter()
        split_run(torch, SPLIT_HEADLINE + SPLIT_CASES[0][1]
                  + f"n_therms = 0\nn_sweeps = 1\nprofile_dir = "
                  f"{out / 'trace'}\n", str(out / "traced"),
                  SPLIT_CASES[0][2], devices=["cuda:0", "cuda:0"])
        t_trace = time.perf_counter() - t1
        pt_one = split_run(torch, SPLIT_PT, str(out / "one_pt"), NEED_PT)
        for i in reversed(range(len(SPLIT_CASES))):
            one[i] = split_run(torch, SPLIT_HEADLINE + SPLIT_CASES[i][1],
                               str(out / f"one{i}"), SPLIT_CASES[i][2])
        t_here = time.perf_counter() - t0
        wall, ranked = ranks.run()
        say(f"phase 20: the runs in this process took {t_here:.1f} s (the "
            f"traced one {t_trace:.1f} s), the two processes' {wall:.1f} s")
        for i, (label, _, _) in enumerate(SPLIT_CASES):
            ref = one[i].states.fields.cpu().numpy()
            mp_fields = np.concatenate([r[i]["fields"] for r in ranked])
            same = {"[cuda:0, cuda:0]": np.array_equal(
                        two[i].states.fields.cpu().numpy(), ref),
                    "two processes": np.array_equal(mp_fields, ref)}
            bins = {k: split_bins(out / f"one{i}", out / d, 16)
                    for k, d in (("[cuda:0, cuda:0]", f"dev{i}"),
                                 ("two processes", f"mp{i}"))}
            rel = (SPLIT_BIN_REL_F64 if "float64" in label
                   else RESUME_BIN_REL)
            rate1, rate2 = one[i].sweeps_per_sec, ranked[0][i]["rate"]
            say(f"phase 20: headline {label}, 16 walkers: fields bit for "
                f"bit against one process: " + ", ".join(
                    f"{k} {v}" for k, v in same.items()) + "; bins: "
                + ", ".join(f"{k} {e} of {t} arrays bit for bit, largest "
                            f"gap {w:.3e} of max|x| ({n})"
                            for k, (e, t, w, n) in bins.items())
                + f" (<= {rel:.0e}); acceptance {one[i].acc_rate:.6f} / "
                f"{two[i].acc_rate:.6f} / {ranked[0][i]['acc']:.6f}, "
                f"self-check max {one[i].max_precision_error:.3e} / "
                f"{two[i].max_precision_error:.3e} / "
                f"{ranked[0][i]['err']:.3e}; rate one process "
                f"{rate1:.3f}, two chunks {two[i].sweeps_per_sec:.3f}, two "
                f"processes summed {rate2:.3f} walker-sweep-pairs/s "
                f"(ratio {rate2 / rate1:.3f}) on {card}")
            if not all(same.values()):
                fail(f"phase 20: {label}: a split run's fields part from "
                     f"the unsplit run's")
            if any(b[2] > rel for b in bins.values()):
                fail(f"phase 20: {label}: a split run's bins differ")
        ref = pt_one.states.fields.cpu().numpy()
        mp_fields = np.concatenate([r[-1]["fields"] for r in ranked])
        e, t, w, n = split_bins(out / "one_pt", out / "mp_pt", 6)
        rates = [pt_one.exchange_rate, ranked[0][-1]["exchange"],
                 ranked[1][-1]["exchange"]]
        say(f"phase 20: doped PT (12x12, nt=120, six betas, float32, f64 "
            f"actions), 2 + 1x10 pairs, one exchange attempt: two "
            f"processes x 3 replicas against one process: fields bit for "
            f"bit {np.array_equal(mp_fields, ref)}, exchange rate "
            f"{rates}, bins {e} of {t} arrays bit for bit, largest gap "
            f"{w:.3e} of max|x| ({n}; <= {RESUME_BIN_REL:.0e}); rate one "
            f"process {pt_one.sweeps_per_sec:.3f}, two processes "
            f"{ranked[0][-1]['rate']:.3f} replica-sweep-pairs/s")
        if not (np.array_equal(mp_fields, ref) and len(set(rates)) == 1
                and w <= RESUME_BIN_REL):
            fail("phase 20: the two-process PT run parts from the "
                 "one-process run")
        trace = (out / "trace" / "trace_0.json").read_text()
        named = {k: k in trace for k in ("site_loop_kernel",
                                         "wrap_gemm_kernel")}
        say(f"phase 20: profile_dir trace of the first measured bin "
            f"({len(trace) / 2**20:.1f} MiB): names {named}")
        if not all(named.values()):
            fail("phase 20: the profile_dir trace does not name the fused "
                 "kernels")
    finally:
        for p in ranks.procs:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(out, ignore_errors=True)


# phase 21: the per-slice engine past the 32x32 lattice.  The site loops'
# shapes (L1, L2): 34x34 (ns = 1156, not a multiple of 32), 40x40 and
# 32x64, the kernels' cap (ops/kernels.py MAX_SITES = 2048); K1's float32
# sizes: 1156 (padded to 1184), 1600 and its cap, 1728
WIDE_LATTICES = ((34, 34), (40, 40), (32, 64))
WIDE_QR = (1156, 1600, 1728)
WIDE_W = 2
WIDE_NS = 1600  # the 40x40 run's, at which the kernels are timed
# the 40x40 configuration of (b): attractive, U = 4, mu = 0, beta = 4,
# nt = 80, n_stab = 5, W = 4, float32, the per-slice engine (ns > 512)
# with site_update = pallas (#3), density, doubleOcc, swave and
# densityCorr (the defaults), into spool logs; 1 + 2x1 pairs
WIDE = """
[Lattice]
L1 = 40
L2 = 40
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 4.0
nt = 80
n_stab = 5
n_therms = 1
n_bins = 2
n_sweeps = 1
dtype = float32
seed = 42
[walkers]
n_walkers = 4
[io]
sink = spool
"""
NEED_WIDE = ("cgs2_qr", "delayed_slice")


def wide_inputs(torch, gen, L1, L2, flavors):
    """One slice's inputs on an L1 x L2 lattice at the stretch's dtau =
    0.05 (beta = 1, nt = 20): G (W, 1 or 2, ns, ns) of fresh walkers built
    in float64 (K1 does not take float32 past ns = 1728; float32 cases take
    it rounded), the slice-start fields, per-walker visit orders, proposal
    draws and uniforms (float64), and per-walker couplings (g, alpha)."""
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard, RepulsiveHubbard
    W = WIDE_W
    cls = AttractiveHubbard if flavors == 1 else RepulsiveHubbard
    model = cls.build(square_lattice(L1, L2), U=4.0, t=1.0, mu=0.0,
                      beta=1.0, nt=20, dtype=torch.float64, device="cuda")
    states = init_state(model, EngineConfig(nt=20, n_stab=5),
                        make_generators(5, W, "cuda"))
    ns = model.n_sites
    orders = torch.argsort(torch.rand((W, ns), generator=gen, device="cuda"),
                           dim=-1)
    props = torch.randint(0, 3, (W, ns), generator=gen, device="cuda")
    us = torch.rand((W, ns), generator=gen, device="cuda",
                    dtype=torch.float64)
    scale = 1.0 + 0.05 * torch.linspace(-1.0, 1.0, W, device="cuda",
                                        dtype=torch.float64)
    return (model.g * scale, model.alpha.expand(W), orders, props, us,
            states.G, states.fields[:, 0])


def hold_wide(torch, tag, fn, args, kw, dtype):
    """A site-update wrapper's kernel against its twin on one slice:
    float64 decisions (and signs) identical and G within 1e-9 of max|G|,
    float32 decisions <= 1% apart; the same bits on a second call; each
    walker's bits alone (W = 1) as in the batch.  Returns |dG| max."""
    out = fn(*args, **kw)
    again = fn(*args, **kw)
    want = fn(*args, plain=True, **kw)
    torch.cuda.synchronize()
    W = args[0].shape[0]

    def one(w):
        return tuple(x if i == 2 and x.dim() == 1 else x[w:w + 1]
                     for i, x in enumerate(args))
    alone = all(same_bits(fn(*one(w), **kw), tuple(x[w:w + 1] for x in out))
                for w in range(W))
    same = same_bits(out, again)
    Gk, fk, ak = out[:3]
    Gp, fp, ap = want[:3]
    ns = Gp.shape[-1]
    mism = int((fk != fp).sum())
    signs = int((out[3] != want[3]).sum()) if len(out) > 3 else 0
    dacc = int(((ak - ap).abs() * ns).round().sum())
    gap = float((Gk - Gp).abs().max())
    rel = gap / float(Gp.abs().max())
    accepted = int((ap * ns).round().sum())
    line = (f"phase 21: {tag}: {accepted} of {fk.numel()} accepted, "
            f"mismatched decisions {mism}, signs {signs}, |dG|/max|G| "
            f"{rel:.3e}; two calls bit-equal: {same}; each walker alone "
            f"bit-equal: {alone}")
    if dtype == torch.float64:
        say(line + " (f64: decisions identical, < 1e-9)")
        if mism or signs or dacc or not rel < 1e-9:
            fail(f"phase 21: {tag} disagrees with its twin (f64)")
    else:
        say(line + " (f32: <= 1% of the decisions)")
        if mism > 0.01 * fk.numel():
            fail(f"phase 21: {tag} f32 decisions disagree with the twin")
    if not 0 < accepted < fk.numel():
        fail(f"phase 21: {tag}: the twin needs acceptances and rejections")
    if not (same and alone):
        fail(f"phase 21: {tag}: other bits on a second call or alone")
    return gap


def wide_sites(torch, gen, report):
    """(a) #3 and #6 with one flavor and #4 with two, one slice each at
    WIDE_LATTICES in both float types (#3 and #4 in one shared order at
    rank 32, a short last group at ns = 1156; #6 in per-walker orders),
    held to hold_wide's contracts; then #3, #4 and #6 timed alone at the
    40x40 run's (4, 1600, 32) in float32, in device time, beside the twin
    and the bound, kept under each entry's ``shapes``."""
    from dqmc_tpu_torch.ops import kernels as tk
    gaps, timing = {}, {}
    cases = (("#3", tk.metropolis_slice_update_batched, 1, True),
             ("#6", tk.metropolis_slice_update, 1, False),
             ("#4", tk.metropolis_slice_update_batched_2f, 2, True))
    for L1, L2 in WIDE_LATTICES:
        ns = L1 * L2
        for flavors in (1, 2):
            base = wide_inputs(torch, gen, L1, L2, flavors)
            for label, fn, nfl, shared in cases:
                if nfl != flavors:
                    continue
                kw = dict(k_delay=32, exact_rank=True) if shared else {}
                for dtype in (torch.float64, torch.float32):
                    g, alpha, orders, props, us, G, fields = base
                    args = (g.to(dtype), alpha.to(dtype),
                            orders[0] if shared else orders, props,
                            us.to(dtype), G.to(dtype), fields)
                    tag = (f"{label} {str(dtype)[6:]} W={WIDE_W} ns={ns} "
                           + ("k=32 shared order" if shared
                              else "per-walker orders"))
                    gap = hold_wide(torch, tag, fn, args, kw, dtype)
                    if ns == WIDE_NS:
                        if dtype == torch.float64:
                            gaps[label] = gap
                        else:
                            timing[label] = args
    # the times at the 40x40 run's shape: W = 4 (each walker's cluster on
    # its own SMs), the two walkers' inputs twice
    K, P = tk.KERNELS, tk.PLAIN
    W, n, k = 4, WIDE_NS, 32
    for label, name, nfl in (("#3", "delayed_slice", 1),
                             ("#4", "delayed_slice_2f", 2),
                             ("#6", "rank1_sites", 1)):
        g, alpha, order, props, us, G, fields = (
            x if i == 2 and x.dim() == 1 else torch.cat([x, x])
            for i, x in enumerate(timing[label]))
        order = order.to(torch.int32).contiguous()
        dt = G.dtype
        _, gb, delta = tk.visit_factors(g, alpha, fields,
                                        order.long().expand(W, n), props,
                                        dt, nfl)
        gb, delta = gb.contiguous(), delta.contiguous()
        G = (G[:, 0] if nfl == 1 else G).contiguous()
        acc = torch.empty((W, n), dtype=dt, device="cuda")
        sgn = torch.ones((W,), dtype=dt, device="cuda")
        if name == "rank1_sites":
            kern = lambda: K.rank1(G.clone(), acc, order, gb, delta, us)
            plain = lambda: P.rank1(G.clone(), acc.clone(), order, gb,
                                    delta, us)
            K.rank1(G.clone(), acc, order, gb, delta, us)
            ops, nbytes = 2 * n * n * int(acc.sum()), 4 * W * (2 * n * n
                                                               + 5 * n)
        else:
            sl = (acc, order, gb, delta, us, k, sgn)
            Gt = G.clone()
            kern = lambda: K.delayed_slice(Gt, *sl)
            plain = lambda: P.delayed_slice(G.clone(), acc.clone(),
                                            *sl[1:-1], sgn.clone())
            ops, nbytes = slice_bound(W, n, k, nfl)
        ms = device_ms(kern, 2)
        plain_ms = cuda_ms(plain, 1)
        record(report, name, max_abs_err=gaps[label], ms=ms,
               plain_ms=plain_ms, ops=ops, nbytes=nbytes,
               shape=(W, n, "float32") if name == "rank1_sites"
               else (W, n, k, "float32"), main=False)
        r = report[name]["shapes"][-1]
        say(f"phase 21: {name} ({label}) f32 W={W} ns={n}, one slice: "
            f"kernel {ms:.4f} ms (device time), plain {plain_ms:.3f} ms, "
            f"no single library call, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")


def wide_qr(torch, gen, report):
    """(a) K1 in float32 at (2, n) for n in WIDE_QR to phase 2's
    tolerances (tests/test_qr_kernel.py's quality thresholds, |d(Q,R)| <
    1e-3 against the twin), the same bits on a second call and for each
    matrix alone; then timed at the 40x40 run's (4, 1600) beside the twin,
    torch.linalg.qr and the bound."""
    from dqmc_tpu_torch.ops import qr_kernel as qk
    for n in WIDE_QR:
        A = graded(gen, WIDE_W, n, torch.float32)
        qr_quality(torch, qk, A, "phase 21")
        got = qk.cgs2_qr_inv(A)
        again = qk.cgs2_qr_inv(A)
        want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
        alone = all(same_bits(qk.cgs2_qr_inv(A[w:w + 1]),
                              tuple(x[w:w + 1] for x in got))
                    for w in range(WIDE_W))
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        same = same_bits(got, again)
        say(f"phase 21: K1 f32 ({WIDE_W}, {n}, {n}) |d(Q,R)| vs twin "
            f"{err:.3e} (< 1e-3); two calls bit-equal: {same}; each matrix "
            f"alone bit-equal: {alone}")
        if not (err < 1e-3 and same and alone):
            fail(f"phase 21: K1 f32 at ({WIDE_W}, {n}) against its twin, "
                 f"a second call or a matrix alone")
    B, n = 4, WIDE_NS
    A = graded(gen, B, n, torch.float32)
    want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
    got = qk.cgs2_qr_inv(A)
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    ms = cuda_ms(lambda: qk.cgs2_qr_inv(A), 5)
    plain_ms = cuda_ms(lambda: qk.padded_qr(A, True, qk.cgs2_qr_plain), 1)
    lib_ms = cuda_ms(lambda: torch.linalg.qr(A), 5)
    record(report, "cgs2_qr", max_abs_err=err, ms=ms, plain_ms=plain_ms,
           ops=(4 + 1 / 3) * n ** 3 * B, nbytes=4 * B * n * n * 4,
           library_ms=lib_ms, shape=(B, n, n), main=False)
    r = report["cgs2_qr"]["shapes"][-1]
    say(f"phase 21: K1 f32 ({B}, {n}, {n}): kernel {ms:.3f} ms per "
        f"cgs2_qr_inv, twin {plain_ms:.3f} ms, torch.linalg.qr "
        f"{lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


# the device split of a 40x40 pair: kernel-name substrings by family
WIDE_FAMILIES = (("K1", tuple(key for key, _ in K1_STAGES[:5])),
                 ("#3 delayed_slice", ("delayed_slice_kernel",)),
                 ("#6 rank1_sites", ("rank1_sites_kernel",)),
                 ("GEMMs (the wraps and folds)", ("gemm", "Gemm", "GEMM")))


def wide_pair_split(torch, summary, report):
    """One more float32 pallas pair from the run's final walkers under
    torch.profiler (device activity alone): device busy by family (K1,
    #3, the torch GEMMs, the rest) and launches per pair, which go into
    the kernels line's 40x40 shapes."""
    from torch.profiler import ProfilerActivity, profile
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine.sweep import sweep_pair
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    from dqmc_tpu_torch.run import make_engine_config
    dev = torch.device("cuda")
    params = Parameters.from_string(WIDE)
    model = MODEL_REGISTRY["attractive"].from_params(
        params, square_lattice(40, 40), dtype=torch.float32, device=dev)
    cfg = make_engine_config(params, dev, 5)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_pair(model, cfg, summary.states)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    rows = device_rows(prof)
    busy = sum(e.us for e in rows) / 1e6
    fam = Counter()
    for e in rows:
        name = next((f for f, keys in WIDE_FAMILIES
                     if any(key in e.key for key in keys)), "the rest")
        fam[name] += e.us / 1e6
    say(f"phase 21: 40x40 f32 pallas, one profiled sweep pair: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1.0 - busy / wall:.4f}; launches per pair {launches}")
    for name, s in fam.most_common():
        say(f"phase 21:   {name:30s} {s:8.3f} s ({s / busy:6.1%})")
    for name in ("cgs2_qr", "delayed_slice"):
        for r in report.get(name, {}).get("shapes", []):
            if r["shape"][:2] == [4, WIDE_NS]:
                r["launches_per_40x40_pair"] = launches.get(name, 0)


def wide_runs(torch, report):
    """(b) the 40x40 configuration through run_simulation: float32 with
    site_update = pallas (#3 + K1) into spool logs, 1 + 2x1 pairs, one
    profiled pair after it; float64 at W = 2 (#3; Householder QR), 0 +
    1x1; float32 with site_update = scan (#6 + K1), 0 + 1x1.  Each:
    the kernels launched, acceptance in (0, 1), finite observables, the
    spool logs holding every bin; float64: the steady self-check <= its
    err_warn, 1e-6.  float32: each walker's final G within TAU_F32_REL of
    its max|G| of the float64 chain's G on the same fields (n_stab = 1);
    its steady self-check is printed beside err_warn (1e-2), not gated:
    this float32 configuration reads 1e-2 to 1e-1 there with K1 or
    Householder, #3 or #6, n_stab 1 to 5, and after 1 to 40
    thermalization pairs (scripts/wide_selfcheck.py), as the JAX
    package's float32 headline reads 10.8 on the TPU (BENCH_r05.json)."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    out = Path(tempfile.mkdtemp(prefix="phase21_"))
    try:
        f64 = ("[simulation]\ndtype = float64\nn_therms = 0\nn_bins = 1\n"
               "[walkers]\nn_walkers = 2\n")
        scan = ("[simulation]\nsite_update = scan\nn_therms = 0\n"
                "n_bins = 1\n")
        for text, label, need, W, bins, warn, tag in (
                (WIDE, "40x40 beta=4 nt=80 n_stab=5 W=4 f32, engine = auto "
                 "(per slice), site_update = pallas (#3), sink = spool, 1 + "
                 "2x1 pairs", NEED_WIDE, 4, 2, 1e-2, "f32"),
                (WIDE + f64, "the same in float64 at W=2 (#3, Householder "
                 "QR), 0 + 1x1 pairs", ("delayed_slice",), 2, 1, 1e-6,
                 "f64"),
                (WIDE + scan, "the same in float32 with site_update = scan "
                 "(#6), 0 + 1x1 pairs", ("cgs2_qr", "rank1_sites"), 4, 1,
                 1e-2, "scan")):
            summary = run_params(torch, text, label, need, "phase 21",
                                 out_dir=out / tag)
            per_pair = {k: v / (bins + (tag == "f32"))
                        for k, v in _cuda.LAUNCHES.items() if v}
            err = summary.max_precision_error
            if tag == "f64":
                say(f"phase 21: {tag}: steady self-check max {err:.3e} (<= "
                    f"{warn:.0e})")
                if not err <= warn:
                    fail(f"phase 21: {tag}: steady self-check {err:.3e} "
                         f"above err_warn {warn:.0e}")
            else:
                params = Parameters.from_string(text)
                G64, _ = _f64_rebuild(torch, params, summary.states.fields)
                G32 = summary.states.G.double()
                rel = ((G32 - G64).abs().amax(dim=(1, 2, 3))
                       / G64.abs().amax(dim=(1, 2, 3)))
                say(f"phase 21: {tag}: steady self-check max {err:.3e} "
                    f"(err_warn {warn:.0e}: printed, not gated); per walker "
                    f"max|G_f32 - G_f64| / max|G_f64| of the final fields "
                    + ", ".join(f"{x:.3e}" for x in rel.tolist())
                    + f" (<= {TAU_F32_REL:.0e})")
                if not bool((rel <= TAU_F32_REL).all()):
                    fail(f"phase 21: {tag}: the float32 G is farther from "
                         f"the float64 chain's than {TAU_F32_REL}")
            hold_logs(Parameters.from_string(text), out / tag, W, bins,
                      phase="phase 21")
            say(f"phase 21: {tag}: launches per sweep pair (the first "
                f"Green's function's K1 calls included) {per_pair}")
            if tag == "f32":
                wide_pair_split(torch, summary, report)
            for r in report.get("rank1_sites", {}).get("shapes", []):
                if tag == "scan" and r["shape"][:2] == [4, WIDE_NS]:
                    r["launches_per_40x40_pair"] = per_pair.get(
                        "rank1_sites", 0)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_wide(torch, report):
    """Phase 21: K1, #3, #4 and #6 past the 32x32 lattice, parts (a) and
    (b) as the module docstring lists them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    for part, fn in (("a, K1", lambda: wide_qr(torch, gen, report)),
                     ("a, site loops", lambda: wide_sites(torch, gen,
                                                          report)),
                     ("b", lambda: wide_runs(torch, report))):
        t0 = time.perf_counter()
        fn()
        say(f"phase 21 ({part}) took {time.perf_counter() - t0:.1f} s")


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
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
          19, 20, 21)
# the phases that run, in this order after phase 14, while phase 16 runs
# in a process of its own: phase 16 is host-bound (~220 s of launches), as
# are these, and none of them profiles the card but phase 15's two blocks
# of elementwise glue (phase 17's tau sweep read 2x its device time beside
# it: two processes' kernels share the card by time slices); every kernel
# time of the kernels line is taken before it starts
BESIDE_16 = (4, 11, 15)


def exact_matmuls(torch) -> None:
    """No TF32 in torch's float32 products (the twins and the engines'
    torch glue)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _side_phase(phase: int, conn) -> None:
    """Entry point of SidePhase's process: run ``phase`` and send back
    its launch counts (a failed check exits non-zero first)."""
    import torch
    sys.path.insert(0, str(REPO))
    exact_matmuls(torch)
    t0 = time.perf_counter()
    {16: phase_tier_split}[phase](torch)
    say(f"phase {phase}: done in {time.perf_counter() - t0:.1f} s in its "
        f"own process")
    conn.send(dict(TOTALS))


class SidePhase:
    """A phase run in a spawned process of its own (a daemon: it ends
    with this script) beside the phases in BESIDE_16; ``join`` waits for
    it, fails if it failed and adds its launch counts to TOTALS."""

    def __init__(self, phase: int):
        ctx = mp.get_context("spawn")
        self.phase, self.t0 = phase, time.perf_counter()
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_side_phase, args=(phase, child),
                                daemon=True)
        self.proc.start()
        child.close()
        say(f"phase {phase}: started in a process of its own, beside "
            f"phases {', '.join(map(str, BESIDE_16))}")

    def join(self) -> None:
        self.proc.join()
        if self.proc.exitcode != 0:
            fail(f"phase {self.phase} (its own process) exited with "
                 f"{self.proc.exitcode}")
        TOTALS.update(self.conn.recv())
        say(f"phase {self.phase} took {time.perf_counter() - self.t0:.1f} "
            f"s (in its own process)")


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

    exact_matmuls(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    gen14 = torch.Generator(device="cuda")
    gen14.manual_seed(14)
    report = {}
    steps = ((2, lambda: phase_qr(torch, gen, report)),
             (3, lambda: phase_block(torch, gen, report)),
             (5, lambda: phase_headline(torch, card)),
             (6, lambda: phase_sites(torch, gen, report)),
             (7, lambda: phase_stretch(torch)),
             (8, lambda: phase_basic_slice(torch)),
             (9, lambda: phase_profile(torch)),
             (10, lambda: phase_new_kernels(torch, report)),
             (12, lambda: phase_repulsive_headline(torch, card)),
             (13, lambda: phase_fused_submatrix(torch, card)),
             (14, lambda: phase_mw_panels(torch, gen14, report)),
             (16, None),
             (4, lambda: phase_main(torch)),
             (11, lambda: phase_repulsive(torch)),
             (15, lambda: phase_df32_headline(torch)),
             (17, lambda: phase_tau(torch)),
             (18, lambda: phase_checkerboard(torch)),
             (19, lambda: phase_tempering(torch)),
             (20, lambda: phase_split(torch, card)),
             (21, lambda: phase_wide(torch, report)))
    side = None
    for phase, run in steps:
        if phase not in phases:
            continue
        if side is not None and phase not in BESIDE_16:
            side.join()
            side = None
        if run is None:
            side = SidePhase(phase)
            continue
        t1 = time.perf_counter()
        run()
        say(f"phase {phase} took {time.perf_counter() - t1:.1f} s")
    if side is not None:
        side.join()
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
