#!/usr/bin/env python3
"""Split a one-launch seed kernel into its stages, and hold a redesigned
kernel against its seed, on the card.

A seed kernel (the one an earlier commit shipped) ran a whole piece of
work in one launch, so no profiler can split it.  This script takes the
seed's source, builds it several times with one stage stubbed out in each
build (each with its own nvcc, in parallel), and times every build through
its C entry points.  The differences give each stage's share.  The stubbed
builds compute wrong results; only their times are read.

K1, the one-CTA-per-matrix CGS2 QR (before its grid-wide redesign): builds
without the two block projection passes, without the in-panel column loop
and without the zero fill of R, timed through ``dqmc_cgs2_qr_f32`` with and
without R^{-1}:

    git show <commit>:dqmc_tpu_torch/csrc/cgs2_qr.cu > old_cgs2_qr.cu
    python3 scripts/seed_split.py k1 --source old_cgs2_qr.cu

The fused site loop (#2, #2b) with one CTA per walker (before its cluster
redesign), given its ``fused_block.cu``:

    git show <commit>:dqmc_tpu_torch/csrc/fused_block.cu > old_fused_block.cu
    python3 scripts/seed_split.py sites --source old_fused_block.cu \\
        [--parts split,barriers,bits,times]

- ``split``: builds without the rank-k flush and without the visits (the
  second keeps one visit in k, whose U/V slot the flush reads), timed at
  (16, 256, 32) and (16, 448, 32) float32 with one and two flavors;
- ``barriers``: the round trip of a cluster barrier (``cluster.sync()``,
  that is ``barrier.cluster.arrive`` + ``wait``) at cluster sizes 2, 4, 8
  and 16 against a ``__syncthreads()``, with 32 and 256 threads per CTA,
  alone and after one store per thread into a peer's shared memory, over
  16 clusters;
- ``bits``: the seed's site loops against the checkout's
  (``dqmc_tpu_torch/csrc/fused_block.cu``) on the same inputs, one slice:
  whether G, the accept mask and the sign are equal bit for bit, for one
  and two flavors in both float types, at the shapes both take;
- ``times``: both, alternating (seed, checkout, checkout, seed) at
  ``chip_smoke.py``'s phase-10 shapes, per slice in CUDA events.

The per-slice engine's delayed site loop (#3, #4) as groups of k visits,
each one launch of the visit kernel and one of the rank-k flush (before
its one-launch cluster redesign), given that commit's ``site_update.cu``
and the ``rank_k_flush.cuh`` it includes, in one directory:

    mkdir old && for f in site_update.cu rank_k_flush.cuh; do
        git show <commit>:dqmc_tpu_torch/csrc/$f > old/$f; done
    python3 scripts/seed_split.py delayed --source old/site_update.cu \\
        [--parts split,bits,times,probes]

- ``split``: device time (``chip_smoke.device_ms``: a CUDA graph of calls
  between two events) of the seed's pieces at the engine's shapes: one
  group's visits, one group's flush, ``Gw.baddbmm_(U.mT, V)`` for the same
  flush, and the whole slice as the seed ran it (the twin loop of
  ``ops/kernels.py delayed_slice_plain`` on the seed's pieces);
- ``bits``: the seed's slice against the checkout's on the same inputs
  (spread ratios, rejections and, with two flavors, sign flips): whether
  G, the accept flags and the sign are equal bit for bit, one and two
  flavors, both float types, at (4, 36) per walker (groups of 32 + 4),
  (4, 36, 4), (32, 64), (16, 256) and (4, 1024); then the seed's rank-k
  flush against the checkout's on random operands;
- ``times``: both slices alternating (seed, checkout, checkout, seed) at
  the shapes of ``split``, in device time, and a build of the checkout's
  slice without its flush; then the seed's flush, the checkout's
  (``submatrix_flush``) and ``baddbmm_`` alternating;
- ``probes`` (not in the default parts): the checkout's slice at the
  stretch shape against builds whose flush by owner copies V from its own
  CTA, copies no V, moves no G, takes its FMA operands from registers, or
  runs twice (wrong results; only the times are read).

The submatrix scheme before its redesign -- #5 as three launches per group
of k visits (one warp per walker for the decisions, an operand kernel, the
rank-k flush) and #2c on one CTA per walker -- given that commit's
``submatrix_update.cu``, ``fused_block.cu`` and the headers they include,
in one directory:

    mkdir old && for f in submatrix_update.cu fused_block.cu \
        rank_k_flush.cuh submatrix_decide.cuh site_loop.cuh; do
        git show <commit>:dqmc_tpu_torch/csrc/$f > old/$f; done
    python3 scripts/seed_split.py submatrix --source old/submatrix_update.cu \
        [--parts split,bits,times,probes]

- ``split``: device time of the seed's #5 launches per group (decide,
  prep, flush, and ``baddbmm_`` for the same flush) and of its slice, at
  (4, 1024, 32) in both float types, (16, 256, 32) and (4, 36, 4), each
  with the shared and per-walker orders, and (4, 36, 32 + 4) per walker;
  then the seed's #2c loop at (16, 256, 32) and (4, 36, 4) against builds
  without its flush and without its k sequential decisions;
- ``bits``: the seed's #5 slice against the checkout's (and the route-A
  probe's, below; and at ns = 1156, past the clusters) and the seed's #2c
  loop against the checkout's, on inputs with rejections: G and the flags
  bit for bit?
- ``times``: both #5 slices alternating (seed, checkout, checkout, seed)
  in device time, the checkout's group kernel and flush alone; #2c the
  same way, and the checkout's #2c in float64 at ns = 484 and 512;
- ``probes``: the checkout's #5 (two launches per group, the flush over
  the whole card) against one cluster launch per slice with the flush on
  the walker's own SMs (``PROBE_SUB_SRC``: a copy of the package's slice
  body with R <= 64 and the flush by owner), alternating.

The multiword panel kernels #7 (df32) and #8 (tf32) before their
tensor-core redesign, given that commit's ``mw_qr_panel.cu`` (built, as
the package builds it, with ``--fmad=false``):

    mkdir old && git show <commit>:dqmc_tpu_torch/csrc/mw_qr_panel.cu \
        > old/mw_qr_panel.cu
    python3 scripts/seed_split.py panels --source old/mw_qr_panel.cu \
        [--parts split,bits,times,probe]

- ``split``: device time per panel of the seed and of builds without one
  stage each -- the E dots (the int8 products against the finished
  columns' planes), the update's class sums, the multiword residual chain
  of every digit extraction, the norm (its digits, products and
  reduction; Q scaled by 1), and the recombinations (E over the y planes,
  c over the q planes, the update's delta) -- at (16, 32, 256),
  (16, 32, 64) and (4, 32, 512), both word counts;
- ``bits``: the seed against the checkout on every panel of
  ``chip_smoke.panel_cases`` (graded panels at n = 256, 64, 512 and 32,
  zero rows, the carry planes of y, q and e), both word counts: every
  word of Q and R equal?
- ``times``: both, alternating (seed, checkout, checkout, seed) in
  device time at the shapes of ``split``, beside ``torch.linalg.qr`` in
  float64 of the same panel (CUDA events);
- ``probe`` (not in the default parts): the checkout's kernel built with
  ``clock64()`` stamps on thread 0 of block 0 between its phases
  (``PANEL_PROBES``, which match the checkout's text only): cycles per
  column by phase at the shapes of ``split``.

The rank-1 site loop #6 on one CTA per walker with G in global memory
(before its cluster redesign), given that commit's ``site_update.cu`` and
the ``site_loop.cuh`` it includes, in one directory:

    mkdir old && for f in site_update.cu site_loop.cuh; do
        git show <commit>:dqmc_tpu_torch/csrc/$f > old/$f; done
    python3 scripts/seed_split.py rank1 --source old/site_update.cu \
        [--parts split,bits,times]

- ``split``: device time per launch of the seed and of builds without one
  stage each -- the 64-bit division of the update's index (a shift in its
  place), G's global traffic in the update (the products summed in a
  register instead), the two barriers of an accepted visit, and every
  update (the decisions alone) -- at (4, 36), (16, 256) and (4, 1024) in
  both float types, with the accepted count of each build;
- ``bits``: the seed against the checkout on the same inputs (a physical
  G at the stretch dtau, ``chip_smoke.slice_inputs``) at those shapes,
  both float types, shared and per-walker orders: G and the accept flags
  bit for bit?
- ``times``: both, alternating (seed, checkout, checkout, seed) in device
  time per launch at those shapes, then builds of the checkout with the
  cluster fixed at C = 1, 2, 4, 8 and 16 CTAs per walker (its
  ``rank1_cluster`` replaced);
- ``probes`` (not in the default parts): the checkout against builds in
  which an accepted visit updates row nx alone (the handoff chain) or a
  row travels as one 16-byte vector (wrong results; only the times are
  read), float32;
- ``clock`` (not in the default parts): the checkout built with
  ``clock64()`` stamps between the stages of a visit (``RANK1_CLOCKS``):
  cycles per visit by stage on thread 0 of CTA 0, float32.

The stubs match the seed's text only, and the script stops on any other.
Needs a CUDA card and nvcc; prints one line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (LOOP_CASES, PANEL_SHAPES, cuda_ms,  # noqa: E402
                        device_ms, panel_cases, panel_inputs)

NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]

# variant name -> (text in the source, its replacement)
K1_STUBS = {
    "no_block": ("pass < 2 && p0 > 0", "pass < 0 && p0 > 0"),
    "no_panel": ("for (int t = 0; t < PANEL; ++t) {\n      T* y",
                 "for (int t = 0; t < 0; ++t) {\n      T* y"),
    "no_zero": ("e += THREADS) r[e] = T(0);", "e += THREADS) {}"),
}
K1_SHAPES = (((16, 256), 20), ((4, 1024), 3))
SITE_STUBS = {
    "no_flush": ("if (slot == k - 1 && own) {",
                 "if (false && slot == k - 1 && own) {"),
    "no_visits": ("const int slot = idx % k;\n",
                  "const int slot = idx % k;\n    if (slot != k - 1) "
                  "continue;\n"),
}
SPLIT_SHAPES = ((16, 256), (16, 448))
# the panel kernels' stages: (text in the source, its replacement), one
# pair or a tuple of pairs per build
PANEL_STUBS = {
    "E dots": ("for (int s = 0; s < n4; ++s) {",
               "for (int s = 0; s < 0; ++s) {"),
    "update class sums": ("for (int u = 0; u < t; ++u) {",
                          "for (int u = 0; u < 0; ++u) {"),
    "digit residual chains": (
        "r = sub(r, from_f32<T>(fmul(q, pow2f(-7 * (i + 1)))));", ";"),
    "norm": ("    // norm^2 from y's digit planes: exact class products\n"
             "    {",
             "    if (tid < 8) scal[tid] = tid == 1 || tid == W + 1;\n"
             "    __syncthreads();\n    if (t < 0) {"),
    # every integer term still feeds the result (a float32 sum of the
    # integers), so no product above it becomes dead code
    "recombinations": (
        ("// max over the block; every thread returns the same value",
         "template <int NP, typename T>\n__device__ T isum(const int* a) {\n"
         "  int s = 0;\n  for (int i = 0; i < NP; ++i) s += a[i];\n"
         "  return from_f32<T>(__int2float_rn(s));\n}\n\n"
         "// max over the block; every thread returns the same value"),
        ("store(ew, ew_w, pj, wsum<NP, T>(acc, -7));",
         "store(ew, ew_w, pj, isum<NP, T>(acc));"),
        ("c = add(c, scale(ld<T>(ew, ew_w, tid * NP + j), "
         "pow2f(-7 * (j + 1))));",
         "c.hi = fadd(c.hi, ew[tid * NP + j]);"),
        ("const T delta = wsum<NP, T>(cls, -14);",
         "const T delta = isum<NP, T>(cls);")),
}
PANEL_FLAGS = ("--fmad=false",)
# the checkout's phases for a clock64() probe: (text before, text after,
# the phase that ends between them); thread 0 of block 0 adds the cycles
# since the previous stamp to the phase's sum, and writes the sums over
# R's first 128 bytes when the panel is done
PANEL_PROBES = (
    ("\n      pow2_scales(block_max(m, red, buf), s_y, inv_sy);\n", "",
     "y load, block max of y"),
    ("ys);\n        }\n      __syncthreads();\n", "", "y digits"),
    ("      __syncthreads();\n", "\n      // E[u][j] = sum_i", "E dots"),
    ("      __syncthreads();\n", "\n      // every warp, lane u < t",
     "E recombination"),
    ("de[0] == 128);\n      __syncwarp();\n", "", "c, e, e's digits"),
    ("        __syncwarp();\n      }\n", "    }\n\n    // norm^2",
     "update: products, recombination, y -= "),
    ("\n    pow2_scales(block_max(m, red, buf), s_y, inv_sy);\n", "",
     "norm: block max of y"),
    ("if (lane == 0) ncls[warp * NP + w] = v;\n    }\n    __syncthreads();\n",
     "", "norm: digits, products, block sum"),
    ("zero ? from_f32<T>(1.0f) : nrm);\n", "",
     "norm: recombination, sqrt, division"),
    ("    pow2_scales(block_max(m, red, buf), s_q, inv_sq);\n", "",
     "q = y / |y|, block max of q"),
    ("    if (lane == t) sq_u = s_q;\n", "", "q digits, Q and R stores"),
)


def probed(text: str) -> str:
    """The checkout's kernel with the PANEL_PROBES stamps."""
    stamp = ("    if (threadIdx.x == 0 && blockIdx.x == 0) {{ const long long "
             "c_ = clock64(); prof_[{k}] += c_ - prof_t_; prof_t_ = c_; }}\n")
    for k, (before, after, _) in enumerate(PANEL_PROBES):
        if text.count(before + after) != 1:
            sys.exit(f"probe {k}: anchor matches {text.count(before + after)}"
                     f" times")
        text = text.replace(before + after,
                            before + stamp.format(k=k) + after)
    head = "  const int b = blockIdx.x, tid = threadIdx.x;\n"
    tail = "  }\n}\n\ntemplate <int W, int NP>\nint launch_panel"
    for anchor in (head, tail):
        if text.count(anchor) != 1:
            sys.exit("probe: kernel anchors not found")
    text = text.replace(head, head + (
        "  __shared__ long long prof_[16];\n"
        "  if (tid < 16) prof_[tid] = 0;\n"
        "  long long prof_t_ = clock64();\n"))
    return text.replace(tail, (
        "  }\n  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
        "    for (int i = 0; i < 16; ++i)\n"
        "      reinterpret_cast<long long*>(Ro)[i] = prof_[i];\n}\n\n"
        "template <int W, int NP>\nint launch_panel"))
# (W, ns, k, flavors, float type) of the bit comparison: every shape both
# designs take among the engine's (examples/basic, the repulsive preset,
# the headline and the largest ones the seed takes)
BIT_CASES = ((4, 36, 4, 1, "float64"), (4, 36, 4, 2, "float64"),
             (4, 36, 4, 1, "float32"), (4, 36, 4, 2, "float32"),
             (32, 64, 32, 1, "float64"), (32, 64, 32, 2, "float64"),
             (32, 64, 32, 1, "float32"), (32, 64, 32, 2, "float32"),
             (16, 256, 32, 1, "float64"), (16, 256, 32, 1, "float32"),
             (16, 256, 32, 2, "float32"), (16, 224, 32, 2, "float64"),
             (16, 448, 32, 1, "float64"), (16, 448, 32, 2, "float32"))

BARRIER_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void block_sync(int iters) {
  for (int it = 0; it < iters; ++it) __syncthreads();
}

__global__ void cluster_sync(int iters, int store) {
  extern __shared__ float buf[];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank(), size = cl.num_blocks();
  float* peer = cl.map_shared_rank(buf, (rank + 1) % size);
  for (int it = 0; it < iters; ++it) {
    if (store) peer[(it & 1) * blockDim.x + threadIdx.x] = (float)it;
    cl.sync();
  }
}

extern "C" int probe(int cluster, int threads, int iters, int clusters,
                     int store, void* stream) {
  if (cluster == 0) {
    block_sync<<<clusters, threads, 0, (cudaStream_t)stream>>>(iters);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * threads * sizeof(float);
  if (cluster > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_sync, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_sync, iters, store);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
"""


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    return smi.stdout.strip()


def nvcc_all(jobs: dict, tmp: Path, include: Path | None = None,
             flags: tuple = ()) -> dict:
    """Build each {name: source text} into its own shared library, one nvcc
    each (with the extra ``flags``), in parallel; headers are looked up
    beside ``include`` (the seed) and then in the checkout's csrc/.
    Returns {name: loaded library}."""
    cmds, libs = [], {}
    dirs = ([include.parent] if include else []) + [REPO / "dqmc_tpu_torch"
                                                    / "csrc"]
    for name, body in jobs.items():
        stem = name.replace(" ", "_")
        cu = tmp / f"{stem}.cu"
        cu.write_text(body)
        libs[name] = tmp / f"lib{stem}.so"
        cmds.append(NVCC + list(flags) + [f"-I{d}" for d in dirs]
                    + ["-o", str(libs[name]), str(cu)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def stubbed(src: Path, stubs: dict) -> dict:
    text = src.read_text()
    variants = {"full": text}
    for name, pairs in stubs.items():
        body = text
        for old, new in (pairs if isinstance(pairs[0], tuple) else (pairs,)):
            if body.count(old) != 1:
                sys.exit(f"{src}: stub {name!r} matches {body.count(old)} "
                         f"times")
            body = body.replace(old, new)
        variants[name] = body
    return variants


def k1_split(opts) -> None:
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        libs = nvcc_all(stubbed(opts.source, K1_STUBS), Path(tmp),
                        opts.source)
        fns = {}
        for name, lib in libs.items():
            fn = lib.dqmc_cgs2_qr_f32
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name] = fn
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        for (B, n), reps in K1_SHAPES:
            A = torch.randn((B, n, n), generator=gen, device="cuda")
            at = A.transpose(-1, -2).contiguous()
            qt, r, rinv = (torch.empty_like(at) for _ in range(3))
            r.zero_()
            cbuf = torch.empty((B, 32, n), device="cuda")
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())

            def timed(fn, inv):
                def once():
                    err = fn(p(at), p(qt), p(r), p(rinv if inv else None),
                             p(cbuf), B, n, stream)
                    if err:
                        sys.exit(f"launch failed: CUDA error {err}")
                return cuda_ms(once, reps)

            t = {name: timed(fn, False) for name, fn in fns.items()}
            t_inv = timed(fns["full"], True)
            stages = {"block passes": t["full"] - t["no_block"],
                      "in-panel loop": t["full"] - t["no_panel"],
                      "R^-1 back substitution": t_inv - t["full"],
                      "R zero fill": t["full"] - t["no_zero"]}
            stages["rest (panel loads and stores)"] = (
                t_inv - sum(stages.values()))
            print(f"K1 seed ({B}, {n}, {n}) f32: cgs2_qr_inv {t_inv:.3f} ms, "
                  f"cgs2_qr {t['full']:.3f} ms; builds without block passes "
                  f"{t['no_block']:.3f}, without in-panel loop "
                  f"{t['no_panel']:.3f}, without zero fill "
                  f"{t['no_zero']:.3f} ms", flush=True)
            for name, ms in stages.items():
                print(f"K1 seed ({B}, {n}, {n}) f32:   {name:32s} "
                      f"{ms:9.3f} ms  {100 * ms / t_inv:5.1f}%", flush=True)


_SITE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def site_fn(lib, nfl: int, dtype: str):
    fn = getattr(lib, ("dqmc_site_loop_2f" if nfl == 2 else "dqmc_site_loop")
                 + ("_f64" if dtype == "float64" else "_f32"))
    fn.argtypes = _SITE_ARGS
    fn.restype = ctypes.c_int
    return fn


def site_inputs(torch, W, ns, nfl, dtype, seed, timing):
    """One slice's inputs.  ``timing``: chip_smoke.py's phase-10 inputs (G
    = I/2 + noise, every ratio positive).  Otherwise spread ratios with
    rejections, acceptances and, with two flavors, negative ones (signs
    flip)."""
    kw = dict(device="cuda", dtype=getattr(torch, dtype))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    shape = (W, ns, ns) if nfl == 1 else (W, 2, ns, ns)
    noise = 0.01 if timing else 0.05
    G = 0.5 * torch.eye(ns, **kw) + noise * torch.randn(shape, generator=g,
                                                        **kw)
    u = lambda *s: torch.rand(s, generator=g, **kw)
    dshape = (W, ns) if nfl == 1 else (W, 2, ns)
    if timing:
        gb = torch.ones((W, ns), **kw)
        delta = torch.full(dshape, 0.3, **kw)
        if nfl == 2:
            delta[:, 1] = -0.25
    else:
        gb = 0.5 + u(W, ns)
        delta = -0.6 + 1.8 * u(*dshape)
        if nfl == 2:
            delta[:, 1] = -2.6 + 3.0 * u(W, ns)
    us = u(W, ns)
    order = torch.argsort(torch.rand((1, ns), generator=g, device="cuda"),
                          dim=-1).to(torch.int32)
    return G, gb, delta.contiguous(), us, order


def run_site(torch, fn, inputs, k, nfl):
    G0, gb, delta, us, order = inputs
    W, ns = gb.shape
    G = G0.clone()
    mask = torch.zeros_like(gb)
    sgn = torch.ones((W,), device="cuda", dtype=G.dtype)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = fn(p(G), p(mask), ns, p(order), p(gb), p(delta), p(us), ns,
             p(sgn), ns, k, W, stream)
    if err:
        sys.exit(f"site loop launch failed: CUDA error {err}")
    return G, mask, sgn


def site_split(torch, opts, tmp) -> None:
    libs = nvcc_all(stubbed(opts.source, SITE_STUBS), tmp, opts.source)
    for W, ns in SPLIT_SHAPES:
        for nfl in (1, 2):
            inputs = site_inputs(torch, W, ns, nfl, "float32", 1, True)
            t = {name: cuda_ms(lambda: run_site(
                torch, site_fn(lib, nfl, "float32"), inputs, 32, nfl), 10)
                for name, lib in libs.items()}
            flush = t["full"] - t["no_flush"]
            visits = (t["full"] - t["no_visits"]) * 32 / 31
            print(f"site loop seed ({W}, {ns}, 32) f32 flavors={nfl}: "
                  f"{t['full']:.3f} ms per slice; without the flush "
                  f"{t['no_flush']:.3f}, with 1 visit in 32 "
                  f"{t['no_visits']:.3f} ms; flush {flush:.3f} ms "
                  f"({100 * flush / t['full']:.1f}%), visits {visits:.3f} ms "
                  f"({100 * visits / t['full']:.1f}%, from the second build "
                  f"scaled by 32/31)", flush=True)


def barriers(torch, tmp) -> None:
    lib = nvcc_all({"probe": BARRIER_SRC}, tmp)["probe"]
    lib.probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.probe.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    iters, clusters = 20000, 16
    for threads in (32, 256):
        for cluster in (0, 1, 2, 4, 8, 16):
            for store in ((0,) if cluster == 0 else (0, 1)):
                def once():
                    err = lib.probe(cluster, threads, iters, clusters, store,
                                    stream)
                    if err:
                        sys.exit(f"barrier probe failed: CUDA error {err}")
                us = 1e3 * cuda_ms(once, 3) / iters
                what = ("__syncthreads()" if cluster == 0 else
                        f"cluster.sync() cluster={cluster}"
                        + (" after a store to a peer" if store else ""))
                print(f"barrier round trip, {threads} threads per CTA, "
                      f"{clusters} {'CTAs' if cluster == 0 else 'clusters'}"
                      f": {what}: {us * 1e3:.1f} ns", flush=True)


def bits(torch, seed) -> None:
    from dqmc_tpu_torch import _cuda
    new = _cuda.lib()
    for W, ns, k, nfl, dtype in BIT_CASES:
        inputs = site_inputs(torch, W, ns, nfl, dtype, 7 + ns, False)
        a = run_site(torch, site_fn(seed, nfl, dtype), inputs, k, nfl)
        b = run_site(torch, site_fn(new, nfl, dtype), inputs, k, nfl)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        gap = float((a[0] - b[0]).abs().max())
        print(f"bits ({W}, {ns}, {k}) {dtype} flavors={nfl}: G "
              f"{'equal' if same[0] else f'DIFFERS (max {gap:.3e})'}"
              f", mask {'equal' if same[1] else 'DIFFERS'} "
              f"({int(a[1].sum())} accepted), sign "
              f"{'equal' if same[2] else 'DIFFERS'} "
              f"({int((a[2] < 0).sum())} walkers flipped)", flush=True)


def times(torch, seed) -> None:
    from dqmc_tpu_torch import _cuda
    new = _cuda.lib()
    for W, ns, nfl, sub, dtype in LOOP_CASES:
        if sub:
            continue
        inputs = site_inputs(torch, W, ns, nfl, dtype, 1, True)
        # the seed refuses the shapes whose buffers did not fit one CTA
        takes = seed_takes(seed, inputs, nfl, dtype)
        t = {"seed": [], "new": []}
        for name, lib in (("seed", seed), ("new", new), ("new", new),
                          ("seed", seed)):
            if name == "seed" and not takes:
                t[name].append(float("nan"))
                continue
            fn = site_fn(lib, nfl, dtype)
            t[name].append(cuda_ms(
                lambda: run_site(torch, fn, inputs, 32, nfl), 10))
        print(f"times ({W}, {ns}, 32) {dtype} flavors={nfl}: seed "
              f"{t['seed'][0]:.3f} / {t['seed'][1]:.3f} ms"
              f"{'' if takes else ' (not a shape it takes)'}, checkout "
              f"{t['new'][0]:.3f} / {t['new'][1]:.3f} ms per slice",
              flush=True)


def seed_takes(seed, inputs, nfl, dtype) -> bool:
    import torch
    try:
        run_site(torch, site_fn(seed, nfl, dtype), inputs, 32, nfl)
    except SystemExit:
        return False
    return True


# (W, ns, k, flavors, float type, per-walker order) of the delayed mode's
# timings: the stretch shape in both float types and with two flavors,
# the df32 headline's float32 view, the repulsive preset, examples/basic
# at JAX's rank (4) and per walker (groups of 32 + 4)
DELAYED_CASES = ((4, 1024, 32, 1, "float32", False),
                 (4, 1024, 32, 1, "float64", False),
                 (4, 1024, 32, 2, "float32", False),
                 (16, 256, 32, 1, "float32", False),
                 (32, 64, 32, 2, "float32", False),
                 (4, 36, 4, 1, "float32", False),
                 (4, 36, 32, 1, "float32", True))
DELAYED_BIT_SHAPES = ((4, 36, 32, True), (4, 36, 4, False),
                      (32, 64, 32, False), (16, 256, 32, False),
                      (4, 1024, 32, False))
# the flush of the checkout's slice (either path), removed for the split
# (the visits cannot be: a visit waits for its peers' entries)
SLICE_STUBS = {"no_flush": ("    if constexpr (RMAX > 32) {",
                            "    if (false) if constexpr (RMAX > 32) {")}
# throwaway builds of the checkout's slice for ``probes``: each takes one
# cost out of the flush by owner (or doubles it) and gives wrong G; only
# their times are read
_FLUSH_CALL = ("        flush_by_owner<T>(cluster, Gw + f * nn + (long long)a0 * n,\n"
               "                          Uo + f * kR, Vo, f * kR, GC, GR, n, R, Rp, own,\n"
               "                          cnt);\n")
PROBE_STUBS = {
    "V copied from the own CTA": [(
        "cluster.map_shared_rank(Vo, (c + step) % C) + off);",
        "cluster.map_shared_rank(Vo, c) + off);")],
    "no V copy": [(
        "      if (tid + i * nthreads < nv) pre[i] = src[tid + i * nthreads];\n",
        "      (void)src;\n")],
    "no G loads or stores": [(
        "if (in && c0 < cols) v = ldcg_vec(g0 + (long long)x * n + y);",
        "if (in && c0 < cols && n < 0) v = ldcg_vec(g0 + (long long)x * n + y);"), (
        "              *reinterpret_cast<Vec<T>*>(gx + y) = e;",
        "              if (e.v[0] == T(-12345.5))\n"
        "                *reinterpret_cast<Vec<T>*>(gx + y) = e;")],
    "FMA operands from registers": [(
        "        const Vec<T> e =\n"
        "            *reinterpret_cast<const Vec<T>*>(Uf + s * Rp + l0 + x);",
        "        Vec<T> e;\n"
        "        for (int q = 0; q < VW; ++q) e.v[q] = T(s + q + l0);"), (
        "        const Vec<T> e =\n"
        "            *reinterpret_cast<const Vec<T>*>(Vs + s * Rp + c0 + y);",
        "        Vec<T> e;\n"
        "        for (int q = 0; q < VW; ++q) e.v[q] = T(s - q + c0);")],
    "the flush twice": [(
        "      for (int f = 0; f < NFL; ++f)\n" + _FLUSH_CALL,
        "      for (int f = 0; f < NFL; ++f) {\n" + _FLUSH_CALL
        + "        __syncthreads();\n" + _FLUSH_CALL + "      }\n")],
}
_LL, _I, _VP = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_SEED_SITES = [_VP] * 6 + [_LL] + [_VP] * 3 + [_LL] + [_I] * 4 + [_VP]
_SEED_FLUSH = [_VP] * 3 + [_LL] + [_I] * 3 + [_VP]
_SLICE = [_VP] * 3 + [_LL] + [_VP] * 4 + [_I] * 3 + [_VP]


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(err, what):
    if err:
        sys.exit(f"{what} failed: CUDA error {err}")


def seed_pieces(lib, dtype):
    """The seed's visit kernel and flush as the ``block`` and ``flush``
    pieces of :func:`group_loop`."""
    sfx = "_f64" if dtype == "float64" else "_f32"
    sites = {1: _bind(lib, "dqmc_delayed_sites" + sfx, _SEED_SITES),
             2: _bind(lib, "dqmc_delayed_sites_2f" + sfx, _SEED_SITES)}
    flush_fn = _bind(lib, "dqmc_delayed_flush" + sfx, _SEED_FLUSH)

    def block(G, U, V, acc, order, gb, delta, us, v0, cnt, sgn=None):
        W, n = G.shape[0], G.shape[-1]
        _check(sites[1 if G.dim() == 3 else 2](
            _ptr(G), _ptr(U), _ptr(V), _ptr(acc), _ptr(sgn), _ptr(order),
            0 if order.dim() == 1 else n, _ptr(gb), _ptr(delta), _ptr(us),
            U.shape[-2] * n, n, v0, cnt, W, _stream()), "seed visits")

    def flush(G, U, V, cnt):
        n = G.shape[-1]
        _check(flush_fn(_ptr(G), _ptr(U), _ptr(V), U.shape[-2] * n, n, cnt,
                        G.numel() // (n * n), _stream()), "seed flush")
    return block, flush


def group_loop(block, flush):
    """A slice as the seed ran it: groups of k visits (the last one short
    when k does not divide n), each ``block`` and then ``flush``, called as
    ``ops/kernels.py delayed_slice_plain`` is."""
    import torch

    def run(G, acc, order, gb, delta, us, k, sgn=None):
        n = G.shape[-1]
        U, V = (torch.empty(G.shape[:-2] + (k, n), dtype=G.dtype,
                            device=G.device) for _ in range(2))
        for v0 in range(0, n, k):
            cnt = min(k, n - v0)
            block(G, U, V, acc, order, gb, delta, us, v0, cnt, sgn)
            flush(G, U, V, cnt)
    return run


def slice_entry(lib, dtype):
    """A build's one-launch slice (``dqmc_delayed_slice``), called as
    ``ops/kernels.py delayed_slice_cuda`` is, without counting."""
    sfx = "_f64" if dtype == "float64" else "_f32"
    fns = {1: _bind(lib, "dqmc_delayed_slice" + sfx, _SLICE),
           2: _bind(lib, "dqmc_delayed_slice_2f" + sfx, _SLICE)}

    def run(G, acc, order, gb, delta, us, k, sgn=None):
        W, n = G.shape[0], G.shape[-1]
        _check(fns[1 if G.dim() == 3 else 2](
            _ptr(G), _ptr(acc), _ptr(order), 0 if order.dim() == 1 else n,
            _ptr(gb), _ptr(delta), _ptr(us), _ptr(sgn), n, k, W, _stream()),
            "slice")
    return run


def delayed_inputs(torch, W, ns, nfl, dtype, seed, timing, per_walker):
    """One slice's inputs for the per-slice engine's kernels: G, the
    per-visit gb, delta and us, the order ((ns,) or (W, ns), int32).
    ``timing``: every ratio positive, as site_inputs.  Otherwise spread
    ratios (noise of G scaled to keep it well conditioned at every ns)."""
    G, gb, delta, us, order = site_inputs(torch, W, ns, nfl, dtype, seed,
                                          timing)
    if not timing:
        eye = 0.5 * torch.eye(ns, device="cuda", dtype=G.dtype)
        G = eye + (G - eye) * (6.0 / ns ** 0.5)
    order = order[0]
    if per_walker:
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 1)
        order = torch.argsort(torch.rand((W, ns), generator=g,
                                         device="cuda"), dim=-1)
    return G, gb, delta, us, order.to(torch.int32).contiguous()


def run_slice(torch, fn, inputs, k):
    """One slice by ``fn`` (called as ``delayed_slice_plain``) on a copy
    of G; returns (G, accept flags, sign)."""
    G0, gb, delta, us, order = inputs
    W = gb.shape[0]
    G = G0.clone()
    acc = torch.zeros_like(gb)
    sgn = torch.ones((W,), device="cuda", dtype=G.dtype)
    fn(G, acc, order, gb, delta, us, k, sgn)
    return G, acc, sgn


def _tag(W, ns, k, nfl, dtype, pw):
    return (f"({W}, {ns}, {k}) {dtype} flavors={nfl}"
            + (" per-walker order" if pw else ""))


def delayed_split(torch, seed, tmp=None) -> None:
    for W, ns, k, nfl, dtype, pw in DELAYED_CASES:
        inputs = delayed_inputs(torch, W, ns, nfl, dtype, 1, True, pw)
        G0, gb, delta, us, order = inputs
        block, flush = seed_pieces(seed, dtype)
        G = G0.clone()
        U, V = (torch.zeros(G.shape[:-2] + (k, ns), dtype=G.dtype,
                            device="cuda") for _ in range(2))
        acc = torch.zeros_like(gb)
        sgn = torch.ones((W,), device="cuda", dtype=G.dtype)
        blk = (acc, order, gb, delta, us, 0, k, sgn)
        block(G, U, V, *blk)
        Gf = G.view(-1, ns, ns)
        Uf, Vf = U.view(-1, k, ns), V.view(-1, k, ns)
        seed_slice = group_loop(block, flush)
        groups = -(-ns // k)
        t = {"visits": device_ms(lambda: block(G, U, V, *blk), 10),
             "flush": device_ms(lambda: flush(G, U, V, k), 10),
             "baddbmm": device_ms(lambda: Gf.baddbmm_(Uf.mT, Vf), 10),
             "slice": device_ms(lambda: run_slice(torch, seed_slice, inputs,
                                                  k), 3)}
        print(f"delayed seed {_tag(W, ns, k, nfl, dtype, pw)}, device time: "
              f"one group's visits {t['visits']:.4f} ms, its flush "
              f"{t['flush']:.4f} ms, baddbmm_ {t['baddbmm']:.4f} ms; slice "
              f"{t['slice']:.3f} ms ({groups} groups: visits x groups "
              f"{t['visits'] * groups:.3f}, flushes x groups "
              f"{t['flush'] * groups:.3f})", flush=True)


def delayed_bits(torch, seed, tmp=None) -> None:
    from dqmc_tpu_torch.ops import kernels as tk
    for W, ns, k, pw in DELAYED_BIT_SHAPES:
        for nfl in (1, 2):
            for dtype in ("float64", "float32"):
                inputs = delayed_inputs(torch, W, ns, nfl, dtype, 7 + ns,
                                        False, pw)
                block, flush = seed_pieces(seed, dtype)
                a = run_slice(torch, group_loop(block, flush), inputs, k)
                b = run_slice(torch, tk.KERNELS.delayed_slice, inputs, k)
                torch.cuda.synchronize()
                same = [torch.equal(x, y) for x, y in zip(a, b)]
                gap = float((a[0] - b[0]).abs().max())
                print(f"delayed bits {_tag(W, ns, k, nfl, dtype, pw)}: G "
                      f"{'equal' if same[0] else f'DIFFERS (max {gap:.3e})'}"
                      f" (max |G| {float(a[0].abs().max()):.3e}, finite "
                      f"{bool(torch.isfinite(a[0]).all())}), flags "
                      f"{'equal' if same[1] else 'DIFFER'} "
                      f"({int(a[1].sum())} of {a[1].numel()} accepted), sign "
                      f"{'equal' if same[2] else 'DIFFERS'} "
                      f"({int((a[2] < 0).sum())} walkers flipped)",
                      flush=True)
    flush_bits(torch, seed)


# (W, n, k, float type) of the flush's bit comparison: the engine's
# shapes, and a ragged n (the scalar path)
FLUSH_BIT_CASES = ((4, 1024, 32, "float32"), (4, 1024, 32, "float64"),
                   (16, 256, 32, "float32"), (4, 36, 4, "float64"),
                   (3, 25, 5, "float32"), (3, 25, 5, "float64"))


def flush_bits(torch, seed) -> None:
    """The seed's rank-k flush against the checkout's (``submatrix_flush``)
    on the same random G, U and V: G equal bit for bit?"""
    from dqmc_tpu_torch.ops import kernels as tk
    for W, n, k, dtype in FLUSH_BIT_CASES:
        g = torch.Generator(device="cuda")
        g.manual_seed(n + k)
        G, U, V = (torch.randn(shape, generator=g, device="cuda",
                               dtype=getattr(torch, dtype))
                   for shape in ((W, n, n), (W, k, n), (W, k, n)))
        a, b = G.clone(), G.clone()
        seed_pieces(seed, dtype)[1](a, U, V, k)
        tk.KERNELS.submatrix_flush(b, U, V, k)
        torch.cuda.synchronize()
        print(f"flush bits ({W}, {n}, {k}) {dtype}: G "
              + ("equal" if torch.equal(a, b) else
                 f"DIFFERS (max {float((a - b).abs().max()):.3e})"),
              flush=True)


def delayed_times(torch, seed, tmp) -> None:
    from dqmc_tpu_torch.ops import kernels as tk
    csrc = REPO / "dqmc_tpu_torch" / "csrc"
    stub = tmp / "stub"
    stub.mkdir()
    (stub / "site_loop.cuh").write_text(
        stubbed(csrc / "site_loop.cuh", SLICE_STUBS)["no_flush"])
    noflush = nvcc_all({"noflush": (csrc / "site_update.cu").read_text()},
                       tmp, stub / "site_update.cu")["noflush"]
    for W, ns, k, nfl, dtype, pw in DELAYED_CASES:
        inputs = delayed_inputs(torch, W, ns, nfl, dtype, 1, True, pw)
        block, flush = seed_pieces(seed, dtype)
        fns = {"seed": group_loop(block, flush),
               "checkout": tk.KERNELS.delayed_slice}
        t = {"seed": [], "checkout": []}
        for name in ("seed", "checkout", "checkout", "seed"):
            t[name].append(device_ms(lambda: run_slice(
                torch, fns[name], inputs, k), 3))
        bare = device_ms(lambda: run_slice(
            torch, slice_entry(noflush, dtype), inputs, k), 3)
        print(f"delayed times {_tag(W, ns, k, nfl, dtype, pw)}, device time "
              f"per slice: seed {t['seed'][0]:.4f} / {t['seed'][1]:.4f} ms, "
              f"checkout {t['checkout'][0]:.4f} / {t['checkout'][1]:.4f} ms,"
              f" checkout without its flush {bare:.4f} ms", flush=True)
    for W, ns, k, dtype in ((4, 1024, 32, "float64"),
                            (4, 1024, 32, "float32"),
                            (16, 256, 32, "float32")):
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        G = torch.randn((W, ns, ns), generator=g, device="cuda", dtype=dt)
        U, V = (torch.randn((W, k, ns), generator=g, device="cuda",
                            dtype=dt) for _ in range(2))
        _, seed_flush = seed_pieces(seed, dtype)
        fns = {"seed": lambda: seed_flush(G, U, V, k),
               "checkout": lambda: tk.KERNELS.submatrix_flush(G, U, V, k),
               "baddbmm_": lambda: G.baddbmm_(U.mT, V)}
        t = {name: [] for name in fns}
        for name in ("seed", "checkout", "baddbmm_", "baddbmm_", "checkout",
                     "seed"):
            t[name].append(device_ms(fns[name], 30))
        print(f"flush times ({W}, {ns}, {k}) {dtype}, device time per "
              f"call: " + ", ".join(
                  f"{name} {a:.5f} / {b:.5f} ms" for name, (a, b) in
                  t.items()), flush=True)


def delayed_probes(torch, seed, tmp) -> None:
    """The checkout's slice at the large shapes of DELAYED_CASES against
    builds with one of PROBE_STUBS applied (one nvcc each, in parallel)."""
    csrc = REPO / "dqmc_tpu_torch" / "csrc"
    hdr = (csrc / "site_loop.cuh").read_text()
    src = (csrc / "site_update.cu").read_text()
    jobs = {}  # name -> directory of the stubbed build
    for i, (name, stubs) in enumerate(PROBE_STUBS.items()):
        text = hdr
        for old, new in stubs:
            if text.count(old) != 1:
                sys.exit(f"probe {name!r}: stub matches {text.count(old)} "
                         f"times")
            text = text.replace(old, new)
        d = tmp / f"probe{i}"
        d.mkdir()
        (d / "site_loop.cuh").write_text(text)
        (d / "site_update.cu").write_text(src)
        jobs[name] = d
    procs = {name: subprocess.Popen(
        NVCC + [f"-I{d}", "-o", str(d / "lib.so"), str(d / "site_update.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, d in jobs.items()}
    outs = {name: proc.communicate()[0] for name, proc in procs.items()}
    for name, proc in procs.items():
        if proc.returncode:
            sys.exit(f"nvcc failed for probe {name!r}\n{outs[name]}")
    libs = {name: ctypes.CDLL(str(d / "lib.so")) for name, d in jobs.items()}
    from dqmc_tpu_torch import _cuda
    builds = {"checkout": _cuda.lib(), **libs}
    for W, ns, k, nfl, dtype, pw in DELAYED_CASES[:3]:
        inputs = delayed_inputs(torch, W, ns, nfl, dtype, 1, True, pw)
        t = {name: device_ms(lambda: run_slice(
            torch, slice_entry(lib, dtype), inputs, k), 3)
            for name, lib in builds.items()}
        print(f"delayed probes {_tag(W, ns, k, nfl, dtype, pw)}, device "
              f"time per slice: " + ", ".join(
                  f"{name} {ms:.4f} ms" for name, ms in t.items()),
              flush=True)


# (W, ns, k, per-walker order) of the submatrix mode's #5 timings: the
# stretch shape (both float types below), the df32 headline's view and
# examples/basic at JAX's rank (4), each with the shared and the
# per-walker order; and examples/basic per walker at k = 32 (32 + 4)
SUB_CASES = ((4, 1024, 32, "float32"), (4, 1024, 32, "float64"),
             (16, 256, 32, "float32"), (4, 36, 4, "float32"))
# (W, ns, k) of #2c's: the headline and examples/basic
SUB_FUSED_CASES = ((16, 256, 32), (4, 36, 4))
# the seed's fused submatrix loop without its flush, and (in the shared
# decision header) without the k sequential decisions; the gathers stay
SUB_FUSED_STUBS = {
    "no flush": ("fused_block.cu", "for (int a = 0; a < n; ++a) {",
                 "for (int a = 0; a < 0; ++a) {"),
    "no decisions": ("submatrix_decide.cuh",
                     "for (int t = 0; t < cnt; ++t) {",
                     "for (int t = 0; t < 0; ++t) {"),
}
_SEED_DECIDE = [_VP] * 4 + [_LL] + [_VP] * 3 + [_I] * 5 + [_VP]
_SEED_PREP = [_VP] * 5 + [_LL] + [_I] * 5 + [_VP]
_SUB_LOOP = [_VP, _VP, _LL] + [_VP] * 4 + [_LL] + [_I] * 3 + [_VP]


def seed_sub_pieces(lib, dtype):
    """The seed's #5 launches (decide, prep, flush), called as the
    plain pieces of ``ops/kernels.py`` are, and its whole slice as the
    seed's ``sites_update`` ran it (three launches per group)."""
    sfx = "_f64" if dtype == "float64" else "_f32"
    dec = _bind(lib, "dqmc_submatrix_decide" + sfx, _SEED_DECIDE)
    prep_fn = _bind(lib, "dqmc_submatrix_prep" + sfx, _SEED_PREP)
    flush_fn = _bind(lib, "dqmc_submatrix_flush" + sfx, _SEED_FLUSH)
    so = lambda order, n: 0 if order.dim() == 1 else n

    def decide(G, Wm, acc, order, gb, delta, us, v0, cnt):
        W, n = G.shape[0], G.shape[-1]
        _check(dec(_ptr(G), _ptr(Wm), _ptr(acc), _ptr(order), so(order, n),
                   _ptr(gb), _ptr(delta), _ptr(us), n, Wm.shape[1], v0, cnt,
                   W, _stream()), "seed decide")

    def prep(G, Wm, Ut, M, order, v0, cnt):
        W, n = G.shape[0], G.shape[-1]
        _check(prep_fn(_ptr(G), _ptr(Wm), _ptr(Ut), _ptr(M), _ptr(order),
                       so(order, n), n, Wm.shape[1], v0, cnt, W, _stream()),
               "seed prep")

    def flush(G, Ut, M, cnt):
        n = G.shape[-1]
        _check(flush_fn(_ptr(G), _ptr(Ut), _ptr(M), Ut.shape[-2] * n, n, cnt,
                        G.shape[0], _stream()), "seed flush")

    def run(G, acc, order, gb, delta, us, k, sgn=None):
        import torch
        W, n = G.shape[0], G.shape[-1]
        new = lambda *s: torch.empty((W,) + s, dtype=G.dtype,
                                     device=G.device)
        Wm, Ut, M = new(k, k), new(k, n), new(k, n)
        for v0 in range(0, n, k):
            cnt = min(k, n - v0)
            decide(G, Wm, acc, order, gb, delta, us, v0, cnt)
            prep(G, Wm, Ut, M, order, v0, cnt)
            flush(G, Ut, M, cnt)
    return decide, prep, flush, run


def sub_loop_entry(lib, dtype):
    """A build's fused submatrix loop (``dqmc_site_loop_sub``) for one
    slice of site_inputs(), without counting."""
    fn = _bind(lib, "dqmc_site_loop_sub"
               + ("_f64" if dtype == "float64" else "_f32"), _SUB_LOOP)

    def run(torch, inputs, k):
        G0, gb, delta, us, order = inputs
        W, ns = gb.shape
        G = G0.clone()
        mask = torch.zeros_like(gb)
        _check(fn(_ptr(G), _ptr(mask), ns, _ptr(order), _ptr(gb),
                  _ptr(delta), _ptr(us), ns, ns, k, W, _stream()),
               "submatrix loop")
        return G, mask
    return run


# #5 as one cluster launch per slice (route A): the package's submatrix
# slice body with R <= 64 rows per CTA and site_loop.cuh's flush by owner
# (which needs a second copy buffer), for the probe against the
# checkout's two launches per group
PROBE_SUB_SRC = r"""
#include "submatrix_decide.cuh"
namespace {
constexpr int RMAX = 64;
template <typename T>
size_t smem_bytes(int n, int k) {
  const size_t Rp = dqmc::site_cluster(n, RMAX).Rp;
  return sizeof(dqmc::DecideSmem<T>) +
         sizeof(T) * (4 * (size_t)k * Rp + 3 * (size_t)n) +
         sizeof(int) * 2 * (size_t)n;
}
template <typename T>
__global__ void __launch_bounds__(dqmc::SITE_THREADS, 1)
sub_slice_kernel(const dqmc::SiteLoopArgs<T> a) {
  using namespace dqmc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, k = a.k;
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int R = (n + C - 1) / C;
  const int Rp = (R + 3) / 4 * 4;
  const int a0 = c * R;
  const int own = max(0, min(R, n - a0));
  const int kR = k * Rp;
  DecideSmem<T>& sm = *reinterpret_cast<DecideSmem<T>*>(smem_raw);
  T* Uo = reinterpret_cast<T*>(smem_raw + sizeof(DecideSmem<T>));
  T* Vo = Uo + kR;
  T* GR = Vo + kR;  // G[I, own] - E; then a copy buffer of the flush
  T* B1 = GR + kR;  // the flush's second copy buffer
  T* gbs = B1 + kR;
  T* uss = gbs + n;
  T* dls = uss + n;
  int* ords = reinterpret_cast<int*>(dls + n);
  int* accs = ords + n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int w = blockIdx.y;
  T* Gw = a.G + (long long)w * n * n;
  const int* order = a.order + w * a.s_order;
  for (int e = tid; e < n; e += nthreads) ords[e] = order[e];
  __syncthreads();
  for (int e = tid; e < n; e += nthreads) {
    gbs[e] = a.gb[w * a.s_stream + e];
    dls[e] = a.delta[w * a.s_stream + e];
    uss[e] = a.us[w * a.s_stream + e];
  }
  for (int g0 = 0; g0 < n; g0 += k) {
    const int cnt = min(k, n - g0);
    const int* I = ords + g0;
    __syncthreads();
    sub_gather(sm, Gw, n, I, cnt, tid, nthreads);
    __syncthreads();
    if (tid < 32)
      sub_decide_warp(sm, cnt, gbs + g0, dls + g0, uss + g0, accs + g0, tid);
    else
      sub_panels(Gw, n, I, cnt, a0, own, Uo, Rp, GR, Rp, tid - 32,
                 nthreads - 32);
    __syncthreads();
    sub_m(sm, GR, Rp, Vo, Rp, cnt, own, tid, nthreads);
    cluster.sync();
    flush_by_owner<T>(cluster, Gw + (long long)a0 * n, Uo, Vo, 0, GR, B1, n,
                      R, Rp, own, cnt);
    cluster.sync();
  }
  if (c == 0)
    for (int e = tid; e < n; e += nthreads)
      a.flags[w * a.s_flags + e] = accs[e] ? T(1) : T(0);
}
template <typename T>
int run(T* G, T* acc, const int* order, long long s_order, const T* gb,
        const T* delta, const T* us, int n, int k, int batch, void* stream) {
  static dqmc::SiteLaunchCache cache;
  const dqmc::SiteLoopArgs<T> args{G,  acc, n,       order, s_order, gb, delta,
                                   us, n,   nullptr, n,     k,       true};
  return dqmc::launch_site_loop<T>(sub_slice_kernel<T>, cache, args,
                                   smem_bytes<T>(n, k), RMAX, batch,
                                   stream);
}
}  // namespace
extern "C" int probe_slice_f32(float* G, float* acc, const int* order,
                               long long s_order, const float* gb,
                               const float* delta, const float* us, int n,
                               int k, int batch, void* stream) {
  return run<float>(G, acc, order, s_order, gb, delta, us, n, k, batch,
                    stream);
}
extern "C" int probe_slice_f64(double* G, double* acc, const int* order,
                               long long s_order, const double* gb,
                               const double* delta, const double* us, int n,
                               int k, int batch, void* stream) {
  return run<double>(G, acc, order, s_order, gb, delta, us, n, k, batch,
                     stream);
}
"""
_PROBE_SLICE = [_VP] * 3 + [_LL] + [_VP] * 3 + [_I] * 3 + [_VP]


def probe_slice_entry(lib, dtype):
    """The route-A probe's one-launch slice, called as
    ``ops/kernels.py submatrix_slice_plain`` is."""
    fn = _bind(lib, "probe_slice" + ("_f64" if dtype == "float64"
                                     else "_f32"), _PROBE_SLICE)

    def run(G, acc, order, gb, delta, us, k, sgn=None):
        W, n = G.shape[0], G.shape[-1]
        _check(fn(_ptr(G), _ptr(acc), _ptr(order),
                  0 if order.dim() == 1 else n, _ptr(gb), _ptr(delta),
                  _ptr(us), n, k, W, _stream()), "probe slice")
    return run


def _sub_cases():
    for W, ns, k, dtype in SUB_CASES:
        for pw in (False, True):
            yield W, ns, k, dtype, pw
    yield 4, 36, 32, "float32", True


def submatrix_split(torch, source, tmp) -> None:
    """Step 0: the seed's #5 launches per group and its slice, and the
    seed's #2c loop with and without its flush and its decisions, in
    device time."""
    seed = nvcc_all({"seed": source.read_text()}, tmp, source)["seed"]
    for W, ns, k, dtype, pw in _sub_cases():
        inputs = delayed_inputs(torch, W, ns, 1, dtype, 1, True, pw)
        G0, gb, delta, us, order = inputs
        decide, prep, flush, slice_fn = seed_sub_pieces(seed, dtype)
        G = G0.clone()
        new = lambda *s: torch.zeros((W,) + s, dtype=G.dtype, device="cuda")
        Wm, Ut, M = new(k, k), new(k, ns), new(k, ns)
        acc = torch.zeros_like(gb)
        blk = (acc, order, gb, delta, us, 0, k)
        decide(G, Wm, *blk)
        prep(G, Wm, Ut, M, order, 0, k)
        groups = -(-ns // k)
        t = {"decide": device_ms(lambda: decide(G, Wm, *blk), 10),
             "prep": device_ms(lambda: prep(G, Wm, Ut, M, order, 0, k), 10),
             "flush": device_ms(lambda: flush(G, Ut, M, k), 10),
             "baddbmm": device_ms(lambda: G.baddbmm_(Ut.mT, M), 10),
             "slice": device_ms(lambda: run_slice(torch, slice_fn, inputs,
                                                  k), 3)}
        print(f"submatrix seed {_tag(W, ns, k, 1, dtype, pw)}, device time "
              f"per group: decide {t['decide']:.4f} ms, prep "
              f"{t['prep']:.4f} ms, flush {t['flush']:.4f} ms, baddbmm_ "
              f"{t['baddbmm']:.4f} ms; slice {t['slice']:.4f} ms ({groups} "
              f"groups: launches x groups "
              f"{(t['decide'] + t['prep'] + t['flush']) * groups:.4f})",
              flush=True)
    src = source.parent
    builds = {"seed": source.parent / "fused_block.cu"}
    for i, (name, (fname, old, new_text)) in enumerate(
            SUB_FUSED_STUBS.items()):
        d = tmp / f"stub{i}"
        d.mkdir()
        for f in src.iterdir():
            if f.suffix in (".cu", ".cuh"):
                text = f.read_text()
                if f.name == fname:
                    if text.count(old) != 1:
                        sys.exit(f"stub {name!r} matches {text.count(old)} "
                                 f"times in {f}")
                    text = text.replace(old, new_text)
                (d / f.name).write_text(text)
        builds[name] = d / "fused_block.cu"
    libs = {}
    for name, path in builds.items():
        tag = "fused_" + name.replace(" ", "_")
        libs[name] = nvcc_all({tag: path.read_text()}, tmp, path)[tag]
    for W, ns, k in SUB_FUSED_CASES:
        inputs = site_inputs(torch, W, ns, 1, "float32", 1, True)
        t = {name: device_ms(lambda: sub_loop_entry(lib, "float32")(
            torch, inputs, k), 3) for name, lib in libs.items()}
        print(f"submatrix seed #2c ({W}, {ns}, {k}) float32, device time per "
              f"slice: " + ", ".join(f"{name} {ms:.4f} ms"
                                     for name, ms in t.items()), flush=True)


def _same(torch, a, b):
    """G and the flags of two runs: equal bit for bit?"""
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    return ("G " + ("equal" if same[0] else
                    f"DIFFERS (max {float((a[0] - b[0]).abs().max()):.3e})")
            + ", flags " + ("equal" if same[1] else
                            f"DIFFER ({int((a[1] != b[1]).sum())})"))


def submatrix_bits(torch, source, tmp) -> None:
    """The seed's #5 slice and #2c loop against the checkout's (and #5's
    route-A probe) on inputs with rejections: G and the flags bit for
    bit?"""
    from dqmc_tpu_torch.ops import kernels as tk
    seed = nvcc_all({"seed": source.read_text()}, tmp, source)["seed"]
    fseed = nvcc_all({"fseed": (source.parent / "fused_block.cu")
                      .read_text()}, tmp,
                     source.parent / "fused_block.cu")["fseed"]
    probe = nvcc_all({"probe": PROBE_SUB_SRC}, tmp)["probe"]
    for W, ns, k, dtype, pw in _sub_cases():
        inputs = delayed_inputs(torch, W, ns, 1, dtype, 7 + ns, False, pw)
        a = run_slice(torch, seed_sub_pieces(seed, dtype)[3], inputs, k)
        b = run_slice(torch, tk.KERNELS.submatrix_slice, inputs, k)
        c = run_slice(torch, probe_slice_entry(probe, dtype), inputs, k)
        torch.cuda.synchronize()
        rej = int((a[1] == 0).sum())
        full = int((a[1].view(W, -1)[:, :ns // k * k].view(W, -1, k)
                    .sum(-1) == k).sum())
        print(f"submatrix bits {_tag(W, ns, k, 1, dtype, pw)} "
              f"({a[1].numel() - rej} of {a[1].numel()} accepted, {full} "
              f"groups all accepted): checkout {_same(torch, a, b)}; route A "
              f"{_same(torch, a, c)}", flush=True)
    # #5 past the clusters' ns <= 1024 (ceil(ns / 64) CTAs per walker, a
    # short last group; no route A there)
    for dtype in ("float64", "float32"):
        W, ns, k = 2, 34 * 34, 32
        inputs = delayed_inputs(torch, W, ns, 1, dtype, 7 + ns, False, True)
        a = run_slice(torch, seed_sub_pieces(seed, dtype)[3], inputs, k)
        b = run_slice(torch, tk.KERNELS.submatrix_slice, inputs, k)
        torch.cuda.synchronize()
        print(f"submatrix bits {_tag(W, ns, k, 1, dtype, True)} "
              f"({int(a[1].sum())} of {a[1].numel()} accepted): checkout "
              f"{_same(torch, a, b)}", flush=True)
    for W, ns, k in ((16, 256, 32), (4, 36, 4), (16, 416, 32)):
        for dtype in ("float64", "float32"):
            inputs = site_inputs(torch, W, ns, 1, dtype, 7 + ns, False)
            a = sub_loop_entry(fseed, dtype)(torch, inputs, k)
            b = sub_loop_entry(_checkout(), dtype)(torch, inputs, k)
            torch.cuda.synchronize()
            print(f"submatrix bits #2c ({W}, {ns}, {k}) {dtype} "
                  f"({int(a[1].sum())} of {a[1].numel()} accepted): "
                  f"checkout {_same(torch, a, b)}", flush=True)


def _checkout():
    from dqmc_tpu_torch import _cuda
    return _cuda.lib()


def submatrix_times(torch, source, tmp) -> None:
    """The seed's #5 slice against the checkout's, alternating (seed,
    checkout, checkout, seed), in device time, with the checkout's group
    kernel and flush alone; then #2c the same way, and #2c in float64 at
    ns = 484 and 512 (which the seed refused)."""
    from dqmc_tpu_torch.ops import kernels as tk
    seed = nvcc_all({"seed": source.read_text()}, tmp, source)["seed"]
    fseed = nvcc_all({"fseed": (source.parent / "fused_block.cu")
                      .read_text()}, tmp,
                     source.parent / "fused_block.cu")["fseed"]
    lib = _checkout()
    for W, ns, k, dtype, pw in _sub_cases():
        inputs = delayed_inputs(torch, W, ns, 1, dtype, 1, True, pw)
        fns = {"seed": seed_sub_pieces(seed, dtype)[3],
               "checkout": tk.KERNELS.submatrix_slice}
        t = {"seed": [], "checkout": []}
        for name in ("seed", "checkout", "checkout", "seed"):
            t[name].append(device_ms(lambda: run_slice(
                torch, fns[name], inputs, k), 3))
        G0, gb, delta, us, order = inputs
        G = G0.clone()
        acc = torch.zeros_like(gb)
        Ut, M = (torch.zeros((W, k, ns), dtype=G.dtype, device="cuda")
                 for _ in range(2))
        sfx = "_f64" if dtype == "float64" else "_f32"
        grp = _bind(lib, "dqmc_submatrix_group" + sfx,
                    [_VP] * 3 + [_LL] + [_VP] * 5 + [_I] * 5 + [_VP])
        so = 0 if order.dim() == 1 else ns
        one = lambda: _check(grp(_ptr(G), _ptr(acc), _ptr(order), so,
                                 _ptr(gb), _ptr(delta), _ptr(us), _ptr(Ut),
                                 _ptr(M), ns, k, 0, k, W, _stream()),
                             "group")
        tg = device_ms(one, 10)
        tf = device_ms(lambda: tk.KERNELS.submatrix_flush(G, Ut, M, k), 10)
        print(f"submatrix times {_tag(W, ns, k, 1, dtype, pw)}, device time "
              f"per slice: seed {t['seed'][0]:.4f} / {t['seed'][1]:.4f} ms, "
              f"checkout {t['checkout'][0]:.4f} / {t['checkout'][1]:.4f} ms;"
              f" checkout per group: group kernel {tg:.4f} ms, flush "
              f"{tf:.4f} ms", flush=True)
    for W, ns, k in SUB_FUSED_CASES:
        inputs = site_inputs(torch, W, ns, 1, "float32", 1, True)
        fns = {"seed": sub_loop_entry(fseed, "float32"),
               "checkout": sub_loop_entry(lib, "float32")}
        t = {"seed": [], "checkout": []}
        for name in ("seed", "checkout", "checkout", "seed"):
            t[name].append(device_ms(lambda: fns[name](torch, inputs, k), 3))
        print(f"submatrix times #2c ({W}, {ns}, {k}) float32, device time "
              f"per slice: seed {t['seed'][0]:.4f} / {t['seed'][1]:.4f} ms, "
              f"checkout {t['checkout'][0]:.4f} / {t['checkout'][1]:.4f} ms",
              flush=True)
    for W, ns in ((16, 484), (16, 512)):
        k = 4 if ns % 32 else 32
        inputs = site_inputs(torch, W, ns, 1, "float64", 1, True)
        ms = device_ms(lambda: sub_loop_entry(lib, "float64")(
            torch, inputs, k), 3)
        print(f"submatrix times #2c ({W}, {ns}, {k}) float64 (the seed "
              f"refused it), device time per slice: checkout {ms:.4f} ms",
              flush=True)


def submatrix_probes(torch, source, tmp) -> None:
    """#5's two launches per group (the checkout) against one cluster
    launch per slice with the in-cluster flush (route A, PROBE_SUB_SRC),
    alternating, in device time."""
    from dqmc_tpu_torch.ops import kernels as tk
    probe = nvcc_all({"probe": PROBE_SUB_SRC}, tmp)["probe"]
    for W, ns, k, dtype in SUB_CASES:
        inputs = delayed_inputs(torch, W, ns, 1, dtype, 1, True, False)
        fns = {"two launches per group": tk.KERNELS.submatrix_slice,
               "one cluster launch": probe_slice_entry(probe, dtype)}
        t = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            t[name].append(device_ms(lambda: run_slice(
                torch, fns[name], inputs, k), 3))
        print(f"submatrix probes {_tag(W, ns, k, 1, dtype, False)}, device "
              f"time per slice: " + ", ".join(
                  f"{name} {a:.4f} / {b:.4f} ms" for name, (a, b) in
                  t.items()), flush=True)


def _panel_fn(lib, words):
    return _bind(lib, "dqmc_df_qr_panel" if words == 2 else
                 "dqmc_tf_qr_panel", [_VP] * 3 + [_I] * 2 + [_VP])


def _panel_call(torch, fn, P):
    """(q, r) of one call of a panel entry point on the multiword panel P
    (B, 32, n): the words stacked outermost, as ops/df_qr_kernel.py
    passes them."""
    B, _, n = P.hi.shape
    p = torch.stack(tuple(P)).contiguous()
    q = torch.empty_like(p)
    r = torch.empty((len(P), B, 32, 32), dtype=p.dtype, device=p.device)
    _check(fn(_ptr(p), _ptr(q), _ptr(r), B, n, _stream()), "panel")
    return q, r


_PANEL_NM = ((2, "df32", "#7"), (3, "tf32", "#8"))


def _nm(words):
    from dqmc_tpu_torch.ops import df32, tf32
    return df32 if words == 2 else tf32


def panels_split(torch, source, tmp) -> None:
    """Device time per panel of the seed and of its builds without one
    stage each; the differences are the stages' shares."""
    libs = nvcc_all(stubbed(source, PANEL_STUBS), tmp, source, PANEL_FLAGS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    for words, tname, num in _PANEL_NM:
        for B, n in PANEL_SHAPES:
            P = panel_inputs(torch, gen, _nm(words), B, n)
            fns = {name: _panel_fn(lib, words) for name, lib in libs.items()}
            t = {name: device_ms(lambda: _panel_call(torch, fn, P), 10)
                 for name, fn in fns.items()}
            t["full"] = (t["full"] + device_ms(
                lambda: _panel_call(torch, fns["full"], P), 10)) / 2
            full = t["full"]
            print(f"panels split {num} {tname} ({B}, 32, {n}), device ms "
                  f"per panel: seed {full:.4f}; without " + ", ".join(
                      f"{name} {ms:.4f} ({full - ms:+.4f}, "
                      f"{100 * (full - ms) / full:.1f}%)"
                      for name, ms in t.items() if name != "full"),
                  flush=True)


def panels_probe(torch, source, tmp) -> None:
    """Cycles per column of each phase of the checkout's kernel (thread 0
    of block 0, clock64(), a probe build), at the shapes of ``split``."""
    lib = nvcc_all({"probe": probed(
        (REPO / "dqmc_tpu_torch" / "csrc" / "mw_qr_panel.cu").read_text())},
        tmp, None, PANEL_FLAGS)["probe"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    for words, tname, num in _PANEL_NM:
        for B, n in PANEL_SHAPES:
            P = panel_inputs(torch, gen, _nm(words), B, n)
            _panel_call(torch, _panel_fn(lib, words), P)
            _, r = _panel_call(torch, _panel_fn(lib, words), P)
            cyc = r[0, 0, 0, :32].contiguous().view(torch.int64).tolist()
            total = sum(cyc[:len(PANEL_PROBES)])
            print(f"panels probe {num} {tname} ({B}, 32, {n}), cycles per "
                  f"column (thread 0, block 0): {total / 32:.0f}: " + ", ".join(
                      f"{name} {c / 32:.0f} ({100 * c / total:.1f}%)"
                      for (_, _, name), c in zip(PANEL_PROBES, cyc)),
                  flush=True)


def panels_bits(torch, source, tmp) -> None:
    """The seed against the checkout on every panel of
    chip_smoke.panel_cases, both word counts: Q and R bit for bit?"""
    seed = nvcc_all({"seed": source.read_text()}, tmp, source,
                    PANEL_FLAGS)["seed"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for words, tname, num in _PANEL_NM:
        for label, P in panel_cases(torch, gen, _nm(words)):
            a = _panel_call(torch, _panel_fn(seed, words), P)
            b = _panel_call(torch, _panel_fn(_checkout(), words), P)
            torch.cuda.synchronize()
            diff = [int((x != y).sum()) for x, y in zip(a, b)]
            print(f"panels bits {num} {tname} {label}: words of Q, R "
                  f"differing from the seed {diff[0]}, {diff[1]} "
                  f"({'equal' if not any(diff) else 'DIFFER'})", flush=True)


def panels_times(torch, source, tmp) -> None:
    """The seed and the checkout alternating (seed, checkout, checkout,
    seed), device time per panel, beside torch.linalg.qr in float64."""
    seed = nvcc_all({"seed": source.read_text()}, tmp, source,
                    PANEL_FLAGS)["seed"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    for words, tname, num in _PANEL_NM:
        fns = {"seed": _panel_fn(seed, words),
               "checkout": _panel_fn(_checkout(), words)}
        for B, n in PANEL_SHAPES:
            nm = _nm(words)
            P = panel_inputs(torch, gen, nm, B, n)
            t = {"seed": [], "checkout": []}
            for name in ("seed", "checkout", "checkout", "seed"):
                t[name].append(device_ms(
                    lambda: _panel_call(torch, fns[name], P), 10))
            A64 = nm.to_f64(P).mT.contiguous()
            lib_ms = cuda_ms(lambda: torch.linalg.qr(A64), 5)
            print(f"panels times {num} {tname} ({B}, 32, {n}), device ms per "
                  f"panel: seed {t['seed'][0]:.4f} / {t['seed'][1]:.4f}, "
                  f"checkout {t['checkout'][0]:.4f} / "
                  f"{t['checkout'][1]:.4f}; torch.linalg.qr float64 of the "
                  f"panel {lib_ms:.4f} (CUDA events)", flush=True)


# #6's shapes: examples/basic (W = 4, 6 x 6), the headline's view (16,
# 16 x 16) and the stretch (4, 32 x 32), as (W, L)
RANK1_SHAPES = ((4, 6), (16, 16), (4, 32))
# the seed's stages (its rank1_sites_kernel), one per build
_RANK1_LOOP = "    for (long long e = tid; e < (long long)n * n; e += nthr) {\n"
RANK1_STUBS = {
    "division": ("const int a = (int)(e / n), b = (int)(e - (long long)a * n);",
                 "const int a = (int)(e >> 5) & 31, b = (int)e & 31;"),
    "G traffic": ((_RANK1_LOOP, "    T sink = T(0);\n" + _RANK1_LOOP),
                  ("      G[e] += col[a] * row[b];\n    }\n",
                   "      sink = fma(col[a], row[b], sink);\n    }\n"
                   "    if (sink == T(-7.25)) G[tid] = sink;\n")),
    "barriers": (("    __syncthreads();\n" + _RANK1_LOOP, _RANK1_LOOP),
                 ("    }\n    __syncthreads();\n  }\n}\n",
                  "    }\n  }\n}\n")),
    "updates": ("if (!accept) continue;", "continue;"),
}
RANK1_LAYOUTS = (1, 2, 4, 8, 16)
# the checkout's choice of cluster, replaced by a fixed C for ``times``
RANK1_POLICY = ("  int C = 1;\n  while (C < dqmc::SITE_CLUSTER_MAX && "
                "(n + C - 1) / C > RANK1_RMAX) C *= 2;\n  return C;\n")
# throwaway builds of the checkout's #6 for ``probes`` (wrong results; only
# the times are read): an accepted visit updates row nx alone (the handoff
# chain without the bulk update), and a row travels as one vector
RANK1_PROBES = {
    "row nx alone": (
        ("        for (int q = 0; q < VW; ++q) greg[k][q] = fma(cl, rv[q], "
         "greg[k][q]);",
         "        for (int q = 0; q < VW; ++q)\n"
         "          if (l == lnx) greg[k][q] = fma(cl, rv[q], greg[k][q]);"),
        ("for (int l0 = rg + LR; l0 < own; l0 += B * RG) {",
         "for (int l0 = rg + LR; l0 < 0; l0 += B * RG) {")),
    "one vector per row": (
        ("const unsigned row_bytes = 16u * NV;",
         "const unsigned row_bytes = 16u;"),
        ("      for (int r = 0; r < C; ++r)\n        st_async_vec",
         "      for (int r = 0; r < (j == 0 ? C : 0); ++r)\n"
         "        st_async_vec")),
}
_RANK1 = [_VP] * 3 + [_LL] + [_VP] * 3 + [_I] * 2 + [_VP]


def rank1_fn(lib, dtype):
    return _bind(lib, "dqmc_rank1_sites" + ("_f64" if dtype == "float64"
                                            else "_f32"), _RANK1)


def rank1_inputs(torch, W, L, dtype, shared):
    """One slice of #6 as phase 6 gives it (chip_smoke.slice_inputs: a
    physical G at the stretch dtau, per-walker couplings): G (W, n, n),
    the order ((n,) shared or (W, n)), gb, delta and us by visit."""
    from chip_smoke import slice_inputs
    from dqmc_tpu_torch.ops import kernels as tk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(100 + L)
    dt = getattr(torch, dtype)
    G, fields, orders, props, us, g, alpha = slice_inputs(torch, gen, W, L,
                                                          dt)
    n = L * L
    order = (orders[0] if shared else orders).to(torch.int32).contiguous()
    _, gb, delta = tk.visit_factors(g, alpha, fields,
                                    order.long().expand(W, n), props, dt)
    return (G[:, 0].contiguous(), order, gb.contiguous(), delta.contiguous(),
            us.contiguous())


def run_rank1(torch, fn, inputs):
    """One launch on a copy of G; returns (G, accept flags)."""
    G0, order, gb, delta, us = inputs
    W, n = gb.shape
    G = G0.clone()
    acc = torch.zeros_like(gb)
    _check(fn(_ptr(G), _ptr(acc), _ptr(order), 0 if order.dim() == 1 else n,
              _ptr(gb), _ptr(delta), _ptr(us), n, W, _stream()), "rank1")
    return G, acc


def rank1_probes(torch, source, tmp) -> None:
    """The checkout's #6 against the RANK1_PROBES builds, alternating,
    device time per launch at RANK1_SHAPES in float32."""
    src = REPO / "dqmc_tpu_torch" / "csrc" / "site_update.cu"
    libs = nvcc_all(stubbed(src, RANK1_PROBES), tmp, None)
    for W, L in RANK1_SHAPES:
        n = L * L
        inputs = rank1_inputs(torch, W, L, "float32", False)
        t = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            fn = rank1_fn(libs[name], "float32")
            t[name].append(device_ms(lambda: run_rank1(torch, fn, inputs),
                                     _rank1_reps(n)))
        print(f"rank1 probes ({W}, {n}) float32, device ms per launch: "
              + ", ".join(f"{'checkout' if name == 'full' else name} "
                          f"{a:.4f} / {b:.4f}" for name, (a, b) in
                          t.items()), flush=True)


# the checkout's #6 with clock64() stamps between the stages of a visit:
# (text before, text after, the stage that ends between them); every
# thread keeps the sums, and thread 0 of CTA 0 of walker 0 writes them
# over that walker's first accept flags when the slice is done
RANK1_CLOCKS = (
    ("    __syncthreads();\n", "    if constexpr (!ONE) {\n      if (v > 0",
     "top barrier (the own CTA's last update)"),
    ("        mbar_expect(smem_addr(full + v % D), row_bytes);\n    }\n", "",
     "free arrivals, wait for the row"),
    ("      a.acc[ws + v] = accept ? T(1) : T(0);\n",
     "", "decision"),
    ("      if (nx >= 0) produce(v + 1, nx);\n", "      continue;",
     "rejected: row nx and column nx"),
    ("      pend = true;\n    }\n", "  }\n  // no CTA leaves",
     "accepted: the update and the pushes"),
)


def rank1_clocked(text: str) -> str:
    stamp = ("    {{ const long long c_ = clock64(); prof_[{k}] += c_ - t_; "
             "t_ = c_; }}\n")
    for k, (before, after, _) in enumerate(RANK1_CLOCKS):
        if text.count(before + after) != 1:
            sys.exit(f"rank1 probe {k}: anchor matches "
                     f"{text.count(before + after)} times")
        text = text.replace(before + after,
                            before + stamp.format(k=k) + after)
    head = "  T greg[KR][VW];  // own rows rg + k RG, k < KR\n"
    tail = ("  // no CTA leaves while another may still arrive on its barriers "
            "(and\n")
    for anchor in (head, tail):
        if text.count(anchor) != 1:
            sys.exit("rank1 probe: kernel anchors not found")
    n = len(RANK1_CLOCKS)
    text = text.replace(head, head + (
        f"  long long prof_[{n}] = {{}};\n  long long t_ = clock64();\n"))
    return text.replace(tail, (
        "  if (tid == 0 && c == 0 && w == 0)\n"
        f"    for (int k = 0; k < {n}; ++k)\n"
        "      reinterpret_cast<long long*>(a.acc)[k] = prof_[k];\n" + tail))


def rank1_clock(torch, source, tmp) -> None:
    """Cycles per visit by stage (thread 0 of CTA 0, walker 0) of the
    checkout's #6 in a clock64() build, float32 at RANK1_SHAPES."""
    src = (REPO / "dqmc_tpu_torch" / "csrc" / "site_update.cu").read_text()
    lib = nvcc_all({"clock": rank1_clocked(src)}, tmp, None)["clock"]
    for W, L in RANK1_SHAPES:
        n = L * L
        inputs = rank1_inputs(torch, W, L, "float32", False)
        run_rank1(torch, rank1_fn(lib, "float32"), inputs)
        acc = run_rank1(torch, rank1_fn(lib, "float32"), inputs)[1]
        cyc = acc[0, :2 * len(RANK1_CLOCKS)].contiguous().view(
            torch.int64).tolist()
        total = sum(cyc)
        print(f"rank1 clock ({W}, {n}) float32, cycles per visit (thread 0 "
              f"of CTA 0, walker 0): {total / n:.0f}: " + ", ".join(
                  f"{name} {c / n:.0f} ({100 * c / total:.1f}%)"
                  for (_, _, name), c in zip(RANK1_CLOCKS, cyc)),
              flush=True)


def _rank1_reps(n):
    return 2 if n > 512 else 20


def rank1_split(torch, source, tmp) -> None:
    """Device time per launch of the seed and of its builds without one
    stage each (wrong results; the accepted counts show how far the
    decisions moved)."""
    libs = nvcc_all(stubbed(source, RANK1_STUBS), tmp, source)
    for dtype in ("float32", "float64"):
        for W, L in RANK1_SHAPES:
            n = L * L
            inputs = rank1_inputs(torch, W, L, dtype, False)
            t, took = {}, {}
            for name, lib in libs.items():
                fn = rank1_fn(lib, dtype)
                took[name] = int(run_rank1(torch, fn, inputs)[1].sum())
                t[name] = device_ms(lambda: run_rank1(torch, fn, inputs),
                                    _rank1_reps(n))
            full = t["full"]
            print(f"rank1 split ({W}, {n}) {dtype}, device ms per launch: "
                  f"seed {full:.4f} ({took['full']} of {W * n} accepted); "
                  "without " + ", ".join(
                      f"{name} {ms:.4f} ({full - ms:+.4f}, "
                      f"{100 * (full - ms) / full:.1f}%; {took[name]} "
                      f"accepted)" for name, ms in t.items()
                      if name != "full"), flush=True)


def rank1_bits(torch, source, tmp) -> None:
    """The seed against the checkout: G and the flags bit for bit?"""
    seed = nvcc_all({"seed": source.read_text()}, tmp, source)["seed"]
    for dtype in ("float64", "float32"):
        for W, L in RANK1_SHAPES:
            for shared in (True, False):
                inputs = rank1_inputs(torch, W, L, dtype, shared)
                a = run_rank1(torch, rank1_fn(seed, dtype), inputs)
                b = run_rank1(torch, rank1_fn(_checkout(), dtype), inputs)
                torch.cuda.synchronize()
                print(f"rank1 bits ({W}, {L * L}) {dtype} "
                      f"{'shared' if shared else 'per-walker'} order "
                      f"({int(a[1].sum())} of {a[1].numel()} accepted, max "
                      f"|G| {float(a[0].abs().max()):.3e}): "
                      f"{_same(torch, a, b)}", flush=True)


def rank1_times(torch, source, tmp) -> None:
    """The seed and the checkout alternating, then the checkout with the
    cluster fixed at each of RANK1_LAYOUTS beside the default build; device
    time per launch (with the copy of G the call makes)."""
    csrc = REPO / "dqmc_tpu_torch" / "csrc"
    src = (csrc / "site_update.cu").read_text()
    seed = nvcc_all({"seed": source.read_text()}, tmp, source)["seed"]
    if src.count(RANK1_POLICY) != 1:
        sys.exit("rank1 times: the cluster policy's text not found")
    layouts = nvcc_all({f"C{C}": src.replace(RANK1_POLICY, f"  return {C};\n")
                        for C in RANK1_LAYOUTS}, tmp, None)
    layouts = {C: layouts[f"C{C}"] for C in RANK1_LAYOUTS}
    for dtype in ("float32", "float64"):
        for W, L in RANK1_SHAPES:
            n = L * L
            inputs = rank1_inputs(torch, W, L, dtype, False)
            fns = {"seed": rank1_fn(seed, dtype),
                   "checkout": rank1_fn(_checkout(), dtype)}
            t = {"seed": [], "checkout": []}
            for name in ("seed", "checkout", "checkout", "seed"):
                t[name].append(device_ms(lambda: run_rank1(
                    torch, fns[name], inputs), _rank1_reps(n)))
            lay = {}
            for C, lib in layouts.items():
                fn = rank1_fn(lib, dtype)
                lay[C] = device_ms(lambda: run_rank1(torch, fn, inputs),
                                   _rank1_reps(n))
            print(f"rank1 times ({W}, {n}) {dtype}, device ms per launch: "
                  f"seed {t['seed'][0]:.4f} / {t['seed'][1]:.4f}, checkout "
                  f"{t['checkout'][0]:.4f} / {t['checkout'][1]:.4f}; "
                  "layouts " + ", ".join(f"C={C} {ms:.4f}"
                                         for C, ms in lay.items()),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("k1", "sites", "delayed",
                                       "submatrix", "panels", "rank1"))
    ap.add_argument("--source", required=True, type=Path,
                    help="the seed's cgs2_qr.cu (k1), fused_block.cu "
                    "(sites), site_update.cu (delayed), "
                    "submatrix_update.cu (submatrix), mw_qr_panel.cu "
                    "(panels) or site_update.cu (rank1)")
    ap.add_argument("--parts", default="split,barriers,bits,times",
                    help="sites: which of split, barriers, bits, times; "
                    "delayed and submatrix: which of split, bits, times, "
                    "probes; panels: which of split, bits, times, probe; "
                    "rank1: which of split, bits, times, probes, clock")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(card(), flush=True)
    if opts.kernel == "k1":
        return k1_split(opts)
    parts = opts.parts.split(",")
    if opts.kernel == "rank1":
        with tempfile.TemporaryDirectory() as tmp:
            for part, run in (("split", rank1_split), ("bits", rank1_bits),
                              ("times", rank1_times),
                              ("probes", rank1_probes),
                              ("clock", rank1_clock)):
                if part in parts:
                    run(torch, opts.source, Path(tmp))
        return
    if opts.kernel == "panels":
        with tempfile.TemporaryDirectory() as tmp:
            for part, run in (("split", panels_split),
                              ("bits", panels_bits),
                              ("times", panels_times),
                              ("probe", panels_probe)):
                if part in parts:
                    run(torch, opts.source, Path(tmp))
        return
    if opts.kernel == "submatrix":
        with tempfile.TemporaryDirectory() as tmp:
            for part, run in (("split", submatrix_split),
                              ("bits", submatrix_bits),
                              ("times", submatrix_times),
                              ("probes", submatrix_probes)):
                if part in parts:
                    run(torch, opts.source, Path(tmp))
        return
    if opts.kernel == "delayed":
        with tempfile.TemporaryDirectory() as tmp:
            seed = nvcc_all({"seed": opts.source.read_text()}, Path(tmp),
                            opts.source)["seed"]
            for part, run in (("split", delayed_split),
                              ("bits", delayed_bits),
                              ("times", delayed_times),
                              ("probes", delayed_probes)):
                if part in parts:
                    run(torch, seed, Path(tmp))
        return
    with tempfile.TemporaryDirectory() as tmp:
        if "split" in parts:
            site_split(torch, opts, Path(tmp))
        if "barriers" in parts:
            barriers(torch, Path(tmp))
        if "bits" in parts or "times" in parts:
            seed = nvcc_all({"seed": opts.source.read_text()}, Path(tmp),
                            opts.source)["seed"]
            if "bits" in parts:
                bits(torch, seed)
            if "times" in parts:
                times(torch, seed)


if __name__ == "__main__":
    main()
