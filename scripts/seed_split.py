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
from chip_smoke import LOOP_CASES, cuda_ms  # noqa: E402

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


def nvcc_all(jobs: dict, tmp: Path, include: Path | None = None) -> dict:
    """Build each {name: source text} into its own shared library, one nvcc
    each, in parallel; headers are looked up beside ``include`` (the seed)
    and then in the checkout's csrc/.  Returns {name: loaded library}."""
    cmds, libs = [], {}
    dirs = ([include.parent] if include else []) + [REPO / "dqmc_tpu_torch"
                                                    / "csrc"]
    for name, body in jobs.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(body)
        libs[name] = tmp / f"lib{name}.so"
        cmds.append(NVCC + [f"-I{d}" for d in dirs]
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
    for name, (old, new) in stubs.items():
        if text.count(old) != 1:
            sys.exit(f"{src}: stub {name!r} matches {text.count(old)} times")
        variants[name] = text.replace(old, new)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("k1", "sites"))
    ap.add_argument("--source", required=True, type=Path,
                    help="the seed's cgs2_qr.cu (k1) or fused_block.cu "
                    "(sites)")
    ap.add_argument("--parts", default="split,barriers,bits,times",
                    help="sites: which of split, barriers, bits, times")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(card(), flush=True)
    if opts.kernel == "k1":
        return k1_split(opts)
    parts = opts.parts.split(",")
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
