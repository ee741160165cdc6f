#!/usr/bin/env python3
"""Device time of the wrap GEMM (``csrc/fused_block.cu``) at several CTA and
register tile shapes, beside torch.matmul, on the card.

Builds one shared library that instantiates ``launch_gemm_tiles`` at each
shape in ``TILES`` (one nvcc; the kernel source is included as it is), and,
with ``--seed``, an earlier ``fused_block.cu`` through its own
``dqmc_wrap_gemm_f32``.  For each (matrices, n) it times the A-shared
product (expK G: one walker per grid slice) and the B-shared one (G invexpK
scaled by a row vector: the walkers' rows as one tall GEMM), as device time
per call (a CUDA graph of the calls between two events), and checks each
against torch.matmul.

    python3 scripts/wrap_gemm_tiles.py [--seed path/to/old/fused_block.cu]

Needs a CUDA card and nvcc.
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
from chip_smoke import device_ms  # noqa: E402

NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]
# (BM, BN, TM, TN, BK): CTA tile, register tile per thread, depth
TILES = ((64, 64, 8, 4, 16), (64, 64, 4, 4, 16), (128, 64, 8, 4, 16),
         (64, 128, 4, 8, 16), (64, 64, 4, 8, 16), (128, 128, 8, 8, 16),
         (32, 64, 4, 4, 16), (64, 32, 4, 4, 16), (64, 64, 8, 4, 32),
         (128, 64, 8, 8, 16), (64, 64, 4, 4, 32), (32, 32, 4, 4, 16))
SHAPES = ((16, 256), (64, 64), (4, 36))


def name(tile) -> str:
    return "tile_{}x{}_{}x{}_{}".format(*tile)


def build(tmp: Path, seed: Path | None) -> dict:
    lines = [f'#include "{REPO / "dqmc_tpu_torch/csrc/fused_block.cu"}"']
    for tile in TILES:
        lines.append(
            f'extern "C" int {name(tile)}(float* C, const float* A, '
            f"long long sA, const float* B, long long sB, const float* rv, "
            f"const float* mv, const float* cv, long long sV, int n, "
            f"int batch, void* stream) {{ return launch_gemm_tiles<float, "
            f"{', '.join(map(str, tile))}>(C, A, sA, B, sB, rv, mv, cv, sV, "
            f"n, batch, (cudaStream_t)stream); }}")
    (tmp / "tiles.cu").write_text("\n".join(lines) + "\n")
    jobs = [(tmp / "tiles.cu", tmp / "libtiles.so", [])]
    if seed is not None:
        jobs.append((seed, tmp / "libseed.so",
                     ["-I", str(seed.parent), "-I",
                      str(REPO / "dqmc_tpu_torch/csrc")]))
    procs = [subprocess.Popen(NVCC + inc + ["-o", str(out), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, out, inc in jobs]
    for proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed:\n{out}")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P, P, LL, P, LL, P, P, P, LL, I, I, P]
    lib = ctypes.CDLL(str(tmp / "libtiles.so"))
    fns = {name(t): getattr(lib, name(t)) for t in TILES}
    if seed is not None:
        fns["seed"] = ctypes.CDLL(str(tmp / "libseed.so")).dqmc_wrap_gemm_f32
    for fn in fns.values():
        fn.argtypes, fn.restype = sig, I
    return fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=Path, default=None,
                    help="an earlier fused_block.cu to time beside the tiles")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp), opts.seed.resolve() if opts.seed else None)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
        stream = lambda: ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream)
        for W, n in SHAPES:
            K = torch.randn((n, n), generator=gen, device="cuda")
            G = torch.randn((W, n, n), generator=gen, device="cuda")
            ev = torch.rand((W, n), generator=gen, device="cuda") + 0.5
            C = torch.empty_like(G)
            want_a, want_b = K @ G, (G @ K) * ev[:, :, None]
            print(f"({W}, {n}, {n}) f32: torch.matmul "
                  f"{device_ms(lambda: torch.matmul(K, G)):.4f} ms (expK G), "
                  f"{device_ms(lambda: torch.matmul(G, K)):.4f} ms (G K)",
                  flush=True)
            for label, fn in fns.items():
                a = lambda: fn(ptr(C), ptr(K), 0, ptr(G), n * n, None, None,
                               None, n, n, W, stream())
                b = lambda: fn(ptr(C), ptr(G), n * n, ptr(K), 0, ptr(ev),
                               None, None, n, n, W, stream())
                errs = []
                for call, want in ((a, want_a), (b, want_b)):
                    if call():
                        sys.exit(f"{label}: launch failed")
                    torch.cuda.synchronize()
                    errs.append(float((C - want).abs().max()
                                      / want.abs().max()))
                print(f"  {label:22s} {device_ms(a):.4f} ms (A shared), "
                      f"{device_ms(b):.4f} ms (B shared), relative error "
                      f"{max(errs):.1e}", flush=True)


if __name__ == "__main__":
    main()
