#!/usr/bin/env python3
"""Stage split of the one-CTA-per-matrix CGS2 QR kernel (K1 before its
grid-wide redesign), on the card.

The earlier kernel ran a whole factorization in one launch, so no profiler
can split it.  This script takes that kernel's source, builds it four
times -- as it is, without the two block projection passes, without the
in-panel column loop, and without the zero fill of R -- each with its own
nvcc (in parallel), and times each build through its C entry point
(``dqmc_cgs2_qr_f32``) with and without R^{-1}.  The differences give each
stage's share: block passes, in-panel loop, R^{-1} back substitution,
zero fill, and the rest (panel loads and stores).  The stubbed builds
compute wrong factors; only their times are read.

    git show <commit>:dqmc_tpu_torch/csrc/cgs2_qr.cu > old_cgs2_qr.cu
    python3 scripts/k1_seed_split.py --source old_cgs2_qr.cu

with <commit> one whose K1 is still the one-CTA-per-matrix kernel: the
stubs match that kernel's text only, and the script stops on any other.

Needs a CUDA card and nvcc; prints one line per shape and stage.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# variant name -> (text in the source, its replacement)
STUBS = {
    "no_block": ("pass < 2 && p0 > 0", "pass < 0 && p0 > 0"),
    "no_panel": ("for (int t = 0; t < PANEL; ++t) {\n      T* y",
                 "for (int t = 0; t < 0; ++t) {\n      T* y"),
    "no_zero": ("e += THREADS) r[e] = T(0);", "e += THREADS) {}"),
}
SHAPES = (((16, 256), 20), ((4, 1024), 3))


def build(src: Path, tmp: Path) -> dict:
    text = src.read_text()
    variants = {"full": text}
    for name, (old, new) in STUBS.items():
        if text.count(old) != 1:
            sys.exit(f"{src}: stub {name!r} matches {text.count(old)} times")
        variants[name] = text.replace(old, new)
    cmds, libs = [], {}
    for name, body in variants.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(body)
        libs[name] = tmp / f"lib{name}.so"
        cmds.append(["/usr/local/cuda/bin/nvcc", "-gencode",
                     "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-o",
                     str(libs[name]), str(cu)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed: {' '.join(cmd)}\n{out}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.dqmc_cgs2_qr_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        loaded[name] = fn
    return loaded


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True, type=Path,
                    help="the one-CTA-per-matrix cgs2_qr.cu to split")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(opts.source, Path(tmp))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        for (B, n), reps in SHAPES:
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
                once()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    once()
                stop.record()
                torch.cuda.synchronize()
                return start.elapsed_time(stop) / reps

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


if __name__ == "__main__":
    main()
