"""Build and bind the port's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` expose a plain C interface.  At first use each
is compiled with its own ``nvcc`` process for ``sm_90a`` (all started
together; ``SOURCE_FLAGS`` adds a source's own flags, such as
``--fmad=false`` for the multiword kernels, whose error-free
transformations a fused multiply-add would break), and the objects are
linked into one shared library under ``_build/`` (named by a hash of the
sources, headers and flags, so an edit never loads a stale build) and
loaded with ctypes.  Importing this module
needs no CUDA toolchain; only :func:`lib` (and so every kernel launch)
does.

Every launch goes through :func:`launch` (or :func:`call` plus
:func:`count` in a wrapper's inner loop), which raises on a non-zero
``cudaGetLastError()`` and adds one per kernel launch to the kernel's entry
in :data:`LAUNCHES` -- a plain counter that lets a run show which kernels it
went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"mw_qr_panel.cu": ("--fmad=false",)}

# kernel name -> launches since the last reset
LAUNCHES = {"cgs2_qr": 0, "fused_wrap": 0, "fused_sites": 0,
            "fused_sites_2f": 0, "fused_sites_sub": 0,
            "delayed_slice": 0, "delayed_slice_2f": 0,
            "rank1_sites": 0, "submatrix_group": 0, "submatrix_flush": 0,
            "df_qr_panel": 0, "tf_qr_panel": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SITE_LOOP = (_P, _P, _LL, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _P)
_DELAYED_SLICE = (_P, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _P)
_SIGNATURES = {  # each has a _f32 and a _f64 entry point
    "dqmc_cgs2_qr": (_P, _P, _P, _P, _P, _I, _I, _P),
    "dqmc_wrap_gemm": (_P, _P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _I, _P),
    "dqmc_site_loop": _SITE_LOOP,
    "dqmc_site_loop_2f": _SITE_LOOP,
    "dqmc_site_loop_sub": (_P, _P, _LL, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
    "dqmc_delayed_slice": _DELAYED_SLICE,
    "dqmc_delayed_slice_2f": _DELAYED_SLICE,
    "dqmc_rank1_sites": (_P, _P, _P, _LL, _P, _P, _P, _I, _I, _P),
    "dqmc_submatrix_slice": (_P, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I,
                             _I, _P),
    "dqmc_submatrix_group": (_P, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _P),
    "dqmc_submatrix_flush": (_P, _P, _P, _LL, _I, _I, _I, _P),
}
_FLOAT32_SIGNATURES = {  # float32-only entry points, no suffix
    "dqmc_df_qr_panel": (_P, _P, _P, _I, _I, _P),
    "dqmc_tf_qr_panel": (_P, _P, _P, _I, _I, _P),
}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_flags(src: Path) -> tuple:
    """The flags one source is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(src.name, ())


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(" ".join(nvcc_flags(src)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdqmc_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails (after all have ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile each ``csrc/*.cu`` with its own nvcc, in parallel, and link
    the shared library (no-op when built)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    try:
        _run_all([[nvcc, *nvcc_flags(src), "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)])
        tmp = out.with_name(f"{tag}.so.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            names = {base + sfx: args for base, args in _SIGNATURES.items()
                     for sfx in ("_f32", "_f64")}
            for name, argtypes in {**names, **_FLOAT32_SIGNATURES}.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.dqmc_cgs2_workspace.argtypes = [_I, _I]
            handle.dqmc_cgs2_workspace.restype = _LL
            handle.dqmc_site_cluster.argtypes = [_I, _I]
            handle.dqmc_site_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
            handle.dqmc_site_smem_bytes.restype = _LL
            handle.dqmc_sub_smem_bytes.argtypes = [_I, _I, _I]
            handle.dqmc_sub_smem_bytes.restype = _LL
            handle.dqmc_submatrix_group_ctas.argtypes = [_I]
            handle.dqmc_error_string.argtypes = [ctypes.c_int]
            handle.dqmc_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def ptr(t: torch.Tensor | None, offset: int = 0) -> ctypes.c_void_p:
    """Device address of ``t`` (plus ``offset`` elements); NULL for None."""
    if t is None:
        return ctypes.c_void_p(None)
    return ctypes.c_void_p(t.data_ptr() + offset * t.element_size())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "_f32"
    if dtype == torch.float64:
        return "_f64"
    raise TypeError(f"CUDA kernels take float32 or float64, not {dtype}")


def call(fn, *args) -> None:
    """Call a C entry point (from :func:`lib`) on the current device;
    raise on a CUDA error.  The caller counts the launch."""
    err = fn(*args)
    if err != 0:
        msg = lib().dqmc_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} ({msg})")


def count(kernel: str, n: int = 1) -> None:
    LAUNCHES[kernel] += n


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device`` and count the launch."""
    with torch.cuda.device(device):
        call(getattr(lib(), fn_name), *args)
    count(kernel)


def check(t: torch.Tensor, name: str, *, device: torch.device,
          dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given kind."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, not "
                         f"tensors on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
