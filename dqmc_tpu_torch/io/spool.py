"""Binned-measurement spool: a length-prefixed binary log of bins.

PyTorch-port counterpart of ``dqmc_tpu/io/spool.py``.  With ``[io] sink =
spool`` each walker's bins are appended to ``data_<rank>.spool`` as they
close, instead of being written through h5py; ``convert_spool_to_h5``
replays a log into the reference's HDF5 layout (``io/h5out.py``), so the
analysis contract is unchanged.  The log needs only numpy, so a machine
without h5py still writes every bin, and the logs are converted later
where h5py is installed:

    python -m dqmc_tpu_torch.io.spool results/     # every data_*.spool

The byte layout is that of the JAX package's native writer
(``native/dqmc_spool.cpp``), little-endian:

    magic "DQMB" | u32 version (1)
    per record: u32 name_len | name | i64 bin_idx | u8 kind (0 real,
    1 complex) | u32 ndim | i64 shape[ndim] | f64 data[prod(shape)
    * (2 if complex else 1)], complex values as interleaved (re, im)

Records are written on the calling thread.  A log that cannot be opened or
written raises; nothing falls back to h5.  A resumed run appends to its
log (``append=True``): a partial record left at the end by an interrupted
write is cut off first, and a bin written again after a resume overrides
its earlier records when the log is read back (``read_bins``).
"""

from __future__ import annotations

import glob
import os
import struct
import sys
from typing import Dict

import numpy as np

MAGIC = b"DQMB"
VERSION = 1
HEADER = MAGIC + struct.pack("<I", VERSION)


def _complete_length(path) -> int:
    """Bytes of the log up to the end of its last complete record; raises
    when the file is not a version-1 spool log."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(8) != HEADER:
            raise ValueError(f"{path}: not a version-1 dqmc spool log")
        end = 8
        while True:
            head = f.read(4)
            if len(head) < 4:
                return end
            (name_len,) = struct.unpack("<I", head)
            f.seek(name_len, 1)
            fixed = f.read(13)
            if len(fixed) < 13:
                return end
            _, kind, ndim = struct.unpack("<qBI", fixed)
            shape = f.read(8 * ndim)
            if len(shape) < 8 * ndim:
                return end
            n = int(np.prod(struct.unpack(f"<{ndim}q", shape)))
            nxt = f.tell() + 8 * n * (2 if kind else 1)
            if nxt > size:
                return end
            f.seek(nxt)
            end = nxt


class Spool:
    """One walker's log.  ``append`` continues an existing log (a resumed
    run); otherwise the file is truncated."""

    def __init__(self, path: str | os.PathLike, append: bool = False):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if append and os.path.exists(self.path):
            keep = _complete_length(self.path)
            self._f = open(self.path, "r+b")
            self._f.truncate(keep)
            self._f.seek(keep)
        else:
            self._f = open(self.path, "wb")
            self._f.write(HEADER)

    def write(self, name: str, bin_idx: int, arr) -> None:
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            kind = 1
            data = np.empty(arr.shape + (2,), dtype="<f8")
            data[..., 0] = arr.real
            data[..., 1] = arr.imag
        else:
            kind = 0
            data = np.ascontiguousarray(arr, dtype="<f8")
        shape = arr.shape if arr.ndim else (1,)
        raw = name.encode()
        self._f.write(b"".join((
            struct.pack("<I", len(raw)), raw,
            struct.pack("<qBI", int(bin_idx), kind, len(shape)),
            np.asarray(shape, dtype="<i8").tobytes(), data.tobytes())))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_spool(path: str | os.PathLike):
    """Yield (name, bin_idx, array) records from a spool log."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header[:4] != MAGIC:
            raise ValueError(f"{path}: not a dqmc spool file")
        while True:
            raw = f.read(4)
            if not raw:
                return
            (name_len,) = struct.unpack("<I", raw)
            name = f.read(name_len).decode()
            bin_idx, kind, ndim = struct.unpack("<qBI", f.read(13))
            shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
            n = int(np.prod(shape)) * (2 if kind else 1)
            data = np.frombuffer(f.read(8 * n), dtype="<f8")
            if kind:
                data = data[0::2] + 1j * data[1::2]
            yield name, bin_idx, data.reshape(shape)


GROUPS = (("scalar/", "scalar"), ("equaltime/", "eq_r"),
          ("unequaltime/", "uneq_r"), ("K/equaltime/", "eq_k"),
          ("K/unequaltime/", "uneq_k"))


def read_bins(path) -> Dict[int, Dict[str, Dict[str, np.ndarray]]]:
    """bin -> group -> name -> value from a log; the last record of a
    (bin, name) wins, so a bin written again after a resume overrides
    the earlier one."""
    bins: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
    for name, bin_idx, arr in read_spool(path):
        slot = bins.setdefault(bin_idx, {g: {} for _, g in GROUPS})
        for prefix, group in GROUPS:
            if name.startswith(prefix):
                slot[group][name[len(prefix):]] = (
                    float(arr.reshape(-1)[0]) if group == "scalar" else arr)
                break
        else:
            raise ValueError(f"unknown spool record group: {name}")
    return bins


def convert_spool_to_h5(spool_path, h5_path) -> int:
    """Replay a spool log into the reference HDF5 layout (truncating
    ``h5_path``); returns the number of bins written."""
    from dqmc_tpu_torch.io.h5out import BinFileWriter
    bins = read_bins(spool_path)
    with BinFileWriter(h5_path) as w:
        for bin_idx in sorted(bins):
            s = bins[bin_idx]
            w.write_bin(bin_idx, s["scalar"], s["eq_r"], s["eq_k"],
                        s["uneq_r"], s["uneq_k"])
    return len(bins)


def convert_dir(out_dir) -> Dict[str, int]:
    """Convert every ``data_*.spool`` under ``out_dir`` to the ``.h5``
    beside it; returns path -> bins written."""
    done = {}
    for path in sorted(glob.glob(os.path.join(str(out_dir),
                                              "data_*.spool"))):
        done[path] = convert_spool_to_h5(path, path[:-len(".spool")] + ".h5")
    return done


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m dqmc_tpu_torch.io.spool",
        description="Convert a run's data_*.spool logs into the reference "
                    "HDF5 layout (data_*.h5 beside them); needs h5py.")
    p.add_argument("out_dir", nargs="?", default="results",
                   help="the run's output directory (default: results)")
    args = p.parse_args(argv)
    done = convert_dir(args.out_dir)
    if not done:
        sys.exit(f"no data_*.spool under {args.out_dir}")
    for path, n in done.items():
        print(f"{path}: {n} bins -> {path[:-len('.spool')]}.h5")


if __name__ == "__main__":
    main()
