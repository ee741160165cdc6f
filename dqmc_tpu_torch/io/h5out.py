"""Binned HDF5 output, bit-compatible with the reference's layout.

The reference writes one file per MPI rank, ``results/data_<rank>.h5``
(measurementh5.h:292-297), with per-bin groups

    /bin_N/scalar/<name>        shape (1,) f64
    /bin_N/equaltime/<name>     shape (L1, L2, n_orb^2) f64
    /bin_N/unequaltime/<name>   shape (L1, L2, n_orb^2 * n_tau) f64
    /binK_N/equaltime/<name>    shape (L1, L2, S, 2) f64 (re, im interleaved)
    /binK_N/unequaltime/<name>  shape (L1, L2, S, 2) f64

The reference's ``write_cube`` performs an axis-reversing transpose of the
column-major Armadillo cube (h5utils.h:58-66); the net effect is that h5py
reads an array A with A[i,j,k] == cube(i,j,k) — i.e. a plain C-order array
of the logical shape.  Here we simply write C-order numpy arrays of that
logical shape, byte-identical layout.  Complex cubes get a trailing
(re, im) axis of size 2 (h5utils.h:81-119).

This layout is the compatibility contract consumed by the jackknife
analysis pipeline (scripts/analysis.py:63-129 in the reference;
dqmc_tpu/analysis in this framework).

The port keeps its own copy of ``dqmc_tpu/io/h5out.py`` so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import h5py
import numpy as np


class BinFileWriter:
    """One walker's (``rank``'s) binned output file."""

    def __init__(self, path: str | os.PathLike, mode: str = "w"):
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        # "w" truncates (fresh run); "a" appends further bins (resume)
        self._f = h5py.File(path, mode)

    def write_bin(
        self,
        bin_idx: int,
        scalars: Dict[str, float],
        eqtime_r: Optional[Dict[str, np.ndarray]] = None,
        eqtime_k: Optional[Dict[str, np.ndarray]] = None,
        uneqtime_r: Optional[Dict[str, np.ndarray]] = None,
        uneqtime_k: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        g_r = self._f.create_group(f"/bin_{bin_idx}")
        g_k = self._f.create_group(f"/binK_{bin_idx}")
        g_scalar = g_r.create_group("scalar")
        g_eq_r = g_r.create_group("equaltime")
        g_uneq_r = g_r.create_group("unequaltime")
        g_eq_k = g_k.create_group("equaltime")
        g_uneq_k = g_k.create_group("unequaltime")

        for name, value in scalars.items():
            g_scalar.create_dataset(
                name, data=np.asarray([value], dtype=np.float64))
        for group, data in ((g_eq_r, eqtime_r), (g_uneq_r, uneqtime_r)):
            for name, arr in (data or {}).items():
                group.create_dataset(
                    name, data=np.ascontiguousarray(arr, dtype=np.float64))
        for group, data in ((g_eq_k, eqtime_k), (g_uneq_k, uneqtime_k)):
            for name, arr in (data or {}).items():
                arr = np.asarray(arr)
                interleaved = np.stack(
                    [arr.real.astype(np.float64), arr.imag.astype(np.float64)],
                    axis=-1)
                group.create_dataset(name, data=np.ascontiguousarray(interleaved))
        self._f.flush()

    def bins(self) -> list:
        """The bin indices the file holds."""
        return sorted(int(k[4:]) for k in self._f if k.startswith("bin_"))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
