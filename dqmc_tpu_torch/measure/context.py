"""Lattice tables for the measurement kernels.

PyTorch counterpart of ``dqmc_tpu/measure/context.py``.  The Lattice object
is host-side numpy; ``MeasurementContext`` packages the site-pair ->
displacement index vector and the +x neighbour map (on the device) and the
DFT phases (on the host, where the manager transforms bins to momentum
space).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dqmc_tpu_torch.lattice import Lattice


@dataclasses.dataclass(frozen=True)
class MeasurementContext:
    L1: int
    L2: int
    n_orb: int
    n_cells: int
    n_sites: int
    # (ns^2,) column of each site pair (i, j) in the flattened
    # (L1, L2, n_orb^2) displacement array: (dx*L2 + dy)*no^2 + a*no + b
    pair_cols: torch.Tensor
    phases: np.ndarray          # (L1, L2, L1, L2) complex exp(-i k . r)
    nbr_x: torch.Tensor         # (ns,) +x neighbour of each site (currxx)

    @property
    def n_disp(self) -> int:
        return self.L1 * self.L2 * self.n_orb * self.n_orb


def pair_cols_vector(lat: Lattice) -> np.ndarray:
    """Entry i*ns + j is (dx*L2 + dy)*no^2 + a*no + b, where (dx, dy) is the
    offset-indexed displacement from i's cell to j's cell and (a, b) their
    orbitals (Lattice.displacement_table conventions, measurementh5.h:
    20-66)."""
    ns, no, nc = lat.n_sites, lat.n_orb, lat.n_cells
    T = lat.displacement_table()                      # (L1, L2, nc)
    cols_vec = np.zeros(ns * ns, np.int64)
    cells = np.arange(nc)
    d_flat = (np.arange(lat.L1)[:, None] * lat.L2
              + np.arange(lat.L2)[None, :])           # (L1, L2)
    for a in range(no):
        for b in range(no):
            rows = ((cells[None, None, :] * no + a) * ns
                    + T * no + b)                     # (L1, L2, nc)
            cols = (d_flat * no * no + a * no + b)[..., None]
            cols_vec[rows.ravel()] = \
                np.broadcast_to(cols, rows.shape).ravel()
    return cols_vec


def make_context(lat: Lattice, device="cpu") -> MeasurementContext:
    return MeasurementContext(
        L1=lat.L1, L2=lat.L2, n_orb=lat.n_orb, n_cells=lat.n_cells,
        n_sites=lat.n_sites,
        pair_cols=torch.as_tensor(pair_cols_vector(lat), device=device),
        phases=lat.kspace_phases(),
        nbr_x=torch.as_tensor(lat.neighbor_map((1, 0), orb=0),
                              dtype=torch.int64, device=device),
    )
