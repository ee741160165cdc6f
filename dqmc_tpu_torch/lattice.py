"""2D Bravais lattice geometry with an orbital basis.

Capability mirror of the reference ``Lattice`` (include/lattice.h:14-137):
Bravais vectors a1/a2, orbital offsets, L1 x L2 unit cells with periodic
boundary conditions, reciprocal vectors and a k-grid shifted to (-pi, pi],
site indexing ``site = cell * n_orb + orb``, neighbor lookup with PBC wrap,
and the ``results/info`` metadata file consumed by the analysis pipeline.

Everything here is host-side, static ``numpy`` data computed once at setup;
the sweep engine and the measurement transforms consume the precomputed
index tables (`neighbor_map`, `displacement_table`, `kspace_phases`) as
constants.  The port keeps its own copy of ``dqmc_tpu/lattice.py`` so that
it imports nothing of the JAX package.

Unlike the reference (whose k-grid and displacement index arithmetic,
lattice.h:42-49 and measurementh5.h:57-58, are only valid for even L), odd
linear sizes are handled correctly here; for even L the conventions are
bit-identical to the reference.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from dqmc_tpu_torch.config import Parameters


def _half_offset(L: int) -> int:
    # Displacement/momentum index offset. Even L reproduces the reference
    # convention (range -L/2+1 .. L/2, measurementh5.h:57); odd L uses the
    # symmetric range -(L-1)/2 .. (L-1)/2.
    return L // 2 - 1 if L % 2 == 0 else L // 2


def pbc_shortest(d: int, L: int) -> int:
    """Minimal-image displacement in (-L/2, L/2] (measurementh5.h:13-17)."""
    if d > L // 2:
        d -= L
    if d <= -((L + 1) // 2):
        d += L
    return d


class Lattice:
    """Periodic 2D Bravais lattice with an orbital basis."""

    def __init__(
        self,
        L1: int,
        L2: int,
        a1: Sequence[float] = (1.0, 0.0),
        a2: Sequence[float] = (0.0, 1.0),
        orbs: Sequence[Sequence[float]] = ((0.0, 0.0),),
    ):
        if L1 <= 0 or L2 <= 0 or len(orbs) == 0:
            raise ValueError("Bad lattice dims")
        self.L1 = int(L1)
        self.L2 = int(L2)
        self.a1 = np.asarray(a1, dtype=np.float64)
        self.a2 = np.asarray(a2, dtype=np.float64)
        self.orbs = np.asarray(orbs, dtype=np.float64)
        self.n_orb = len(orbs)

        det = self.a1[0] * self.a2[1] - self.a1[1] * self.a2[0]
        if abs(det) < 1e-12:
            raise ValueError("Singular lattice")
        # Reduced reciprocal vectors (lattice.h:38-39): b1, b2 already divided
        # by L so k = qx*b1 + qy*b2 with integer (qx, qy).
        self.b1 = np.array([2 * np.pi * self.a2[1] / det / L1,
                            -2 * np.pi * self.a2[0] / det / L1])
        self.b2 = np.array([-2 * np.pi * self.a1[1] / det / L2,
                            2 * np.pi * self.a1[0] / det / L2])

        # k-grid in (-pi, pi] (lattice.h:42-49); row-major over (n, m) so that
        # flat index kidx = n * L2 + m.
        off1, off2 = _half_offset(L1), _half_offset(L2)
        ks = []
        for n in range(L1):
            qx = n - off1
            for m in range(L2):
                qy = m - off2
                ks.append(qx * self.b1 + qy * self.b2)
        self.k_points = np.asarray(ks)  # (L1*L2, 2)

    # ------------------------------------------------------------------
    # basic info
    # ------------------------------------------------------------------

    @classmethod
    def from_params(cls, params: Parameters, a1=(1.0, 0.0), a2=(0.0, 1.0),
                    orbs=((0.0, 0.0),)) -> "Lattice":
        return cls(params.get_int("Lattice", "L1"),
                   params.get_int("Lattice", "L2"), a1, a2, orbs)

    @property
    def n_cells(self) -> int:
        return self.L1 * self.L2

    @property
    def n_sites(self) -> int:
        return self.L1 * self.L2 * self.n_orb

    # ------------------------------------------------------------------
    # coordinate helpers (site = cell * n_orb + orb; cell = uy * L1 + ux)
    # ------------------------------------------------------------------

    def site_position(self, idx: int) -> np.ndarray:
        cell, orb = divmod(idx, self.n_orb)
        ux, uy = cell % self.L1, cell // self.L1
        return ux * self.a1 + uy * self.a2 + self.orbs[orb]

    def cell_to_site(self, cell: int, orb: int) -> int:
        return cell * self.n_orb + orb

    def site_to_unitcellpos(self, idx: int) -> Tuple[int, int]:
        cell = idx // self.n_orb
        return cell % self.L1, cell // self.L1

    def site_neighbor(self, idx: int, delta: Tuple[int, int], orb: int) -> int:
        """Site reached from `idx`'s unit cell by lattice translation `delta`,
        landing on orbital `orb` (lattice.h:100-107)."""
        cell = idx // self.n_orb
        ux, uy = cell % self.L1, cell // self.L1
        tx = (ux + delta[0]) % self.L1
        ty = (uy + delta[1]) % self.L2
        return (ty * self.L1 + tx) * self.n_orb + orb

    def neighbor_map(self, delta: Tuple[int, int], orb: int = 0) -> np.ndarray:
        """Vectorized `site_neighbor` over all sites: (n_sites,) int array."""
        return np.array(
            [self.site_neighbor(i, delta, orb) for i in range(self.n_sites)],
            dtype=np.int32,
        )

    # ------------------------------------------------------------------
    # tables for measurement transforms (consumed by dqmc_tpu.measure)
    # ------------------------------------------------------------------

    def displacement_table(self) -> np.ndarray:
        """T[dx_idx, dy_idx, cell] = cell translated by displacement d.

        Used to reduce site-pair observables chi[i, j] to displacement space:
        chi_r[dx, dy, (a*n_orb+b)] = mean_cell chi[cell*n_orb+a, T[dx,dy,cell]*n_orb+b],
        the vectorized equivalent of transform::chi_site_to_chi_r
        (measurementh5.h:20-66) with the same index offsets.
        """
        off1, off2 = _half_offset(self.L1), _half_offset(self.L2)
        T = np.empty((self.L1, self.L2, self.n_cells), dtype=np.int32)
        for dxi in range(self.L1):
            dx = dxi - off1
            for dyi in range(self.L2):
                dy = dyi - off2
                for cell in range(self.n_cells):
                    ux, uy = cell % self.L1, cell // self.L1
                    tx = (ux + dx) % self.L1
                    ty = (uy + dy) % self.L2
                    T[dxi, dyi, cell] = ty * self.L1 + tx
        return T

    def kspace_phases(self) -> np.ndarray:
        """Complex phase tensor P[kx, ky, x, y] = exp(-i k . r(x, y)).

        chi_k[kx, ky, s] = sum_{x,y} P[kx, ky, x, y] * chi_r[x, y, s] — the
        explicit DFT of transform::chi_r_to_chi_k (measurementh5.h:78-116)
        expressed as one dense contraction (an MXU matmul on device).
        """
        off1, off2 = _half_offset(self.L1), _half_offset(self.L2)
        xs = np.arange(self.L1) - off1
        ys = np.arange(self.L2) - off2
        # physical displacement r = dx*a1 + dy*a2 (measurementh5.h:103-104)
        rx = xs[:, None] * self.a1[0] + ys[None, :] * self.a2[0]
        ry = xs[:, None] * self.a1[1] + ys[None, :] * self.a2[1]
        k = self.k_points.reshape(self.L1, self.L2, 2)
        phase = (k[:, :, None, None, 0] * rx[None, None, :, :]
                 + k[:, :, None, None, 1] * ry[None, None, :, :])
        return np.exp(-1j * phase)

    # ------------------------------------------------------------------
    # metadata file for the analysis pipeline (lattice.h:110-136)
    # ------------------------------------------------------------------

    def save_info(self, filename: str | os.PathLike) -> None:
        d = os.path.dirname(str(filename))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(filename, "w") as fh:
            fh.write(f"L1 {self.L1}\n")
            fh.write(f"L2 {self.L2}\n")
            fh.write(f"n_orb {self.n_orb}\n")
            fh.write(f"a1_x {_fmt(self.a1[0])}\n")
            fh.write(f"a1_y {_fmt(self.a1[1])}\n")
            fh.write(f"a2_x {_fmt(self.a2[0])}\n")
            fh.write(f"a2_y {_fmt(self.a2[1])}\n")


def _fmt(x: float) -> str:
    # C++ ostream default formatting: up to 6 significant digits, no
    # trailing zeros ("1", "0.5", "1.5e-07").
    s = f"{x:.6g}"
    return s


def square_lattice(L1: int, L2: int) -> Lattice:
    """The reference driver's lattice: 1-orbital square, a1=(1,0), a2=(0,1)
    (main.cpp:85-88)."""
    return Lattice(L1, L2)


def triangular_lattice(L1: int, L2: int) -> Lattice:
    """1-orbital triangular lattice, a1=(1,0), a2=(1/2, sqrt(3)/2).

    Beyond reference capability (the reference hardcodes the square
    lattice, main.cpp:85-88); the Bravais machinery here is general."""
    return Lattice(L1, L2, a1=(1.0, 0.0), a2=(0.5, np.sqrt(3) / 2))


def honeycomb_lattice(L1: int, L2: int) -> Lattice:
    """2-orbital honeycomb (graphene) lattice: triangular Bravais vectors
    with A at (0,0) and B at (a1+a2)/3.  Beyond reference capability."""
    a1 = np.array([1.0, 0.0])
    a2 = np.array([0.5, np.sqrt(3) / 2])
    b_off = (a1 + a2) / 3.0
    return Lattice(L1, L2, a1=a1, a2=a2, orbs=((0.0, 0.0), tuple(b_off)))


def nn_bonds(geometry: str) -> List[Tuple[Tuple[int, int], int, int]]:
    """Nearest-neighbour bond set for a geometry: (cell delta, orb_from,
    orb_to) triples, one entry per bond direction (the hermitian conjugate
    is implied).

    - square: +x and +y cell translations (model.cpp:39-60 semantics);
    - triangular: +a1, +a2, and +a2-a1;
    - honeycomb: A->B within the cell and to the -a1 / -a2 neighbour cells
      (each A has 3 NN B sites).
    """
    if geometry == "square":
        return [((1, 0), 0, 0), ((0, 1), 0, 0)]
    if geometry == "triangular":
        return [((1, 0), 0, 0), ((0, 1), 0, 0), ((-1, 1), 0, 0)]
    if geometry == "honeycomb":
        return [((0, 0), 0, 1), ((-1, 0), 0, 1), ((0, -1), 0, 1)]
    raise ValueError(f"unknown geometry: {geometry}")


def bonds_with_tp(geometry: str, tp: float):
    """NN bond set plus next-nearest-neighbour bonds of amplitude ``tp``
    (the [hubbard] tp key; 4-tuple bonds carry their own amplitude —
    see models.build_kinetic_matrix).  t' frustrates the square lattice
    and breaks particle-hole symmetry (beyond reference capability)."""
    bonds = list(nn_bonds(geometry))
    if tp:
        if geometry != "square":
            raise NotImplementedError(
                "tp (next-nearest hopping) is implemented for the square "
                "geometry; extend bonds_with_tp for others")
        bonds += [((1, 1), 0, 0, tp), ((1, -1), 0, 0, tp)]
    return bonds


def make_lattice(geometry: str, L1: int, L2: int) -> Lattice:
    builders = {"square": square_lattice, "triangular": triangular_lattice,
                "honeycomb": honeycomb_lattice}
    if geometry not in builders:
        raise ValueError(f"unknown geometry: {geometry}")
    return builders[geometry](L1, L2)
