"""Attractive Hubbard model on a periodic lattice, dense kinetics.

PyTorch counterpart of ``dqmc_tpu/models/attractive_hubbard.py``:

    H = -t sum_<ij> c_i^dag c_j - mu sum_i n_i
        - U sum_i (n_{iu} - 1/2)(n_{id} - 1/2)

After the 4-state GHQ Hubbard–Stratonovich transform each imaginary-time
propagator is B_l = diag(exp(g * eta(s_l))) @ expm(-dtau * K) with
g = sqrt(dtau |U| / 2).  The model is spin-symmetric: one stored flavor
(``n_flavor = 1``) whose determinant ratio enters squared
(``det_power = 2``).  The matrix exponentials are taken once in host f64
with scipy, exactly as in the JAX package, then moved to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.lattice import Lattice, bonds_with_tp


def build_kinetic_matrix(lat: Lattice, t: float, mu: float,
                         bonds=None) -> np.ndarray:
    """Hopping + chemical-potential matrix K (model.cpp:39-60) for any bond
    set: K[i,i] = -mu; K[i,j] = K[j,i] = -amp for every bond (delta, orb_a,
    orb_b[, amp]) with periodic boundaries.  Assignment (not accumulation)
    semantics, as in the reference."""
    if bonds is None:
        bonds = [((1, 0), 0, 0), ((0, 1), 0, 0)]
    ns = lat.n_sites
    K = np.zeros((ns, ns))
    np.fill_diagonal(K, -mu)
    for bond in bonds:
        delta, orb_a, orb_b = bond[:3]
        amp = bond[3] if len(bond) > 3 else t
        for cell in range(lat.n_cells):
            i = lat.cell_to_site(cell, orb_a)
            j = lat.site_neighbor(i, delta, orb_b)
            K[i, j] = -amp
            K[j, i] = -amp
    return K


@dataclasses.dataclass(frozen=True)
class AttractiveHubbard:
    n_sites: int
    nt: int
    n_flavor: int            # stored flavors (spin-symmetric: 1)
    det_power: int           # determinant-ratio multiplicity per flavor
    expK: torch.Tensor       # (ns, ns) expm(-dtau K)
    invexpK: torch.Tensor    # (ns, ns) expm(+dtau K)
    expK_half: torch.Tensor  # (ns, ns) expm(-dtau K / 2)
    invexpK_half: torch.Tensor  # (ns, ns) expm(+dtau K / 2)
    g: torch.Tensor          # () HS coupling sqrt(dtau |U| / 2)
    alpha: torch.Tensor      # () bosonic sign (-1 for attractive U > 0)
    eta: torch.Tensor        # (4,) GHQ node values
    gamma: torch.Tensor      # (4,) GHQ weights
    beta: torch.Tensor       # () inverse temperature
    checkerboard: bool = False

    # what build() gives this model; RepulsiveHubbard overrides them
    N_FLAVOR = 1
    DET_POWER = 2
    ALPHA = -1.0

    @classmethod
    def build(cls, lat: Lattice, *, U: float, t: float, mu: float,
              beta: float, nt: int, dtype=torch.float64,
              device="cpu", checkerboard: bool = False,
              bonds=None):
        if checkerboard:
            raise NotImplementedError(
                "checkerboard kinetics are not ported to dqmc_tpu_torch yet "
                "(ROADMAP: modules to port, slice 3 'other models and "
                "geometries')")
        dtau = beta / nt
        K = build_kinetic_matrix(lat, t, mu, bonds=bonds)
        as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                         dtype=dtype, device=device)
        return cls(
            n_sites=lat.n_sites, nt=int(nt), n_flavor=cls.N_FLAVOR,
            det_power=cls.DET_POWER,
            expK=as_t(scipy.linalg.expm(-dtau * K)),
            invexpK=as_t(scipy.linalg.expm(dtau * K)),
            expK_half=as_t(scipy.linalg.expm(-0.5 * dtau * K)),
            invexpK_half=as_t(scipy.linalg.expm(0.5 * dtau * K)),
            g=as_t(np.sqrt(0.5 * abs(U) * dtau)),
            alpha=as_t(cls.ALPHA),
            eta=as_t(hsfield.ETA),
            gamma=as_t(hsfield.GAMMA),
            beta=as_t(beta),
        )

    @classmethod
    def from_params(cls, params: Parameters, lat: Lattice, *,
                    dtype=torch.float64, device="cpu"):
        geometry = params.get_str("Lattice", "geometry", "square")
        bonds = bonds_with_tp(geometry,
                              params.get_float("hubbard", "tp", 0.0))
        return cls.build(
            lat,
            U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"),
            beta=params.get_float("simulation", "beta"),
            nt=params.get_int("simulation", "nt"),
            dtype=dtype, device=device,
            checkerboard=params.get_bool("hubbard", "checkerboard", False),
            bonds=bonds,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.expK.dtype

    @property
    def device(self) -> torch.device:
        return self.expK.device

    # ------------------------------------------------------------------
    # propagator pieces
    # ------------------------------------------------------------------

    def expV_diag(self, fields_l: torch.Tensor) -> torch.Tensor:
        """diag of exp(+V): (..., nfl, ns) = exp(g * eta(s)) for fields
        (..., ns) (model.cpp:62-72)."""
        return torch.exp(self.g * self.eta[fields_l])[..., None, :]

    # ------------------------------------------------------------------
    # local-update math (model.cpp:90-122)
    # ------------------------------------------------------------------

    def update_factors(self, old: torch.Tensor, new: torch.Tensor):
        """(gammaR, bosonR, delta) for a proposed single-site flip; delta
        carries a trailing flavor axis, B' = (I + delta e_i e_i^T) B."""
        d_eta = self.eta[new] - self.eta[old]
        gammaR = self.gamma[new] / self.gamma[old]
        bosonR = torch.exp(self.alpha * self.g * d_eta)
        delta = torch.expm1(self.g * d_eta)
        return gammaR, bosonR, delta[..., None]

    def det_ratio(self, G_ii: torch.Tensor, delta: torch.Tensor):
        """prod_flv [1 + (1 - G_ii) delta]^det_power over the trailing
        flavor axis."""
        r_flv = 1.0 + (1.0 - G_ii) * delta
        return torch.prod(r_flv, dim=-1) ** self.det_power

    # ------------------------------------------------------------------
    # global action (model.cpp:140-159)
    # ------------------------------------------------------------------

    def global_action(self, fields: torch.Tensor,
                      log_det_M: torch.Tensor) -> torch.Tensor:
        """S = -det_power sum_flv log|det M_flv|
               - sum_i (alpha g eta_i + log gamma_i),
        with the bosonic sum taken as exact state counts times per-state
        constants (load-bearing for f32 chains)."""
        s_ferm = -self.det_power * torch.sum(log_det_M)
        counts = torch.stack([torch.count_nonzero(fields == v)
                              for v in range(4)]).to(self.eta.dtype)
        log_boson = self.alpha * self.g * torch.sum(counts * self.eta)
        log_gamma = torch.sum(counts * torch.log(self.gamma))
        return s_ferm - log_boson - log_gamma
