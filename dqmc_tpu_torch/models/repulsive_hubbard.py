"""Repulsive Hubbard model (2-flavor DQMC), dense kinetics.

PyTorch counterpart of ``dqmc_tpu/models/repulsive_hubbard.py``:

    H = -t sum_<ij> c_i^dag c_j - mu sum_i n_i
        + U sum_i (n_{iu} - 1/2)(n_{id} - 1/2)

HS decoupling in the spin channel: with y = n_u - n_d,
exp(dtau U/2 y^2) ~= sum_s gamma(s) exp(g eta(s) y), g = sqrt(dtau U / 2),
so the two flavors see opposite couplings exp(+-g eta(s)) and there is no
per-field bosonic factor (``alpha = 0``).  Two stored flavors
(``n_flavor = 2``) whose determinant ratios enter once each
(``det_power = 1``); away from half filling the ratio may go negative: the
engine tracks the Metropolis sign (``WalkerState.sign``) and the measurement
layer records <sign> for reweighting.

Everything the two models share (the kinetic exponentials, ``from_params``,
``det_ratio``, ``global_action`` -- whose bosonic term vanishes with alpha)
is inherited from :class:`AttractiveHubbard`.
"""

from __future__ import annotations

import dataclasses

import torch

from dqmc_tpu_torch.models.attractive_hubbard import AttractiveHubbard


@dataclasses.dataclass(frozen=True)
class RepulsiveHubbard(AttractiveHubbard):
    N_FLAVOR = 2
    DET_POWER = 1
    ALPHA = 0.0

    def expV_diag(self, fields_l: torch.Tensor) -> torch.Tensor:
        """(..., 2, ns): up sees exp(+g eta(s)), down exp(-g eta(s))."""
        v = self.g * self.eta[fields_l]
        return torch.stack([torch.exp(v), torch.exp(-v)], dim=-2)

    def update_factors(self, old: torch.Tensor, new: torch.Tensor):
        """(gammaR, bosonR = 1, delta (..., 2)) with opposite flavor
        couplings."""
        d_eta = self.eta[new] - self.eta[old]
        gammaR = self.gamma[new] / self.gamma[old]
        bosonR = torch.exp(self.alpha * self.g * d_eta)
        x = self.g * d_eta
        return gammaR, bosonR, torch.stack([torch.expm1(x),
                                            torch.expm1(-x)], dim=-1)
