"""Equal-time observables: Wick-contracted functions of G.

PyTorch counterpart of the equal-time part of
``dqmc_tpu/measure/observables.py`` (the reference's model.cpp:165-288).
Each function takes G00 (..., nfl, ns, ns) with any leading walker axes;
the up/down species are G00[..., 0, :, :] / G00[..., -1, :, :], identical
for the spin-symmetric attractive model (nfl = 1) and distinct for the
2-flavor repulsive model.  Where the reference's arithmetic
deviates from the textbook Wick expression it is reproduced (NOTES.md
"Quirks knowingly reproduced").
"""

from __future__ import annotations

import torch

from dqmc_tpu_torch.measure.context import MeasurementContext


def _updn(G):
    return G[..., 0, :, :], G[..., -1, :, :]


def _diag(G):
    return torch.diagonal(G, dim1=-2, dim2=-1)


def density(G00, ctx: MeasurementContext):
    """<n> = (1/N) sum_i <n_iu + n_id>, <n_is> = 1 - G_s(i,i)."""
    Gup, Gdn = _updn(G00)
    ns = ctx.n_sites
    return (2.0 * ns - _diag(Gup).sum(-1) - _diag(Gdn).sum(-1)) / ns


def double_occupancy(G00, ctx: MeasurementContext):
    """<D> = (1/N) sum_i (1 - Gu_ii)(1 - Gd_ii)."""
    Gup, Gdn = _updn(G00)
    return torch.mean((1.0 - _diag(Gup)) * (1.0 - _diag(Gdn)), dim=-1)


def swave_pairing(G00, ctx: MeasurementContext):
    """q=0 s-wave pair structure factor (model.cpp:223-256):
    (1/N) sum_ij (delta_ji - Gu(j,i)) (delta_ji - Gd(j,i))."""
    Gup, Gdn = _updn(G00)
    eye = torch.eye(ctx.n_sites, dtype=G00.dtype, device=G00.device)
    return torch.sum((eye - Gup) * (eye - Gdn), dim=(-2, -1)) / ctx.n_sites


def density_corr(G00, ctx: MeasurementContext):
    """Connected density-density correlation matrix (model.cpp:258-288):
    n_i n_j + exch(i,j) - n_avg^2 with exch(i,j) = sum_s (1 - G_s(j,i))
    G_s(i,j).  The reference's (1 - G(j,i)) in place of (delta_ji - G(j,i))
    is reproduced for output parity (model.cpp:281)."""
    Gup, Gdn = _updn(G00)
    n_i = (1.0 - _diag(Gup)) + (1.0 - _diag(Gdn))
    n_avg = torch.mean(n_i, dim=-1)
    exch = ((1.0 - Gup.transpose(-1, -2)) * Gup
            + (1.0 - Gdn.transpose(-1, -2)) * Gdn)
    return (n_i[..., :, None] * n_i[..., None, :] + exch
            - (n_avg ** 2)[..., None, None])


def spin_zz_corr(G00, ctx: MeasurementContext):
    """<S^z_i S^z_j> with S^z = (n_up - n_dn)/2 (beyond the reference; the
    magnetic probe of the 2-flavor repulsive model):
    1/4 [m_i m_j + X_up(i,j) + X_dn(i,j)], m_i = <n_iu> - <n_id> and
    X_s(i,j) = (delta_ij - G_s(j,i)) G_s(i,j) -- the textbook delta_ij, not
    the reference's 1 - G quirk of density_corr."""
    Gup, Gdn = _updn(G00)
    eye = torch.eye(ctx.n_sites, dtype=G00.dtype, device=G00.device)
    m = _diag(Gdn) - _diag(Gup)
    X = ((eye - Gup.transpose(-1, -2)) * Gup
         + (eye - Gdn.transpose(-1, -2)) * Gdn)
    return 0.25 * (m[..., :, None] * m[..., None, :] + X)


def spin_xx_corr(G00, ctx: MeasurementContext):
    """<S^x_i S^x_j> = 1/4 [<S+_i S-_j> + <S-_i S+_j>] with
    <S+_i S-_j> = (delta_ij - Gu(j,i)) Gd(i,j) and the spin-flipped mirror.
    Equals spin_zz_corr for a spin-symmetric G (SU(2))."""
    Gup, Gdn = _updn(G00)
    eye = torch.eye(ctx.n_sites, dtype=G00.dtype, device=G00.device)
    return 0.25 * ((eye - Gup.transpose(-1, -2)) * Gdn
                   + (eye - Gdn.transpose(-1, -2)) * Gup)


# registries used by run.py (main.cpp:116-122)
SCALAR_OBSERVABLES = {
    "density": density,
    "doubleOcc": double_occupancy,
    "swave": swave_pairing,
}

EQUAL_TIME_OBSERVABLES = {
    "densityCorr": density_corr,
}

# the opt-in magnetic set ([simulation] measure_spin = true)
SPIN_OBSERVABLES = {
    "spinZZCorr": spin_zz_corr,
    "spinXXCorr": spin_xx_corr,
}
