"""Observables: Wick-contracted functions of the Green's functions.

PyTorch counterpart of ``dqmc_tpu/measure/observables.py`` (the
reference's model.cpp:165-392).  Each equal-time function takes G00
(..., nfl, ns, ns) with any leading walker axes; each unequal-time one
takes the per-tau triplet (Gtt, Gt0, G0t) and G00, with leading axes that
broadcast (the tau sweep hands in a block of taus at once);
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


def _T(G):
    return G.transpose(-1, -2)


def green_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """G_u(tau,0) + G_d(tau,0) (model.cpp:290-314)."""
    return Gt0[..., 0, :, :] + Gt0[..., -1, :, :]


def doublon_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Pair propagator Gt0_u(i,j) Gt0_d(i,j) (model.cpp:316-344)."""
    return Gt0[..., 0, :, :] * Gt0[..., -1, :, :]


def spinzz_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """<S^z_i(tau) S^z_j(0)> (beyond the reference; ``measure_spin``):
    1/4 [m_i(tau) m_j(0) - sum_s G0t_s(j,i) Gt0_s(i,j)] with
    m_i(tau) = Gtt_dn(i,i) - Gtt_up(i,i); equals spin_zz_corr at tau = 0."""
    m_tau = _diag(Gtt[..., -1, :, :]) - _diag(Gtt[..., 0, :, :])
    m_0 = _diag(G00[..., -1, :, :]) - _diag(G00[..., 0, :, :])
    X = (_T(G0t[..., 0, :, :]) * Gt0[..., 0, :, :]
         + _T(G0t[..., -1, :, :]) * Gt0[..., -1, :, :])
    return 0.25 * (m_tau[..., :, None] * m_0[..., None, :] - X)


def spinxx_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """<S^x_i(tau) S^x_j(0)> (beyond the reference; ``measure_spin``):
    -1/4 [G0t_u(j,i) Gt0_d(i,j) + G0t_d(j,i) Gt0_u(i,j)]; equals
    spin_xx_corr at tau = 0."""
    return -0.25 * (_T(G0t[..., 0, :, :]) * Gt0[..., -1, :, :]
                    + _T(G0t[..., -1, :, :]) * Gt0[..., 0, :, :])


def density_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """Connected <n_i(tau) n_j(0)> - navg(tau) navg(0) (beyond the
    reference; ``measure_charge``), with the textbook cross contraction
    -sum_s G0t_s(j,i) Gt0_s(i,j): at tau = 0 it equals the textbook
    densityCorr, not the reference's 1 - G quirk."""
    n_tau = ((1.0 - _diag(Gtt[..., 0, :, :]))
             + (1.0 - _diag(Gtt[..., -1, :, :])))
    n_0 = (1.0 - _diag(G00[..., 0, :, :])) + (1.0 - _diag(G00[..., -1, :, :]))
    X = (_T(G0t[..., 0, :, :]) * Gt0[..., 0, :, :]
         + _T(G0t[..., -1, :, :]) * Gt0[..., -1, :, :])
    return (n_tau[..., :, None] * n_0[..., None, :] - X
            - (n_tau.mean(-1) * n_0.mean(-1))[..., None, None])


def currxx_tau(Gtt, Gt0, G0t, G00, ctx: MeasurementContext):
    """x-current correlator <j_x(i,tau) j_x(j,0)> (model.cpp:346-392), the
    superfluid stiffness's input.  The reference's eight element patterns
    are index gathers through the +x neighbour map nbr (ix = nbr[i]), in
    both float types (the JAX package's float32 one-hot matmuls are the
    same function, written for the TPU)."""
    nbr = ctx.nbr_x
    idx = torch.arange(ctx.n_sites, device=nbr.device)

    def one_spin(Gtt_s, Gt0_s, G0t_s, G00_s):
        PGt0 = Gt0_s[..., nbr, :]                     # Gt0(ix, j)
        PG0t_T = _T(G0t_s[..., nbr, :])               # G0t(jx, i)
        G0t_T = _T(G0t_s)
        return (Gtt_s[..., nbr, idx],                 # Gtt(ix, i)
                Gtt_s[..., idx, nbr],                 # Gtt(i, ix)
                G00_s[..., nbr, idx],                 # G00(jx, j)
                G00_s[..., idx, nbr],                 # G00(j, jx)
                PG0t_T * PGt0,                        # G0t(jx,i) Gt0(ix,j)
                G0t_T * PGt0[..., :, nbr],            # G0t(j,i) Gt0(ix,jx)
                PG0t_T[..., nbr, :] * Gt0_s,          # G0t(jx,ix) Gt0(i,j)
                G0t_T[..., nbr, :] * Gt0_s[..., :, nbr])  # G0t(j,ix) Gt0(i,jx)

    flavor = lambda G, f: G[..., f, :, :]             # noqa: E731
    up = one_spin(*(flavor(G, 0) for G in (Gtt, Gt0, G0t, G00)))
    dn = one_spin(*(flavor(G, -1) for G in (Gtt, Gt0, G0t, G00)))
    dc1_i, dc2_i, dc1_j, dc2_j, c1, c2, c3, c4 = (
        u + d for u, d in zip(up, dn))
    term1 = dc1_i[..., :, None] * dc1_j[..., None, :] - c1
    term2 = dc1_i[..., :, None] * dc2_j[..., None, :] - c2
    term3 = dc2_i[..., :, None] * dc1_j[..., None, :] - c3
    term4 = dc2_i[..., :, None] * dc2_j[..., None, :] - c4
    return -(term1 - term2 - term3 + term4)


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

# the tau-resolved sets, registered only with isMeasureUnequalTime: the
# default one, the magnetic one (measure_spin) and the dynamic charge one
# (measure_charge)
UNEQUAL_TIME_OBSERVABLES = {
    "greenTau": green_tau,
    "doublonTau": doublon_tau,
    "currxxTau": currxx_tau,
}

SPIN_UNEQUAL_TIME_OBSERVABLES = {
    "spinzzTau": spinzz_tau,
    "spinxxTau": spinxx_tau,
}

CHARGE_UNEQUAL_TIME_OBSERVABLES = {
    "densityTau": density_tau,
}
