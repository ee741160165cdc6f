"""Site-pair -> displacement -> momentum transforms.

PyTorch counterpart of ``dqmc_tpu/measure/transforms.py``.  ``site_to_r``
averages a site-pair array over cells into the reference's displacement
layout (L1, L2, (a*n_orb + b)*S + s) (measurementh5.h:57-61); here it is one
``index_add_`` over the precomputed pair -> displacement column vector (the
JAX package used a one-hot matmul for the TPU's sake; the sums are the
same).  ``r_to_k`` is the dense DFT chi_k[k] = sum_r chi_r[r] exp(-i k.r).
"""

from __future__ import annotations

import numpy as np
import torch

from dqmc_tpu_torch.measure.context import MeasurementContext


def site_to_r_batched(chis: torch.Tensor,
                      ctx: MeasurementContext) -> torch.Tensor:
    """chis (..., ns, ns) -> (..., L1, L2, n_orb^2), averaged over cells."""
    ns = ctx.n_sites
    lead = chis.shape[:-2]
    X = chis.reshape((-1, ns * ns))
    out = torch.zeros((X.shape[0], ctx.n_disp), dtype=chis.dtype,
                      device=chis.device)
    out.index_add_(1, ctx.pair_cols, X)
    return (out / ctx.n_cells).reshape(
        lead + (ctx.L1, ctx.L2, ctx.n_orb * ctx.n_orb))


def site_to_r_all(vals: dict, ctx: MeasurementContext) -> dict:
    """dict name -> site-pair array (..., ns, ns), each reduced to
    (..., L1, L2, n_orb^2); arrays of one shape share one reduction (the
    per-tau emit's observables go through a single ``index_add_``)."""
    out, by_shape = {}, {}
    for name, v in vals.items():
        by_shape.setdefault(tuple(v.shape), []).append(name)
    for names in by_shape.values():
        red = site_to_r_batched(torch.stack([vals[n] for n in names]), ctx)
        out.update(zip(names, red))
    return {name: out[name] for name in vals}


def site_to_r(chi: torch.Tensor, ctx: MeasurementContext) -> torch.Tensor:
    """chi (ns, ns) or (ns, ns, S) -> (L1, L2, n_orb^2 * S)."""
    if chi.dim() == 2:
        chi = chi[..., None]
    S = chi.shape[-1]
    out = site_to_r_batched(torch.movedim(chi, -1, 0), ctx)  # (S,L1,L2,ab)
    return torch.movedim(out, 0, -1).reshape(
        ctx.L1, ctx.L2, ctx.n_orb * ctx.n_orb * S)


def r_to_k(chi_r: np.ndarray, ctx: MeasurementContext) -> np.ndarray:
    """(L1, L2, S) real displacement data -> (L1, L2, S) complex k-space,
    on the host (bins are transformed once each, when written)."""
    return np.tensordot(ctx.phases, chi_r, axes=((2, 3), (0, 1)))
