"""Kinetic-propagator application: dense expm or checkerboard decomposition.

PyTorch counterpart of ``dqmc_tpu/models/kinetic.py``: the engine never
needs exp(-dtau K) alone, only the four products with B = diag(expV) expK.
``X`` carries any leading batch axes and ``fields_l`` the matching leading
axes without the flavor axis; a replica-stacked model's exp(-dtau K)
meets X's walker axis (``attractive_hubbard.lead``).  The branch follows
the model's ``checkerboard`` flag:

- dense: one matrix product with the precomputed exp(-dtau K);
- checkerboard: exp(-dtau K_hop) ~= prod_g exp(-dtau K_g) over the square
  lattice's four bond groups (x-even, x-odd, y-even, y-odd), each an exact
  disjoint two-site rotation [[cosh, sinh], [sinh, cosh]](dtau t) applied
  as a masked row gather-mix, O(ns^2) per application; exp(dtau mu)
  commutes (a multiple of the identity for one orbital).

The checkerboard operator defines the simulated B (its inverse is the
exact reverse-order product, so stabilization is unaffected); it differs
from the dense model by an O(dtau^2) Trotter term.  The group application
is plain torch, as it is XLA glue (no Pallas kernel) in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dqmc_tpu_torch.models.attractive_hubbard import lead


def build_checkerboard(lat, t: float, dtau: float):
    """(perms (4, ns) int64, masks (4, ns) float64, ch, sh): group g's
    permutation maps each site to its bond partner (itself when the site
    is not in the group).  Requires even L1, L2 (disjoint bonds) and one
    orbital."""
    if lat.L1 % 2 or lat.L2 % 2 or lat.n_orb != 1:
        raise ValueError("checkerboard kinetics requires even L1, L2 and a "
                         "single orbital")
    ns = lat.n_sites
    perms, masks = [], []
    for axis, parity in (((1, 0), 0), ((1, 0), 1), ((0, 1), 0), ((0, 1), 1)):
        p = np.arange(ns, dtype=np.int64)
        m = np.zeros(ns)
        nm = lat.neighbor_map(axis, orb=0)
        for i in range(ns):
            ux, uy = lat.site_to_unitcellpos(i)
            if (ux if axis == (1, 0) else uy) % 2 == parity:
                j = nm[i]
                p[i], p[j] = j, i
                m[i] = m[j] = 1.0
        perms.append(p)
        masks.append(m)
    return (np.stack(perms), np.stack(masks), math.cosh(dtau * t),
            math.sinh(dtau * t))


def _apply_groups(X, perms, masks, ch, sh, *, reverse: bool):
    """prod_g G_g (or its transpose: the reversed order, each G_g being
    symmetric) applied to the rows of X (..., ns, n)."""
    order = range(perms.shape[0] - 1, -1, -1) if reverse \
        else range(perms.shape[0])
    for g in order:
        m = masks[g][:, None].to(X.dtype)
        Xp = torch.index_select(X, -2, perms[g])
        X = X + m * ((ch - 1.0) * X + sh * Xp)
    return X


def _kin_left(model, X, *, inv: bool):
    """exp(-+dtau K) @ X."""
    if not model.checkerboard:
        return lead(model.invexpK if inv else model.expK, 2, X.dim()) @ X
    if inv:
        # reverse order, sinh -> -sinh, 1/emu
        return _apply_groups(X, model.cb_perm, model.cb_mask, model.cb_ch,
                             -model.cb_sh, reverse=True) / model.cb_emu
    return model.cb_emu * _apply_groups(X, model.cb_perm, model.cb_mask,
                                        model.cb_ch, model.cb_sh,
                                        reverse=False)


def _kin_right(model, X, *, inv: bool):
    """X @ exp(-+dtau K): X P = (P^T X^T)^T, and P^T is the product of
    the same symmetric group factors in the reverse order (P^{-T} likewise
    in the forward order).  The JAX package applies P^T itself here
    (ROADMAP.md section 3, "Faults of the reference")."""
    if not model.checkerboard:
        return X @ lead(model.invexpK if inv else model.expK, 2, X.dim())
    XT = X.transpose(-1, -2)
    if inv:
        YT = _apply_groups(XT, model.cb_perm, model.cb_mask, model.cb_ch,
                           -model.cb_sh, reverse=False) / model.cb_emu
    else:
        YT = model.cb_emu * _apply_groups(XT, model.cb_perm, model.cb_mask,
                                          model.cb_ch, model.cb_sh,
                                          reverse=True)
    return YT.transpose(-1, -2)


def apply_B_left(model, fields_l, X):
    """B @ X"""
    expV = model.expV_diag(fields_l)
    return expV[..., :, None] * _kin_left(model, X, inv=False)


def apply_B_right(model, fields_l, X):
    """X @ B"""
    expV = model.expV_diag(fields_l)
    return _kin_right(model, X * expV[..., None, :], inv=False)


def apply_invB_left(model, fields_l, X):
    """B^{-1} @ X = expK^{-1} (diag(expV)^{-1} X)"""
    expV = model.expV_diag(fields_l)
    return _kin_left(model, X / expV[..., :, None], inv=True)


def apply_invB_right(model, fields_l, X):
    """X @ B^{-1} = (X expK^{-1}) diag(expV)^{-1}"""
    expV = model.expV_diag(fields_l)
    return _kin_right(model, X, inv=True) / expV[..., None, :]
