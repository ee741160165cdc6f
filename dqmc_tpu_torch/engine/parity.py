"""The multiword measurement tier: equal-time Green's functions rebuilt from
the fields at df32 or tf32 grade.

PyTorch counterpart of the equal-time half of ``dqmc_tpu/engine/parity.py``,
walker-batched.  :func:`measurement_greens_fn` returns ``greens_fn(states)
-> G (W, nfl, ns, ns)`` in float64: each walker's G(0, 0) = [I + B(beta,
0)]^{-1} is folded from its fields through the multiword LDR chain
(``ops/df_linalg``; every fold's QR runs panel kernel #7 or #8 on CUDA),
independent of the sampling engine's precision, and half-warped in
multiword when ``symmetric``.  The model passed is the float64 build (its
expK at full precision).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.engine.state import EngineConfig
from dqmc_tpu_torch.ops import df32, df_linalg, tf32


def _expv_table_f64(model, sign: float = 1.0) -> np.ndarray:
    """exp(sign g eta(s)) for the 4 field states, float64 (4,): +1 for the
    attractive model's flavor and the repulsive up flavor, -1 for down."""
    g = float(model.g.double().cpu())
    return np.exp(sign * g * np.asarray(hsfield.ETA, np.float64))


def _flavor_signs(model):
    return (1.0,) if model.n_flavor == 1 else (1.0, -1.0)


def _slice_B(model, expK, fields_l: torch.Tensor, nm, sign: float = 1.0):
    """Multiword B_l = diag(expV(s_l)) @ expK for fields (W, ns), a full
    multiword multiply; the field values selected by a chain over the 4
    states."""
    tbl = nm.from_f64(torch.as_tensor(_expv_table_f64(model, sign),
                                      device=fields_l.device))

    def sel(comp):
        out = torch.zeros(fields_l.shape, dtype=torch.float32,
                          device=fields_l.device)
        for v in range(4):
            out = torch.where(fields_l == v, comp[v], out)
        return out

    ev = nm.cmap(lambda c: sel(c)[..., :, None], tbl)
    return nm.mul(expK, ev)


def _check_model(model):
    if model.n_flavor not in (1, 2):
        raise NotImplementedError(
            "parity rebuild: 1- or 2-flavor models only")
    if model.expK.dtype != torch.float64:
        raise ValueError("parity rebuild needs the float64-built model "
                         "(expK at full precision); build it with "
                         "dtype=torch.float64")


def _identity_ldr(W: int, ns: int, nm, device):
    eye = nm.df(torch.eye(ns, dtype=torch.float32, device=device).expand(
        W, ns, ns))
    ones = nm.df(torch.ones((W, ns), dtype=torch.float32, device=device))
    return df_linalg.LDRdf(eye, ones, eye,
                           torch.zeros((W, ns), dtype=torch.int32,
                                       device=device))


def rebuild_chain(model, cfg: EngineConfig, fields: torch.Tensor, nm=df32,
                  *, flavor_sign: float = 1.0):
    """Multiword chain rebuild of a field batch (W, nt, ns) -> (G (W, ns,
    ns) nm tuple, log|det| (W,)): the dag (transpose-suffix) fold over the
    blocks, latest first.  With exact blocking (nt % n_stab == 0) the chain
    starts from an identity factor and every block is a fold, as the JAX
    package's scan form; otherwise the first (ragged) block is factored
    directly, as its unrolled form."""
    W, nt, ns = fields.shape
    dev = fields.device
    expK = nm.from_f64(model.expK)
    eye = nm.df(torch.eye(ns, dtype=torch.float32, device=dev))

    def block_product(l0, l1):
        Bbar = eye
        for l in range(l0, l1):
            B = _slice_B(model, expK, fields[:, l], nm, flavor_sign)
            Bbar = nm.matmul(B, Bbar)
        return Bbar

    F2t = (_identity_ldr(W, ns, nm, dev) if nt % cfg.n_stab == 0
           else None)
    for i_stack in range(cfg.n_stack - 1, -1, -1):
        l0 = i_stack * cfg.n_stab
        BbarT = df_linalg.transpose(
            block_product(l0, min(l0 + cfg.n_stab, nt)))
        F2t = (df_linalg.to_ldr(BbarT, nm=nm) if F2t is None
               else df_linalg.mat_mul_ldr(BbarT, F2t, nm=nm))
    # the identity's factorization is the same for every walker
    F1 = df_linalg.to_ldr(eye, nm=nm)
    bat = lambda c: c.expand((W,) + c.shape)  # noqa: E731
    F1 = df_linalg.LDRdf(nm.cmap(bat, F1.L), nm.cmap(bat, F1.d),
                         nm.cmap(bat, F1.R), bat(F1.e))
    return df_linalg.inv_one_plus_ldr_dag(F1, F2t, nm=nm)


def measurement_greens_fn(model64, cfg: EngineConfig, nm, *,
                          symmetric: bool = False,
                          n_stab: int | None = None):
    """``greens_fn(states) -> G (W, nfl, ns, ns)`` float64: the measured
    equal-time G rebuilt from each walker's fields at nm grade (one chain
    per stored flavor), half-warped G~ = invexpK_half G expK_half in
    multiword when ``symmetric``.

    ``n_stab`` is the rebuild's fold stride: by default twice the engine's
    for tf32 (its precision headroom tolerates the wider stride, and the
    multiword QRs dominate the rebuild), the engine's for df32; a stride
    that does not divide nt falls back to the engine's."""
    _check_model(model64)
    if n_stab is None:
        n_stab = 2 * cfg.n_stab if nm is tf32 else cfg.n_stab
    if cfg.nt % n_stab != 0:
        n_stab = cfg.n_stab
    cfg = dataclasses.replace(cfg, n_stab=n_stab)
    left = nm.from_f64(model64.invexpK_half)
    right = nm.from_f64(model64.expK_half)

    def greens_fn(states):
        Gs = []
        for sign in _flavor_signs(model64):
            G, _ = rebuild_chain(model64, cfg, states.fields, nm,
                                 flavor_sign=sign)
            if symmetric:
                G = nm.matmul(nm.matmul(left, G), right)
            Gs.append(nm.to_f64(G))
        return torch.stack(Gs, dim=1)

    greens_fn.n_stab = n_stab
    return greens_fn
