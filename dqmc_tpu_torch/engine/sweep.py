"""Stack-slot helpers, random streams, the rank-1 update oracle, stack
rebuild and initialization.

PyTorch counterpart of the pieces of ``dqmc_tpu/engine/sweep.py`` that the
fused driver uses.  Everything is walker-batched: stack leaves are
(W, nfl, n_slots, ...), G is (W, nfl, ns, ns), fields are (W, nt, ns).

The per-slice engine (``sweep``/``sweep_pair`` with the scan, delayed and
submatrix site updates) is not ported yet (ROADMAP: kernels #3-#6 and the
slice engine).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
from dqmc_tpu_torch.models.kinetic import apply_B_right
from dqmc_tpu_torch.ops.linalg import LDR, inv_one_plus_ldr_dag, mat_mul_ldr


# ----------------------------------------------------------------------
# stack-slot helpers: slot axis -3 for L/R, -2 for d
# ----------------------------------------------------------------------

def slot_get(stack: LDR, i: int) -> LDR:
    return LDR(stack.L[..., i, :, :], stack.d[..., i, :],
               stack.R[..., i, :, :])


def slot_set(stack: LDR, i: int, F: LDR) -> LDR:
    L, d, R = stack.L.clone(), stack.d.clone(), stack.R.clone()
    L[..., i, :, :] = F.L
    d[..., i, :] = F.d
    R[..., i, :, :] = F.R
    return LDR(L, d, R)


def identity_slot(nfl: int, ns: int, dtype, device="cpu",
                  batch: tuple = ()) -> LDR:
    """One identity LDR factor with leading (*batch, nfl) axes: the seed of
    the prefix/suffix chains and the stack's padding slots."""
    eye = torch.eye(ns, dtype=dtype, device=device).expand(
        batch + (nfl, ns, ns))
    return LDR(eye, torch.ones(batch + (nfl, ns), dtype=dtype,
                               device=device), eye)


def stack_from_slots(slots: List[LDR], id_slot: LDR,
                     tail: Optional[LDR] = None, *,
                     reverse: bool = False) -> LDR:
    """The identity-padded stack from per-block factors listed in
    block-processing order.  ``tail`` is the extra slot of the short last
    block when nt % n_stab != 0 (processed last forward, first backward);
    ``reverse`` marks backward sweeps and rebuilds, whose blocks run
    n_stack-1..0."""
    slots = list(slots)
    if tail is not None:
        slots = [tail] + slots if reverse else slots + [tail]
    if reverse:
        slots = slots[::-1]
    seq = [id_slot] + slots + [id_slot]
    return LDR(torch.stack([s.L for s in seq], dim=-3),
               torch.stack([s.d for s in seq], dim=-2),
               torch.stack([s.R for s in seq], dim=-3))


# ----------------------------------------------------------------------
# random streams and the rank-1 oracle (update.cpp:5-32)
# ----------------------------------------------------------------------

def draw_slice_randoms(gen: torch.Generator, ns: int, dtype,
                       shape: tuple = ()):
    """The per-slice random stream (visit order, proposal draws, uniforms),
    each (*shape, ns), drawn on the generator's device.  The visit order is
    a uniform random permutation (argsort of uniforms, so a whole sweep's
    orders are one call)."""
    dev = gen.device
    order = torch.argsort(torch.rand(shape + (ns,), generator=gen,
                                     device=dev, dtype=torch.float64), dim=-1)
    props = torch.randint(0, 3, shape + (ns,), generator=gen, device=dev)
    us = torch.rand(shape + (ns,), generator=gen, device=dev, dtype=dtype)
    return order, props, us


def local_update_core(model, G: torch.Tensor, fields_l: torch.Tensor,
                      order: torch.Tensor, props: torch.Tensor,
                      us: torch.Tensor):
    """One walker's sequential rank-1 Sherman-Morrison site loop with an
    explicit stream (props indexed per VISIT).  G (nfl, ns, ns).
    Returns (G, fields_l, acceptance fraction, sign)."""
    ns = model.n_sites
    G = G.clone()
    fields_l = fields_l.clone()
    acc = 0
    sgn = 1.0
    for i, r, u in zip(order.tolist(), props.tolist(), us.tolist()):
        old = int(fields_l[i])
        new = int(hsfield.PROPOSAL[old, r])
        gammaR, bosonR, delta = model.update_factors(
            torch.tensor(old, device=G.device),
            torch.tensor(new, device=G.device))
        r_flv = 1.0 + (1.0 - G[:, i, i]) * delta
        R = gammaR * bosonR * torch.prod(r_flv) ** model.det_power
        if u < min(1.0, abs(float(R))):
            if float(R) < 0:
                sgn = -sgn
            prefac = delta / r_flv
            v_vec = G[:, i, :].clone()
            v_vec[:, i] -= 1.0
            G = G + prefac[:, None, None] * (G[:, :, i][:, :, None]
                                              * v_vec[:, None, :])
            fields_l[i] = new
            acc += 1
    return G, fields_l, acc / ns, sgn


# ----------------------------------------------------------------------
# stack (re)initialization (dqmc.cpp:43-72)
# ----------------------------------------------------------------------

def rebuild_stack_and_greens(model, cfg: EngineConfig, fields: torch.Tensor):
    """The full right-to-left LDR stack of a field batch (W, nt, ns) and
    G(0,0) = [I + B(beta,0)]^{-1} with its log-determinant.

    A backward no-update pass: each block's dense product Bbar extends the
    suffix chain in TRANSPOSE form, slot[i+1] = LDR(Bbar_i^T slot[i+2]),
    so every QR input is column-graded."""
    W = fields.shape[0]
    nfl, ns = model.n_flavor, model.n_sites
    dtype, dev = model.dtype, model.device
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    eyeB = torch.eye(ns, dtype=dtype, device=dev).expand(W, nfl, ns, ns)

    def run_block(T_prev, n_slices, l0):
        Bbar = eyeB
        for k in range(n_slices):
            l = l0 + n_slices - 1 - k
            Bbar = apply_B_right(model, fields[:, l], Bbar)
        return mat_mul_ldr(Bbar.transpose(-1, -2), T_prev)

    T = identity_slot(nfl, ns, dtype, dev, (W,))
    tail = None
    if rem:
        T = tail = run_block(T, rem, n_full * n_stab)
    slots = []
    for i in range(n_full - 1, -1, -1):
        T = run_block(T, n_stab, i * n_stab)
        slots.append(T)
    id_w = identity_slot(nfl, ns, dtype, dev, (W,))
    stack = stack_from_slots(slots, id_w, tail, reverse=True)
    G, log_det_M = inv_one_plus_ldr_dag(id_w, T)
    return stack, G, log_det_M


def init_state(model, cfg: EngineConfig,
               gens: List[torch.Generator]) -> WalkerState:
    """Fresh walkers, one per generator: random HS fields (field.h:52-57),
    stack and G from them.  Each generator then carries its walker's
    chain."""
    fields = torch.stack([hsfield.init_fields(g, cfg.nt, model.n_sites)
                          for g in gens]).to(model.device)
    stack, G, log_det_M = rebuild_stack_and_greens(model, cfg, fields)
    W = len(gens)
    z = torch.zeros((W,), dtype=model.dtype, device=model.device)
    return WalkerState(fields=fields, G=G, stack=stack, log_det_M=log_det_M,
                       gens=list(gens), acc_sum=z, sign=torch.ones_like(z),
                       err_max=z.clone(), err_sum=z.clone(),
                       err_count=z.clone())


def reset_error_stats(state: WalkerState) -> WalkerState:
    """Zero the stabilization-precision accumulators, so reported errors
    reflect the measured phase only."""
    z = torch.zeros_like(state.err_max)
    return dataclasses.replace(state, err_max=z, err_sum=z.clone(),
                               err_count=z.clone())


def half_warp(model, G: torch.Tensor) -> torch.Tensor:
    """G~ = expm(+dtau K/2) G expm(-dtau K/2) (dqmc.cpp:288-315): the
    symmetric-Trotter measurement transform."""
    return model.invexpK_half @ G @ model.expK_half
