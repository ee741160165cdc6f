"""The per-slice sweep engine, and what it shares with the fused one:
stack-slot helpers, random streams, the rank-1 update oracle, the block
driver, stack rebuild and initialization.

PyTorch counterpart of ``dqmc_tpu/engine/sweep.py``.  Everything is
walker-batched: stack leaves are (W, nfl, n_slots, ...), G is
(W, nfl, ns, ns), fields are (W, nt, ns).  Where the JAX package vmaps
``sweep`` over walkers, :func:`sweep` takes the walker axis directly; a
replica-stacked model (``parallel/walkers.stack_models``) runs walker r
with replica r's constants, as JAX's vmap over stacked models does.

Each slice wraps G through B = diag(expV) expK (torch.matmul), runs the
site update, and extends the block product; every n_stab slices the block
is folded into the LDR stack (:func:`run_sweep`).  The site update follows
the EngineConfig (:func:`site_update_fn`): ``use_pallas`` takes the
walker-batched kernels with a shared visit order (#4 for a 2-flavor model,
#5 submatrix when ``submatrix_rank > 0``, else #3 delayed at JAX's rank),
else each walker runs its own order through the submatrix, delayed (rank
``delay_rank``) or rank-1 scheme.  On CUDA tensors they launch the kernels
of ``ops/kernels.py``; on CPU tensors they run its plain twins.  A 2-flavor
(det_power = 1) model carries its Metropolis sign: every site update
returns the product of its slice's sign flips and :func:`run_sweep`
multiplies it into ``states.sign``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
from dqmc_tpu_torch.models.attractive_hubbard import lead
from dqmc_tpu_torch.models.kinetic import (apply_B_left, apply_B_right,
                                           apply_invB_left, apply_invB_right)
from dqmc_tpu_torch.ops import kernels
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


def draw_sweep_streams(gens, nt: int, ns: int, dtype):
    """One sweep's streams, each walker's from its generator: orders,
    props and us, each (W, nt, ns), indexed by slice."""
    per = [draw_slice_randoms(g, ns, dtype, (nt,)) for g in gens]
    return tuple(torch.stack([p[j] for p in per]) for j in range(3))


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
# per-walker-order site updates (sweep.py:150-403); (G, fields_l, acc, sgn)
# ----------------------------------------------------------------------

def _couplings(model, W: int):
    """Per-walker (g, alpha) (W,): one model's, or a replica-stacked
    model's one per replica."""
    return model.g.reshape(-1).expand(W), model.alpha.reshape(-1).expand(W)


def local_update_slice(model, G, fields_l, order, props, us):
    """The rank-1 Sherman-Morrison loop (the ``scan`` site update), each
    walker in its own order (W, ns); kernel #6 on CUDA for one stored
    flavor, torch ops for two."""
    g, alpha = _couplings(model, G.shape[0])
    return kernels.slice_update("rank1", g, alpha, order, props, us, G,
                                fields_l, 1)


def local_update_slice_delayed(model, G, fields_l, order, props, us,
                               k_max: int):
    """Delayed rank-``k_max`` updates, each walker in its own order; a
    short last block when k_max does not divide ns (JAX pads the stream
    with rejected visits to the same effect); kernel #3 on CUDA, #4 for
    two flavors."""
    g, alpha = _couplings(model, G.shape[0])
    return kernels.slice_update("delayed", g, alpha, order, props, us, G,
                                fields_l, k_max)


def local_update_slice_submatrix(model, G, fields_l, order, props, us,
                                 k_max: int):
    """Submatrix updates of rank ``k_max``, each walker in its own order
    (a short last block as above), one bordered inverse per flavor; kernel
    #5 on CUDA for one stored flavor, torch ops for two."""
    g, alpha = _couplings(model, G.shape[0])
    return kernels.slice_update("submatrix", g, alpha, order, props, us, G,
                                fields_l, k_max)


def site_update_fn(model, cfg: EngineConfig):
    """The slice's site update for the config, as a function of (G,
    fields_l, orders (W, ns), props, us) -> (G, fields_l, acc, sgn),
    mirroring the JAX dispatch (sweep.py:518-553).  The shared-order kernels
    take walker 0's order, as JAX's batched kernels take keys[0]'s; a
    2-flavor model under ``use_pallas`` takes kernel #4 whatever the
    submatrix rank, as in JAX."""
    kinds = (model.n_flavor, model.det_power)
    if kinds not in ((1, 2), (2, 1)):
        raise NotImplementedError(
            f"site updates: single-flavor det_power=2 or two-flavor "
            f"det_power=1 models, not n_flavor, det_power = {kinds}")

    def update(G, f, o, p, u):
        if cfg.use_pallas:
            g, alpha = _couplings(model, G.shape[0])
            if model.n_flavor == 2:
                return kernels.metropolis_slice_update_batched_2f(
                    g, alpha, o[0], p, u, G, f)
            if cfg.submatrix_rank > 0:
                out = kernels.metropolis_slice_update_submatrix(
                    g, alpha, o[0], p, u, G, f, k_sub=cfg.submatrix_rank)
            else:
                out = kernels.metropolis_slice_update_batched(g, alpha, o[0],
                                                              p, u, G, f)
            return out + (torch.ones_like(out[2]),)   # sign-free
        if cfg.submatrix_rank > 0:
            return local_update_slice_submatrix(model, G, f, o, p, u,
                                                cfg.submatrix_rank)
        if cfg.delay_rank > 0:
            return local_update_slice_delayed(model, G, f, o, p, u,
                                              cfg.delay_rank)
        return local_update_slice(model, G, f, o, p, u)

    return update


# ----------------------------------------------------------------------
# the block driver shared by both engines (dqmc.cpp:337-456)
# ----------------------------------------------------------------------

def stabilize(G, F_prev, other, Bbar, forward: bool):
    """Stabilization at a block boundary: extend the carried chain factor
    with the block product and recompute G from the stable factorization;
    ``other`` is the opposite half-chain's slot from the input stack.
    Returns (G_new, F_new, log_det, err) with err the per-walker max
    deviation of the propagated G from the stabilized one."""
    if forward:
        F_new = mat_mul_ldr(Bbar, F_prev)
        G_new, log_det = inv_one_plus_ldr_dag(F_new, other)
    else:
        F_new = mat_mul_ldr(Bbar.transpose(-1, -2), F_prev)
        G_new, log_det = inv_one_plus_ldr_dag(other, F_new)
    err = torch.amax(torch.abs(G - G_new), dim=(1, 2, 3))
    return G_new, F_new, log_det, err


def run_sweep(model, cfg: EngineConfig, states: WalkerState, run_block, *,
              forward: bool) -> WalkerState:
    """One walker-batched sweep as a sequence of stabilization blocks.

    ``run_block(l0, n, G, fields_blk)`` propagates and updates slices
    l0..l0+n-1 and returns (G, fields_blk, Bbar, acc, sign) with Bbar
    (W, nfl, ns, ns) the block's propagator product in application order,
    acc the block's acceptance fraction (W,) and sign the product of its
    sign flips (W,).  A ragged last block (nt % n_stab != 0) runs last
    forward and first backward."""
    W = states.G.shape[0]
    nfl, ns, dtype, dev = model.n_flavor, model.n_sites, model.dtype, \
        model.device
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    blocks = [(i, i * n_stab, n_stab) for i in range(n_full)]
    tail = (cfg.n_stack - 1, n_full * n_stab, rem) if rem else None
    if forward:
        seq = blocks + ([tail] if tail else [])
    else:
        seq = ([tail] if tail else []) + blocks[::-1]

    id_w = identity_slot(nfl, ns, dtype, dev, (W,))
    fields = states.fields.clone()
    G, F_prev, log_det = states.G, id_w, states.log_det_M
    acc, sgn = states.acc_sum, states.sign
    emax, esum, ecnt = states.err_max, states.err_sum, states.err_count
    slots, tail_slot = [], None
    for blk in seq:
        i_stack, l0, n = blk
        win = slice(l0, l0 + n)
        G, fb, bbar, acc_b, sgn_b = run_block(l0, n, G, fields[:, win])
        fields[:, win] = fb
        other = slot_get(states.stack, i_stack + (2 if forward else 0))
        G, F_prev, log_det, err = stabilize(G, F_prev, other, bbar, forward)
        if blk is tail:
            tail_slot = F_prev
        else:
            slots.append(F_prev)
        acc = acc + acc_b * (n / cfg.nt)
        sgn = sgn * sgn_b
        emax = torch.maximum(emax, err)
        esum = esum + err
        ecnt = ecnt + 1.0
    stack = stack_from_slots(slots, id_w, tail_slot, reverse=not forward)
    return dataclasses.replace(
        states, fields=fields, G=G, stack=stack, log_det_M=log_det,
        acc_sum=acc, sign=sgn, err_max=emax, err_sum=esum, err_count=ecnt)


def sweep(model, cfg: EngineConfig, states: WalkerState, *,
          forward: bool = True, update: bool = True,
          streams=None) -> WalkerState:
    """One walker-batched sweep of the per-slice engine.

    forward=True: 0 -> beta, wrap G then update each slice, stabilize at
    block ends; forward=False: beta -> 0, update then wrap back.
    update=False propagates and stabilizes only.  ``streams = (orders,
    props, us)``, each (W, nt, ns) and indexed by slice, replaces the draw
    from the walker generators (tests hand in the JAX package's
    streams)."""
    W = states.G.shape[0]
    ns, dtype, dev = model.n_sites, model.dtype, model.device
    if update:
        if streams is None:
            streams = draw_sweep_streams(states.gens, cfg.nt, ns, dtype)
        orders, props, us = (torch.as_tensor(x).to(dev) for x in streams)
        update_fn = site_update_fn(model, cfg)
    eye = torch.eye(ns, dtype=dtype, device=dev).expand(
        W, model.n_flavor, ns, ns)

    def run_block(l0, n, G, fb):
        fb = fb.clone()
        bbar = eye
        acc = torch.zeros((W,), dtype=dtype, device=dev)
        sgn = torch.ones_like(acc)
        for step in range(n):
            j = step if forward else n - 1 - step
            f = fb[:, j]
            if forward:
                # G(l+1) = B_l G(l) B_l^{-1}, pre-update fields
                G = apply_invB_right(model, f, apply_B_left(model, f, G))
            if update:
                l = l0 + j
                G, f, acc_l, sgn_l = update_fn(G, f, orders[:, l],
                                               props[:, l], us[:, l])
                fb[:, j] = f
                acc = acc + acc_l
                sgn = sgn * sgn_l
            if forward:
                bbar = apply_B_left(model, f, bbar)
            else:
                # G(l) = B_l^{-1} G(l+1) B_l, post-update fields
                G = apply_B_right(model, f, apply_invB_left(model, f, G))
                bbar = apply_B_right(model, f, bbar)
        return G, fb, bbar, acc / n, sgn

    return run_sweep(model, cfg, states, run_block, forward=forward)


def sweep_pair(model, cfg: EngineConfig, states: WalkerState,
               streams=None) -> WalkerState:
    """Forward then backward sweep (main.cpp:131-132); ``streams`` is None
    or a pair (forward streams, backward streams)."""
    fwd, bwd = streams if streams is not None else (None, None)
    states = sweep(model, cfg, states, forward=True, streams=fwd)
    return sweep(model, cfg, states, forward=False, streams=bwd)


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
    return (lead(model.invexpK_half, 2, G.dim()) @ G
            @ lead(model.expK_half, 2, G.dim()))
