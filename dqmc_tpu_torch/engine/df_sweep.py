"""The hybrid df32 parity engine: float32 site updates and wraps, df32
stabilization.

PyTorch counterpart of ``dqmc_tpu/engine/df_sweep.py``, walker-batched.
The Metropolis site loop and the slice-to-slice wraps stay on the float32
path of the per-slice engine (``engine/sweep.py``: the same site-update
dispatch and kernels), while everything whose error accumulates over a
sweep -- the block propagator products, the LDR stack folds and the
stabilized inverses -- is carried in double-float32 (``ops/df32``,
``ops/df_linalg``; every fold's QR runs panel kernel #7 on CUDA).  At each
stabilization the float32 G is replaced by the df rebuild, so its drift
never compounds; ``G_df`` is the df-grade Green's function of the current
fields.

Leaves: stack (W, nfl, n_slots, ...) with the exponent-split scale ladder,
G and G_df (W, nfl, ns, ns), fields (W, nt, ns); one ``torch.Generator``
per walker.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.engine.state import EngineConfig
from dqmc_tpu_torch.engine.sweep import draw_sweep_streams, site_update_fn
from dqmc_tpu_torch.models.kinetic import (apply_B_left, apply_B_right,
                                           apply_invB_left, apply_invB_right)
from dqmc_tpu_torch.ops import df32
from dqmc_tpu_torch.ops.df32 import DF
from dqmc_tpu_torch.ops.df_linalg import (LDRdf, inv_one_plus_ldr_dag,
                                          mat_mul_ldr, transpose)


# ----------------------------------------------------------------------
# df model data
# ----------------------------------------------------------------------

# the df32 engine's block products and stack come from the dense expK
# (df_aux_build), so with a checkerboard model32 they would not be the
# products of the B its float32 wraps apply: the JAX package runs that
# mixture (ROADMAP.md section 3, "Faults of the reference")
CHECKERBOARD_DF32 = (
    "the df32 engine builds its df32 block products and stack from the "
    "dense expK, not from the checkerboard operator its float32 wraps "
    "apply (ROADMAP.md section 3, 'Faults of the reference'); run "
    "checkerboard = true with dtype float32 or float64")


class DFModelAux(NamedTuple):
    """df32 twins of the propagator constants: expK (ns, ns) of
    expm(-dtau K) from the float64 build, expv (nfl, 4) the table
    exp(+-g eta(s)) per stored flavor, act (4,) the per-state bosonic
    action constants -(alpha g eta_v + log gamma_v).  A replica-stacked
    aux (:func:`stack_aux`) holds expK (R, 1, ns, ns), expv (R, nfl, 4)
    and act (R, 4), walker r taking replica r's."""
    expK: DF
    expv: DF
    act: DF


def _split64(x: np.ndarray, device) -> DF:
    hi = np.float32(x)
    lo = np.float32(x - np.float64(hi))
    return DF(torch.as_tensor(hi, device=device),
              torch.as_tensor(lo, device=device))


def df_aux_build(lat, *, U: float, t: float, mu: float, beta: float,
                 nt: int, bonds=None, n_flavor: int = 1,
                 device="cpu") -> DFModelAux:
    """The df32 propagator constants, built on the host in float64 (scipy
    expm, as the model build) and split into pairs; n_flavor = 2 builds the
    repulsive spin-channel twin (opposite couplings, alpha = 0)."""
    import scipy.linalg
    from dqmc_tpu_torch.models.attractive_hubbard import build_kinetic_matrix
    dtau = beta / nt
    expK64 = scipy.linalg.expm(-dtau * build_kinetic_matrix(lat, t, mu,
                                                            bonds=bonds))
    g64 = float(np.sqrt(0.5 * abs(U) * dtau))
    alpha = -1.0 if n_flavor == 1 else 0.0
    eta = np.asarray(hsfield.ETA, np.float64)
    gamma = np.asarray(hsfield.GAMMA, np.float64)
    tbl = (np.exp(g64 * eta)[None, :] if n_flavor == 1 else
           np.stack([np.exp(g64 * eta), np.exp(-g64 * eta)]))
    act = -(alpha * g64 * eta + np.log(gamma))
    return DFModelAux(expK=_split64(expK64, device),
                      expv=_split64(tbl, device), act=_split64(act, device))


def stack_aux(auxs) -> DFModelAux:
    """One replica-stacked aux from per-replica ones (one beta each; the
    df twin of ``parallel/walkers.stack_models``)."""
    st = lambda xs, lead=False: DF(*(  # noqa: E731
        torch.stack([getattr(x, c) for x in xs])[:, None] if lead
        else torch.stack([getattr(x, c) for x in xs]) for c in ("hi", "lo")))
    return DFModelAux(expK=st([a.expK for a in auxs], lead=True),
                      expv=st([a.expv for a in auxs]),
                      act=st([a.act for a in auxs]))


def df_global_action(aux: DFModelAux, fields: torch.Tensor,
                     log_det_M: torch.Tensor,
                     det_power: int = 2) -> torch.Tensor:
    """S per walker (W,) at df accuracy for replica exchange
    (model.cpp:140-159): the df chain's log-det (W, nfl) for the
    fermionic part, and the exact integer state counts dotted with the
    per-state constants ``aux.act`` as df pairs for the bosonic part."""
    counts = torch.stack([torch.count_nonzero(fields == v, dim=(-2, -1))
                          for v in range(4)], dim=-1).to(torch.float32)
    prod = df32.mul(aux.act, df32.df(counts))
    tot = df32.df(torch.zeros(counts.shape[:-1], device=fields.device))
    for v in range(4):
        tot = df32.add(tot, DF(prod.hi[..., v], prod.lo[..., v]))
    s_ferm = -det_power * torch.sum(log_det_M, dim=-1)
    return s_ferm + tot.hi + tot.lo


def _slice_B_df(aux: DFModelAux, fields_l: torch.Tensor) -> DF:
    """(W, nfl, ns, ns) df B_l = diag(expv[s_l]) @ expK for fields (W, ns):
    a full df multiply, the field values selected by a chain over the 4
    states."""
    W, ns = fields_l.shape
    nfl = aux.expv.hi.shape[-2]
    evh = torch.zeros((W, nfl, ns), dtype=torch.float32,
                      device=fields_l.device)
    evl = torch.zeros_like(evh)
    for v in range(4):
        m = (fields_l == v)[:, None, :]
        evh = torch.where(m, aux.expv.hi[..., v:v + 1], evh)
        evl = torch.where(m, aux.expv.lo[..., v:v + 1], evl)
    return df32.mul(aux.expK, DF(evh[..., :, None], evl[..., :, None]))


# ----------------------------------------------------------------------
# the df stack: slot axis 2 (after walker and flavor)
# ----------------------------------------------------------------------

def _leaves(F: LDRdf):
    return (*F.L, *F.d, *F.R, F.e)


def _ldr(leaves) -> LDRdf:
    return LDRdf(DF(*leaves[0:2]), DF(*leaves[2:4]), DF(*leaves[4:6]),
                 leaves[6])


def slot_get_df(stack: LDRdf, i: int) -> LDRdf:
    return _ldr([x[:, :, i] for x in _leaves(stack)])


def identity_slot_df(W: int, nfl: int, ns: int, device="cpu") -> LDRdf:
    eye = torch.eye(ns, dtype=torch.float32, device=device).expand(
        W, nfl, ns, ns)
    ones = torch.ones((W, nfl, ns), dtype=torch.float32, device=device)
    return LDRdf(DF(eye, torch.zeros_like(eye)),
                 DF(ones, torch.zeros_like(ones)),
                 DF(eye, torch.zeros_like(eye)),
                 torch.zeros((W, nfl, ns), dtype=torch.int32, device=device))


def stack_from_slots_df(slots: List[LDRdf], id_slot: LDRdf,
                        tail: Optional[LDRdf] = None, *,
                        reverse: bool = False) -> LDRdf:
    """The identity-padded df stack from per-block factors in processing
    order (engine/sweep.py's stack_from_slots for the df leaves)."""
    slots = list(slots)
    if tail is not None:
        slots = [tail] + slots if reverse else slots + [tail]
    if reverse:
        slots = slots[::-1]
    seq = [_leaves(s) for s in [id_slot] + slots + [id_slot]]
    return _ldr([torch.stack(xs, dim=2) for xs in zip(*seq)])


def _eye_df(W: int, nfl: int, ns: int, device) -> DF:
    eye = torch.eye(ns, dtype=torch.float32, device=device).expand(
        W, nfl, ns, ns)
    return DF(eye, torch.zeros_like(eye))


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class DFWalkerState:
    """Markov-chain state of the df32 engine, walker axis first: G the
    float32 working Green's function the site loop reads, G_df its df32
    twin refreshed at every stabilization (what measurements should
    consume), log_det_M (W, nfl) float64, statistics (W,)."""
    fields: torch.Tensor
    G: torch.Tensor
    G_df: DF
    stack: LDRdf
    log_det_M: torch.Tensor
    gens: List[torch.Generator]
    acc_sum: torch.Tensor
    sign: torch.Tensor
    err_max: torch.Tensor
    err_sum: torch.Tensor
    err_count: torch.Tensor


# ----------------------------------------------------------------------
# stack rebuild (dqmc.cpp:43-72 in df)
# ----------------------------------------------------------------------

def rebuild_stack_df(aux: DFModelAux, cfg: EngineConfig,
                     fields: torch.Tensor):
    """The full right-to-left df stack of a field batch (W, nt, ns), G_df
    (0, 0) and log|det| (W, nfl)."""
    W = fields.shape[0]
    nfl, ns = aux.expv.hi.shape[-2], aux.expK.hi.shape[-1]
    dev = fields.device
    eyeB = _eye_df(W, nfl, ns, dev)
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab

    def run_block(T_prev, n_slices, l0):
        Bbar = eyeB
        for k in range(n_slices):
            B = _slice_B_df(aux, fields[:, l0 + n_slices - 1 - k])
            Bbar = df32.matmul(Bbar, B)          # right to left: Bbar @ B_l
        return mat_mul_ldr(transpose(Bbar), T_prev)

    T = identity_slot_df(W, nfl, ns, dev)
    tail = None
    if rem:
        T = tail = run_block(T, rem, n_full * n_stab)
    slots = []
    for i in range(n_full - 1, -1, -1):
        T = run_block(T, n_stab, i * n_stab)
        slots.append(T)
    id_w = identity_slot_df(W, nfl, ns, dev)
    stack = stack_from_slots_df(slots, id_w, tail, reverse=True)
    G_df, log_det = inv_one_plus_ldr_dag(id_w, T)
    return stack, G_df, log_det


def init_state_df(model32, aux: DFModelAux, cfg: EngineConfig,
                  gens: List[torch.Generator]) -> DFWalkerState:
    """Fresh walkers, one per generator: random HS fields, the df stack
    and G from them."""
    fields = torch.stack([hsfield.init_fields(g, cfg.nt, model32.n_sites)
                          for g in gens]).to(model32.device)
    stack, G_df, log_det = rebuild_stack_df(aux, cfg, fields)
    z = torch.zeros((len(gens),), dtype=torch.float32,
                    device=model32.device)
    return DFWalkerState(
        fields=fields, G=G_df.hi, G_df=G_df, stack=stack,
        log_det_M=log_det, gens=list(gens), acc_sum=z,
        sign=torch.ones_like(z), err_max=z.clone(), err_sum=z.clone(),
        err_count=z.clone())


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def df_sweep(model32, aux: DFModelAux, cfg: EngineConfig,
             states: DFWalkerState, *, forward: bool = True,
             update: bool = True, streams=None) -> DFWalkerState:
    """One walker-batched sweep: float32 wraps and site updates, df
    stabilization at block ends (the block schedule of engine/sweep.py;
    a ragged last block runs last forward and first backward).
    ``streams = (orders, props, us)``, each (W, nt, ns), replaces the draw
    from the walker generators."""
    if model32.checkerboard:
        raise NotImplementedError(CHECKERBOARD_DF32)
    W = states.G.shape[0]
    nfl, ns, dev = model32.n_flavor, model32.n_sites, model32.device
    if update:
        if streams is None:
            streams = draw_sweep_streams(states.gens, cfg.nt, ns,
                                         model32.dtype)
        orders, props, us = (torch.as_tensor(x).to(dev) for x in streams)
        update_fn = site_update_fn(model32, cfg)
    eyeB = _eye_df(W, nfl, ns, dev)
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    blocks = [(i, i * n_stab, n_stab) for i in range(n_full)]
    tail = (n_full, n_full * n_stab, rem) if rem else None
    if forward:
        seq = blocks + ([tail] if tail else [])
    else:
        seq = ([tail] if tail else []) + blocks[::-1]

    fields = states.fields.clone()
    G, G_df, log_det = states.G, states.G_df, states.log_det_M
    F_prev = identity_slot_df(W, nfl, ns, dev)
    acc, sgn = states.acc_sum, states.sign
    emax, esum, ecnt = states.err_max, states.err_sum, states.err_count
    slots, tail_slot = [], None
    for blk in seq:
        i_stack, l0, n = blk
        Bbar = eyeB
        for step in range(n):
            l = l0 + (step if forward else n - 1 - step)
            f = fields[:, l]
            if forward:
                G = apply_invB_right(model32, f, apply_B_left(model32, f, G))
            if update:
                G, f, acc_l, sgn_l = update_fn(G, f, orders[:, l],
                                               props[:, l], us[:, l])
                fields[:, l] = f
                acc = acc + acc_l / cfg.nt
                sgn = sgn * sgn_l
            B_df = _slice_B_df(aux, f)
            if forward:
                Bbar = df32.matmul(B_df, Bbar)
            else:
                G = apply_B_right(model32, f, apply_invB_left(model32, f, G))
                Bbar = df32.matmul(Bbar, B_df)
        if forward:
            F_prev = mat_mul_ldr(Bbar, F_prev)
            G_df, log_det = inv_one_plus_ldr_dag(
                F_prev, slot_get_df(states.stack, i_stack + 2))
        else:
            F_prev = mat_mul_ldr(transpose(Bbar), F_prev)
            G_df, log_det = inv_one_plus_ldr_dag(
                slot_get_df(states.stack, i_stack), F_prev)
        err = torch.amax(torch.abs(G - G_df.hi), dim=(1, 2, 3))
        G = G_df.hi
        emax = torch.maximum(emax, err)
        esum = esum + err
        ecnt = ecnt + 1.0
        if blk is tail:
            tail_slot = F_prev
        else:
            slots.append(F_prev)
    stack = stack_from_slots_df(slots, identity_slot_df(W, nfl, ns, dev),
                                tail_slot, reverse=not forward)
    return dataclasses.replace(
        states, fields=fields, G=G, G_df=G_df, stack=stack,
        log_det_M=log_det, acc_sum=acc, sign=sgn, err_max=emax,
        err_sum=esum, err_count=ecnt)


def df_sweep_pair(model32, aux: DFModelAux, cfg: EngineConfig,
                  states: DFWalkerState, streams=None) -> DFWalkerState:
    """Forward then backward sweep (main.cpp:156-157); ``streams`` is None
    or a pair (forward streams, backward streams)."""
    fwd, bwd = streams if streams is not None else (None, None)
    states = df_sweep(model32, aux, cfg, states, forward=True, streams=fwd)
    return df_sweep(model32, aux, cfg, states, forward=False, streams=bwd)


def f32_view(states: DFWalkerState):
    """The float32 ``WalkerState`` of df walkers: the hi words of the
    stack's L and R, and the exponent-split scale ladder linearized under
    the float32 log clamp (e^+-60, ``ops/linalg._log_clamp``; beyond it the
    view saturates either way).  The float32 unequal-time sweep runs on it:
    its triplets start from df-accurate factors, so the tau data carries
    float32 reconstruction noise but none of a float32 chain's drift."""
    from dqmc_tpu_torch.engine.state import WalkerState
    from dqmc_tpu_torch.ops.linalg import LDR
    dm = states.stack.d.hi
    log_d = (torch.log(torch.where(dm == 0, torch.ones_like(dm), dm))
             + 0.6931471805599453 * states.stack.e.float())
    d32 = torch.where(dm == 0, torch.zeros_like(dm),
                      torch.exp(torch.clamp(log_d, -60.0, 60.0)))
    return WalkerState(
        fields=states.fields, G=states.G,
        stack=LDR(states.stack.L.hi, d32, states.stack.R.hi),
        log_det_M=states.log_det_M, gens=states.gens,
        acc_sum=states.acc_sum, sign=states.sign, err_max=states.err_max,
        err_sum=states.err_sum, err_count=states.err_count)
