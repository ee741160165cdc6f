"""The unequal-time Green's-function sweep (dqmc.cpp:458-514, 223-280).

PyTorch counterpart of ``dqmc_tpu/engine/uneqtime.py``, walker-batched.
With the HS fields frozen (the sweep runs after each measured sweep pair,
main.cpp:156-158), the triplet

    Gtt(tau) = G(tau, tau),   Gt0(tau) = G(tau, 0),   G0t(tau) = G(0, tau)

is propagated forward through every slice and restabilized at each block
end from the LDR pair (B(tau, 0), B(beta, tau)) through the shared
factorization ``ops/linalg.inv_triplet_dag``:

    Gtt = [I + Bt0 Bbt]^-1,  Gt0 = [Bt0^-1 + Bbt]^-1,  G0t = -[Bbt^-1 + Bt0]^-1

It takes the stack a backward sweep (or a rebuild) leaves: suffix products
B(beta, tau) in transpose form, identity-padded, so the tau = beta endpoint
and a ragged last block (nt % n_stab != 0, whose slot i_stack + 2 is the
padding) need no special case.  Each slice runs two stacked B applications
(B [Gtt, Gt0, Bbar] on the left, [B Gtt, G0t] B^-1 on the right); the
products stay ``torch.matmul``, as the JAX package leaves them to XLA.

The measurement emit runs once per block, batched over the block's slices:
``measure_fn(Gtt, Gt0, G0t, G00)`` gets (W, k, nfl, ns, ns) stacks and G00
(W, 1, nfl, ns, ns), and returns a dict of (W, k, ...) arrays.  Without a
``measure_fn`` the sweep returns the full ``TauGreens`` stack, which is
3 (nt + 1) W nfl ns^2 words (tests only); ``iter_unequal_time`` streams the
same chain chunk by chunk to the host instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
from dqmc_tpu_torch.engine.sweep import half_warp, identity_slot, slot_get
from dqmc_tpu_torch.models.kinetic import apply_B_left, apply_invB_right
from dqmc_tpu_torch.ops.linalg import inv_triplet_dag, mat_mul_ldr


class TauGreens(NamedTuple):
    """Per-tau Green's functions, each (W, n_tau, nfl, ns, ns)."""

    Gtt: torch.Tensor
    Gt0: torch.Tensor
    G0t: torch.Tensor


def _emit_fn(model, measure_fn: Optional[Callable], warp: bool):
    """The per-block emit and the G00 it is handed: ``warp`` half-warps
    the triplet per call and G00 once (the reference warps Gtt and
    Gt0/G0t per tau, dqmc.cpp:300-312)."""
    base = measure_fn or (lambda a, b, c, g00: TauGreens(a, b, c))
    if not warp:
        return base, lambda G: G
    return (lambda a, b, c, g00: base(*(half_warp(model, x)
                                        for x in (a, b, c)), g00),
            lambda G: half_warp(model, G))


def tree_map(fn, *trees):
    """fn over the leaves of emits: dicts of tensors or ``TauGreens``."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return type(trees[0])(*(fn(*xs) for xs in zip(*trees)))


def _cat_tau(parts):
    """Concatenate emits along their tau axis (dim 1)."""
    return tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)


def _tau_steps(model, cfg: EngineConfig, states: WalkerState):
    """The chain for tau = 1..nt: yields (Gtt, Gt0, G0t, err) after each
    slice, err the per-walker (W,) max deviation of the propagated triplet
    from the restabilized one at a block end and None inside a block."""
    W, nfl, ns = states.G.shape[0], model.n_flavor, model.n_sites
    dtype, dev = model.dtype, model.device
    eye = torch.eye(ns, dtype=dtype, device=dev).expand(W, nfl, ns, ns)
    G00 = states.G
    Gtt, Gt0, G0t, Bbar = G00, G00, G00 - eye, eye
    Bt0 = identity_slot(nfl, ns, dtype, dev, (W,))
    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    blocks = [(i, n_stab) for i in range(n_full)] + (
        [(n_full, rem)] if rem else [])
    for i_stack, n in blocks:
        for k in range(n):
            f = states.fields[:, i_stack * n_stab + k, None]
            BL = apply_B_left(model, f, torch.stack([Gtt, Gt0, Bbar], dim=1))
            BR = apply_invB_right(model, f, torch.stack([BL[:, 0], G0t],
                                                        dim=1))
            Gtt, Gt0, G0t, Bbar = BR[:, 0], BL[:, 1], BR[:, 1], BL[:, 2]
            if k < n - 1:
                yield Gtt, Gt0, G0t, None
                continue
            Bt0 = mat_mul_ldr(Bbar, Bt0)
            Gtt_s, Gt0_s, G0t_s, _ = inv_triplet_dag(
                Bt0, slot_get(states.stack, i_stack + 2))
            err = torch.stack([torch.amax(torch.abs(a - b), dim=(1, 2, 3))
                               for a, b in ((Gtt, Gtt_s), (Gt0, Gt0_s),
                                            (G0t, G0t_s))]).amax(0)
            Gtt, Gt0, G0t, Bbar = Gtt_s, Gt0_s, G0t_s, eye
            yield Gtt, Gt0, G0t, err


def sweep_unequal_time(model, cfg: EngineConfig, states: WalkerState,
                       measure_fn: Optional[Callable] = None,
                       warp: bool = False):
    """(ys, err_max) for tau = 0..nt: ys the stacked emits, (W, nt+1, ...)
    per observable (``TauGreens`` when ``measure_fn`` is None), err_max
    (W,) the largest block-end self-check deviation.

    Call it right after a backward sweep: the stack then holds the suffix
    products and states.G is G(0, 0).  ``warp=True`` half-warps what the
    emit sees; the propagation runs on the unwarped functions."""
    emit, warp_fn = _emit_fn(model, measure_fn, warp)
    G00 = states.G[:, None]
    G00m = warp_fn(G00)
    eye = torch.eye(model.n_sites, dtype=model.dtype, device=model.device)
    ys = [emit(G00, G00, G00 - eye, G00m)]        # tau = 0 (dqmc.cpp:235)
    err_max = torch.zeros(states.G.shape[0], dtype=model.dtype,
                          device=model.device)
    block = []
    for Gtt, Gt0, G0t, err in _tau_steps(model, cfg, states):
        block.append((Gtt, Gt0, G0t))
        if err is not None:
            ys.append(emit(*(torch.stack(x, dim=1) for x in zip(*block)),
                           G00m))
            err_max = torch.maximum(err_max, err)
            block = []
    return _cat_tau(ys), err_max


def iter_unequal_time(model, cfg: EngineConfig, states: WalkerState,
                      tau_chunk: int = 16, warp: bool = False):
    """Stream the tau-resolved Green's functions in bounded device memory:
    the chain of ``sweep_unequal_time`` yields ``(tau_start, TauGreens)``
    chunks of ``tau_chunk`` slices on the host (CPU tensors), tau = 0
    included in the first, so chunk c covers tau = [c == 0 ? 0 :
    c tau_chunk + 1 .. min((c + 1) tau_chunk, nt)].  The chunks concatenate
    to the unchunked stack."""
    emit, _ = _emit_fn(model, None, warp)
    G00 = states.G[:, None]
    eye = torch.eye(model.n_sites, dtype=model.dtype, device=model.device)
    parts = [emit(G00, G00, G00 - eye, G00)]
    start = 0
    for step, (Gtt, Gt0, G0t, _) in enumerate(_tau_steps(model, cfg,
                                                          states)):
        parts.append(emit(Gtt[:, None], Gt0[:, None], G0t[:, None], G00))
        if step + 1 == cfg.nt or (step + 1) % tau_chunk == 0:
            chunk = _cat_tau(parts)
            yield start, TauGreens(*(x.cpu() for x in chunk))
            start, parts = step + 1, []
