"""The multiword measurement tier: Green's functions rebuilt from the
fields at df32 or tf32 grade.

PyTorch counterpart of ``dqmc_tpu/engine/parity.py``'s single-model tiers,
walker-batched.  :func:`measurement_greens_fn` returns ``greens_fn(states)
-> G (W, nfl, ns, ns)`` in float64: each walker's G(0, 0) = [I + B(beta,
0)]^{-1} is folded from its fields through the multiword LDR chain
(``ops/df_linalg``; every fold's QR runs panel kernel #7 or #8 on CUDA),
independent of the sampling engine's precision, and half-warped in
multiword when ``symmetric``.  :func:`measurement_uneq_fn` is its
tau-resolved twin: the triplet (Gtt, Gt0, G0t)(tau) rebuilt from the
fields at the same grade, emitted per tau in float64, with the tier's G00
as the equal-time G.  The model passed is the float64 build (its expK at
full precision).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dqmc_tpu_torch import hsfield
from dqmc_tpu_torch.engine.state import EngineConfig
from dqmc_tpu_torch.engine.uneqtime import tree_map
from dqmc_tpu_torch.ops import df32, df_linalg, tf32


def _expv_table_f64(model, sign: float = 1.0) -> np.ndarray:
    """exp(sign g eta(s)) for the 4 field states, float64 (4,): +1 for the
    attractive model's flavor and the repulsive up flavor, -1 for down."""
    g = float(model.g.double().cpu())
    return np.exp(sign * g * np.asarray(hsfield.ETA, np.float64))


def _flavor_signs(model):
    return (1.0,) if model.n_flavor == 1 else (1.0, -1.0)


def _expv(model, fields_l: torch.Tensor, nm, sign: float, invert: bool):
    """Multiword exp(sign g eta(s_l)) (its reciprocal with ``invert``) for
    fields (..., ns), the field values selected by a chain over the 4
    states."""
    tbl = _expv_table_f64(model, sign)
    tbl = nm.from_f64(torch.as_tensor(1.0 / tbl if invert else tbl,
                                      device=fields_l.device))

    def sel(comp):
        out = torch.zeros(fields_l.shape, dtype=torch.float32,
                          device=fields_l.device)
        for v in range(4):
            out = torch.where(fields_l == v, comp[v], out)
        return out

    return nm.cmap(sel, tbl)


def _slice_B(model, expK, fields_l: torch.Tensor, nm, sign: float = 1.0):
    """Multiword B_l = diag(expV(s_l)) @ expK for fields (..., ns), a full
    multiword multiply (a row scaling)."""
    ev = _expv(model, fields_l, nm, sign, invert=False)
    return nm.mul(expK, nm.cmap(lambda c: c[..., :, None], ev))


def _slice_invB(model, invexpK, fields_l: torch.Tensor, nm,
                sign: float = 1.0):
    """Multiword B_l^{-1} = invexpK @ diag(1/expV(s_l)) (a column
    scaling)."""
    ev = _expv(model, fields_l, nm, sign, invert=True)
    return nm.mul(invexpK, nm.cmap(lambda c: c[..., None, :], ev))


def _check_model(model):
    if model.n_flavor not in (1, 2):
        raise NotImplementedError(
            "parity rebuild: 1- or 2-flavor models only")
    if model.expK.dtype != torch.float64:
        raise ValueError("parity rebuild needs the float64-built model "
                         "(expK at full precision); build it with "
                         "dtype=torch.float64")


def _identity_ldr(batch: tuple, ns: int, nm, device):
    eye = nm.df(torch.eye(ns, dtype=torch.float32, device=device).expand(
        batch + (ns, ns)))
    ones = nm.df(torch.ones(batch + (ns,), dtype=torch.float32,
                            device=device))
    return df_linalg.LDRdf(eye, ones, eye,
                           torch.zeros(batch + (ns,), dtype=torch.int32,
                                       device=device))


def _eye_ldr(batch: tuple, ns: int, nm, device):
    """to_ldr of the identity (the same for every walker), expanded to
    the batch: the prefix side of G(0, 0) = [I + B(beta, 0)]^{-1}."""
    F = df_linalg.to_ldr(nm.df(torch.eye(ns, dtype=torch.float32,
                                          device=device)), nm=nm)
    bat = lambda c: c.expand(batch + c.shape)  # noqa: E731
    return df_linalg.LDRdf(nm.cmap(bat, F.L), nm.cmap(bat, F.d),
                           nm.cmap(bat, F.R), bat(F.e))


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

    F2t = (_identity_ldr((W,), ns, nm, dev) if nt % cfg.n_stab == 0
           else None)
    for i_stack in range(cfg.n_stack - 1, -1, -1):
        l0 = i_stack * cfg.n_stab
        BbarT = df_linalg.transpose(
            block_product(l0, min(l0 + cfg.n_stab, nt)))
        F2t = (df_linalg.to_ldr(BbarT, nm=nm) if F2t is None
               else df_linalg.mat_mul_ldr(BbarT, F2t, nm=nm))
    return df_linalg.inv_one_plus_ldr_dag(_eye_ldr((W,), ns, nm, dev), F2t,
                                          nm=nm)


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


# ----------------------------------------------------------------------
# the tau-resolved tier
# ----------------------------------------------------------------------

# boundaries per batched triplet factorization and blocks per propagation
# group: the full batch's carries at the tf32 headline are GBs each (the
# JAX package's chunk and group sizes, parity.py:244-257)
_TRIPLET_CHUNK = 4
_BLOCK_GROUP = 8


def _divisor_stride(nt: int, want: int) -> int:
    """The largest stride <= want that divides nt (the block-batched
    sweep needs exact blocking)."""
    s = max(1, min(want, nt))
    while nt % s:
        s -= 1
    return s


def _stack_ldr(Fs, dim: int):
    """LDRdf factors stacked along a new axis ``dim``."""
    leaves = [list(F.L) + list(F.d) + list(F.R) + [F.e] for F in Fs]
    out = [torch.stack(xs, dim=dim) for xs in zip(*leaves)]
    k = len(Fs[0].L)
    mw = type(Fs[0].L)
    return df_linalg.LDRdf(mw(*out[:k]), mw(*out[k:2 * k]),
                           mw(*out[2 * k:3 * k]), out[-1])


def measurement_uneq_fn(model64, cfg: EngineConfig, nm, measure_fn, *,
                        symmetric: bool = False, n_stab: int | None = None,
                        emit_greens: bool = False):
    """``uneq_step(states) -> (ys, err)`` (with ``emit_greens``, ``(ys,
    err, G)``): the tau-resolved triplet rebuilt from each walker's fields
    at nm grade, the tier twin of ``engine/uneqtime.sweep_unequal_time``
    (dqmc.cpp:458-514), in the JAX package's block-batched formulation.

    - A multiword suffix chain B(beta, k n_stab)^T is folded once, keeping
      each block's product; G00 = [I + B(beta, 0)]^{-1} comes from its
      last factor, and the prefix chain B(k n_stab, 0) folds the same
      block products.
    - One ``df_linalg.inv_triplet_dag`` per chunk of _TRIPLET_CHUNK
      boundaries gives the stabilized triplet at every block end.
    - Each group of _BLOCK_GROUP blocks then propagates from its
      boundaries' triplets for n_stab steps at once (B [Gtt, Gt0] and
      [Gtt, G0t] B^{-1} in multiword), emitting the taus inside the
      blocks; the block ends emit the stabilized triplets, and ``err``
      (W,) is the largest deviation of a propagated block end from its
      stabilized triplet (the check_error analogue, dqmc.cpp:500-511).

    ``measure_fn(Gtt, Gt0, G0t, G00)`` gets float64 (W, k, nfl, ns, ns)
    views, half-warped in multiword when ``symmetric``, and G00 (W, 1,
    nfl, ns, ns); ys stacks its outputs over tau = 0..nt at dim 1.  With
    ``emit_greens`` G is the tier's (warped) G00 (W, nfl, ns, ns) float64,
    which serves as the equal-time measurement's G.

    The stride: ``n_stab`` when given, else the engine's, for df32 capped
    at 0.4 / dtau (the within-block propagation is naive, so the tier's
    floor grows as cond(B_block)^2), then the largest divisor of nt not
    above it."""
    _check_model(model64)
    ns, nt = model64.n_sites, cfg.nt
    if n_stab is None or n_stab <= 0:
        n_stab = cfg.n_stab
        if nm is df32:
            dtau = float(model64.beta) / nt
            n_stab = max(1, min(n_stab, int(0.4 / dtau)))
    n_stab = _divisor_stride(nt, n_stab)
    n_stack = nt // n_stab
    signs = _flavor_signs(model64)
    nfl = len(signs)
    expK = nm.from_f64(model64.expK)
    invexpK = nm.from_f64(model64.invexpK)
    left = nm.from_f64(model64.invexpK_half)
    right = nm.from_f64(model64.expK_half)

    def warp(G):
        # engine/sweep.half_warp's convention: invexpK_half G expK_half
        return nm.matmul(nm.matmul(left, G), right) if symmetric else G

    def B_all(f):
        """(..., nfl, ns, ns) multiword B_l for fields (..., ns)."""
        Bs = [_slice_B(model64, expK, f, nm, s) for s in signs]
        return nm.cmap(lambda *cs: torch.stack(cs, dim=-3), *Bs)

    def invB_all(f):
        Bs = [_slice_invB(model64, invexpK, f, nm, s) for s in signs]
        return nm.cmap(lambda *cs: torch.stack(cs, dim=-3), *Bs)

    def uneq_step(states):
        fields = states.fields
        W, dev = fields.shape[0], fields.device
        blocks = fields[:, :nt].reshape(W, n_stack, n_stab, ns)
        eye32 = torch.eye(ns, dtype=torch.float32, device=dev)
        eyeB = nm.df(eye32.expand(W, nfl, ns, ns))

        # the suffix chain, latest block first: bounds[k] holds
        # B(beta, (k+1) n_stab)^T (identity for the last block)
        F = _identity_ldr((W, nfl), ns, nm, dev)
        bounds, Bbars = [None] * n_stack, [None] * n_stack
        for k in range(n_stack - 1, -1, -1):
            Bbar = eyeB
            for i in range(n_stab):
                Bbar = nm.matmul(B_all(blocks[:, k, i]), Bbar)
            bounds[k], Bbars[k] = F, Bbar
            F = df_linalg.mat_mul_ldr(df_linalg.transpose(Bbar), F, nm=nm)
        G00, _ = df_linalg.inv_one_plus_ldr_dag(
            _eye_ldr((W, nfl), ns, nm, dev), F, nm=nm)
        G00_64 = nm.to_f64(warp(G00))

        def emit(Gtt, Gt0, G0t):
            return measure_fn(*(nm.to_f64(warp(G)) for G in (Gtt, Gt0, G0t)),
                              G00_64[:, None])

        # the prefix chain: prefixes[k] holds B((k+1) n_stab, 0)
        prefixes, F1 = [], _identity_ldr((W, nfl), ns, nm, dev)
        for Bbar in Bbars:
            F1 = df_linalg.mat_mul_ldr(Bbar, F1, nm=nm)
            prefixes.append(F1)

        t0 = (G00, G00, nm.sub(G00, eyeB))
        lift = lambda G: nm.cmap(lambda c: c[:, None], G)  # noqa: E731
        ys = [emit(*(lift(G) for G in t0))]               # tau = 0
        err = torch.zeros(W, dtype=torch.float64, device=dev)
        anchor = tuple(lift(G) for G in t0)
        for g0 in range(0, n_stack, _BLOCK_GROUP):
            ks = range(g0, min(g0 + _BLOCK_GROUP, n_stack))
            # the stabilized triplets at the group's block ends
            parts = []
            for c0 in range(ks.start, ks.stop, _TRIPLET_CHUNK):
                cs = range(c0, min(c0 + _TRIPLET_CHUNK, ks.stop))
                parts.append(df_linalg.inv_triplet_dag(
                    _stack_ldr([prefixes[k] for k in cs], 1),
                    _stack_ldr([bounds[k] for k in cs], 1), nm=nm)[:3])
            stab = tuple(nm.cmap(lambda *c: torch.cat(c, dim=1),
                                 *(p[j] for p in parts)) for j in range(3))
            # each block propagates from the triplet at its start
            Gtt, Gt0, G0t = (nm.cmap(lambda a, b: torch.cat(
                [a, b[:, :-1]], dim=1), an, st)
                for an, st in zip(anchor, stab))
            anchor = tuple(nm.cmap(lambda c: c[:, -1:], st) for st in stab)
            outs = []
            for i in range(n_stab):
                f = blocks[:, ks.start:ks.stop, i]
                B, invB = B_all(f), invB_all(f)
                Gtt = nm.matmul(nm.matmul(B, Gtt), invB)
                Gt0 = nm.matmul(B, Gt0)
                G0t = nm.matmul(G0t, invB)
                if i < n_stab - 1:
                    outs.append(emit(Gtt, Gt0, G0t))
            for a, b in zip((Gtt, Gt0, G0t), stab):
                err = torch.maximum(err, torch.amax(torch.abs(
                    nm.to_f64(a) - nm.to_f64(b)), dim=(1, 2, 3, 4)))
            # tau order: per block the propagated taus, then its end
            outs.append(emit(*stab))
            ys.append(tree_map(
                lambda *o: torch.stack(o, dim=2).flatten(1, 2), *outs))
        ys = tree_map(lambda *y: torch.cat(y, dim=1), *ys)
        if emit_greens:
            return ys, err, G00_64
        return ys, err

    uneq_step.n_stab = n_stab
    return uneq_step
