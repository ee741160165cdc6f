"""Site-update kernels of the per-slice engine: wrappers and plain twins.

PyTorch counterpart of ``dqmc_tpu/ops/kernels.py``.  One time slice of the
sequential Metropolis site loop, walker-batched, in three schemes:

- #6 ``metropolis_slice_update``: rank-1 Sherman-Morrison per accepted
  visit (``csrc/site_update.cu`` rank1_sites_kernel);
- #3 ``metropolis_slice_update_batched``: delayed rank-k updates, the
  pending terms flushed as G += U^T V every k visits
  (``csrc/site_update.cu`` delayed_sites_kernel and the rank-k flush);
- #5 ``metropolis_slice_update_submatrix``: the k decisions of a block on
  the k x k submatrix G[I, I] through a bordered Woodbury inverse W, then
  G += G[:, I] W (G[I, :] - E_I) (``csrc/submatrix_update.cu``).

Each wrapper takes per-walker coupling vectors (g, alpha) (W,), so one call
can batch walkers of different models (parallel-tempering replicas), and
explicit random streams: the visit order, shared (ns,) or per walker
(W, ns), and the proposal draws and uniforms (W, ns), both indexed by
visit.  It returns (G, fields, acceptance fraction (W,)).

The field-dependent factors of every visit are computed before the loop
(:func:`visit_factors`): each site is visited once per slice, so its
pre-update field is the slice-start field.  The loop returns one accept
flag per visit, from which the new fields follow.  On a CUDA tensor the
loop launches the kernels (and raises on a shape or rank they do not
take); on a CPU tensor it runs the plain twin, the same arithmetic in
torch ops.  ``plain=True`` runs the twin on any device (the on-card
reference of ``chip_smoke.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from dqmc_tpu_torch import _cuda, hsfield

KMAX = 32         # largest block rank the CUDA kernels take
MAX_SITES = 1024  # largest ns of the delayed-sites and rank-1 kernels


def pick_rank(ns: int, k: int = 32) -> int:
    """JAX's block rank for the shared-order kernels (kernels.py:382-383,
    747-748): k when it divides ns, else the largest of 16/8/4/2/1 that
    does (ns = 36 -> 4)."""
    if ns % k == 0:
        return k
    return next(c for c in (16, 8, 4, 2, 1) if ns % c == 0)


def visit_factors(g, alpha, fields, sites, props, dtype):
    """Per-visit Metropolis factors from the slice-start fields (W, ns),
    the visited sites (W, ns) and the proposal draws (W, ns): the proposed
    state, gb = gamma ratio * boson ratio, and delta = exp(g d_eta) - 1,
    each (W, ns)."""
    eta = torch.as_tensor(hsfield.ETA, dtype=dtype, device=fields.device)
    gamma = torch.as_tensor(hsfield.GAMMA, dtype=dtype, device=fields.device)
    old = torch.gather(fields, 1, sites)
    new = hsfield.new_state(old, props.to(old.dtype))
    d_eta = eta[new] - eta[old]
    g, alpha = g.to(dtype)[:, None], alpha.to(dtype)[:, None]
    gb = (gamma[new] / gamma[old]) * torch.exp(alpha * g * d_eta)
    return new, gb, torch.expm1(g * d_eta)


# ----------------------------------------------------------------------
# the kernels' plain twins, piece by piece, on G (W, n, n) in place.
# ``order`` is int32, (n,) shared or (W, n) per walker; accept flags go to
# ``acc`` (W, n) as 0/1 in G's dtype, one per visit.
# ----------------------------------------------------------------------

def _sites(order, W):
    return order.long().expand(W, order.shape[-1])


def rank1_slice_plain(G, acc, order, gb, delta, us):
    """#6: a whole slice; G += (prefac G[:, i]) (G[i, :] - e_i) per
    accepted visit."""
    W, n, _ = G.shape
    ar = torch.arange(W, device=G.device)
    sites = _sites(order, W)
    for idx in range(n):
        i = sites[:, idx]
        d = delta[:, idx]
        rf = 1.0 + (1.0 - G[ar, i, i]) * d
        ok = us[:, idx] < gb[:, idx] * rf * rf
        prefac = torch.where(ok, d / rf, torch.zeros_like(d))
        col = prefac[:, None] * G[ar, :, i]
        row = G[ar, i, :].clone()
        row[ar, i] -= 1.0
        G += col[:, :, None] * row[:, None, :]
        acc[:, idx] = ok.to(G.dtype)


def delayed_block_plain(G, U, V, acc, order, gb, delta, us, v0, cnt):
    """#3: visits v0..v0+cnt-1 (cnt <= k); each forms G's effective row
    and column under the pending slots 0..t-1 of U, V (W, k, n) and writes
    slot t.  G itself is only read."""
    W, n, _ = G.shape
    ar = torch.arange(W, device=G.device)
    sites = _sites(order, W)
    for t in range(cnt):
        idx = v0 + t
        i = sites[:, idx]
        row = G[ar, i, :] + torch.einsum("ws,wsn->wn", U[ar, :t, i],
                                         V[:, :t])
        col = G[ar, :, i] + torch.einsum("ws,wsn->wn", V[ar, :t, i],
                                         U[:, :t])
        d = delta[:, idx]
        rf = 1.0 + (1.0 - row[ar, i]) * d
        ok = us[:, idx] < gb[:, idx] * rf * rf
        prefac = torch.where(ok, d / rf, torch.zeros_like(d))
        U[:, t] = prefac[:, None] * col
        V[:, t] = row
        V[ar, t, i] -= 1.0
        acc[:, idx] = ok.to(G.dtype)


def rank_k_flush_plain(G, U, V, cnt):
    """G += U[:, :cnt]^T V[:, :cnt] (the #3 and #5 flushes)."""
    G += torch.einsum("wsa,wsb->wab", U[:, :cnt], V[:, :cnt])


def submatrix_decide_plain(G, Wm, acc, order, gb, delta, us, v0, cnt):
    """#5: the cnt decisions of a block on G[I, I] through the bordered
    inverse; writes W (W, k, k)[:cnt, :cnt].  G is only read."""
    W = G.shape[0]
    I = _sites(order, W)[:, v0:v0 + cnt]
    GII = G[torch.arange(W, device=G.device)[:, None, None], I[:, :, None],
            I[:, None, :]]
    Wb = torch.zeros((W, cnt, cnt), dtype=G.dtype, device=G.device)
    mask = torch.zeros((W, cnt), dtype=G.dtype, device=G.device)
    for t in range(cnt):
        idx = v0 + t
        b = -GII[:, t, :] * mask
        c = -GII[:, :, t] * mask
        Wc = torch.einsum("wpq,wq->wp", Wb, c)
        bW = torch.einsum("wp,wpq->wq", b, Wb)
        bWc = torch.sum(b * Wc, dim=1)
        d = delta[:, idx]
        rf = 1.0 + d * (1.0 - GII[:, t, t]) - d * bWc
        ok = us[:, idx] < gb[:, idx] * rf * rf
        inv_s = torch.where(ok, d / rf, torch.zeros_like(d))
        Wb = Wb + inv_s[:, None, None] * Wc[:, :, None] * bW[:, None, :]
        keep = ok[:, None]
        Wb[:, t, :] = torch.where(keep, -inv_s[:, None] * bW, Wb[:, t, :])
        Wb[:, :, t] = torch.where(keep, -inv_s[:, None] * Wc, Wb[:, :, t])
        Wb[:, t, t] = torch.where(ok, inv_s, Wb[:, t, t])
        mask[:, t] = torch.where(ok, torch.ones_like(d), mask[:, t])
        acc[:, idx] = ok.to(G.dtype)
    Wm[:, :cnt, :cnt] = Wb


def submatrix_prep_plain(G, Wm, Ut, M, order, v0, cnt):
    """#5: the flush operands Ut = G[:, I]^T and M = W (G[I, :] - E_I)."""
    W, n, _ = G.shape
    I = _sites(order, W)[:, v0:v0 + cnt]
    rows = torch.gather(G, 1, I[:, :, None].expand(W, cnt, n))
    Ut[:, :cnt] = torch.gather(G, 2, I[:, None, :].expand(W, n, cnt)).mT
    E = torch.nn.functional.one_hot(I, n).to(G.dtype)
    M[:, :cnt] = Wm[:, :cnt, :cnt] @ (rows - E)


PLAIN = SimpleNamespace(rank1=rank1_slice_plain,
                        delayed_block=delayed_block_plain,
                        delayed_flush=rank_k_flush_plain,
                        submatrix_decide=submatrix_decide_plain,
                        submatrix_prep=submatrix_prep_plain,
                        submatrix_flush=rank_k_flush_plain)


# ----------------------------------------------------------------------
# the CUDA kernels, one launch per call, the same contract as the twins.
# The wrappers below check the slice's tensors once; these launchers only
# count.
# ----------------------------------------------------------------------

def _launch(name, G, *args):
    fn = getattr(_cuda.lib(), "dqmc_" + name + _cuda.suffix(G.dtype))
    _cuda.call(fn, *args, _cuda.stream(G.device))
    _cuda.count(name)


def _stride(order):
    return 0 if order.dim() == 1 else order.shape[-1]


def rank1_slice_cuda(G, acc, order, gb, delta, us):
    W, n, _ = G.shape
    P = _cuda.ptr
    _launch("rank1_sites", G, P(G), P(acc), P(order), _stride(order), P(gb),
            P(delta), P(us), n, W)


def delayed_block_cuda(G, U, V, acc, order, gb, delta, us, v0, cnt):
    W, n, _ = G.shape
    P = _cuda.ptr
    _launch("delayed_sites", G, P(G), P(U), P(V), P(acc), P(order),
            _stride(order), P(gb), P(delta), P(us), U.shape[1] * n, n, v0,
            cnt, W)


def _flush_cuda(name):
    def flush(G, U, V, cnt):
        W, n, _ = G.shape
        P = _cuda.ptr
        _launch(name, G, P(G), P(U), P(V), U.shape[1] * n, n, cnt, W)
    return flush


def submatrix_decide_cuda(G, Wm, acc, order, gb, delta, us, v0, cnt):
    W, n, _ = G.shape
    P = _cuda.ptr
    _launch("submatrix_decide", G, P(G), P(Wm), P(acc), P(order),
            _stride(order), P(gb), P(delta), P(us), n, Wm.shape[1], v0, cnt,
            W)


def submatrix_prep_cuda(G, Wm, Ut, M, order, v0, cnt):
    W, n, _ = G.shape
    P = _cuda.ptr
    _launch("submatrix_prep", G, P(G), P(Wm), P(Ut), P(M), P(order),
            _stride(order), n, Wm.shape[1], v0, cnt, W)


KERNELS = SimpleNamespace(rank1=rank1_slice_cuda,
                          delayed_block=delayed_block_cuda,
                          delayed_flush=_flush_cuda("delayed_flush"),
                          submatrix_decide=submatrix_decide_cuda,
                          submatrix_prep=submatrix_prep_cuda,
                          submatrix_flush=_flush_cuda("submatrix_flush"))


def _roadmap(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (ROADMAP: site-update kernels beyond the 32x32 lattice and "
        f"rank {KMAX})")


def check_cuda_slice(G, order, gb, delta, us, scheme: str, k: int) -> None:
    """Raise unless the CUDA kernels take this slice: shapes and rank in
    range, contiguous CUDA tensors of G's dtype (order int32)."""
    W, n, _ = G.shape
    if scheme != "submatrix" and n > MAX_SITES:
        raise _roadmap(f"{scheme} site update at ns={n}: the kernel takes "
                       f"ns <= {MAX_SITES}")
    if scheme != "rank1" and k > KMAX:
        raise _roadmap(f"{scheme} site update at k={k}: the kernels take "
                       f"k <= {KMAX}")
    dev, dt = G.device, G.dtype
    _cuda.check(G, "G", device=dev, dtype=dt, shape=(W, n, n))
    for name, t in (("gb", gb), ("delta", delta), ("us", us)):
        _cuda.check(t, name, device=dev, dtype=dt, shape=(W, n))
    _cuda.check(order, "order", device=dev, dtype=torch.int32,
                shape=(n,) if order.dim() == 1 else (W, n))


def sites_update(G, order, gb, delta, us, scheme: str, k: int, prims):
    """One slice of ``scheme`` (rank1 / delayed / submatrix) of block rank
    k on G (W, n, n) in place, through ``prims`` (:data:`KERNELS` or
    :data:`PLAIN`); returns the accept flags (W, n) bool, one per visit."""
    W, n, _ = G.shape
    acc = torch.empty((W, n), dtype=G.dtype, device=G.device)
    if scheme == "rank1":
        prims.rank1(G, acc, order, gb, delta, us)
        return acc > 0.5
    new = lambda *shape: torch.empty((W,) + shape, dtype=G.dtype,
                                     device=G.device)
    if scheme == "delayed":
        U, V = new(k, n), new(k, n)
        for v0 in range(0, n, k):
            cnt = min(k, n - v0)
            prims.delayed_block(G, U, V, acc, order, gb, delta, us, v0, cnt)
            prims.delayed_flush(G, U, V, cnt)
        return acc > 0.5
    Wm, Ut, M = new(k, k), new(k, n), new(k, n)
    for v0 in range(0, n, k):
        cnt = min(k, n - v0)
        prims.submatrix_decide(G, Wm, acc, order, gb, delta, us, v0, cnt)
        prims.submatrix_prep(G, Wm, Ut, M, order, v0, cnt)
        prims.submatrix_flush(G, Ut, M, cnt)
    return acc > 0.5


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def _slice_update(scheme, g, alpha, order, props, us, G, fields, k, plain):
    W, nfl, ns, _ = G.shape
    if nfl != 1:
        raise NotImplementedError(
            "site-update kernels: one stored flavor only (ROADMAP: the "
            "repulsive model with #4)")
    dtype, dev = G.dtype, G.device
    order = order.to(device=dev, dtype=torch.int32).contiguous()
    sites = _sites(order, W)
    fields = fields.to(dev)
    new, gb, delta = visit_factors(g, alpha, fields, sites, props.to(dev),
                                   dtype)
    gb, delta = gb.contiguous(), delta.contiguous()
    us = us.to(device=dev, dtype=dtype).contiguous()
    G3 = G[:, 0].clone(memory_format=torch.contiguous_format)
    if plain or dev.type == "cpu":
        accept = sites_update(G3, order, gb, delta, us, scheme, k, PLAIN)
    elif dev.type == "cuda":
        check_cuda_slice(G3, order, gb, delta, us, scheme, k)
        with torch.cuda.device(dev):
            accept = sites_update(G3, order, gb, delta, us, scheme, k,
                                  KERNELS)
    else:
        raise ValueError(f"site update: unsupported device {dev}")
    cur = torch.gather(fields, 1, sites)
    fields = fields.scatter(1, sites, torch.where(accept, new, cur))
    acc = accept.sum(dim=1).to(dtype) / ns
    return G3[:, None], fields, acc


def metropolis_slice_update(g, alpha, order, props, us, G, fields, *,
                            plain: bool = False):
    """#6: one slice of the rank-1 loop.  G (W, 1, ns, ns); fields (W, ns)
    slice-start; order (ns,) or (W, ns); props, us (W, ns) per visit;
    g, alpha (W,).  Returns (G, fields, acc (W,))."""
    return _slice_update("rank1", g, alpha, order, props, us, G, fields, 1,
                         plain)


def metropolis_slice_update_batched(g, alpha, order, props, us, G, fields,
                                    *, k_delay: int = 32,
                                    exact_rank: bool = False,
                                    plain: bool = False):
    """#3: one slice of the delayed rank-k loop; arguments as
    :func:`metropolis_slice_update`.  The rank follows JAX's rule
    (:func:`pick_rank`) unless ``exact_rank``, which keeps ``k_delay`` and
    flushes a short last block (the per-walker-order scheme of
    ``engine/sweep.py``)."""
    ns = G.shape[-1]
    k = k_delay if exact_rank else pick_rank(ns, k_delay)
    return _slice_update("delayed", g, alpha, order, props, us, G, fields,
                         k, plain)


def metropolis_slice_update_submatrix(g, alpha, order, props, us, G, fields,
                                      *, k_sub: int = 32,
                                      exact_rank: bool = False,
                                      plain: bool = False):
    """#5: one slice of the submatrix scheme; arguments and rank as
    :func:`metropolis_slice_update_batched`."""
    ns = G.shape[-1]
    k = k_sub if exact_rank else pick_rank(ns, k_sub)
    return _slice_update("submatrix", g, alpha, order, props, us, G, fields,
                         k, plain)
