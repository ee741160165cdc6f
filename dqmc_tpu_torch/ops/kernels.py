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
  G += G[:, I] W (G[I, :] - E_I) (``csrc/submatrix_update.cu``);
- #4 ``metropolis_slice_update_batched_2f``: the delayed rank-k loop of a
  2-flavor (det_power = 1) model: opposite couplings per flavor, the
  ratio R = gb r_up r_dn taken once per flavor, Metropolis on |R| with the
  sign of every accepted R < 0 multiplied into a per-walker sign
  (``csrc/site_update.cu`` delayed_sites_kernel with two flavors; the
  flush runs over 2 W matrices).  It also returns that sign.

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

The twins are written over a flavor axis: G is (W, n, n) with delta (W, n)
for one flavor, or (W, 2, n, n) with delta (W, 2, n) for two, and the
buffers follow G.  The rank-1 and submatrix schemes of a 2-flavor model
have no kernel (the JAX package runs them outside any Pallas kernel too):
they run these torch ops on any device.
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


def visit_factors(g, alpha, fields, sites, props, dtype, n_flavor: int = 1):
    """Per-visit Metropolis factors from the slice-start fields (W, ns),
    the visited sites (W, ns) and the proposal draws (W, ns): the proposed
    state, gb = gamma ratio * boson ratio, and delta = exp(g d_eta) - 1,
    each (W, ns); with two flavors delta is (W, 2, ns), the second flavor
    seeing the opposite coupling exp(-g d_eta) - 1."""
    eta = torch.as_tensor(hsfield.ETA, dtype=dtype, device=fields.device)
    gamma = torch.as_tensor(hsfield.GAMMA, dtype=dtype, device=fields.device)
    old = torch.gather(fields, 1, sites)
    new = hsfield.new_state(old, props.to(old.dtype))
    d_eta = eta[new] - eta[old]
    g, alpha = g.to(dtype)[:, None], alpha.to(dtype)[:, None]
    gb = (gamma[new] / gamma[old]) * torch.exp(alpha * g * d_eta)
    x = g * d_eta
    if n_flavor == 1:
        return new, gb, torch.expm1(x)
    return new, gb, torch.stack([torch.expm1(x), torch.expm1(-x)], dim=1)


# ----------------------------------------------------------------------
# the kernels' plain twins, piece by piece, on G in place: (W, n, n), or
# (W, F, n, n) with delta (W, F, n) and buffers (W, F, k, ...).  ``order``
# is int32, (n,) shared or (W, n) per walker; accept flags go to ``acc``
# (W, n) as 0/1 in G's dtype, one per visit; ``sgn`` (W,) is multiplied by
# -1 per accepted R < 0 (two flavors only).
# ----------------------------------------------------------------------

def _sites(order, W):
    return order.long().expand(W, order.shape[-1])


def flavor_view(x, ndim):
    """x with a flavor axis after the walker axis (a view)."""
    return x[:, None] if x.dim() == ndim else x


def accept_visit(gb, rf, u, sgn):
    """The Metropolis decision of one visit from the flavor ratios rf
    (W, F).  One stored flavor (det_power 2): R = gb rf^2 >= 0, accept on
    u < R.  Two flavors (det_power 1): R = gb r_up r_dn may be negative;
    accept on u < |R| (u < 1 strictly) and flip ``sgn`` in place where an
    accepted R < 0."""
    if rf.shape[1] == 1:
        return u < gb * rf[:, 0] * rf[:, 0]
    R = gb * rf[:, 0] * rf[:, 1]
    ok = u < R.abs()
    sgn *= torch.where(ok & (R < 0), -1.0, 1.0).to(sgn.dtype)
    return ok


def rank1_slice_plain(G, acc, order, gb, delta, us, sgn=None):
    """#6: a whole slice; G += (prefac G[:, i]) (G[i, :] - e_i) per
    accepted visit."""
    Gf, df = flavor_view(G, 3), flavor_view(delta, 2)
    W, n = Gf.shape[0], Gf.shape[-1]
    ar = torch.arange(W, device=G.device)
    sites = _sites(order, W)
    for idx in range(n):
        i = sites[:, idx]
        d = df[:, :, idx]
        rf = 1.0 + (1.0 - Gf[ar, :, i, i]) * d
        ok = accept_visit(gb[:, idx], rf, us[:, idx], sgn)
        prefac = torch.where(ok[:, None], d / rf, torch.zeros_like(d))
        col = prefac[:, :, None] * Gf[ar, :, :, i]
        row = Gf[ar, :, i, :].clone()
        row[ar, :, i] -= 1.0
        Gf += col[:, :, :, None] * row[:, :, None, :]
        acc[:, idx] = ok.to(G.dtype)


def delayed_block_plain(G, U, V, acc, order, gb, delta, us, v0, cnt,
                        sgn=None):
    """#3 and #4: visits v0..v0+cnt-1 (cnt <= k); each forms G's effective
    row and column under the pending slots 0..t-1 of U, V (W, k, n) and
    writes slot t.  G itself is only read."""
    Gf, Uf, Vf = (flavor_view(x, 3) for x in (G, U, V))
    df = flavor_view(delta, 2)
    W = Gf.shape[0]
    ar = torch.arange(W, device=G.device)
    sites = _sites(order, W)
    for t in range(cnt):
        idx = v0 + t
        i = sites[:, idx]
        row = Gf[ar, :, i, :] + torch.einsum(
            "wfs,wfsn->wfn", Uf[ar, :, :t, i], Vf[:, :, :t])
        col = Gf[ar, :, :, i] + torch.einsum(
            "wfs,wfsn->wfn", Vf[ar, :, :t, i], Uf[:, :, :t])
        d = df[:, :, idx]
        rf = 1.0 + (1.0 - row[ar, :, i]) * d
        ok = accept_visit(gb[:, idx], rf, us[:, idx], sgn)
        prefac = torch.where(ok[:, None], d / rf, torch.zeros_like(d))
        Uf[:, :, t] = prefac[:, :, None] * col
        Vf[:, :, t] = row
        Vf[ar, :, t, i] -= 1.0
        acc[:, idx] = ok.to(G.dtype)


def rank_k_flush_plain(G, U, V, cnt):
    """G += U[:, :cnt]^T V[:, :cnt] (the #3, #4 and #5 flushes)."""
    G += U[..., :cnt, :].mT @ V[..., :cnt, :]


def submatrix_decide_plain(G, Wm, acc, order, gb, delta, us, v0, cnt,
                           sgn=None):
    """#5: the cnt decisions of a block on G[I, I] through the bordered
    inverse (one per flavor); writes W (W, k, k)[:cnt, :cnt].  G is only
    read."""
    Gf, Wf, df = flavor_view(G, 3), flavor_view(Wm, 3), flavor_view(delta, 2)
    W, F = Gf.shape[:2]
    I = _sites(order, W)[:, v0:v0 + cnt]
    GII = Gf[torch.arange(W, device=G.device)[:, None, None, None],
             torch.arange(F, device=G.device)[None, :, None, None],
             I[:, None, :, None], I[:, None, None, :]]
    Wb = torch.zeros((W, F, cnt, cnt), dtype=G.dtype, device=G.device)
    mask = torch.zeros((W, cnt), dtype=G.dtype, device=G.device)
    for t in range(cnt):
        idx = v0 + t
        b = -GII[:, :, t, :] * mask[:, None]
        c = -GII[:, :, :, t] * mask[:, None]
        Wc = torch.einsum("wfpq,wfq->wfp", Wb, c)
        bW = torch.einsum("wfp,wfpq->wfq", b, Wb)
        bWc = torch.sum(b * Wc, dim=-1)
        d = df[:, :, idx]
        rf = 1.0 + d * (1.0 - GII[:, :, t, t]) - d * bWc
        ok = accept_visit(gb[:, idx], rf, us[:, idx], sgn)
        inv_s = torch.where(ok[:, None], d / rf, torch.zeros_like(d))
        Wb = Wb + (inv_s[:, :, None, None] * Wc[:, :, :, None]
                   * bW[:, :, None, :])
        keep = ok[:, None, None]
        Wb[:, :, t, :] = torch.where(keep, -inv_s[:, :, None] * bW,
                                     Wb[:, :, t, :])
        Wb[:, :, :, t] = torch.where(keep, -inv_s[:, :, None] * Wc,
                                     Wb[:, :, :, t])
        Wb[:, :, t, t] = torch.where(ok[:, None], inv_s, Wb[:, :, t, t])
        mask[:, t] = torch.where(ok, torch.ones_like(mask[:, t]), mask[:, t])
        acc[:, idx] = ok.to(G.dtype)
    Wf[:, :, :cnt, :cnt] = Wb


def submatrix_prep_plain(G, Wm, Ut, M, order, v0, cnt):
    """#5: the flush operands Ut = G[:, I]^T and M = W (G[I, :] - E_I)."""
    Gf, Wf, Uf, Mf = (flavor_view(x, 3) for x in (G, Wm, Ut, M))
    W, F, n, _ = Gf.shape
    I = _sites(order, W)[:, v0:v0 + cnt]
    rows = torch.gather(Gf, 2, I[:, None, :, None].expand(W, F, cnt, n))
    Uf[:, :, :cnt] = torch.gather(
        Gf, 3, I[:, None, None, :].expand(W, F, n, cnt)).mT
    E = torch.nn.functional.one_hot(I, n).to(G.dtype)[:, None]
    Mf[:, :, :cnt] = Wf[:, :, :cnt, :cnt] @ (rows - E)


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


def rank1_slice_cuda(G, acc, order, gb, delta, us, sgn=None):
    W, n, _ = G.shape
    P = _cuda.ptr
    _launch("rank1_sites", G, P(G), P(acc), P(order), _stride(order), P(gb),
            P(delta), P(us), n, W)


def delayed_block_cuda(G, U, V, acc, order, gb, delta, us, v0, cnt,
                       sgn=None):
    """#3 on G (W, n, n); #4 on G (W, 2, n, n) with ``sgn``."""
    W, n = G.shape[0], G.shape[-1]
    P = _cuda.ptr
    name = "delayed_sites" if G.dim() == 3 else "delayed_sites_2f"
    _launch(name, G, P(G), P(U), P(V), P(acc), P(sgn), P(order),
            _stride(order), P(gb), P(delta), P(us), U.shape[-2] * n, n, v0,
            cnt, W)


def _flush_cuda(name):
    def flush(G, U, V, cnt):
        # one matrix per walker and flavor: the tiled kernel sees a flat
        # batch
        n = G.shape[-1]
        P = _cuda.ptr
        _launch(name, G, P(G), P(U), P(V), U.shape[-2] * n, n, cnt,
                G.numel() // (n * n))
    return flush


def submatrix_decide_cuda(G, Wm, acc, order, gb, delta, us, v0, cnt,
                          sgn=None):
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
    range, contiguous CUDA tensors of G's dtype (order int32).  G is
    (W, n, n), or (W, 2, n, n) with delta (W, 2, n) for the 2-flavor
    delayed kernel."""
    W, n = G.shape[0], G.shape[-2]
    if scheme != "submatrix" and n > MAX_SITES:
        raise _roadmap(f"{scheme} site update at ns={n}: the kernel takes "
                       f"ns <= {MAX_SITES}")
    if scheme != "rank1" and k > KMAX:
        raise _roadmap(f"{scheme} site update at k={k}: the kernels take "
                       f"k <= {KMAX}")
    flv = tuple(G.shape[1:-2])
    if flv not in ((), (2,)) or (flv and scheme != "delayed"):
        raise NotImplementedError(
            f"{scheme} site update with flavor axes {flv}: one flavor, or "
            f"two for the delayed scheme (#4)")
    dev, dt = G.device, G.dtype
    _cuda.check(G, "G", device=dev, dtype=dt, shape=(W,) + flv + (n, n))
    _cuda.check(delta, "delta", device=dev, dtype=dt, shape=(W,) + flv + (n,))
    for name, t in (("gb", gb), ("us", us)):
        _cuda.check(t, name, device=dev, dtype=dt, shape=(W, n))
    _cuda.check(order, "order", device=dev, dtype=torch.int32,
                shape=(n,) if order.dim() == 1 else (W, n))


def sites_update(G, order, gb, delta, us, scheme: str, k: int, prims,
                 sgn=None):
    """One slice of ``scheme`` (rank1 / delayed / submatrix) of block rank
    k on G (W, n, n) or (W, 2, n, n) in place, through ``prims``
    (:data:`KERNELS` or :data:`PLAIN`); returns the accept flags (W, n)
    bool, one per visit.  ``sgn`` (W,) takes the sign flips of two
    flavors."""
    W, n = G.shape[0], G.shape[-1]
    acc = torch.empty((W, n), dtype=G.dtype, device=G.device)
    if scheme == "rank1":
        prims.rank1(G, acc, order, gb, delta, us, sgn)
        return acc > 0.5
    new = lambda *shape: torch.empty(G.shape[:-2] + shape, dtype=G.dtype,
                                     device=G.device)
    if scheme == "delayed":
        U, V = new(k, n), new(k, n)
        for v0 in range(0, n, k):
            cnt = min(k, n - v0)
            prims.delayed_block(G, U, V, acc, order, gb, delta, us, v0, cnt,
                                sgn)
            prims.delayed_flush(G, U, V, cnt)
        return acc > 0.5
    Wm, Ut, M = new(k, k), new(k, n), new(k, n)
    for v0 in range(0, n, k):
        cnt = min(k, n - v0)
        prims.submatrix_decide(G, Wm, acc, order, gb, delta, us, v0, cnt,
                               sgn)
        prims.submatrix_prep(G, Wm, Ut, M, order, v0, cnt)
        prims.submatrix_flush(G, Ut, M, cnt)
    return acc > 0.5


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def slice_update(scheme, g, alpha, order, props, us, G, fields, k,
                 plain=False):
    """One slice of ``scheme`` (rank1 / delayed / submatrix) at block rank
    k on G (W, nfl, ns, ns), nfl 1 or 2; returns (G, fields, acc, sgn) with
    sgn (W,) the product of the slice's sign flips (ones for one flavor).
    The wrappers below name the kernels; ``engine/sweep.py`` calls this for
    either flavor count."""
    W, nfl, ns, _ = G.shape
    if nfl not in (1, 2):
        raise NotImplementedError(f"site updates: 1 or 2 stored flavors, "
                                  f"not {nfl}")
    dtype, dev = G.dtype, G.device
    order = order.to(device=dev, dtype=torch.int32).contiguous()
    sites = _sites(order, W)
    fields = fields.to(dev)
    new, gb, delta = visit_factors(g, alpha, fields, sites, props.to(dev),
                                   dtype, nfl)
    gb, delta = gb.contiguous(), delta.contiguous()
    us = us.to(device=dev, dtype=dtype).contiguous()
    Gc = (G[:, 0] if nfl == 1 else G).clone(
        memory_format=torch.contiguous_format)
    sgn = torch.ones((W,), dtype=dtype, device=dev)
    # two flavors have a kernel for the delayed scheme only (#4)
    no_kernel = nfl == 2 and scheme != "delayed"
    if plain or no_kernel or dev.type == "cpu":
        accept = sites_update(Gc, order, gb, delta, us, scheme, k, PLAIN,
                              sgn)
    elif dev.type == "cuda":
        check_cuda_slice(Gc, order, gb, delta, us, scheme, k)
        with torch.cuda.device(dev):
            accept = sites_update(Gc, order, gb, delta, us, scheme, k,
                                  KERNELS, sgn)
    else:
        raise ValueError(f"site update: unsupported device {dev}")
    cur = torch.gather(fields, 1, sites)
    fields = fields.scatter(1, sites, torch.where(accept, new, cur))
    acc = accept.sum(dim=1).to(dtype) / ns
    return Gc.reshape(G.shape), fields, acc, sgn


def metropolis_slice_update(g, alpha, order, props, us, G, fields, *,
                            plain: bool = False):
    """#6: one slice of the rank-1 loop.  G (W, 1, ns, ns); fields (W, ns)
    slice-start; order (ns,) or (W, ns); props, us (W, ns) per visit;
    g, alpha (W,).  Returns (G, fields, acc (W,))."""
    return slice_update("rank1", g, alpha, order, props, us, G, fields, 1,
                         plain)[:3]


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
    return slice_update("delayed", g, alpha, order, props, us, G, fields,
                         k, plain)[:3]


def metropolis_slice_update_batched_2f(g, alpha, order, props, us, G, fields,
                                       *, k_delay: int = 32,
                                       exact_rank: bool = False,
                                       plain: bool = False):
    """#4: one slice of the 2-flavor delayed rank-k loop on G
    (W, 2, ns, ns); other arguments and the rank as
    :func:`metropolis_slice_update_batched`.  Returns (G, fields, acc (W,),
    sgn (W,)), sgn the product of this slice's sign flips (multiply it into
    the walker's running sign)."""
    ns = G.shape[-1]
    if G.shape[1] != 2:
        raise ValueError(f"2-flavor site update: G {tuple(G.shape)} must "
                         f"have two flavors")
    k = k_delay if exact_rank else pick_rank(ns, k_delay)
    return slice_update("delayed", g, alpha, order, props, us, G, fields,
                         k, plain)


def metropolis_slice_update_submatrix(g, alpha, order, props, us, G, fields,
                                      *, k_sub: int = 32,
                                      exact_rank: bool = False,
                                      plain: bool = False):
    """#5: one slice of the submatrix scheme; arguments and rank as
    :func:`metropolis_slice_update_batched`."""
    ns = G.shape[-1]
    k = k_sub if exact_rank else pick_rank(ns, k_sub)
    return slice_update("submatrix", g, alpha, order, props, us, G, fields,
                         k, plain)[:3]
