#!/usr/bin/env python3
"""Where a walker's numbers depend on the batch it runs in, on the card.

    python3 scripts/split_witness.py        # ~1 minute on an H100

A run split over devices or processes runs each chunk as a batch of its
own, so a walker's numbers stay the unsplit run's only where every
operation gives it the same bits whatever the batch holds.  This script
takes the headline shape (16x16, beta = 8, nt = 160, n_stab = 5, W = 16,
seed 20) on cuda:0 and runs each operation of the sweep on the whole
batch and on its two halves of 8, printing per operation whether the
halves give the whole batch's bits and the largest gap over the largest
value:

- float64: the wraps (expK @ G and G @ expK^-1, where torch folds the
  walker axis into the GEMM's rows), a batched product (bmm), torch's
  Householder QR and triangular solve called on the batch, the port's QR
  (``ops/linalg.qr``, one matrix per call), the stack rebuild and one
  per-slice sweep pair;
- float32: K1 (the CGS2 QR kernel), the wrap GEMM kernel and one fused
  sweep pair;
- the measured bins of phase 20's float64 run made twice unsplit, the
  floor that index_add_'s float64 atomics set between two runs of the
  same fields.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def gap(a, b):
    """(bits equal, max |a - b| / max |a|) over tensors or tuples of them."""
    import torch
    if isinstance(a, (tuple, list)):
        parts = [gap(x, y) for x, y in zip(a, b)]
        return all(p[0] for p in parts), max(p[1] for p in parts)
    scale = float(a.abs().max()) or 1.0
    return bool(torch.equal(a, b)), float((a - b).abs().max()) / scale


def halves(fn, *args):
    """fn on each half of the walker axis of every tensor argument,
    concatenated back."""
    import torch
    W = args[0].shape[0] if hasattr(args[0], "shape") else None
    out = [fn(*(a[s] if hasattr(a, "shape") and a.shape[:1] == (W,)
                else a for a in args))
           for s in (slice(0, W // 2), slice(W // 2, W))]
    if isinstance(out[0], tuple):
        return tuple(torch.cat(x) for x in zip(*out))
    return torch.cat(out)


def main() -> None:
    import torch
    from dqmc_tpu_torch.engine.fused import sweep_pair_fused
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import (init_state,
                                             rebuild_stack_and_greens,
                                             sweep_pair)
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    from dqmc_tpu_torch.models.kinetic import apply_B_left, apply_invB_right
    from dqmc_tpu_torch.ops import linalg
    from dqmc_tpu_torch.parallel.walkers import (gather_walkers,
                                                 split_walkers,
                                                 with_shared_order)
    if not torch.cuda.is_available():
        sys.exit("split_witness.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    W, L, beta, nt, n_stab = 16, 16, 8.0, 160, 5
    dev = torch.device("cuda", 0)

    def say(name, res):
        print(f"split_witness: {name}: halves give the batch's bits "
              f"{res[0]}, largest gap {res[1]:.3e} of max|x|", flush=True)

    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                        mu=0.0, beta=beta, nt=nt,
                                        dtype=dtype, device=dev)
        cfg = EngineConfig(nt=nt, n_stab=n_stab, use_pallas=True)
        states = init_state(model, cfg, make_generators(20, W, dev))
        G, f = states.G, states.fields[:, 0]
        if dtype == torch.float64:
            say(f"{tag} expK @ G (folded GEMM)", gap(
                apply_B_left(model, f, G),
                halves(lambda f, G: apply_B_left(model, f, G), f, G)))
            say(f"{tag} G @ expK^-1 (folded GEMM)", gap(
                apply_invB_right(model, f, G),
                halves(lambda f, G: apply_invB_right(model, f, G), f, G)))
            say(f"{tag} G @ G^T (bmm)", gap(
                G @ G.transpose(-1, -2),
                halves(lambda G: G @ G.transpose(-1, -2), G)))
            say(f"{tag} Householder QR", gap(
                tuple(torch.linalg.qr(G)),
                halves(lambda G: tuple(torch.linalg.qr(G)), G)))
            Q, R = torch.linalg.qr(G)
            say(f"{tag} triangular solve", gap(
                torch.linalg.solve_triangular(R, Q, upper=True),
                halves(lambda R, Q: torch.linalg.solve_triangular(
                    R, Q, upper=True), R, Q)))
            say(f"{tag} the port's QR (linalg.qr, one matrix per call)",
                gap(tuple(linalg.qr(G)), halves(
                    lambda G: tuple(linalg.qr(G)), G)))
            say(f"{tag} stack rebuild", gap(
                rebuild_stack_and_greens(model, cfg, states.fields)[1],
                halves(lambda fl: rebuild_stack_and_greens(
                    model, cfg, fl)[1], states.fields)))
            step = sweep_pair
        else:
            from dqmc_tpu_torch.engine.fused import wrap_gemm_cuda
            from dqmc_tpu_torch.ops.qr_kernel import cgs2_qr
            A = G.reshape(W, L * L, L * L)
            say(f"{tag} K1 (cgs2_qr)", gap(tuple(cgs2_qr(A)), halves(
                lambda A: tuple(cgs2_qr(A)), A)))
            say(f"{tag} wrap GEMM kernel", gap(
                wrap_gemm_cuda(A, model.expK),
                halves(lambda A: wrap_gemm_cuda(A, model.expK), A)))
            step = sweep_pair_fused
            cfg = EngineConfig(nt=nt, n_stab=n_stab)
        # the same walkers again, their generators fresh, in two chunks;
        # the second draws walker 0's visit order, as a run's chunk does
        chunks = split_walkers(init_state(model, cfg, make_generators(
            20, W, dev)), [dev, dev])
        one = step(model, cfg, states)
        steps = with_shared_order([step, step], chunks, [0, W // 2],
                                  [dev, dev], True, step is not sweep_pair)
        two = gather_walkers([st(model, cfg, s)
                              for st, s in zip(steps, chunks)])
        say(f"{tag} one sweep pair: G", gap(one.G, two.G))
        print(f"split_witness: {tag} one sweep pair: fields equal "
              f"{bool(torch.equal(one.fields, two.fields))}", flush=True)

    import numpy as np
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.io.spool import read_bins
    from dqmc_tpu_torch.run import run_simulation
    sys.path.insert(0, str(REPO))
    from chip_smoke import SPLIT_CASES, SPLIT_HEADLINE
    text = SPLIT_HEADLINE + SPLIT_CASES[1][1]
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("a", "b"):
            run_simulation(Parameters.from_string(text),
                           out_dir=f"{tmp}/{run}", device="cuda",
                           verbose=False)
        worst, name = 0.0, ""
        for w in range(W):
            A = read_bins(f"{tmp}/a/data_{w}.spool")
            B = read_bins(f"{tmp}/b/data_{w}.spool")
            for b in A:
                for group, vals in A[b].items():
                    for n, x in vals.items():
                        x, y = np.asarray(x), np.asarray(B[b][group][n])
                        g = float(np.abs(x - y).max()) / max(
                            float(np.abs(x).max()), 1e-300)
                        if g > worst:
                            worst, name = g, f"{group}/{n}"
    print(f"split_witness: float64 run made twice unsplit: the bins' "
          f"largest gap {worst:.3e} of max|x| ({name})", flush=True)


if __name__ == "__main__":
    main()
