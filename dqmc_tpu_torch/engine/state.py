"""Walker state and static engine configuration.

PyTorch counterpart of ``dqmc_tpu/engine/state.py``.  The whole Markov-chain
state of a batch of W walkers is one dataclass of tensors with a leading
walker axis, plus one ``torch.Generator`` per walker for its random stream.

``walker_state_from_numpy`` and ``model_from_numpy`` carry a model and
walker states of the JAX package (as numpy arrays) into the port, so both
packages can be run from the same state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from dqmc_tpu_torch.ops.linalg import LDR


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """nt time slices in n_stack blocks of n_stab (the last block is
    shorter when nt % n_stab != 0), dqmc.cpp:8-18, and the per-slice
    engine's site-update choice (``engine/sweep.py``):

    - ``use_pallas``: the walker-batched kernels with a shared visit order
      (#3 delayed, or #5 submatrix when ``submatrix_rank > 0``); the name
      is the JAX package's;
    - ``submatrix_rank > 0``: the submatrix scheme of that rank;
    - ``delay_rank > 0``: the delayed rank-k scheme with per-walker order;
    - otherwise the rank-1 Sherman-Morrison loop (``scan``).

    ``fused_update`` is the fused block's in-slice scheme; only
    ``delayed`` is ported."""

    nt: int
    n_stab: int
    delay_rank: int = 0
    submatrix_rank: int = 0
    use_pallas: bool = False
    fused_update: str = "delayed"

    def __post_init__(self):
        if self.nt <= 0 or self.n_stab <= 0:
            raise ValueError("nt and n_stab must be positive")
        if self.delay_rank < 0:
            raise ValueError("delay_rank must be >= 0")
        if self.submatrix_rank < 0:
            raise ValueError("submatrix_rank must be >= 0")

    @property
    def n_stack(self) -> int:
        return math.ceil(self.nt / self.n_stab)

    @property
    def n_slots(self) -> int:
        # physical stacks at slots 1..n_stack; slots 0 and n_stack+1 hold
        # identity factors so no stabilization needs a special case
        return self.n_stack + 2


@dataclasses.dataclass
class WalkerState:
    """Per-walker chain state, walker axis first.

    - fields: (W, nt, ns) int64 HS configuration
    - G: (W, nfl, ns, ns) current equal-time Green's function
    - stack: LDR with leaves (W, nfl, n_slots, ...); slots 0 and n_slots-1
      are identity padding; prefix products in normal form, suffix products
      in transpose form
    - log_det_M: (W, nfl) log|det(I + B(beta,0))|
    - gens: one torch.Generator per walker (on the state's device)
    - acc_sum, sign, err_max, err_sum, err_count: (W,) running statistics
    """

    fields: torch.Tensor
    G: torch.Tensor
    stack: LDR
    log_det_M: torch.Tensor
    gens: List[torch.Generator]
    acc_sum: torch.Tensor
    sign: torch.Tensor
    err_max: torch.Tensor
    err_sum: torch.Tensor
    err_count: torch.Tensor


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def make_generators(seed: int, n: int, device, first: int = 0,
                    count: int | None = None) -> List[torch.Generator]:
    """n independent generators on ``device``, seeded from one integer via
    numpy's SeedSequence (independent child streams); ``first`` and
    ``count`` keep children [first, first + count) of the n, so that a
    walker's stream depends only on (seed, its index among the n)."""
    gens = []
    children = np.random.SeedSequence(seed).spawn(n)
    stop = n if count is None else first + count
    for child in children[first:stop]:
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0]))
        gens.append(g)
    return gens


def walker_state_from_numpy(*, fields, G, stack_L, stack_d, stack_R,
                            log_det_M, acc_sum=None, sign=None, err_max=None,
                            err_sum=None, err_count=None, dtype=None,
                            device="cpu", seed: int = 0) -> WalkerState:
    """WalkerState from numpy arrays in the JAX package's batched layout
    (fields (W, nt, ns); G (W, nfl, ns, ns); stack leaves
    (W, nfl, n_slots, ...); log_det_M (W, nfl); statistics (W,)).  The
    walker generators are seeded from ``seed``; missing statistics start at
    their initial values."""
    G = np.asarray(G)
    dtype = dtype or _torch_dtype(G)
    W = G.shape[0]
    as_t = lambda x: torch.as_tensor(np.array(x), dtype=dtype,
                                     device=device)
    stat = lambda x, v: as_t(np.full((W,), v) if x is None else x)
    return WalkerState(
        fields=torch.as_tensor(np.array(fields), dtype=torch.int64,
                               device=device),
        G=as_t(G),
        stack=LDR(as_t(stack_L), as_t(stack_d), as_t(stack_R)),
        log_det_M=as_t(log_det_M),
        gens=make_generators(seed, W, device),
        acc_sum=stat(acc_sum, 0.0), sign=stat(sign, 1.0),
        err_max=stat(err_max, 0.0), err_sum=stat(err_sum, 0.0),
        err_count=stat(err_count, 0.0),
    )


def model_from_numpy(*, n_sites, nt, expK, invexpK, expK_half, invexpK_half,
                     g, beta, alpha=-1.0, n_flavor=1, det_power=2,
                     dtype=None, device="cpu"):
    """The port's model from a JAX model's arrays (numpy): the attractive
    model for one stored flavor with det_power 2, the repulsive one for two
    flavors with det_power 1.  The leaves of the JAX package's
    ``stack_models`` (a leading replica axis on expK and its siblings, g,
    alpha and beta) give the port's replica-stacked model."""
    from dqmc_tpu_torch import hsfield
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    kinds = {(c.N_FLAVOR, c.DET_POWER): c for c in MODEL_REGISTRY.values()}
    cls = kinds[int(n_flavor), int(det_power)]
    expK = np.asarray(expK)
    dtype = dtype or _torch_dtype(expK)
    as_t = lambda x: torch.as_tensor(np.array(x), dtype=dtype,
                                     device=device)
    return cls(
        n_sites=int(n_sites), nt=int(nt), n_flavor=cls.N_FLAVOR,
        det_power=cls.DET_POWER,
        expK=as_t(expK), invexpK=as_t(invexpK), expK_half=as_t(expK_half),
        invexpK_half=as_t(invexpK_half), g=as_t(g), alpha=as_t(alpha),
        eta=as_t(hsfield.ETA), gamma=as_t(hsfield.GAMMA), beta=as_t(beta))
