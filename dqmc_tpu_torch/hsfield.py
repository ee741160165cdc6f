"""Discrete 4-state Gauss–Hermite-quadrature Hubbard–Stratonovich field.

PyTorch counterpart of ``dqmc_tpu/hsfield.py``: the four field states
s in {0,1,2,3} carry quadrature weights gamma(s) and node values eta(s); a
proposal picks one of the other three states uniformly.  Randomness comes
from explicit ``torch.Generator``s (one per walker in the engine).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_S6 = math.sqrt(6.0)

# gamma/eta tables for states 0..3 (field.h:36-43)
GAMMA = np.array(
    [1.0 - _S6 / 3.0, 1.0 + _S6 / 3.0, 1.0 + _S6 / 3.0, 1.0 - _S6 / 3.0]
)
ETA = np.array(
    [
        -math.sqrt(2.0 * (3.0 + _S6)),
        -math.sqrt(2.0 * (3.0 - _S6)),
        math.sqrt(2.0 * (3.0 - _S6)),
        math.sqrt(2.0 * (3.0 + _S6)),
    ]
)

# PROPOSAL[old, r] = new state, r uniform in {0,1,2} (field.h:45-48)
PROPOSAL = np.array(
    [[1, 2, 3],
     [0, 2, 3],
     [0, 1, 3],
     [0, 1, 2]],
    dtype=np.int32,
)

N_STATES = 4


def init_fields(gen: torch.Generator, nt: int, n_sites: int) -> torch.Tensor:
    """Random initial configuration, uniform over the 4 states
    (field.h:52-57), on the generator's device."""
    return torch.randint(0, N_STATES, (nt, n_sites), generator=gen,
                         device=gen.device, dtype=torch.int64)


def propose_new_fields(gen: torch.Generator,
                       old: torch.Tensor) -> torch.Tensor:
    """Propose one of the other 3 states, uniformly, elementwise."""
    r = torch.randint(0, 3, old.shape, generator=gen, device=old.device)
    return new_state(old, r)


def new_state(old: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """PROPOSAL[old, r] without a table: the r-th state other than old."""
    return r + (r >= old).to(r.dtype)


def log_gamma_eta_sums(fields: torch.Tensor, g: torch.Tensor, alpha: float):
    """(sum_i alpha*g*eta(s_i), sum_i log gamma(s_i)) over all field entries
    (model.cpp:147-157)."""
    eta = torch.as_tensor(ETA, dtype=g.dtype, device=g.device)
    gamma = torch.as_tensor(GAMMA, dtype=g.dtype, device=g.device)
    log_boson = alpha * g * torch.sum(eta[fields])
    log_gamma = torch.sum(torch.log(gamma[fields]))
    return log_boson, log_gamma
