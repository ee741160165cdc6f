"""Replica-stacked models for parallel tempering.

PyTorch counterpart of ``stack_models`` in ``dqmc_tpu/parallel/walkers.py``.
The JAX package stacks every array leaf of the per-replica models along a
new leading axis and vmaps the engine over (model, walker) pairs.  The
port's engines are walker-batched and take one model for the whole batch,
so a stacked model keeps the model's dataclass: its per-beta leaves (expK
and its three siblings, g, alpha, beta) gain a leading replica axis, which
the engines line up with the walker axis (``models/attractive_hubbard.lead``),
and walker r runs with replica r's constants.  The leaves every replica
shares (eta, gamma) and the static structure stay as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# the leaves that differ between the betas of a ladder
PER_BETA = ("expK", "invexpK", "expK_half", "invexpK_half", "g", "alpha",
            "beta")
_STATIC = ("n_sites", "nt", "n_flavor", "det_power", "checkerboard")

# the checkerboard tables depend on dtau and are static fields of a JAX
# model, so JAX's stack_models cannot stack a beta ladder of them either
CHECKERBOARD_PT = (
    "parallel tempering with checkerboard = true: the checkerboard tables "
    "(cb_ch, cb_sh, cb_emu) depend on dtau = beta / nt, so a beta ladder "
    "has no single table set, and the JAX package's stack_models cannot "
    "stack them either; run parallel tempering with dense kinetics")


def stack_models(models: Sequence):
    """One replica-stacked model from per-replica models of one class
    (one beta each): the per-beta leaves stacked on a leading replica
    axis, everything else (eta, gamma, the static structure) taken from
    the first model, whose static structure must agree with the
    others'."""
    first = models[0]
    for m in models[1:]:
        if type(m) is not type(first) or any(
                getattr(m, f) != getattr(first, f) for f in _STATIC):
            raise ValueError(
                "stack_models: the replicas differ in their static "
                "structure " + ", ".join(
                    f"{f} {getattr(first, f)} vs {getattr(m, f)}"
                    for f in _STATIC if getattr(m, f) != getattr(first, f))
                + (f"; {type(first).__name__} vs {type(m).__name__}"
                   if type(m) is not type(first) else ""))
    if first.checkerboard:
        raise NotImplementedError(CHECKERBOARD_PT)
    return dataclasses.replace(first, **{
        f: torch.stack([getattr(m, f) for m in models]) for f in PER_BETA})


def cast_model(model, dtype):
    """The model with every floating leaf cast to ``dtype`` (the f64
    exchange actions of a float32 chain cast its model, as JAX's
    _cast_floats does)."""
    return dataclasses.replace(model, **{
        f.name: v.to(dtype) for f in dataclasses.fields(model)
        if isinstance(v := getattr(model, f.name), torch.Tensor)
        and v.is_floating_point()})


def replica(model, r: int):
    """Replica r of a stacked model, as a model of its own."""
    return dataclasses.replace(model, **{f: getattr(model, f)[r]
                                         for f in PER_BETA})
