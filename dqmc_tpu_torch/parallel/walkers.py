"""Walker chunks over devices, and replica-stacked models.

PyTorch counterpart of ``dqmc_tpu/parallel/walkers.py``.  Where the JAX
package shards the walker axis over a device mesh (``make_mesh``,
``shard_walkers``) and lets XLA partition the vmapped step, the port
splits a walker batch into contiguous chunks, one per device
(:func:`local_devices`, :func:`split_walkers`), runs each chunk's step as a
batch of its own, and gathers the chunks back into one state where a
checkpoint or the run's summary needs it (:func:`gather_walkers`).  Walker
w's generator is spawned from (seed, global index w) whatever chunk holds
it, and a chunk whose first walker is not the run's walker 0 draws the
shared visit order of the fused and shared-order engines from a copy of
walker 0's generator (:func:`shared_order_step`), so a chunked run makes
the unsplit run's Markov chains.

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
import sys
from typing import Callable, List, Sequence

import torch

from dqmc_tpu_torch.parallel import distributed

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


# ----------------------------------------------------------------------
# walker chunks over devices
# ----------------------------------------------------------------------

def local_devices(n_devices: int, device) -> List[torch.device]:
    """The devices this process spreads its walkers over ([walkers]
    n_devices): every visible GPU for 0, else min(n_devices, visible), on
    a CUDA ``device``; one device (``device`` itself, with its index) when
    that leaves one, or on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    visible = torch.cuda.device_count()
    ndev = visible if n_devices == 0 else min(n_devices, visible)
    if ndev <= 1:
        return [device]
    return [torch.device("cuda", i) for i in range(ndev)]


def walker_layout(n_walkers: int, devices: Sequence[torch.device],
                  what: str = "n_walkers"):
    """(chunk devices, rank offset, local walkers) of this process
    (JAX run.py:186-206): the run's walkers split evenly over the
    processes, which must divide them (a run over processes cannot fall
    back to one), then this process's over ``devices``; when the
    devices do not divide them, a warning and one chunk on the first."""
    nproc = distributed.process_count()
    if n_walkers % nproc:
        raise ValueError(f"{what} = {n_walkers} is not divisible by "
                         f"[distributed] num_processes = {nproc}")
    n_local = n_walkers // nproc
    devices = list(devices)
    if len(devices) > 1 and n_local % len(devices):
        print(f"WARNING: {what}={n_local} not divisible by "
              f"{len(devices)} devices; running unsharded on one device.",
              file=sys.stderr)
        devices = devices[:1]
    offset = distributed.local_rank_offset(n_local // len(devices),
                                           len(devices))
    return devices, offset, n_local


def _tree(x, fn):
    """fn over every tensor of a state or model (dataclasses and
    NamedTuples of tensors); other leaves are kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _tree(getattr(x, f.name), fn)
            for f in dataclasses.fields(x) if f.name != "gens"})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree(v, fn) for v in x))
    return x


def move_generator(gen: torch.Generator, device) -> torch.Generator:
    """``gen`` on ``device``: a new generator in the same state where the
    device differs (a CUDA generator's state, (seed, offset), continues
    alike on any CUDA device)."""
    if gen.device == torch.device(device):
        return gen
    out = torch.Generator(device=device)
    out.set_state(gen.get_state())
    return out


def to_device(x, device):
    """A state, model or df aux with every tensor (and a state's
    generators) on ``device``."""
    out = _tree(x, lambda t: t.to(device))
    if dataclasses.is_dataclass(x) and hasattr(x, "gens"):
        out = dataclasses.replace(out, gens=[move_generator(g, device)
                                             for g in x.gens])
    return out


def take_walkers(states, start: int, stop: int):
    """Walkers [start, stop) of a state (every tensor's leading axis)."""
    return dataclasses.replace(_tree(states, lambda t: t[start:stop]),
                               gens=list(states.gens[start:stop]))


def split_walkers(states, devices: Sequence[torch.device]) -> list:
    """A state's walker axis in contiguous equal chunks, chunk c on
    devices[c]."""
    per = states.G.shape[0] // len(devices)
    return [to_device(take_walkers(states, c * per, (c + 1) * per), dev)
            for c, dev in enumerate(devices)]


def gather_walkers(chunks: Sequence, device=None):
    """The chunks' walkers as one state on ``device`` (default the first
    chunk's), in chunk order; each generator stays on its chunk's
    device."""
    if len(chunks) == 1 and device is None:
        return chunks[0]
    device = device or chunks[0].G.device
    first = chunks[0]

    def cat(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat([x.to(device) for x in xs])
        return type(xs[0])(*(cat(*v) for v in zip(*xs)))
    return dataclasses.replace(first, **{
        f.name: cat(*(getattr(c, f.name) for c in chunks))
        for f in dataclasses.fields(first) if f.name != "gens"},
        gens=[g for c in chunks for g in c.gens])


def take_replicas(model, start: int, stop: int, device):
    """Replicas [start, stop) of a replica-stacked model (its per-beta
    leaves), or of a stacked df aux, on ``device``."""
    if dataclasses.is_dataclass(model):
        model = dataclasses.replace(model, **{
            f: getattr(model, f)[start:stop] for f in PER_BETA})
    else:
        model = _tree(model, lambda t: t[start:stop])
    return to_device(model, device)


def shared_order_step(step: Callable, shadow: torch.Generator,
                      fused: bool) -> Callable:
    """``step(model, cfg, states, streams=...)`` of a chunk whose first
    walker is not the run's walker 0, under an engine whose walkers share
    walker 0's visit order (the fused engine, and the per-slice engine's
    shared-order kernels): each sweep pair draws the chunk's streams from
    its walkers' generators as the engine would, and the shared order
    from ``shadow``, a copy of walker 0's generator that draws what walker
    0 draws."""
    from dqmc_tpu_torch.engine.sweep import (draw_slice_randoms,
                                             draw_sweep_streams)

    def run(model, cfg, states):
        ns, dtype = model.n_sites, model.dtype
        streams = []
        for _ in range(2):
            orders, props, us = draw_sweep_streams(states.gens, cfg.nt, ns,
                                                   dtype)
            order0 = draw_slice_randoms(shadow, ns, dtype, (cfg.nt,))[0]
            if fused:
                streams.append((order0, props, us))
            else:
                orders[0] = order0
                streams.append((orders, props, us))
        return step(model, cfg, states, streams=streams)
    return run


def with_shared_order(steps: list, chunks: Sequence, firsts: Sequence[int],
                      devices: Sequence[torch.device], shared: bool,
                      fused: bool) -> list:
    """The chunks' steps, those of chunks whose first walker is not the
    run's walker 0 (global index ``firsts[c]``) drawing the shared visit
    order from a copy of walker 0's generator when the engine shares one
    (``shared``): process 0's first chunk holds walker 0, whose generator
    state every process receives (a collective: every process calls this
    alike, after its states are built or loaded)."""
    if not shared:
        return list(steps)
    g0 = distributed.broadcast(chunks[0].gens[0].get_state())
    out = []
    for step, first, dev in zip(steps, firsts, devices):
        if first != 0:
            shadow = torch.Generator(device=dev)
            shadow.set_state(g0)
            step = shared_order_step(step, shadow, fused)
        out.append(step)
    return out
