"""Checkpoint / resume for walker state.

PyTorch counterpart of ``dqmc_tpu/io/checkpoint.py``.  The whole Markov
chain of a walker batch is one state dataclass (``engine/state.py``
``WalkerState`` or ``engine/df_sweep.py`` ``DFWalkerState``): its tensors,
the NamedTuples of tensors inside it (the LDR stack, df32 pairs), and one
``torch.Generator`` per walker, the only random streams the engines draw
from (the fused engine's shared visit order comes from walker 0's).  A
checkpoint stores every tensor and every generator's ``get_state()``, so a
resume continues the same chain bit for bit.

Format: one .npz with the leaves in a fixed order (``leaf_<i>``) and a
JSON metadata record (``__meta__``) holding the caller's metadata, the
format version, the package name, the leaf names and the device type the
state lived on.  Writes are atomic (a temporary file, then a rename), so
an interrupted run never corrupts the previous checkpoint.

Refused with a diagnosis: another format version, another leaf count or
leaf names, another leaf shape or dtype, another device type (a CUDA
generator's state cannot be loaded into a CPU generator, nor the
reverse), and a checkpoint of the JAX package (its walkers carry JAX PRNG
keys, whose streams are not the port's).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# Bump whenever the state's leaf structure changes.
FORMAT_VERSION = 1
PACKAGE = "dqmc_tpu_torch"


def _leaves(states) -> List[Tuple[str, Any]]:
    """(name, leaf) in a fixed order: tensors, and generators under
    ``gens.<w>``."""
    out = []

    def visit(name, x):
        if isinstance(x, torch.Tensor):
            out.append((name, x))
        elif isinstance(x, torch.Generator):
            out.append((name, x))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                visit(f"{name}.{f}", getattr(x, f))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                visit(f"{name}.{i}", v)
        else:
            raise TypeError(f"checkpoint: unsupported state leaf {name} "
                            f"of type {type(x).__name__}")
    for f in dataclasses.fields(states):
        visit(f.name, getattr(states, f.name))
    return out


def _device_type(states) -> str:
    return states.G.device.type


def save_checkpoint(path: str | os.PathLike, states,
                    meta: Dict[str, Any]) -> None:
    """Persist a walker-state dataclass and a JSON-able metadata dict."""
    leaves = _leaves(states)
    payload = {}
    for i, (name, x) in enumerate(leaves):
        if isinstance(x, torch.Generator):
            x = x.get_state()
        payload[f"leaf_{i}"] = x.detach().cpu().numpy()
    payload["__meta__"] = np.frombuffer(json.dumps({
        **meta, "format_version": FORMAT_VERSION, "package": PACKAGE,
        "state": type(states).__name__, "device": _device_type(states),
        "n_leaves": len(leaves), "names": [n for n, _ in leaves],
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(str(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_meta(data, path) -> Dict[str, Any]:
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta.get("package") != PACKAGE:
        raise ValueError(
            f"{path} is a checkpoint of the JAX package dqmc_tpu (no "
            f"'package': '{PACKAGE}' in its metadata): its walkers carry "
            f"JAX PRNG keys, whose random streams are not the port's "
            f"torch.Generator streams, so it cannot continue this chain -- "
            f"resume it with python -m dqmc_tpu, or start a fresh port run")
    return meta


def load_checkpoint(path: str | os.PathLike,
                    template) -> Tuple[Any, Dict[str, Any]]:
    """Restore a state saved by save_checkpoint.

    ``template`` (a freshly initialized state of the same configuration,
    on the device to resume on) gives the structure; leaf names, shapes,
    dtypes and the device type are validated against it."""
    want = _leaves(template)
    with np.load(path) as data:
        meta = _read_meta(data, path)
        ver = meta.get("format_version")
        if ver != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format version {ver} != current "
                f"{FORMAT_VERSION}: written by another version of "
                f"dqmc_tpu_torch -- restart the run or migrate the "
                f"checkpoint")
        if meta.get("n_leaves") != len(want) or meta.get("names") != [
                n for n, _ in want]:
            raise ValueError(
                f"checkpoint has {meta.get('n_leaves')} state leaves "
                f"({meta.get('state')}) but the current configuration "
                f"expects {len(want)} ({type(template).__name__}) -- wrong "
                f"checkpoint for this run?")
        dev = _device_type(template)
        if meta.get("device") != dev:
            raise ValueError(
                f"checkpoint was written by a run on {meta.get('device')} "
                f"and this run is on {dev}: a "
                f"{meta.get('device')} generator's state cannot be loaded "
                f"into a {dev} generator -- resume on the device type the "
                f"checkpoint was written on")
        values = {}
        for i, (name, leaf) in enumerate(want):
            arr = data[f"leaf_{i}"]
            ref = leaf.get_state() if isinstance(leaf, torch.Generator) \
                else leaf
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {tuple(arr.shape)} does "
                    f"not match the current configuration "
                    f"{tuple(ref.shape)} -- wrong checkpoint for this run?")
            t = torch.from_numpy(arr)
            if t.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint leaf {name} dtype {t.dtype} does not "
                    f"match the current configuration {ref.dtype} -- wrong "
                    f"checkpoint for this run?")
            if isinstance(leaf, torch.Generator):
                gen = torch.Generator(device=leaf.device)
                gen.set_state(t)
                values[name] = gen
            else:
                values[name] = t.to(leaf.device)
    return _rebuild(template, values), meta


def _rebuild(states, values: Dict[str, Any]):
    def build(name, x):
        if isinstance(x, (torch.Tensor, torch.Generator)):
            return values[name]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(f"{name}.{f}", getattr(x, f))
                             for f in x._fields))
        return type(x)(build(f"{name}.{i}", v) for i, v in enumerate(x))
    return dataclasses.replace(states, **{
        f.name: build(f.name, getattr(states, f.name))
        for f in dataclasses.fields(states)})


def peek_meta(path: str | os.PathLike) -> Dict[str, Any]:
    """Only the metadata dict of a checkpoint (no leaf loads): run.py needs
    the adapted n_stab before it builds the states, since it sets the
    stack's slot count."""
    with np.load(path) as data:
        meta = _read_meta(data, path)
    meta.pop("names", None)
    return meta
