"""Helpers for the tests that hold dqmc_tpu_torch against dqmc_tpu: carry a
JAX model, JAX walker states and JAX random streams across as numpy."""

import jax
import numpy as np
import torch

from dqmc_tpu.engine.sweep import draw_slice_randoms
from dqmc_tpu_torch.engine.state import model_from_numpy, \
    walker_state_from_numpy


def torch_model(model):
    """The port's model from a JAX AttractiveHubbard (same arrays)."""
    return model_from_numpy(
        n_sites=model.n_sites, nt=model.nt,
        expK=np.asarray(model.expK), invexpK=np.asarray(model.invexpK),
        expK_half=np.asarray(model.expK_half),
        invexpK_half=np.asarray(model.invexpK_half),
        g=np.asarray(model.g), alpha=np.asarray(model.alpha),
        beta=np.asarray(model.beta))


def torch_states(states):
    """The port's WalkerState from walker-batched JAX states."""
    return walker_state_from_numpy(
        fields=np.asarray(states.fields), G=np.asarray(states.G),
        stack_L=np.asarray(states.stack.L), stack_d=np.asarray(states.stack.d),
        stack_R=np.asarray(states.stack.R),
        log_det_M=np.asarray(states.log_det_M),
        acc_sum=np.asarray(states.acc_sum), sign=np.asarray(states.sign),
        err_max=np.asarray(states.err_max), err_sum=np.asarray(states.err_sum),
        err_count=np.asarray(states.err_count))


def jax_sweep_streams(keys, nt, ns, dtype):
    """The streams JAX's sweep_fused draws from per-walker keys (W,):
    ((orders, props, us) as numpy, next keys)."""
    split = jax.vmap(lambda k: jax.random.split(k, nt + 1))(keys)
    slice_keys = split[:, :nt]
    orders = jax.vmap(
        lambda k: draw_slice_randoms(k, ns, dtype)[0])(slice_keys[0])
    props = jax.vmap(jax.vmap(
        lambda k: draw_slice_randoms(k, ns, dtype)[1]))(slice_keys)
    us = jax.vmap(jax.vmap(
        lambda k: draw_slice_randoms(k, ns, dtype)[2]))(slice_keys)
    return (np.asarray(orders), np.asarray(props), np.asarray(us)), \
        split[:, nt]


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def jax_slice_streams(keys, ns, dtype):
    """(orders, props, us), each (W, ns) numpy, as draw_slice_randoms
    draws them from per-walker slice keys (W,)."""
    out = jax.vmap(lambda k: draw_slice_randoms(k, ns, dtype))(keys)
    return tuple(np.asarray(x) for x in out)


def jax_per_slice_streams(keys, nt, ns, dtype, forward):
    """The streams JAX's per-slice ``sweep`` draws from per-walker keys
    (W,): each processed slice splits ``key, k_slice = split(key)``
    (sweep.py:519).  Returns ((orders, props, us) numpy, each (W, nt, ns)
    indexed by slice, next keys)."""
    W = keys.shape[0]
    out = [np.zeros((W, nt, ns), np.int64), np.zeros((W, nt, ns), np.int64),
           np.zeros((W, nt, ns), np.dtype(dtype))]
    split = jax.vmap(jax.random.split)
    for l in (range(nt) if forward else range(nt - 1, -1, -1)):
        pair = split(keys)
        keys, k_slice = pair[:, 0], pair[:, 1]
        for arr, x in zip(out, jax_slice_streams(k_slice, ns, dtype)):
            arr[:, l] = x
    return tuple(out), keys
