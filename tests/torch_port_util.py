"""Helpers for the tests that hold dqmc_tpu_torch against dqmc_tpu: carry a
JAX model, JAX walker states and JAX random streams across as numpy."""

import jax
import numpy as np
import pytest
import torch

from dqmc_tpu.engine.sweep import draw_slice_randoms
from dqmc_tpu_torch.engine.state import model_from_numpy, \
    walker_state_from_numpy

# XLA:CPU maps three memory regions for every executable it holds, and a
# process may hold vm.max_map_count of them (65530 by default): one worker
# that ran the eager df32 tests arrives here with most of them taken, and
# the next compile past the limit kills it.  The JAX references below are
# small, so recompiling them costs little.
_MAPS_HIGH_WATER = 30000


def _n_memory_maps():
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def release_jax_programs():
    """Drop JAX's compiled programs before a test when this process holds
    more than _MAPS_HIGH_WATER memory maps.  A test module gets this by
    importing the name."""
    if _n_memory_maps() > _MAPS_HIGH_WATER:
        jax.clear_caches()
    yield


def torch_model(model):
    """The port's model from a JAX AttractiveHubbard or RepulsiveHubbard
    (same arrays)."""
    return model_from_numpy(
        n_sites=model.n_sites, nt=model.nt,
        expK=np.asarray(model.expK), invexpK=np.asarray(model.invexpK),
        expK_half=np.asarray(model.expK_half),
        invexpK_half=np.asarray(model.invexpK_half),
        g=np.asarray(model.g), alpha=np.asarray(model.alpha),
        beta=np.asarray(model.beta), n_flavor=model.n_flavor,
        det_power=model.det_power)


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
