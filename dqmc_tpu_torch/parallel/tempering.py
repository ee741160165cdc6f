"""Parallel tempering (replica exchange) over the walker axis.

PyTorch counterpart of ``dqmc_tpu/parallel/tempering.py`` (the reference's
MPI replica exchange, update.cpp:34-117, main.cpp:39-73,147-153) on one
device:

- One walker per replica, one beta per replica: the model is
  replica-stacked (``parallel/walkers.stack_models``) and walker r runs
  with replica r's expK and g through the per-slice engine, whose site
  kernels (#3, #4) take per-walker couplings.  The fused engine takes one
  shared expK and g, so PT refuses it, as the JAX package runs PT on the
  per-slice engine only.
- The even/odd partner pairing alternates with the attempt counter
  (update.cpp:34-45, :func:`partner_indices`).
- Configurations travel to the partners as one permutation of the fields;
  both actions come from one stack rebuild of the partner's fields per
  replica; both partners of a pair read the same uniform,
  ``u[min(r, partner)]``; the exchanged state is selected per replica,
  the Metropolis sign travelling with the fields.
- A float32 chain takes both actions from float64 rebuilds through a
  float64 cast of its model by default (``f64_actions``: a float32
  log-det carries O(1..10) of absolute error, which biases the joint
  Metropolis rule), and the exchanged state is cast back; a df32 chain
  takes df-grade actions (:func:`replica_exchange_df`).

Exchange attempts run on the host between measured sweep pairs, before
sweep number k * sweep_steps of the measurement phase (main.cpp:147-171),
counted over the whole run, so a resumed run attempts where an
uninterrupted one does.  The uniforms come from a ``torch.Generator`` of
their own on the CPU, seeded from ``seed`` beside the walkers' generators;
a checkpoint holds its state with ``attempt`` and ``accepted``, and is
taken mid-thermalization too, as the standard driver's is.  Every replica
is binned to ``data_<r>``; the analysis reads ``data_0``, the first beta.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from dqmc_tpu_torch.engine.sweep import (half_warp, init_state,
                                         rebuild_stack_and_greens,
                                         reset_error_stats, sweep_pair)
from dqmc_tpu_torch.ops.linalg import LDR
from dqmc_tpu_torch.parallel.walkers import cast_model, stack_models

FUSED_PT = (
    "parallel tempering with engine = fused: the fused engine takes one "
    "shared expK and g for the whole walker batch, and parallel tempering "
    "runs a beta per walker on the per-slice engine, as the JAX package "
    "does (ROADMAP: queue 1, item 7, the fused engine with a (g, expK) "
    "per walker)")


def partner_indices(n_replicas: int, attempt: int) -> torch.Tensor:
    """Alternating even/odd neighbour pairing (update.cpp:34-45): an odd
    attempt (the first) pairs (0,1),(2,3),...; an even one pairs
    (1,2),(3,4),...,(R-1,0)."""
    idx = torch.arange(n_replicas)
    off_even = 1 if attempt % 2 == 0 else -1
    offset = torch.where(idx % 2 == 0, off_even, -off_even)
    return (idx + offset) % n_replicas


def exchange_generator(seed: int, n_replicas: int) -> torch.Generator:
    """The exchange coins' CPU generator: the child of ``seed`` after the
    walkers' (``engine/state.make_generators``), so its stream is
    independent of theirs."""
    from dqmc_tpu_torch.engine.state import make_generators
    return make_generators(seed, n_replicas + 1, "cpu")[n_replicas]


def exchange_uniforms(gen: torch.Generator, n_replicas: int) -> torch.Tensor:
    """One attempt's uniforms (R,), float64; pair (r, p) reads
    u[min(r, p)]."""
    return torch.rand(n_replicas, generator=gen, dtype=torch.float64)


def _select(accept, new, old):
    return torch.where(accept.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def _decide(S_self, S_cross, partner, u):
    """The joint Metropolis decision per replica with one coin per pair:
    accept on u[min(r, p)] < exp(-[S_r(s_p) + S_p(s_r) - S_r(s_r) -
    S_p(s_p)])."""
    dev = S_self.device
    partner = partner.to(dev)
    dS = S_cross + S_cross[partner] - S_self - S_self[partner]
    pair = torch.minimum(torch.arange(len(partner), device=dev), partner)
    u = torch.as_tensor(u, device=dev).to(torch.float64)
    return u[pair] < torch.exp(-dS.to(torch.float64))


def exchange_actions(model, cfg, states, partner, f64_actions=False):
    """(S_self, S_cross, (stack, G, log_det) of the partners' fields) per
    replica: S_self the action of each replica's own fields under its own
    beta, S_cross of its partner's fields.  ``f64_actions`` (for a
    non-float64 chain) takes both from float64 rebuilds through a float64
    cast of the model, and casts the partners' state back to the chain's
    dtype."""
    fields_p = states.fields[partner.to(states.fields.device)]
    chain = states.G.dtype
    if f64_actions and chain != torch.float64:
        m64 = cast_model(model, torch.float64)
        # the float32 chain's own log-det is not trustworthy: rebuild it
        _, _, ld_own = rebuild_stack_and_greens(m64, cfg, states.fields)
        S_self = m64.global_action(states.fields, ld_own)
        stack, G, ld = rebuild_stack_and_greens(m64, cfg, fields_p)
        S_cross = m64.global_action(fields_p, ld)
        stack = LDR(*(x.to(chain) for x in stack))
        return S_self, S_cross, (stack, G.to(chain), ld.to(chain))
    S_self = model.global_action(states.fields, states.log_det_M)
    stack, G, ld = rebuild_stack_and_greens(model, cfg, fields_p)
    return S_self, model.global_action(fields_p, ld), (stack, G, ld)


def replica_exchange(model, cfg, states, attempt: int, u,
                     f64_actions: bool = False):
    """One replica-exchange attempt over the walker axis of a
    replica-stacked model: (states, accept (R,) bool), each pair sharing
    one decision.  ``u`` (R,) are the attempt's uniforms
    (:func:`exchange_uniforms`); rejected replicas keep their state as it
    was, accepted ones take the partner's fields and sign with the stack,
    G and log-det rebuilt under their own beta."""
    partner = partner_indices(states.fields.shape[0], attempt)
    S_self, S_cross, (stack, G, ld) = exchange_actions(
        model, cfg, states, partner, f64_actions)
    accept = _decide(S_self, S_cross, partner, u)
    p = partner.to(states.fields.device)
    sel = lambda new, old: _select(accept, new, old)  # noqa: E731
    return dataclasses.replace(
        states, fields=sel(states.fields[p], states.fields),
        G=sel(G, states.G),
        stack=LDR(*(sel(a, b) for a, b in zip(stack, states.stack))),
        log_det_M=sel(ld, states.log_det_M),
        # the Metropolis sign belongs to the configuration
        sign=sel(states.sign[p], states.sign)), accept


def replica_exchange_df(aux, cfg, states, attempt: int, u,
                        det_power: int = 2):
    """Replica exchange of a df32 chain (JAX tempering.py:152-202): the
    protocol of :func:`replica_exchange` with both actions at df accuracy,
    the chain's own df log-det and one df stack rebuild of the partners'
    fields (``engine/df_sweep.rebuild_stack_df``), the bosonic part the
    exact state-count dot (``df_global_action``).  ``aux`` is a
    replica-stacked ``DFModelAux`` (``df_sweep.stack_aux``)."""
    from dqmc_tpu_torch.engine.df_sweep import (df_global_action,
                                                rebuild_stack_df)
    from dqmc_tpu_torch.ops.df32 import DF
    from dqmc_tpu_torch.ops.df_linalg import LDRdf
    partner = partner_indices(states.fields.shape[0], attempt)
    p = partner.to(states.fields.device)
    fields_p = states.fields[p]
    S_self = df_global_action(aux, states.fields, states.log_det_M,
                              det_power)
    stack, G_df, ld = rebuild_stack_df(aux, cfg, fields_p)
    S_cross = df_global_action(aux, fields_p, ld, det_power)
    accept = _decide(S_self, S_cross, partner, u)
    sel = lambda new, old: _select(accept, new, old)  # noqa: E731
    seld = lambda new, old: DF(sel(new.hi, old.hi),  # noqa: E731
                               sel(new.lo, old.lo))
    return dataclasses.replace(
        states, fields=sel(fields_p, states.fields),
        G=sel(G_df.hi, states.G), G_df=seld(G_df, states.G_df),
        stack=LDRdf(seld(stack.L, states.stack.L),
                    seld(stack.d, states.stack.d),
                    seld(stack.R, states.stack.R),
                    sel(stack.e, states.stack.e)),
        log_det_M=sel(ld, states.log_det_M),
        sign=sel(states.sign[p], states.sign)), accept


# ----------------------------------------------------------------------
# the PT driver (main.cpp's PT branch)
# ----------------------------------------------------------------------

def run_parallel_tempering(params, *, out_dir: str | None = "results",
                           verbose: bool = True, device="cuda"):
    """Run the parallel-tempering simulation ``params`` describes on
    ``device`` ([ParallelTempering] betas, sweep_steps, f64_actions);
    replica r's bins go to ``out_dir/data_<r>``.  Returns the port's
    RunSummary, its ``observables`` replica 0's (the first beta's)."""
    from dqmc_tpu_torch.engine.df_sweep import (df_aux_build, df_sweep_pair,
                                                f32_view, init_state_df,
                                                stack_aux)
    from dqmc_tpu_torch.engine.parity import (measurement_greens_fn_stacked,
                                              measurement_uneq_fn_stacked)
    from dqmc_tpu_torch.engine.state import make_generators
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from dqmc_tpu_torch.lattice import bonds_with_tp, make_lattice
    from dqmc_tpu_torch.measure.manager import MeasurementManager
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    from dqmc_tpu_torch.ops import df32, tf32
    from dqmc_tpu_torch.run import (RunSummary, _resolve_dtype, _stats,
                                    _sync, make_engine_config)

    device = torch.device(device)
    log = print if verbose else (lambda *a, **k: None)
    dtype, df_mode = _resolve_dtype(params, device)
    measure_prec = params.get_str("simulation", "measure_precision",
                                  "engine")
    if measure_prec not in ("engine", "tf32", "df32"):
        raise ValueError(f"[simulation] measure_precision must be engine, "
                         f"tf32 or df32, got {measure_prec!r}")
    f64_actions = params.get_bool("ParallelTempering", "f64_actions",
                                  dtype == torch.float32 and not df_mode)
    betas = params.get_float_list("ParallelTempering", "betas")
    exchange_step = params.get_int("ParallelTempering", "sweep_steps")
    R = len(betas)
    if R % 2 != 0:
        raise ValueError(
            f"number of betas ({R}) must be even for replica exchange")
    if params.get_str("simulation", "engine", "auto") == "fused":
        raise NotImplementedError(FUSED_PT)
    n_sweeps = params.get_int("simulation", "n_sweeps")
    n_therms = params.get_int("simulation", "n_therms")
    n_bins = params.get_int("simulation", "n_bins")
    nt = params.get_int("simulation", "nt")
    if params.get_str("simulation", "n_stab").strip().lower() == "auto":
        raise ValueError("[simulation] n_stab = auto is not taken with "
                         "parallel tempering (nor by the JAX package's PT "
                         "driver): give an integer")
    n_stab = params.get_int("simulation", "n_stab")
    symmetric = params.get_bool("simulation", "symmetric", False)
    uneq = params.get_bool("simulation", "isMeasureUnequalTime", False)
    seed = params.get_int("simulation", "seed", 42)

    geometry = params.get_str("Lattice", "geometry", "square")
    lat = make_lattice(geometry, params.get_int("Lattice", "L1"),
                       params.get_int("Lattice", "L2"))
    if out_dir is not None:
        lat.save_info(os.path.join(out_dir, "info"))
    model_name = params.get_str("hubbard", "model", "attractive")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"[hubbard] model {model_name!r}: "
                         + " or ".join(sorted(MODEL_REGISTRY)))
    model_cls = MODEL_REGISTRY[model_name]
    build = lambda dt: stack_models([  # noqa: E731
        model_cls.from_params(params, lat, beta=b, dtype=dt, device=device)
        for b in betas])
    models = build(dtype)             # refuses checkerboard kinetics
    signed = models.det_power == 1
    cfg = make_engine_config(params, device, n_stab)
    aux = None
    if df_mode:
        aux = stack_aux([df_aux_build(
            lat, U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"), beta=b, nt=nt,
            bonds=bonds_with_tp(geometry,
                                params.get_float("hubbard", "tp", 0.0)),
            n_flavor=models.n_flavor, device=device) for b in betas])
    log(f"Parallel Tempering enabled: {R} replicas, betas={betas}, "
        f"{lat.L1}x{lat.L2}, nt={nt}, "
        f"dtype={'df32' if df_mode else str(dtype).replace('torch.', '')}, "
        f"f64_actions={f64_actions}, device={device}")

    gens = make_generators(seed, R, device)
    states = (init_state_df(models, aux, cfg, gens) if df_mode
              else init_state(models, cfg, gens))
    ex_gen = exchange_generator(seed, R)

    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path", "")
    if ckpt_every > 0 and not ckpt_path:
        if out_dir is None:
            raise ValueError("checkpoint_every > 0 without an output "
                             "directory needs [simulation] checkpoint_path")
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
    start_bin = start_therm = attempt = 0
    accepted = 0.0
    therm_done = False
    if ckpt_every > 0 and os.path.exists(ckpt_path):
        states, meta = load_checkpoint(ckpt_path, states)
        if meta.get("betas") != betas:
            raise ValueError(f"{ckpt_path} holds a run of betas "
                             f"{meta.get('betas')}, not {betas}")
        start_bin = int(meta["bin"])
        therm_done = bool(meta["therm_done"])
        start_therm = int(meta["therm_sweep"])
        attempt, accepted = int(meta["attempt"]), float(meta["accepted"])
        ex_gen.set_state(torch.tensor(meta["exchange_gen"],
                                      dtype=torch.uint8))
        log(f"Resumed PT run from {ckpt_path} at bin {start_bin}"
            + ("" if therm_done
               else f" (thermalization sweep pair {start_therm})"))

    manager = MeasurementManager(
        lat, n_walkers=R, out_dir=out_dir, device=device,
        measure_unequal=uneq, sink=params.get_str("io", "sink", "h5"),
        start_bin=start_bin)
    manager.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        manager.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        manager.add_charge()
    uneq_fn = manager.uneq_measure_fn

    def checkpoint(therm_flag: bool, therm_sweep: int = 0):
        manager.flush()
        _sync(device)
        save_checkpoint(ckpt_path, states, {
            "bin": manager.current_bin, "therm_done": therm_flag,
            "therm_sweep": therm_sweep, "n_stab": cfg.n_stab, "seed": seed,
            "betas": betas, "attempt": attempt, "accepted": accepted,
            "exchange_gen": ex_gen.get_state().tolist()})

    if df_mode:
        def step(states):
            return df_sweep_pair(models, aux, cfg, states)
    else:
        def step(states):
            return sweep_pair(models, cfg, states)

    def do_exchange():
        nonlocal states, attempt, accepted
        attempt += 1
        u = exchange_uniforms(ex_gen, R)
        if df_mode:
            states, acc = replica_exchange_df(aux, cfg, states, attempt, u,
                                              det_power=models.det_power)
        else:
            states, acc = replica_exchange(models, cfg, states, attempt, u,
                                           f64_actions=f64_actions)
        accepted += float(acc.double().mean())

    t0 = time.perf_counter()
    therm_err_max = 0.0
    if not therm_done:
        ckpt_stride = ckpt_every * max(n_sweeps, 1)
        for it in range(start_therm, n_therms):
            states = step(states)
            if (ckpt_every > 0 and (it + 1) % ckpt_stride == 0
                    and it + 1 < n_therms):
                checkpoint(False, therm_sweep=it + 1)
        therm_err_max = _stats(states)["err_max"]
        states = reset_error_stats(states)
        if ckpt_every > 0:
            checkpoint(True)
    _sync(device)
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds")
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = "
            f"{therm_err_max:.4e}")

    # the measurement: the tier rebuilds each replica's G with its own
    # beta (engine/parity's stacked tiers), else the engine's G is taken
    greens_fn = uneq_step = None
    if measure_prec != "engine":
        nm = tf32 if measure_prec == "tf32" else df32
        models64 = build(torch.float64)
        if uneq_fn is not None:
            stab = params.get_int("simulation", "measure_uneq_n_stab", 0)
            uneq_step = measurement_uneq_fn_stacked(
                models64, cfg, nm, uneq_fn, symmetric=symmetric,
                n_stab=stab if stab > 0 else None, emit_greens=True)
            log(f"PT measurement tier: tau-resolved Gt0/G0t/Gtt + "
                f"equal-time G rebuilt per replica at {measure_prec}")
        else:
            stab = params.get_int("simulation", "measure_n_stab", 0)
            greens_fn = measurement_greens_fn_stacked(
                models64, cfg, nm, symmetric=symmetric,
                n_stab=stab if stab > 0 else None)
            log(f"PT measurement tier: equal-time G rebuilt per replica "
                f"at {measure_prec}")
    elif uneq_fn is not None:
        view = f32_view if df_mode else (lambda s: s)
        uneq_step = lambda s: (*sweep_unequal_time(  # noqa: E731
            models, cfg, view(s), measure_fn=uneq_fn, warp=symmetric), None)
    warp = (lambda G: half_warp(models, G)) if symmetric else None

    err_uneq_max = 0.0
    total = (n_bins - start_bin) * n_sweeps
    t0 = time.perf_counter()
    t_first = 0.0
    n_first = 0
    for ibin in range(start_bin, n_bins):
        acc = {}
        for s in range(n_sweeps):
            k = ibin * n_sweeps + s        # over the whole run
            if (k + 1) % exchange_step == 0:
                if n_first == 0 and k > start_bin * n_sweeps:
                    # the first segment, up to the first attempt, is the
                    # warm-up that the steady rate leaves out
                    _sync(device)
                    t_first = time.perf_counter() - t0
                    n_first = k - start_bin * n_sweeps
                do_exchange()
            states = step(states)
            ys = G = None
            if uneq_step is not None:
                *ys, G = uneq_step(states)
            if G is None:
                G = manager.measurement_greens(states, greens_fn=greens_fn,
                                               warp_fn=warp)
            manager.accumulate(acc, manager.increments(
                G, states.sign if signed else None, uneq=ys))
        err_uneq_max = max(err_uneq_max, manager.ingest_bin(acc, n_sweeps))
        if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
            checkpoint(True)
    _sync(device)
    dt_meas = time.perf_counter() - t0
    manager.close()

    stats = _stats(states)
    acc_rate = stats["acc_sum_mean"] / (2.0 * max(n_therms
                                                  + n_bins * n_sweeps, 1))
    err_max = max(stats["err_max"], err_uneq_max)
    err_mean = stats["err_sum"] / max(stats["err_count"], 1)
    exchange_rate = accepted / attempt if attempt else 0.0
    rate = total * R / dt_meas if dt_meas > 0 else float("inf")
    n_steady, dt_steady = total - n_first, dt_meas - t_first
    steady = (n_steady * R / dt_steady if n_first and dt_steady > 0
              else float("nan"))
    log(f"Average acceptance rate = {acc_rate:.4f}")
    log(f"Max, Mean Precision Error (steady-state) = {err_max:.4e}, "
        f"{err_mean:.4e}")
    log(f"Parallel tempering exchange rate = {exchange_rate:.4f}")
    log(f"Measurement phase: {dt_meas:.2f} s for {total} sweeps x {R} "
        f"replicas = {rate:.2f} replica-sweeps/s ({steady:.2f} steady, "
        f"first segment {t_first:.1f} s excluded)")
    rows = manager.bin_walker_scalars
    observables = {n: float(np.mean([b[n][0] for b in rows]))
                   for n in (rows[0] if rows else {})}
    return RunSummary(
        n_walkers=R, n_bins=n_bins, n_sweeps=n_sweeps,
        therm_seconds=dt_therm, measure_seconds=dt_meas,
        sweeps_per_sec=rate, acc_rate=acc_rate,
        max_precision_error=err_max, mean_precision_error=err_mean,
        therm_max_precision_error=therm_err_max, n_stab=cfg.n_stab,
        device=str(device), err_uneq_max=err_uneq_max,
        observables=observables, walker_signs=states.sign.tolist(),
        states=states, exchange_rate=exchange_rate)
