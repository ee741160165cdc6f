"""Parallel tempering (replica exchange) over the walker axis.

PyTorch counterpart of ``dqmc_tpu/parallel/tempering.py`` (the reference's
MPI replica exchange, update.cpp:34-117, main.cpp:39-73,147-153):

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

The replicas spread over processes and devices in contiguous chunks, as
the standard driver's walkers do (``parallel/walkers.py``), where the
split divides them (JAX tempering.py:319-329).  An attempt gathers every
replica's fields and sign on the host, each chunk computes its replicas'
actions, the actions are gathered, and every process takes the same
decisions from the same coins (:func:`exchange_chunks`); an accepted
replica takes its partner's fields and sign and rebuilds its stack from
them, so only fields, signs and actions travel.

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

import torch

from dqmc_tpu_torch.engine.sweep import (half_warp, init_state,
                                         rebuild_stack_and_greens,
                                         reset_error_stats, sweep_pair)
from dqmc_tpu_torch.ops.linalg import LDR
from dqmc_tpu_torch.parallel import distributed
from dqmc_tpu_torch.parallel.distributed import global_stats, walker_values
from dqmc_tpu_torch.parallel.walkers import (cast_model, gather_walkers,
                                             split_walkers, stack_models,
                                             take_replicas, walker_layout,
                                             with_shared_order)

FUSED_PT = (
    "parallel tempering with engine = fused: the fused engine takes one "
    "shared expK and g for the whole walker batch, and parallel tempering "
    "runs a beta per walker on the per-slice engine, as the JAX package "
    "does (ROADMAP: queue 2, item 5, the fused engine for parallel "
    "tempering, with a (g, expK) per walker)")


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
    """The joint Metropolis decision per replica with one coin per pair,
    on the host: accept on u[min(r, p)] < exp(-[S_r(s_p) + S_p(s_r) -
    S_r(s_r) - S_p(s_p)])."""
    S_self, S_cross, partner = S_self.cpu(), S_cross.cpu(), partner.cpu()
    dS = S_cross + S_cross[partner] - S_self - S_self[partner]
    pair = torch.minimum(torch.arange(len(partner)), partner)
    u = torch.as_tensor(u).cpu().to(torch.float64)
    return u[pair] < torch.exp(-dS.to(torch.float64))


def exchange_actions(model, cfg, states, partner, f64_actions=False,
                     fields_p=None):
    """(S_self, S_cross, (stack, G, log_det) of the partners' fields) per
    replica: S_self the action of each replica's own fields under its own
    beta, S_cross of its partner's fields (``fields_p``, by default the
    partners' among ``states``).  ``f64_actions`` (for a non-float64
    chain) takes both from float64 rebuilds through a float64 cast of the
    model, and casts the partners' state back to the chain's dtype."""
    if fields_p is None:
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


def exchange_actions_df(aux, cfg, states, fields_p, det_power: int = 2):
    """The df32 chain's (S_self, S_cross, (stack, G_df, log_det) of the
    partners' fields) (JAX tempering.py:152-202): the chain's own df
    log-det and one df stack rebuild of ``fields_p``, the bosonic part the
    exact state-count dot (``df_global_action``)."""
    from dqmc_tpu_torch.engine.df_sweep import (df_global_action,
                                                rebuild_stack_df)
    S_self = df_global_action(aux, states.fields, states.log_det_M,
                              det_power)
    stack, G_df, ld = rebuild_stack_df(aux, cfg, fields_p)
    return (S_self, df_global_action(aux, fields_p, ld, det_power),
            (stack, G_df, ld))


def _swap(states, accept, fields_p, sign_p, rebuilt):
    """Accepted replicas take the partner's fields and sign (the
    Metropolis sign belongs to the configuration) with the stack, G and
    log-det rebuilt from them under their own beta; rejected ones keep
    their state."""
    sel = lambda new, old: _select(accept, new, old)  # noqa: E731
    stack, G, ld = rebuilt
    common = dict(fields=sel(fields_p, states.fields),
                  log_det_M=sel(ld, states.log_det_M),
                  sign=sel(sign_p, states.sign))
    if not hasattr(states, "G_df"):
        return dataclasses.replace(
            states, G=sel(G, states.G),
            stack=LDR(*(sel(a, b) for a, b in zip(stack, states.stack))),
            **common)
    from dqmc_tpu_torch.ops.df32 import DF
    from dqmc_tpu_torch.ops.df_linalg import LDRdf
    seld = lambda new, old: DF(sel(new.hi, old.hi),  # noqa: E731
                               sel(new.lo, old.lo))
    return dataclasses.replace(
        states, G=sel(G.hi, states.G), G_df=seld(G, states.G_df),
        stack=LDRdf(seld(stack.L, states.stack.L),
                    seld(stack.d, states.stack.d),
                    seld(stack.R, states.stack.R),
                    sel(stack.e, states.stack.e)), **common)


def exchange_chunks(models, cfg, chunks, firsts, n_replicas: int,
                    attempt: int, u, *, f64_actions: bool = False,
                    auxs=None, det_power: int = 2):
    """One replica-exchange attempt over replicas spread in chunks over
    devices and processes: chunk c holds the global replicas [firsts[c],
    firsts[c] + its size) under ``models[c]`` (df32: ``auxs[c]``), and
    every process calls this alike (it gathers).  Every replica's fields
    and sign are gathered on the host; each chunk computes its replicas'
    actions and rebuilds its partners' fields under its own betas; the
    actions are gathered and every process takes the same decisions on
    the host from the same uniforms ``u`` (R,).  Returns (chunks, accept
    (R,) bool on the host)."""
    partner = partner_indices(n_replicas, attempt)
    fields = distributed.all_gather_walkers(
        torch.cat([s.fields.cpu() for s in chunks]))
    signs = distributed.all_gather_walkers(
        torch.cat([s.sign.cpu() for s in chunks]))
    parts = []
    for c, (s, first) in enumerate(zip(chunks, firsts)):
        p = partner[first:first + s.fields.shape[0]]
        fields_p = fields[p].to(s.fields.device)
        parts.append((p, fields_p, exchange_actions_df(
            auxs[c], cfg, s, fields_p, det_power) if auxs is not None
            else exchange_actions(models[c], cfg, s, p, f64_actions,
                                  fields_p)))
    S_self, S_cross = (distributed.all_gather_walkers(
        torch.cat([act[j].cpu() for _, _, act in parts])) for j in (0, 1))
    accept = _decide(S_self, S_cross, partner, u)
    out = []
    for s, first, (p, fields_p, act) in zip(chunks, firsts, parts):
        dev = s.fields.device
        out.append(_swap(s, accept[first:first + len(p)].to(dev), fields_p,
                         signs[p].to(dev), act[2]))
    return out, accept


def replica_exchange(model, cfg, states, attempt: int, u,
                     f64_actions: bool = False):
    """One replica-exchange attempt over the walker axis of a
    replica-stacked model: (states, accept (R,) bool), each pair sharing
    one decision.  ``u`` (R,) are the attempt's uniforms
    (:func:`exchange_uniforms`); rejected replicas keep their state as it
    was, accepted ones take the partner's fields and sign with the stack,
    G and log-det rebuilt under their own beta."""
    (states,), accept = exchange_chunks(
        [model], cfg, [states], [0], states.fields.shape[0], attempt, u,
        f64_actions=f64_actions)
    return states, accept


def replica_exchange_df(aux, cfg, states, attempt: int, u,
                        det_power: int = 2):
    """Replica exchange of a df32 chain (JAX tempering.py:152-202): the
    protocol of :func:`replica_exchange` with both actions at df accuracy
    (:func:`exchange_actions_df`).  ``aux`` is a replica-stacked
    ``DFModelAux`` (``df_sweep.stack_aux``)."""
    (states,), accept = exchange_chunks(
        None, cfg, [states], [0], states.fields.shape[0], attempt, u,
        auxs=[aux], det_power=det_power)
    return states, accept


# ----------------------------------------------------------------------
# the PT driver (main.cpp's PT branch)
# ----------------------------------------------------------------------

def run_parallel_tempering(params, *, out_dir: str | None = "results",
                           verbose: bool = True, device="cuda",
                           devices=None):
    """Run the parallel-tempering simulation ``params`` describes on
    ``device`` ([ParallelTempering] betas, sweep_steps, f64_actions);
    replica r's bins go to ``out_dir/data_<r>``.  The replicas spread over
    the processes of [distributed] and over [walkers] n_devices (or
    ``devices``) in contiguous chunks, as the standard driver's walkers
    do; a split that does not divide them runs one chunk, as JAX
    tempering.py:319-329 runs unsharded.  Returns the port's RunSummary,
    its ``observables`` replica 0's (the first beta's)."""
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
    from dqmc_tpu_torch.run import (RunSummary, _resolve_dtype, _sync,
                                    find_resume, global_observables,
                                    make_engine_config,
                                    process_checkpoint_path, run_devices)

    device = torch.device(device)
    log = distributed.rank0_log(verbose)
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

    # replicas over processes and devices: chunk c holds the global
    # replicas firsts[c] .. firsts[c] + per - 1
    nproc = distributed.process_count()
    devs, rank_offset, n_local = walker_layout(
        R, run_devices(params, device, devices), what="replicas")
    device = devs[0]
    per = n_local // len(devs)
    firsts = [rank_offset + c * per for c in range(len(devs))]

    geometry = params.get_str("Lattice", "geometry", "square")
    lat = make_lattice(geometry, params.get_int("Lattice", "L1"),
                       params.get_int("Lattice", "L2"))
    if out_dir is not None:
        if distributed.process_index() == 0:
            lat.save_info(os.path.join(out_dir, "info"))
        os.makedirs(out_dir, exist_ok=True)
    model_name = params.get_str("hubbard", "model", "attractive")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"[hubbard] model {model_name!r}: "
                         + " or ".join(sorted(MODEL_REGISTRY)))
    model_cls = MODEL_REGISTRY[model_name]
    build = lambda dt: stack_models([  # noqa: E731
        model_cls.from_params(params, lat, beta=b, dtype=dt, device=device)
        for b in betas])
    ladder = build(dtype)             # refuses checkerboard kinetics

    def chunked(stacked):
        return [take_replicas(stacked, f, f + per, d)
                for f, d in zip(firsts, devs)]
    models = chunked(ladder)
    signed = ladder.det_power == 1
    cfg = make_engine_config(params, device, n_stab)
    auxs = None
    if df_mode:
        auxs = chunked(stack_aux([df_aux_build(
            lat, U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"), beta=b, nt=nt,
            bonds=bonds_with_tp(geometry,
                                params.get_float("hubbard", "tp", 0.0)),
            n_flavor=ladder.n_flavor, device=device) for b in betas]))
    log(f"Parallel Tempering enabled: {R} replicas, betas={betas}, "
        f"{lat.L1}x{lat.L2}, nt={nt}, "
        f"dtype={'df32' if df_mode else str(dtype).replace('torch.', '')}, "
        f"f64_actions={f64_actions}, device={device}")
    if len(devs) > 1 or nproc > 1:
        log(f"Sharded {R} replicas over {len(devs)} devices ({nproc} "
            f"process(es))")

    gens = [make_generators(seed, R, d, first=f, count=per)
            for d, f in zip(devs, firsts)]
    chunks = [init_state_df(m, a, cfg, g) if df_mode else
              init_state(m, cfg, g)
              for m, a, g in zip(models, auxs or models, gens)]
    ex_gen = exchange_generator(seed, R)

    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path", "")
    if ckpt_every > 0 and not ckpt_path:
        if out_dir is None:
            raise ValueError("checkpoint_every > 0 without an output "
                             "directory needs [simulation] checkpoint_path")
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
    own_ckpt = process_checkpoint_path(ckpt_path, nproc,
                                       distributed.process_index())
    start_bin = start_therm = attempt = 0
    accepted = 0.0
    therm_done = False
    resume = find_resume(ckpt_path) if ckpt_every > 0 else None
    if resume:
        states, meta = load_checkpoint(resume, gather_walkers(chunks))
        if meta.get("betas") != betas:
            raise ValueError(f"{resume} holds a run of betas "
                             f"{meta.get('betas')}, not {betas}")
        chunks = split_walkers(states, devs)
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
        lat, n_walkers=n_local, out_dir=out_dir, device=device,
        measure_unequal=uneq, sink=params.get_str("io", "sink", "h5"),
        start_bin=start_bin, rank_offset=rank_offset)
    manager.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        manager.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        manager.add_charge()
    uneq_fn = manager.uneq_measure_fn

    def checkpoint(therm_flag: bool, therm_sweep: int = 0):
        manager.flush()
        _sync(devs)
        save_checkpoint(own_ckpt, gather_walkers(chunks), {
            "bin": manager.current_bin, "therm_done": therm_flag,
            "therm_sweep": therm_sweep, "n_stab": cfg.n_stab, "seed": seed,
            "betas": betas, "attempt": attempt, "accepted": accepted,
            "exchange_gen": ex_gen.get_state().tolist(),
            "num_processes": nproc, "rank_offset": rank_offset})

    def base_step(c):
        if df_mode:
            return lambda m, cfg, s, streams=None: df_sweep_pair(
                m, auxs[c], cfg, s, streams=streams)
        return lambda m, cfg, s, streams=None: sweep_pair(
            m, cfg, s, streams=streams)
    steps = with_shared_order([base_step(c) for c in range(len(devs))],
                              chunks, firsts, devs, cfg.use_pallas, False)

    def advance(chunks):
        return [step(m, cfg, s) for step, m, s in zip(steps, models, chunks)]

    def do_exchange():
        nonlocal chunks, attempt, accepted
        attempt += 1
        u = exchange_uniforms(ex_gen, R)
        chunks, acc = exchange_chunks(
            models, cfg, chunks, firsts, R, attempt, u,
            f64_actions=f64_actions, auxs=auxs,
            det_power=ladder.det_power)
        accepted += float(acc.double().mean())

    t0 = time.perf_counter()
    therm_err_max = 0.0
    if not therm_done:
        ckpt_stride = ckpt_every * max(n_sweeps, 1)
        for it in range(start_therm, n_therms):
            chunks = advance(chunks)
            if (ckpt_every > 0 and (it + 1) % ckpt_stride == 0
                    and it + 1 < n_therms):
                checkpoint(False, therm_sweep=it + 1)
        therm_err_max = global_stats(chunks)["err_max"]
        chunks = [reset_error_stats(s) for s in chunks]
        if ckpt_every > 0:
            checkpoint(True)
    _sync(devs)
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds")
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = "
            f"{therm_err_max:.4e}")

    # the measurement: the tier rebuilds each replica's G with its own
    # beta (engine/parity's stacked tiers, one stride for the whole
    # ladder), else the engine's G is taken
    fns = [(None, None)] * len(devs)
    if measure_prec != "engine":
        nm = tf32 if measure_prec == "tf32" else df32
        ladder64 = build(torch.float64)
        if uneq_fn is not None:
            stab = params.get_int("simulation", "measure_uneq_n_stab", 0)
            stab = measurement_uneq_fn_stacked(
                ladder64, cfg, nm, uneq_fn, symmetric=symmetric,
                n_stab=stab if stab > 0 else None, emit_greens=True).n_stab
            fns = [(None, measurement_uneq_fn_stacked(
                m64, cfg, nm, uneq_fn, symmetric=symmetric, n_stab=stab,
                emit_greens=True)) for m64 in chunked(ladder64)]
            log(f"PT measurement tier: tau-resolved Gt0/G0t/Gtt + "
                f"equal-time G rebuilt per replica at {measure_prec}")
        else:
            stab = params.get_int("simulation", "measure_n_stab", 0)
            fns = [(measurement_greens_fn_stacked(
                m64, cfg, nm, symmetric=symmetric,
                n_stab=stab if stab > 0 else None), None)
                for m64 in chunked(ladder64)]
            log(f"PT measurement tier: equal-time G rebuilt per replica "
                f"at {measure_prec}")
    elif uneq_fn is not None:
        view = f32_view if df_mode else (lambda s: s)
        fns = [(None, lambda s, m=m: (*sweep_unequal_time(
            m, cfg, view(s), measure_fn=uneq_fn, warp=symmetric), None))
            for m in models]
    warps = [(lambda G, m=m: half_warp(m, G)) if symmetric else None
             for m in models]

    err_uneq_max = 0.0
    total = (n_bins - start_bin) * n_sweeps
    t0 = time.perf_counter()
    t_first = 0.0
    n_first = 0
    for ibin in range(start_bin, n_bins):
        accs = [{} for _ in chunks]
        for s in range(n_sweeps):
            k = ibin * n_sweeps + s        # over the whole run
            if (k + 1) % exchange_step == 0:
                if n_first == 0 and k > start_bin * n_sweeps:
                    # the first segment, up to the first attempt, is the
                    # warm-up that the steady rate leaves out
                    _sync(devs)
                    t_first = time.perf_counter() - t0
                    n_first = k - start_bin * n_sweeps
                do_exchange()
            chunks = advance(chunks)
            for acc, st, (greens_fn, uneq_step), warp in zip(
                    accs, chunks, fns, warps):
                ys = G = None
                if uneq_step is not None:
                    *ys, G = uneq_step(st)
                if G is None:
                    G = manager.measurement_greens(st, greens_fn=greens_fn,
                                                   warp_fn=warp)
                manager.accumulate(acc, manager.increments(
                    G, st.sign if signed else None, uneq=ys))
        err_uneq_max = max(err_uneq_max, distributed.all_max(
            manager.ingest_bin(manager.merge(accs), n_sweeps)))
        if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
            checkpoint(True)
    _sync(devs)
    dt_meas = distributed.all_max(time.perf_counter() - t0)
    manager.close()

    stats = global_stats(chunks)
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
    return RunSummary(
        n_walkers=R, n_bins=n_bins, n_sweeps=n_sweeps,
        therm_seconds=dt_therm, measure_seconds=dt_meas,
        sweeps_per_sec=rate, acc_rate=acc_rate,
        max_precision_error=err_max, mean_precision_error=err_mean,
        therm_max_precision_error=therm_err_max, n_stab=cfg.n_stab,
        device=str(device), err_uneq_max=err_uneq_max,
        observables=global_observables(manager, walker=0),
        walker_signs=walker_values(chunks, "sign").tolist(),
        states=gather_walkers(chunks), exchange_rate=exchange_rate)
