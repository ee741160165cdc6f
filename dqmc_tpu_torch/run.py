"""Simulation driver: ``python -m dqmc_tpu_torch``.

PyTorch counterpart of ``dqmc_tpu/run.py`` for the slice the port serves so
far: the attractive (``[hubbard] model = attractive``, one stored flavor)
and the repulsive (``model = repulsive``, two flavors with a tracked
Metropolis sign) Hubbard model with dense kinetics on any of the package's
lattices or checkerboard kinetics on the square lattice, walker-batched
through the fused block engine (the wrap/site-loop kernels) or
the per-slice engine (the delayed, submatrix and rank-1 site-update
kernels), with the CGS2 QR kernel for float32
stabilization on CUDA and plain twins on the CPU; float32 or float64,
equal-time measurement of density, doubleOcc, swave and densityCorr, plus
spinZZCorr and spinXXCorr with ``measure_spin = true``, sign-weighted with
a ``sign`` scalar for the repulsive model, binned HDF5 output that
``python -m dqmc_tpu.analysis`` reads and reweights.

``isMeasureUnequalTime = true`` runs the unequal-time sweep after every
measured sweep pair (``engine/uneqtime.py``, K1 in every block-end triplet
in float32) and bins greenTau, doublonTau and currxxTau, plus spinzzTau and
spinxxTau with ``measure_spin`` and densityTau with ``measure_charge``; on
the df32 engine it runs on the walkers' float32 view (``f32_view``).

``[simulation] dtype = df32`` runs the hybrid double-float32 engine
(``engine/df_sweep.py``: the per-slice engine's float32 site updates and
wraps, df32 block products, folds and stabilized inverses, with panel
kernel #7 in every fold).  ``measure_precision = df32 | tf32`` measures
every equal-time observable on a Green's function rebuilt from the fields
at that multiword grade (``engine/parity.py``; #7 or #8 in every fold),
whatever the sampling engine; ``measure_n_stab`` sets the rebuild's stride.
With unequal-time measurement on, the tier rebuilds the whole tau-resolved
triplet instead (``measurement_uneq_fn``, stride ``measure_uneq_n_stab``),
and its G00 is the equal-time measurement's G.

``[hubbard] checkerboard = true`` applies every kinetic factor through
the checkerboard groups (``models/kinetic.py``); the fused engine does not
take it, so ``engine = auto`` runs it on the per-slice engine.  The df32
engine and the multiword tiers build their products from the dense expK
and refuse it (ROADMAP.md section 3, "Faults of the reference").

``[simulation] checkpoint_every = N`` saves the chain (``io/checkpoint.py``)
every N bins and every N * n_sweeps thermalization pairs to
``checkpoint_path`` (default ``<out_dir>/checkpoint.npz``); a run that
finds that file resumes from it where it stopped, mid-thermalization
included, at the n_stab it had adapted to, continuing the bin numbering.
``[io] sink = spool`` writes the bins to ``data_<w>.spool`` logs
(``io/spool.py``, numpy only) and converts them to ``data_<w>.h5`` at the
end where h5py is installed.

``[ParallelTempering] enabled = true`` runs one walker per beta of
``betas`` on the per-slice engine with replica exchange every
``sweep_steps`` measured sweeps (``parallel/tempering.py``), replica r's
bins in ``data_<r>``.

``[walkers] n_devices`` spreads a process's walkers over its GPUs (0:
every visible one; ``parallel/walkers.py``), in contiguous chunks that
each run the engine the unsplit run takes (the JAX package's ``auto``
drops its fused engine on a sharded mesh; here a chunk is a batch like any
other, so a walker's chain does not depend on n_devices).  ``[distributed]
num_processes``, ``process_id``, ``coordinator_address`` and ``timeout``
run one process per share of the walkers (``parallel/distributed.py``,
gloo): process p writes ``data_<p * n_walkers / num_processes + w>``, and
every decision all processes must take alike (n_stab = auto, the
warning, the summary) reads every walker's statistics.  A split run makes
the unsplit run's chains and bins.  ``[simulation] profile_dir`` traces
the first measured bin with torch.profiler into
``<profile_dir>/trace_<process>.json``.

``[simulation] engine``: ``auto`` takes the fused engine on CUDA in float32
when it supports the model (ns <= 512, dense kinetics, rank-k buffers that
fit one CTA's shared memory) and the per-slice engine otherwise, as the JAX
package does; ``fused`` and ``slice`` force one.  ``fused_update`` (delayed /
submatrix) picks the fused block's in-slice scheme.  ``site_update``
(pallas / scan / delayed / submatrix, default pallas on CUDA and scan on
the CPU) and ``delay_rank`` configure the per-slice engine as in the JAX
package.

Reads ``parameters.in`` (the JAX package's schema) from the working
directory.  ``--device`` selects the device (``cuda`` by default; CPU runs
say ``--device cpu``); nothing falls back to the CPU when CUDA is missing.
Every configuration outside the slice raises NotImplementedError naming
the ROADMAP item that will port it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.engine.df_sweep import (CHECKERBOARD_DF32,
                                            df_aux_build, df_sweep_pair,
                                            f32_view, init_state_df,
                                            rebuild_stack_df)
from dqmc_tpu_torch.engine.fused import supports_fused, sweep_pair_fused
from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
from dqmc_tpu_torch.engine.sweep import (half_warp, init_state,
                                         rebuild_stack_and_greens,
                                         reset_error_stats, sweep_pair)
from dqmc_tpu_torch.engine.parity import (CHECKERBOARD_TIER,
                                          measurement_greens_fn,
                                          measurement_uneq_fn)
from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
from dqmc_tpu_torch.io.checkpoint import (load_checkpoint, peek_meta,
                                          save_checkpoint)
from dqmc_tpu_torch.lattice import bonds_with_tp, make_lattice
from dqmc_tpu_torch.measure.manager import MeasurementManager
from dqmc_tpu_torch.models import MODEL_REGISTRY
from dqmc_tpu_torch.ops import df32, tf32
from dqmc_tpu_torch.parallel import distributed
from dqmc_tpu_torch.parallel.distributed import global_stats, walker_values
from dqmc_tpu_torch.parallel.walkers import (gather_walkers, local_devices,
                                             split_walkers, to_device,
                                             walker_layout,
                                             with_shared_order)


def _unported(params: Parameters):
    """(what, ROADMAP item) for every requested feature outside the slice."""
    get_s = params.get_str
    return [
        (what, item) for on, what, item in [
            (get_s("simulation", "wrap_precision", "highest") != "highest",
             "wrap_precision other than highest",
             "not to port (TPU MXU-pass knob)"),
            (get_s("simulation", "matmul_precision", "highest")
             != "highest", "matmul_precision other than highest",
             "not to port (TPU MXU-pass knob)"),
        ] if on]


def _resolve_dtype(params: Parameters, device: torch.device):
    """(dtype, df_mode) from [simulation] dtype: df32 runs the hybrid
    double-float32 engine on float32 kernels."""
    name = params.get_str("simulation", "dtype", "")
    if name in ("df32", "df"):
        return torch.float32, True
    if name in ("float32", "f32"):
        return torch.float32, False
    if name in ("float64", "f64"):
        return torch.float64, False
    if name:
        raise ValueError(f"[simulation] dtype {name!r}: float32, float64 "
                         f"or df32")
    return (torch.float32 if device.type == "cuda" else torch.float64), False


def _parse_n_stab(params: Parameters):
    """(start_value, auto_flag) for [simulation] n_stab (``auto`` tunes it
    during thermalization, as in the JAX driver)."""
    raw = params.get_str("simulation", "n_stab").strip().lower()
    if raw == "auto":
        return params.get_int("simulation", "n_stab_start", 5), True
    return params.get_int("simulation", "n_stab"), False


def make_engine_config(params: Parameters, device: torch.device,
                       n_stab: int) -> EngineConfig:
    """EngineConfig from the [simulation] section (run.py:112-143 of the
    JAX package): ``site_update`` is pallas (the default on CUDA), scan
    (the default on the CPU), delayed or submatrix; the last two take
    their rank from ``delay_rank`` (default 32).  ``submatrix`` takes the
    shared-order kernel on CUDA and the per-walker-order scheme on the
    CPU.  The default holds for both models: a 2-flavor model under pallas
    takes the 2-flavor delayed kernel."""
    on_cuda = device.type == "cuda"
    impl = params.get_str("simulation", "site_update",
                          "pallas" if on_cuda else "scan")
    delay = params.get_int("simulation", "delay_rank", 32)
    common = dict(nt=params.get_int("simulation", "nt"), n_stab=n_stab,
                  fused_update=params.get_str("simulation", "fused_update",
                                              "delayed"))
    if common["fused_update"] not in ("delayed", "submatrix"):
        raise ValueError(f"[simulation] fused_update "
                         f"{common['fused_update']!r}: delayed or submatrix")
    if impl == "pallas":
        return EngineConfig(use_pallas=True, **common)
    if impl == "delayed":
        return EngineConfig(delay_rank=delay, **common)
    if impl == "submatrix":
        return EngineConfig(submatrix_rank=delay, use_pallas=on_cuda,
                            **common)
    if impl == "scan":
        return EngineConfig(**common)
    raise ValueError(f"[simulation] site_update {impl!r}: pallas, scan, "
                     f"delayed or submatrix")


def use_fused_engine(params: Parameters, model, device: torch.device,
                     dtype, cfg: EngineConfig | None = None) -> bool:
    """``engine``: auto takes the fused engine when it supports the model
    and the config's ``fused_update`` on CUDA in float32 (run.py:367-380 of
    the JAX package); fused and slice force one (a forced fused engine
    raises on what it does not support)."""
    kind = params.get_str("simulation", "engine", "auto")
    if kind == "auto":
        return (supports_fused(model, cfg) and device.type == "cuda"
                and dtype == torch.float32)
    if kind in ("fused", "slice"):
        return kind == "fused"
    raise ValueError(f"[simulation] engine {kind!r}: auto, fused or slice")


@dataclasses.dataclass
class RunSummary:
    n_walkers: int
    n_bins: int
    n_sweeps: int
    therm_seconds: float
    measure_seconds: float
    sweeps_per_sec: float          # sweep-pairs/sec summed over walkers
    acc_rate: float
    max_precision_error: float     # steady-state (measurement phase only)
    mean_precision_error: float
    therm_max_precision_error: float
    n_stab: int                    # final (possibly auto-adapted) value
    device: str
    # the unequal-time sweep's largest self-check deviation over the
    # measured bins (0.0 without unequal-time measurement); folded into
    # max_precision_error
    err_uneq_max: float = 0.0
    # scalar observables averaged over walkers and bins
    observables: dict = dataclasses.field(default_factory=dict)
    # each walker's Metropolis sign at the end (all +1 for sign-free models)
    walker_signs: list = dataclasses.field(default_factory=list)
    # the final walker states of this process (WalkerState, or
    # DFWalkerState for df32), its chunks gathered on its first device
    states: object = None
    # parallel tempering: accepted exchanges per attempt (0.0 without PT)
    exchange_rate: float = 0.0


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _maybe_init_distributed(params: Parameters) -> None:
    """Form the process group when [distributed] asks for one (JAX
    run.py:172-183; the reference's mpirun + MPI_Init, main.cpp:20-28):
    ``num_processes``, ``process_id`` (else RANK from the environment),
    ``coordinator_address`` (host:port; else env:// rendezvous) and
    ``timeout`` (seconds a collective waits for a peer).  A no-op for one
    process."""
    nproc = params.get_int("distributed", "num_processes", 0)
    pid = params.get_int("distributed", "process_id", -1)
    distributed.initialize_distributed(
        params.get_str("distributed", "coordinator_address", "") or None,
        nproc or None, pid if pid >= 0 else None,
        params.get_float("distributed", "timeout",
                         distributed.DEFAULT_TIMEOUT_S))


def run_devices(params: Parameters, device: torch.device, devices=None):
    """The devices this process spreads its walkers over: ``devices``
    when the caller gives them (a list of torch devices), else [walkers]
    n_devices over the visible GPUs of ``device``'s type."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    return local_devices(params.get_int("walkers", "n_devices", 0), device)


def process_checkpoint_path(path: str, nproc: int, rank: int) -> str:
    """The checkpoint file of process ``rank`` of ``nproc``: ``path``
    itself for one process, ``<stem>_<rank><ext>`` for several."""
    if nproc == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_{rank}{ext}"


def find_resume(path: str) -> str | None:
    """This process's checkpoint under ``path`` when every process has
    one, None when none has; refuses a checkpoint written under another
    process count, naming both counts, and a run where only some
    processes find theirs."""
    nproc, rank = distributed.process_count(), distributed.process_index()
    own = process_checkpoint_path(path, nproc, rank)
    found = os.path.exists(own)
    # the other layout's file: one process's, or process 0's of several
    other = (process_checkpoint_path(path, 2, 0) if nproc == 1 else path)
    probe = own if found else other if os.path.exists(other) else None
    if probe is not None:
        written = int(peek_meta(probe).get("num_processes", 1))
        if written != nproc:
            raise ValueError(
                f"{probe} was written by a run of {written} process(es) "
                f"and this run has {nproc}: resume it with [distributed] "
                f"num_processes = {written}")
    if not distributed.all_agree(int(found)):
        raise ValueError(f"only some processes find their checkpoint "
                         f"under {path} ({own} is "
                         f"{'there' if found else 'missing'})")
    return own if found else None


def global_observables(manager, walker=None) -> dict:
    """The bins' scalar observables averaged over the bins: each bin's
    mean over every walker of every process, or walker ``walker``'s value
    (parallel tempering reports replica 0's)."""
    rows = manager.bin_walker_scalars
    if not rows:
        return {}
    names = list(rows[0])
    local = torch.from_numpy(np.stack([np.stack([b[n] for n in names])
                                       for b in rows]))
    full = distributed.all_gather_walkers(local, dim=2).numpy()
    pick = ((lambda v: float(v.mean())) if walker is None
            else (lambda v: float(v[walker])))
    return {n: sum(pick(full[i, j]) for i in range(len(rows))) / len(rows)
            for j, n in enumerate(names)}


@contextlib.contextmanager
def profile_bin(profile_dir: str, devices, log):
    """Trace what runs inside under torch.profiler (the CPU and, on the
    card, CUDA) into ``<profile_dir>/trace_<process>.json``, a Chrome
    trace (JAX run.py:574-581 traces the first measured bin)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        _sync(devices)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{distributed.process_index()}.json"))
    log(f"Profiler trace written to {profile_dir}")


def run_simulation(params: Parameters, *, out_dir: str | None = "results",
                   verbose: bool = True, device="cuda",
                   devices=None) -> RunSummary:
    """Run the simulation ``params`` describes on ``device``; bins go to
    ``out_dir`` (None writes no files: the run then stops before any
    output and returns only its summary).  ``devices`` (a list of torch
    devices) spreads this process's walkers over those devices in place
    of [walkers] n_devices (a CPU test spreads them over [cpu, cpu])."""
    # the process group forms before anything else (JAX run.py:241-243)
    _maybe_init_distributed(params)
    log = distributed.rank0_log(verbose)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but "
                           "torch.cuda.is_available() is false; run with "
                           "--device cpu for a CPU run")
    unported = _unported(params)
    if unported:
        raise NotImplementedError(
            "not ported to dqmc_tpu_torch yet: " + "; ".join(
                f"{what} (ROADMAP: {item})" for what, item in unported))
    # full-precision float32 products: TF32 costs the stabilization
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if params.get_bool("ParallelTempering", "enabled", False):
        from dqmc_tpu_torch.parallel.tempering import run_parallel_tempering
        return run_parallel_tempering(params, out_dir=out_dir,
                                      verbose=verbose, device=device,
                                      devices=devices)

    dtype, df_mode = _resolve_dtype(params, device)
    measure_prec = params.get_str("simulation", "measure_precision",
                                  "engine")
    if measure_prec not in ("engine", "tf32", "df32"):
        raise ValueError(f"[simulation] measure_precision must be engine, "
                         f"tf32 or df32, got {measure_prec!r}")
    n_sweeps = params.get_int("simulation", "n_sweeps")
    n_therms = params.get_int("simulation", "n_therms")
    n_bins = params.get_int("simulation", "n_bins")
    nt = params.get_int("simulation", "nt")
    n_stab, n_stab_auto = _parse_n_stab(params)
    symmetric = params.get_bool("simulation", "symmetric", False)
    seed = params.get_int("simulation", "seed", 42)
    n_walkers = params.get_int("walkers", "n_walkers", 1)
    profile_dir = params.get_str("simulation", "profile_dir", "")

    # walkers over processes and devices (JAX run.py:186-206): this
    # process's walkers in contiguous chunks, one per device
    nproc = distributed.process_count()
    devs, rank_offset, n_local = walker_layout(
        n_walkers, run_devices(params, device, devices))
    device = devs[0]
    per = n_local // len(devs)
    firsts = [rank_offset + c * per for c in range(len(devs))]

    lat = make_lattice(params.get_str("Lattice", "geometry", "square"),
                       params.get_int("Lattice", "L1"),
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
    model = model_cls.from_params(params, lat, dtype=dtype, device=device)
    models = [model] + [to_device(model, d) for d in devs[1:]]
    signed = model.det_power == 1
    if model.checkerboard and df_mode:
        raise NotImplementedError(CHECKERBOARD_DF32)
    if model.checkerboard and measure_prec != "engine":
        raise NotImplementedError(CHECKERBOARD_TIER)
    # checkpoint / resume: the stack's slot count depends on n_stab, so an
    # adapted n_stab must be known before the states are built; several
    # processes keep one file each
    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path", "")
    if ckpt_every > 0 and not ckpt_path:
        if out_dir is None:
            raise ValueError("checkpoint_every > 0 without an output "
                             "directory needs [simulation] checkpoint_path")
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
    resume = find_resume(ckpt_path) if ckpt_every > 0 else None
    own_ckpt = process_checkpoint_path(ckpt_path, nproc,
                                       distributed.process_index())
    if resume and n_stab_auto:
        n_stab = int(peek_meta(resume).get("n_stab", n_stab))
    cfg = make_engine_config(params, device, n_stab)
    # each chunk takes the engine the unsplit run takes: every kernel
    # works per walker, so a chunk is a batch like any other
    fused = not df_mode and use_fused_engine(params, model, device, dtype,
                                             cfg)
    log(f"Standard DQMC run: {lat.L1}x{lat.L2} lattice, "
        f"beta={float(model.beta)}, nt={nt}, {n_walkers} walkers, "
        f"dtype={'df32' if df_mode else str(dtype).replace('torch.', '')}, "
        f"device={device}")
    if len(devs) > 1 or nproc > 1:
        log(f"Sharded {n_walkers} walkers over {len(devs)} devices "
            f"({nproc} process(es))")
    flavors = f"{model.n_flavor} flavor" + "s" * (model.n_flavor > 1)
    auxs = [None] * len(devs)
    if df_mode:
        aux = df_aux_build(
            lat, U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"), beta=float(model.beta),
            nt=nt, bonds=bonds_with_tp(
                params.get_str("Lattice", "geometry", "square"),
                params.get_float("hubbard", "tp", 0.0)),
            n_flavor=model.n_flavor, device=device)
        auxs = [aux] + [to_device(aux, d) for d in devs[1:]]
        log("Engine: df32 hybrid (f32 kernels, double-float32 "
            "stabilization)")
    elif fused:
        log(f"Engine: fused block (wrap + {cfg.fused_update} site-loop "
            f"kernels, {flavors})")
    else:
        two_pallas = cfg.use_pallas and model.n_flavor == 2
        scheme = ("submatrix" if cfg.submatrix_rank and not two_pallas else
                  "delayed" if cfg.use_pallas or cfg.delay_rank else "rank-1")
        order = "shared" if cfg.use_pallas else "per-walker"
        log(f"Engine: per slice ({scheme} site update, {order} visit "
            f"order, {flavors})")

    # walker w's generator is child w of the seed, whatever chunk holds it
    gens = [make_generators(seed, n_walkers, d, first=f, count=per)
            for d, f in zip(devs, firsts)]
    chunks = [init_state_df(m, a, cfg, g) if df_mode else
              init_state(m, cfg, g) for m, a, g in zip(models, auxs, gens)]
    start_bin = start_therm = 0
    therm_done = False
    if resume:
        states, meta = load_checkpoint(resume, gather_walkers(chunks))
        chunks = split_walkers(states, devs)
        start_bin = int(meta["bin"])
        therm_done = bool(meta["therm_done"])
        start_therm = int(meta["therm_sweep"])
        log(f"Resumed from {ckpt_path} at bin {start_bin}"
            + ("" if therm_done
               else f" (thermalization sweep pair {start_therm})"))

    def base_step(c):
        if df_mode:
            return lambda m, cfg, s, streams=None: df_sweep_pair(
                m, auxs[c], cfg, s, streams=streams)
        return sweep_pair_fused if fused else sweep_pair

    # the fused and shared-order engines visit every walker's sites in
    # walker 0's order: a chunk without the run's walker 0 draws it from
    # a copy of walker 0's generator
    steps = with_shared_order([base_step(c) for c in range(len(devs))],
                              chunks, firsts, devs,
                              fused or cfg.use_pallas, fused)

    def advance(chunks, cfg):
        """One sweep pair of every chunk, every launch issued before any
        wait."""
        return [step(m, cfg, s) for step, m, s in zip(steps, models, chunks)]

    manager = MeasurementManager(
        lat, n_walkers=n_local, out_dir=out_dir, device=device,
        measure_unequal=params.get_bool("simulation",
                                        "isMeasureUnequalTime", False),
        sink=params.get_str("io", "sink", "h5"), start_bin=start_bin,
        rank_offset=rank_offset)
    manager.add_defaults()
    if params.get_bool("simulation", "measure_spin", False):
        manager.add_spin()
    if params.get_bool("simulation", "measure_charge", False):
        manager.add_charge()
    uneq_fn = manager.uneq_measure_fn

    # the reference warns when the naive-vs-stabilized deviation exceeds
    # 1e-6 (dqmc.cpp:390-393); the f32 default reflects the single-precision
    # stabilization bound.  Applies to the steady-state error.
    err_warn = params.get_float("simulation", "err_warn_threshold",
                                1e-6 if dtype == torch.float64 else 1e-2)
    warned = False

    def reseat(chunks, cfg):
        """Rebuild stack + G from the fields under a new n_stab (the chain
        itself -- fields, generators, signs -- is untouched)."""
        out = []
        for m, a, states in zip(models, auxs, chunks):
            if df_mode:
                stack, G_df, log_det = rebuild_stack_df(a, cfg,
                                                        states.fields)
                out.append(dataclasses.replace(
                    states, G=G_df.hi, G_df=G_df, stack=stack,
                    log_det_M=log_det))
                continue
            stack, G, log_det = rebuild_stack_and_greens(m, cfg,
                                                         states.fields)
            out.append(dataclasses.replace(states, G=G, stack=stack,
                                           log_det_M=log_det))
        return out

    def reset(chunks):
        return [reset_error_stats(s) for s in chunks]

    models64 = None
    meas_stab = params.get_int("simulation", "measure_n_stab", 0)
    uneq_stab = params.get_int("simulation", "measure_uneq_n_stab", 0)

    def measured_fns(cfg):
        """Per chunk, (greens_fn, uneq_step) of the measurement phase for
        one n_stab value, rebuilt whenever it changes: the multiword
        tier's greens_fn (None for ``measure_precision = engine``), and
        the unequal-time step (None without unequal-time measurement),
        ``states -> (ys, err, G)``, G the tier's G00, which then is the
        equal-time G, or None on the engine-grade path."""
        nonlocal models64
        if measure_prec == "engine":
            if uneq_fn is None:
                return [(None, None)] * len(models)
            view = f32_view if df_mode else (lambda s: s)
            return [(None, lambda s, m=m: (*sweep_unequal_time(
                m, cfg, view(s), measure_fn=uneq_fn, warp=symmetric),
                None)) for m in models]
        if models64 is None:
            models64 = [model_cls.from_params(params, lat,
                                              dtype=torch.float64, device=d)
                        for d in devs]
        nm = tf32 if measure_prec == "tf32" else df32
        if uneq_fn is not None:
            fns = [(None, measurement_uneq_fn(
                m64, cfg, nm, uneq_fn, symmetric=symmetric,
                n_stab=uneq_stab if uneq_stab > 0 else None,
                emit_greens=True)) for m64 in models64]
            log(f"Measurement tier: tau-resolved Gtt/Gt0/G0t and the "
                f"equal-time G rebuilt at {measure_prec} (stride "
                f"{fns[0][1].n_stab})")
            return fns
        fns = [(measurement_greens_fn(
            m64, cfg, nm, symmetric=symmetric,
            n_stab=meas_stab if meas_stab > 0 else None), None)
            for m64 in models64]
        log(f"Measurement tier: equal-time G rebuilt at {measure_prec} "
            f"({'<1e-10' if measure_prec == 'tf32' else '~1e-8'} "
            f"fixed-field accuracy)")
        return fns

    def chunk_err_mean(chunks):
        s = global_stats(chunks)
        return s["err_sum"] / s["err_count"] if s["err_count"] else 0.0

    def checkpoint(therm_flag: bool, therm_sweep: int = 0):
        """Save the chain after a thermalization pair or a bin; the bins
        written so far go to disk first."""
        manager.flush()
        _sync(devs)
        save_checkpoint(own_ckpt, gather_walkers(chunks), {
            "bin": manager.current_bin, "therm_done": therm_flag,
            "therm_sweep": therm_sweep, "n_stab": cfg.n_stab, "seed": seed,
            "n_walkers": n_walkers, "num_processes": nproc,
            "rank_offset": rank_offset})

    # n_stab = auto: tune during thermalization to the loosest value whose
    # steady chunk error stays below the warn threshold (/16 hysteresis).
    # The marks are those of the whole phase, so a run resumed in
    # thermalization adapts where an uninterrupted one does.  Every
    # decision reads the statistics of every walker of every process.
    adapt_marks = ()
    if n_stab_auto and n_therms >= 4:
        k = min(8, n_therms // 2)
        adapt_marks = sorted({(i + 1) * n_therms // k for i in range(k - 1)})
    n_stab_cap = min(cfg.nt, 32)

    def adapt(chunks, cfg):
        err_mean = chunk_err_mean(chunks)
        new = cfg.n_stab
        if err_mean > err_warn and cfg.n_stab > 1:
            new = cfg.n_stab - 1
        elif err_mean < err_warn / 16 and cfg.n_stab < n_stab_cap:
            new = cfg.n_stab + 1
        chunks = reset(chunks)
        if new == cfg.n_stab:
            return chunks, cfg
        cfg = dataclasses.replace(cfg, n_stab=new)
        log(f"n_stab auto: chunk err_mean {err_mean:.2e} "
            f"(warn {err_warn:.0e}) -> n_stab = {new}")
        return reseat(chunks, cfg), cfg

    # thermalization, checkpointed every checkpoint_every * n_sweeps pairs
    # so that a long one resumes where it stopped; the statistics are
    # reset before the checkpoint that ends it, so a run resumed in the
    # measurement phase carries the measured phase's statistics only
    t0 = time.perf_counter()
    therm_err_max = 0.0
    if not therm_done:
        ckpt_stride = ckpt_every * max(n_sweeps, 1)
        for it in range(start_therm, n_therms):
            chunks = advance(chunks, cfg)
            if (it + 1) in adapt_marks:
                chunks, cfg = adapt(chunks, cfg)
            if (ckpt_every > 0 and (it + 1) % ckpt_stride == 0
                    and it + 1 < n_therms):
                checkpoint(False, therm_sweep=it + 1)
        therm_err_max = global_stats(chunks)["err_max"]
        chunks = reset(chunks)
        if ckpt_every > 0:
            checkpoint(True)
    _sync(devs)
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds"
        + (f" (auto n_stab = {cfg.n_stab})" if n_stab_auto else ""))
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = "
            f"{therm_err_max:.4e}")

    t0 = time.perf_counter()
    fns = measured_fns(cfg)
    warps = [(lambda G, m=m: half_warp(m, G)) if symmetric else None
             for m in models]

    def measure_bin(chunks, cfg, fns):
        """One bin of n_sweeps measured sweep pairs: (chunks, the bin's
        accumulator over this process's walkers)."""
        accs = [{} for _ in chunks]
        for _ in range(n_sweeps):
            chunks = advance(chunks, cfg)
            for acc, s, (greens_fn, uneq_step), warp in zip(
                    accs, chunks, fns, warps):
                uneq = G = None
                if uneq_step is not None:
                    *uneq, G = uneq_step(s)
                if G is None:
                    G = manager.measurement_greens(s, greens_fn=greens_fn,
                                                   warp_fn=warp)
                manager.accumulate(acc, manager.increments(
                    G, s.sign if signed else None, uneq=uneq))
        return chunks, manager.merge(accs)

    err_uneq_max = 0.0
    for ibin in range(start_bin, n_bins):
        if profile_dir and ibin == start_bin:
            with profile_bin(profile_dir, devs, log):
                chunks, acc = measure_bin(chunks, cfg, fns)
        else:
            chunks, acc = measure_bin(chunks, cfg, fns)
        bin_err_uneq = distributed.all_max(manager.ingest_bin(acc,
                                                              n_sweeps))
        err_uneq_max = max(err_uneq_max, bin_err_uneq)
        if not warned:
            cur_err = max(global_stats(chunks)["err_max"], bin_err_uneq)
            if cur_err > err_warn:
                if distributed.process_index() == 0:
                    print(f"WARNING: GF precision {cur_err:.3e} exceeds "
                          f"{err_warn:.1e}. Reduce n_stab or increase nt.",
                          file=sys.stderr)
                warned = True
        # n_stab = auto in the measurement phase: tighten only, on the
        # sweeps' chunk error or the unequal-time sweep's self-check.
        # After every bin, the last included, so that the state a
        # checkpoint carries does not depend on n_bins: a run extended by
        # a resume then equals one run straight to its end.
        if n_stab_auto and cfg.n_stab > 1:
            err_mean = chunk_err_mean(chunks)
            if max(err_mean, bin_err_uneq) > err_warn:
                cfg = dataclasses.replace(cfg, n_stab=cfg.n_stab - 1)
                log(f"n_stab auto (measurement): bin err {err_mean:.2e} / "
                    f"uneq {bin_err_uneq:.2e} exceeds warn {err_warn:.0e} "
                    f"-> n_stab = {cfg.n_stab}, stack reseated")
                chunks = reset(reseat(chunks, cfg))
                fns = measured_fns(cfg)
                warned = False
        if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
            checkpoint(True)
    _sync(devs)
    dt_meas = distributed.all_max(time.perf_counter() - t0)
    manager.close()

    # summary (main.cpp:180-208) over every walker of every process; a
    # sweep here is the reference's forward+backward pair, so acceptance
    # divides by 2 sweeps per pair, over the whole chain (acc_sum is part
    # of a checkpoint's state); the rate counts the slowest process's time
    total = (n_bins - start_bin) * n_sweeps
    stats = global_stats(chunks)
    acc_rate = stats["acc_sum_mean"] / (2.0 * max(n_therms
                                                  + n_bins * n_sweeps, 1))
    err_max = max(stats["err_max"], err_uneq_max)
    err_mean = stats["err_sum"] / max(stats["err_count"], 1)
    rate = total * n_walkers / dt_meas if dt_meas > 0 else float("inf")
    observables = global_observables(manager)
    h, rem = divmod(int(dt_meas), 3600)
    m, s = divmod(rem, 60)
    log(f"DQMC measurement sweeps are finished in {h} hours {m} minutes "
        f"{s} seconds.")
    log(f"Average acceptance rate = {acc_rate:.4f}")
    log(f"Max, Mean Precision Error (steady-state) = {err_max:.4e}, "
        f"{err_mean:.4e}")
    log(f"Throughput: {rate:.3f} walker-sweep-pairs/sec")
    return RunSummary(
        n_walkers=n_walkers, n_bins=n_bins, n_sweeps=n_sweeps,
        therm_seconds=dt_therm, measure_seconds=dt_meas,
        sweeps_per_sec=rate, acc_rate=acc_rate,
        max_precision_error=err_max, mean_precision_error=err_mean,
        therm_max_precision_error=therm_err_max, n_stab=cfg.n_stab,
        device=str(device), err_uneq_max=err_uneq_max,
        observables=observables,
        walker_signs=walker_values(chunks, "sign").tolist(),
        states=gather_walkers(chunks))


def main(argv=None) -> RunSummary:
    import argparse
    p = argparse.ArgumentParser(
        prog="dqmc_tpu_torch",
        description="Determinant QMC of the attractive or repulsive Hubbard "
                    "model on PyTorch/CUDA. Run inside a directory "
                    "containing parameters.in.")
    p.add_argument("-f", "--file", default="parameters.in",
                   help="parameter file (default: parameters.in)")
    p.add_argument("-d", "--out-dir", default="results",
                   help="output directory (default: results)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; say cpu for a CPU "
                        "run)")
    args = p.parse_args(argv)
    return run_simulation(Parameters(args.file), out_dir=args.out_dir,
                          device=args.device)


if __name__ == "__main__":
    main()
