"""Simulation driver: ``python -m dqmc_tpu_torch``.

PyTorch counterpart of ``dqmc_tpu/run.py`` for the slice the port serves so
far: the attractive (``[hubbard] model = attractive``, one stored flavor)
and the repulsive (``model = repulsive``, two flavors with a tracked
Metropolis sign) Hubbard model with dense kinetics on any of the package's
lattices or checkerboard kinetics on the square lattice, walker-batched on
one device through the fused block engine (the wrap/site-loop kernels) or
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

import dataclasses
import os
import sys
import time

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


def _unported(params: Parameters):
    """(what, ROADMAP item) for every requested feature outside the slice."""
    get_s, get_b, get_i = params.get_str, params.get_bool, params.get_int
    return [
        (what, item) for on, what, item in [
            (get_i("walkers", "n_devices", 0) > 1, "n_devices > 1",
             "slice 3, devices"),
            (bool(get_s("distributed", "coordinator_address", "")),
             "multi-host runs", "slice 3, devices"),
            (get_s("simulation", "wrap_precision", "highest") != "highest",
             "wrap_precision other than highest",
             "not to port (TPU MXU-pass knob)"),
            (get_s("simulation", "matmul_precision", "highest")
             != "highest", "matmul_precision other than highest",
             "not to port (TPU MXU-pass knob)"),
            (bool(get_s("simulation", "profile_dir", "")), "profile_dir",
             "slice 1, the bench.py port"),
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
    # the final walker states (WalkerState, or DFWalkerState for df32)
    states: object = None
    # parallel tempering: accepted exchanges per attempt (0.0 without PT)
    exchange_rate: float = 0.0


def _stats(states) -> dict:
    return dict(acc_sum_mean=float(states.acc_sum.mean()),
                err_max=float(states.err_max.max()),
                err_sum=float(states.err_sum.sum()),
                err_count=float(states.err_count.sum()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(params: Parameters, *, out_dir: str | None = "results",
                   verbose: bool = True, device="cuda") -> RunSummary:
    """Run the simulation ``params`` describes on ``device``; bins go to
    ``out_dir`` (None writes no files: the run then stops before any
    output and returns only its summary)."""
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
                                      verbose=verbose, device=device)
    log = print if verbose else (lambda *a, **k: None)

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

    lat = make_lattice(params.get_str("Lattice", "geometry", "square"),
                       params.get_int("Lattice", "L1"),
                       params.get_int("Lattice", "L2"))
    if out_dir is not None:
        lat.save_info(os.path.join(out_dir, "info"))
    model_name = params.get_str("hubbard", "model", "attractive")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"[hubbard] model {model_name!r}: "
                         + " or ".join(sorted(MODEL_REGISTRY)))
    model_cls = MODEL_REGISTRY[model_name]
    model = model_cls.from_params(params, lat, dtype=dtype, device=device)
    signed = model.det_power == 1
    if model.checkerboard and df_mode:
        raise NotImplementedError(CHECKERBOARD_DF32)
    if model.checkerboard and measure_prec != "engine":
        raise NotImplementedError(CHECKERBOARD_TIER)
    # checkpoint / resume: the stack's slot count depends on n_stab, so an
    # adapted n_stab must be known before the states are built
    ckpt_every = params.get_int("simulation", "checkpoint_every", 0)
    ckpt_path = params.get_str("simulation", "checkpoint_path", "")
    if ckpt_every > 0 and not ckpt_path:
        if out_dir is None:
            raise ValueError("checkpoint_every > 0 without an output "
                             "directory needs [simulation] checkpoint_path")
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
    resume = ckpt_every > 0 and os.path.exists(ckpt_path)
    if resume and n_stab_auto:
        n_stab = int(peek_meta(ckpt_path).get("n_stab", n_stab))
    cfg = make_engine_config(params, device, n_stab)
    fused = not df_mode and use_fused_engine(params, model, device, dtype,
                                             cfg)
    step = sweep_pair_fused if fused else sweep_pair
    log(f"Standard DQMC run: {lat.L1}x{lat.L2} lattice, "
        f"beta={float(model.beta)}, nt={nt}, {n_walkers} walkers, "
        f"dtype={'df32' if df_mode else str(dtype).replace('torch.', '')}, "
        f"device={device}")
    flavors = f"{model.n_flavor} flavor" + "s" * (model.n_flavor > 1)
    if df_mode:
        aux = df_aux_build(
            lat, U=params.get_float("hubbard", "U"),
            t=params.get_float("hubbard", "t"),
            mu=params.get_float("hubbard", "mu"), beta=float(model.beta),
            nt=nt, bonds=bonds_with_tp(
                params.get_str("Lattice", "geometry", "square"),
                params.get_float("hubbard", "tp", 0.0)),
            n_flavor=model.n_flavor, device=device)

        def step(model, cfg, states):
            return df_sweep_pair(model, aux, cfg, states)
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

    gens = make_generators(seed, n_walkers, device)
    states = (init_state_df(model, aux, cfg, gens) if df_mode
              else init_state(model, cfg, gens))
    start_bin = start_therm = 0
    therm_done = False
    if resume:
        states, meta = load_checkpoint(ckpt_path, states)
        start_bin = int(meta["bin"])
        therm_done = bool(meta["therm_done"])
        start_therm = int(meta["therm_sweep"])
        log(f"Resumed from {ckpt_path} at bin {start_bin}"
            + ("" if therm_done
               else f" (thermalization sweep pair {start_therm})"))
    manager = MeasurementManager(
        lat, n_walkers=n_walkers, out_dir=out_dir, device=device,
        measure_unequal=params.get_bool("simulation",
                                        "isMeasureUnequalTime", False),
        sink=params.get_str("io", "sink", "h5"), start_bin=start_bin)
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

    def reseat(states, cfg):
        """Rebuild stack + G from the fields under a new n_stab (the chain
        itself -- fields, generators, signs -- is untouched)."""
        if df_mode:
            stack, G_df, log_det = rebuild_stack_df(aux, cfg, states.fields)
            return dataclasses.replace(states, G=G_df.hi, G_df=G_df,
                                       stack=stack, log_det_M=log_det)
        stack, G, log_det = rebuild_stack_and_greens(model, cfg,
                                                     states.fields)
        return dataclasses.replace(states, G=G, stack=stack,
                                   log_det_M=log_det)

    model64 = None
    meas_stab = params.get_int("simulation", "measure_n_stab", 0)
    uneq_stab = params.get_int("simulation", "measure_uneq_n_stab", 0)

    def measured_fns(cfg):
        """(greens_fn, uneq_step) of the measurement phase for one n_stab
        value, rebuilt whenever it changes: the multiword tier's greens_fn
        (None for ``measure_precision = engine``), and the unequal-time
        step (None without unequal-time measurement), ``states -> (ys,
        err, G)``, G the tier's G00, which then is the equal-time G, or
        None on the engine-grade path."""
        nonlocal model64
        if measure_prec == "engine":
            if uneq_fn is None:
                return None, None
            view = f32_view if df_mode else (lambda s: s)
            return None, lambda s: (*sweep_unequal_time(
                model, cfg, view(s), measure_fn=uneq_fn, warp=symmetric),
                None)
        if model64 is None:
            model64 = model_cls.from_params(params, lat, dtype=torch.float64,
                                            device=device)
        nm = tf32 if measure_prec == "tf32" else df32
        if uneq_fn is not None:
            step_u = measurement_uneq_fn(
                model64, cfg, nm, uneq_fn, symmetric=symmetric,
                n_stab=uneq_stab if uneq_stab > 0 else None,
                emit_greens=True)
            log(f"Measurement tier: tau-resolved Gtt/Gt0/G0t and the "
                f"equal-time G rebuilt at {measure_prec} (stride "
                f"{step_u.n_stab})")
            return None, step_u
        fn = measurement_greens_fn(
            model64, cfg, nm, symmetric=symmetric,
            n_stab=meas_stab if meas_stab > 0 else None)
        log(f"Measurement tier: equal-time G rebuilt at {measure_prec} "
            f"({'<1e-10' if measure_prec == 'tf32' else '~1e-8'} "
            f"fixed-field accuracy)")
        return fn, None

    def chunk_err_mean(states):
        s = _stats(states)
        return s["err_sum"] / s["err_count"] if s["err_count"] else 0.0

    def checkpoint(therm_flag: bool, therm_sweep: int = 0):
        """Save the chain after a thermalization pair or a bin; the bins
        written so far go to disk first."""
        manager.flush()
        _sync(device)
        save_checkpoint(ckpt_path, states, {
            "bin": manager.current_bin, "therm_done": therm_flag,
            "therm_sweep": therm_sweep, "n_stab": cfg.n_stab, "seed": seed,
            "n_walkers": n_walkers})

    # n_stab = auto: tune during thermalization to the loosest value whose
    # steady chunk error stays below the warn threshold (/16 hysteresis).
    # The marks are those of the whole phase, so a run resumed in
    # thermalization adapts where an uninterrupted one does.
    adapt_marks = ()
    if n_stab_auto and n_therms >= 4:
        k = min(8, n_therms // 2)
        adapt_marks = sorted({(i + 1) * n_therms // k for i in range(k - 1)})
    n_stab_cap = min(cfg.nt, 32)

    def adapt(states, cfg):
        err_mean = chunk_err_mean(states)
        new = cfg.n_stab
        if err_mean > err_warn and cfg.n_stab > 1:
            new = cfg.n_stab - 1
        elif err_mean < err_warn / 16 and cfg.n_stab < n_stab_cap:
            new = cfg.n_stab + 1
        states = reset_error_stats(states)
        if new == cfg.n_stab:
            return states, cfg
        cfg = dataclasses.replace(cfg, n_stab=new)
        log(f"n_stab auto: chunk err_mean {err_mean:.2e} "
            f"(warn {err_warn:.0e}) -> n_stab = {new}")
        return reseat(states, cfg), cfg

    # thermalization, checkpointed every checkpoint_every * n_sweeps pairs
    # so that a long one resumes where it stopped; the statistics are
    # reset before the checkpoint that ends it, so a run resumed in the
    # measurement phase carries the measured phase's statistics only
    t0 = time.perf_counter()
    therm_err_max = 0.0
    if not therm_done:
        ckpt_stride = ckpt_every * max(n_sweeps, 1)
        for it in range(start_therm, n_therms):
            states = step(model, cfg, states)
            if (it + 1) in adapt_marks:
                states, cfg = adapt(states, cfg)
            if (ckpt_every > 0 and (it + 1) % ckpt_stride == 0
                    and it + 1 < n_therms):
                checkpoint(False, therm_sweep=it + 1)
        therm_err_max = _stats(states)["err_max"]
        states = reset_error_stats(states)
        if ckpt_every > 0:
            checkpoint(True)
    _sync(device)
    dt_therm = time.perf_counter() - t0
    log(f"Thermalization done in {dt_therm:.2f} seconds"
        + (f" (auto n_stab = {cfg.n_stab})" if n_stab_auto else ""))
    if n_therms and not therm_done:
        log(f"Thermalization transient precision error = "
            f"{therm_err_max:.4e}")

    t0 = time.perf_counter()
    greens_fn, uneq_step = measured_fns(cfg)
    warp = (lambda G: half_warp(model, G)) if symmetric else None
    err_uneq_max = 0.0
    for ibin in range(start_bin, n_bins):
        acc = {}
        for _ in range(n_sweeps):
            states = step(model, cfg, states)
            uneq = G = None
            if uneq_step is not None:
                *uneq, G = uneq_step(states)
            if G is None:
                G = manager.measurement_greens(states, greens_fn=greens_fn,
                                               warp_fn=warp)
            manager.accumulate(acc, manager.increments(
                G, states.sign if signed else None, uneq=uneq))
        bin_err_uneq = manager.ingest_bin(acc, n_sweeps)
        err_uneq_max = max(err_uneq_max, bin_err_uneq)
        if not warned:
            cur_err = max(float(states.err_max.max()), bin_err_uneq)
            if cur_err > err_warn:
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
            err_mean = chunk_err_mean(states)
            if max(err_mean, bin_err_uneq) > err_warn:
                cfg = dataclasses.replace(cfg, n_stab=cfg.n_stab - 1)
                log(f"n_stab auto (measurement): bin err {err_mean:.2e} / "
                    f"uneq {bin_err_uneq:.2e} exceeds warn {err_warn:.0e} "
                    f"-> n_stab = {cfg.n_stab}, stack reseated")
                states = reset_error_stats(reseat(states, cfg))
                greens_fn, uneq_step = measured_fns(cfg)
                warned = False
        if ckpt_every > 0 and manager.current_bin % ckpt_every == 0:
            checkpoint(True)
    _sync(device)
    dt_meas = time.perf_counter() - t0
    manager.close()

    # summary (main.cpp:180-208); a sweep here is the reference's
    # forward+backward pair, so acceptance divides by 2 sweeps per pair,
    # over the whole chain (acc_sum is part of a checkpoint's state)
    total = (n_bins - start_bin) * n_sweeps
    stats = _stats(states)
    acc_rate = stats["acc_sum_mean"] / (2.0 * max(n_therms
                                                  + n_bins * n_sweeps, 1))
    err_max = max(stats["err_max"], err_uneq_max)
    err_mean = stats["err_sum"] / max(stats["err_count"], 1)
    rate = total * n_walkers / dt_meas if dt_meas > 0 else float("inf")
    bins = manager.bin_scalars
    observables = {n: sum(b[n] for b in bins) / len(bins)
                   for n in (bins[0] if bins else {})}
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
        observables=observables, walker_signs=states.sign.tolist(),
        states=states)


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
