"""Measurement registry, binned accumulation and HDF5 output.

PyTorch counterpart of ``dqmc_tpu/measure/manager.py`` (the reference's
measurementh5.h:119-363).  Per sweep, :meth:`MeasurementManager.increments`
measures every registered observable on the walker batch's G on the device,
with the site-pair observables already reduced to displacement space (the
transform is linear, so this equals the reference's
accumulate-then-transform), and takes the unequal-time sweep's per-tau
reductions (:attr:`uneq_measure_fn` is the emit the sweep runs once per
block).  The run loop adds increments into an accumulator dict
(:meth:`accumulate`); :meth:`ingest_bin` normalizes a
bin, transforms it to momentum space on the host and writes one HDF5 bin
per walker through ``io/h5out.py``'s ``BinFileWriter`` (the reference's
byte layout): walker w writes ``<out_dir>/data_<rank_offset + w>.h5``.
With ``out_dir = None`` nothing is written; the per-bin scalar means are
kept in ``bin_scalars`` either way.

``sink = "spool"`` appends each walker's bins to ``data_<rank_offset +
w>.spool`` (``io/spool.py``, needs only numpy) instead, under the JAX
package's record names (``scalar/``, ``equaltime/``, ``unequaltime/``,
``K/equaltime/``, ``K/unequaltime/``); :meth:`close` converts every log to
its ``.h5`` where h5py can be imported and keeps the logs, which stay the
run's record for a resume.  Where h5py is missing it
prints where the logs are and how to convert them.  A resumed run
(``start_bin > 0``) continues the bin numbering and appends: to the logs,
or to the h5 files as the JAX package does (a file that already holds a
bin at or past the checkpoint's raises, as the JAX package's create_group
does, but with a diagnosis); a resume with the other sink than the
files holding the run's bins raises.  A log that cannot be opened or
written raises: nothing falls back to h5.

For a model with a sign problem (det_power = 1) the increments take the
walkers' signs: every observable accumulates sign-weighted (<O s>) and a
``sign`` scalar records <s>, so the analysis can reweight <O> = <O s>/<s>.
Sign-free runs write no ``sign`` and are byte-identical to the reference.

A process whose walkers run in chunks on several devices measures each
chunk on its own device (:meth:`context` keeps one measurement context
per device) and closes a bin from the chunks' accumulators joined in
walker order (:meth:`merge`); with several processes each process's
manager holds its own walkers, ``rank_offset`` the first one's global
index.

With a multiword measurement tier (``measure_precision = df32 | tf32``)
:meth:`measurement_greens` hands the observables the tier's float64 G
instead of the engine's.  Unequal-time observables (registered only with
``measure_unequal``, as the reference drops them otherwise) are written as
``unequaltime/<name>`` in the reference's layout (L1, L2, n_orb^2 n_tau),
flattened (a n_orb + b) n_tau + tau.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from dqmc_tpu_torch.lattice import Lattice
from dqmc_tpu_torch.measure.context import MeasurementContext, make_context
from dqmc_tpu_torch.measure.transforms import (r_to_k, site_to_r_all,
                                               site_to_r_batched)

ERR_UNEQ = ("meta", "err_uneq_max")


class MeasurementManager:
    def __init__(self, lat: Lattice, *, n_walkers: int = 1,
                 out_dir: str | None = "results", device="cpu",
                 measure_unequal: bool = False, sink: str = "h5",
                 start_bin: int = 0, rank_offset: int = 0):
        if sink not in ("h5", "spool"):
            raise ValueError(f"[io] sink {sink!r}: h5 or spool")
        self.lat = lat
        self.ctx = make_context(lat, device)
        self._ctxs = {self.ctx.pair_cols.device: self.ctx}
        self.n_walkers = n_walkers
        self.out_dir = out_dir
        self.measure_unequal = measure_unequal
        self.rank_offset = rank_offset
        self.current_bin = start_bin       # a resume continues the numbering
        self._append = start_bin > 0
        self.bin_scalars: list = []        # per bin: name -> walker mean
        self.bin_walker_scalars: list = []  # per bin: name -> (W,) values
        self._scalar_fns: Dict[str, Callable] = {}
        self._eq_fns: Dict[str, Callable] = {}
        self._uneq_fns: Dict[str, Callable] = {}
        self._writers = None
        self._spools = None
        if out_dir is None:
            return
        if self._append:
            # a resume continues the run's bins in the files that hold them
            own, other = ((".spool", ".h5") if sink == "spool"
                          else (".h5", ".spool"))
            for w in range(n_walkers):
                if (os.path.exists(self._path(w, other))
                        and not os.path.exists(self._path(w, own))):
                    raise ValueError(
                        f"this run resumes at bin {start_bin} with [io] "
                        f"sink = {sink}, but its earlier bins are in "
                        f"{self._path(w, other)}: resume with the sink the "
                        f"run started with")
        if sink == "spool":
            from dqmc_tpu_torch.io.spool import Spool
            self._spools = {w: Spool(self._path(w, ".spool"),
                                     append=self._append)
                            for w in range(n_walkers)}
        elif self._append:
            for w in range(n_walkers):     # a bin taken twice raises now
                self._writer(w)

    def add_scalar(self, name: str, fn: Callable) -> None:
        self._scalar_fns[name] = fn

    def add_equal_time(self, name: str, fn: Callable) -> None:
        self._eq_fns[name] = fn

    def add_unequal_time(self, name: str, fn: Callable) -> None:
        # dropped when unequal-time measurement is off
        # (measurementh5.h:182-184)
        if self.measure_unequal:
            self._uneq_fns[name] = fn

    def add_defaults(self) -> None:
        """The reference's default set (main.cpp:116-122)."""
        from dqmc_tpu_torch.measure import observables as obs
        for name, fn in obs.SCALAR_OBSERVABLES.items():
            self.add_scalar(name, fn)
        for name, fn in obs.EQUAL_TIME_OBSERVABLES.items():
            self.add_equal_time(name, fn)
        for name, fn in obs.UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    def add_spin(self) -> None:
        """The opt-in magnetic set ([simulation] measure_spin = true): the
        spin-z and spin-x correlation matrices and their tau-resolved
        forms."""
        from dqmc_tpu_torch.measure import observables as obs
        for name, fn in obs.SPIN_OBSERVABLES.items():
            self.add_equal_time(name, fn)
        for name, fn in obs.SPIN_UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    def add_charge(self) -> None:
        """The opt-in dynamic charge set ([simulation] measure_charge =
        true): the tau-resolved connected density correlator."""
        from dqmc_tpu_torch.measure import observables as obs
        for name, fn in obs.CHARGE_UNEQUAL_TIME_OBSERVABLES.items():
            self.add_unequal_time(name, fn)

    @property
    def uneq_measure_fn(self) -> Callable | None:
        """The tau sweep's emit, (Gtt, Gt0, G0t, G00) -> dict name ->
        (..., L1, L2, n_orb^2), every observable reduced through one
        ``site_to_r_all``; None when no unequal-time observable is
        registered."""
        if not self._uneq_fns:
            return None
        fns, context = dict(self._uneq_fns), self.context

        def emit(Gtt, Gt0, G0t, G00):
            ctx = context(Gtt.device)
            return site_to_r_all({name: fn(Gtt, Gt0, G0t, G00, ctx)
                                  for name, fn in fns.items()}, ctx)
        return emit

    def increments(self, G: torch.Tensor,
                   signs: torch.Tensor | None = None, uneq=None
                   ) -> Dict[tuple, torch.Tensor]:
        """One measurement of the walker batch G (W, nfl, ns, ns): a dict
        keyed (kind, name) with scalars (W,) and equal-time observables
        reduced to (W, L1, L2, n_orb^2).  ``uneq = (ys, err)`` from the
        tau sweep adds ("uneq", name) (W, n_tau, L1, L2, n_orb^2) and the
        sweep's largest self-check deviation under ERR_UNEQ.  With
        ``signs`` (W,) every value is multiplied by its walker's sign and
        ("scalar", "sign") holds the signs."""
        ctx = self.context(G.device)
        out = {} if signs is None else {("scalar", "sign"): signs.clone()}
        s = 1.0 if signs is None else signs
        for name, fn in self._scalar_fns.items():
            out[("scalar", name)] = fn(G, ctx) * s
        if signs is not None:
            s = signs[:, None, None, None]
        for name, fn in self._eq_fns.items():
            out[("eq", name)] = site_to_r_batched(fn(G, ctx), ctx) * s
        if uneq is not None:
            ys, err = uneq
            if signs is not None:
                s = signs[:, None, None, None, None]
            for name, v in ys.items():
                out[("uneq", name)] = v * s
            out[ERR_UNEQ] = err.max()
        return out

    def context(self, device) -> MeasurementContext:
        """The measurement context on ``device`` (one per device that
        holds walkers)."""
        device = torch.device(device)
        if device not in self._ctxs:
            self._ctxs[device] = make_context(self.lat, device)
        return self._ctxs[device]

    @staticmethod
    def merge(accs: list) -> Dict[tuple, torch.Tensor]:
        """One accumulator of the process's walkers from its chunks'
        (``parallel/walkers.split_walkers``), on the host in walker order;
        the self-check deviation keeps its maximum."""
        if len(accs) == 1:
            return accs[0]
        return {key: (torch.stack([a[key].cpu() for a in accs]).amax(0)
                      if key == ERR_UNEQ else
                      torch.cat([a[key].cpu() for a in accs]))
                for key in accs[0]}

    @staticmethod
    def accumulate(acc: Dict[tuple, torch.Tensor],
                   inc: Dict[tuple, torch.Tensor]) -> None:
        """Add one measurement's increments into ``acc`` (the self-check
        deviation keeps its maximum)."""
        for key, v in inc.items():
            if key not in acc:
                acc[key] = v.clone()
            elif key == ERR_UNEQ:
                acc[key] = torch.maximum(acc[key], v)
            else:
                acc[key] += v

    def measurement_greens(self, states, *, greens_fn=None, warp_fn=None):
        """The equal-time measurement input of a walker batch (the JAX
        manager's make_measured_iter): the measurement tier's G when
        ``greens_fn`` is given (``engine/parity.measurement_greens_fn``:
        float64, rebuilt from the fields, already in the measurement basis,
        so ``warp_fn`` is not applied to it), else the engine's G,
        half-warped by ``warp_fn`` when given."""
        if greens_fn is not None:
            return greens_fn(states)
        return warp_fn(states.G) if warp_fn is not None else states.G

    def ingest_bin(self, acc: Dict[tuple, torch.Tensor],
                   count: int) -> float:
        """Close one bin from an accumulator of ``count`` measurements:
        record its walker-mean scalars in ``bin_scalars`` and, unless
        ``out_dir`` is None, write it.  Returns the bin's largest
        unequal-time self-check deviation (0.0 without unequal-time
        measurement)."""
        mean = lambda kind: {  # noqa: E731
            n: v.double().cpu().numpy() / max(count, 1)
            for (k, n), v in acc.items() if k == kind}
        scalars, eq_r = mean("scalar"), mean("eq")
        # (W, T, L1, L2, no^2) -> (W, L1, L2, no^2 T), flat (a no + b) T + t
        uneq_r = {n: np.moveaxis(v, 1, -1).reshape(v.shape[0], v.shape[2],
                                                   v.shape[3], -1)
                  for n, v in mean("uneq").items()}
        err_u = float(acc[ERR_UNEQ]) if ERR_UNEQ in acc else 0.0
        self.bin_scalars.append({n: float(v.mean())
                                 for n, v in scalars.items()})
        self.bin_walker_scalars.append(scalars)
        self.current_bin += 1
        if self.out_dir is None:
            return err_u
        b = self.current_bin - 1
        for w in range(self.n_walkers):
            sc = {n: float(v[w]) for n, v in scalars.items()}
            er = {n: v[w] for n, v in eq_r.items()}
            ur = {n: v[w] for n, v in uneq_r.items()}
            ek = {n: r_to_k(v, self.ctx) for n, v in er.items()}
            uk = {n: r_to_k(v, self.ctx) for n, v in ur.items()}
            if self._spools is None:
                self._writer(w).write_bin(b, sc, er, ek, ur, uk)
                continue
            sp = self._spools[w]
            for n, v in sc.items():
                sp.write(f"scalar/{n}", b, np.asarray([v]))
            for prefix, r, k in (("equaltime/", er, ek),
                                 ("unequaltime/", ur, uk)):
                for n in r:
                    sp.write(prefix + n, b, r[n])
                    sp.write("K/" + prefix + n, b, k[n])
        return err_u

    def _path(self, w: int, ext: str) -> str:
        return os.path.join(self.out_dir,
                            f"data_{self.rank_offset + w}{ext}")

    def _writer(self, w: int):
        # h5py is imported only when a bin is written
        from dqmc_tpu_torch.io.h5out import BinFileWriter
        if self._writers is None:
            self._writers = {}
        if w not in self._writers:
            path = self._path(w, ".h5")
            writer = BinFileWriter(path, mode="a" if self._append else "w")
            late = [b for b in writer.bins() if b >= self.current_bin]
            if late:
                writer.close()
                raise ValueError(
                    f"{path} already holds bins {late}, written after the "
                    f"checkpoint at bin {self.current_bin} that this run "
                    f"resumes from: an h5 file cannot take a bin again (as "
                    f"in the JAX package); remove those bins from it, or "
                    f"run with [io] sink = spool, whose log does")
            self._writers[w] = writer
        return self._writers[w]

    def flush(self) -> None:
        """Put every bin written so far on disk (before a checkpoint)."""
        for sp in (self._spools or {}).values():
            sp.flush()

    def close(self) -> None:
        """Close the files; convert the spool logs to h5 where h5py can be
        imported, else say where they are and how to convert them."""
        for w in (self._writers or {}).values():
            w.close()
        self._writers = None
        if self._spools is None:
            return
        for sp in self._spools.values():
            sp.close()
        self._spools = None
        import importlib.util
        if importlib.util.find_spec("h5py") is None:
            print(f"h5py is not installed: the bins stay in "
                  f"{os.path.join(self.out_dir, 'data_*.spool')}; convert "
                  f"them where h5py is installed with `python -m "
                  f"dqmc_tpu_torch.io.spool {self.out_dir}`")
            return
        from dqmc_tpu_torch.io.spool import convert_spool_to_h5
        for w in range(self.n_walkers):
            convert_spool_to_h5(self._path(w, ".spool"), self._path(w, ".h5"))
