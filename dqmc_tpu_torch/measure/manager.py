"""Equal-time measurement registry, binned accumulation and HDF5 output.

PyTorch counterpart of the equal-time half of
``dqmc_tpu/measure/manager.py`` (the reference's measurementh5.h:119-363).
Per sweep, :meth:`MeasurementManager.increments` measures every registered
observable on the walker batch's G on the device, with the site-pair
observables already reduced to displacement space (the transform is linear,
so this equals the reference's accumulate-then-transform).  The run loop
adds increments into an accumulator dict; :meth:`ingest_bin` normalizes a
bin, transforms it to momentum space on the host and writes one HDF5 bin
per walker through ``io/h5out.py``'s ``BinFileWriter`` (the reference's
byte layout): walker w writes ``<out_dir>/data_<w>.h5``.  With
``out_dir = None`` nothing is written; the per-bin scalar means are kept
in ``bin_scalars`` either way.

For a model with a sign problem (det_power = 1) the increments take the
walkers' signs: every observable accumulates sign-weighted (<O s>) and a
``sign`` scalar records <s>, so the analysis can reweight <O> = <O s>/<s>.
Sign-free runs write no ``sign`` and are byte-identical to the reference.

With a multiword measurement tier (``measure_precision = df32 | tf32``)
:meth:`measurement_greens` hands the observables the tier's float64 G
instead of the engine's.  Unequal-time observables and the opt-in charge
set are not ported yet (ROADMAP: modules to port, engine/uneqtime.py).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch

from dqmc_tpu_torch.lattice import Lattice
from dqmc_tpu_torch.measure.context import make_context
from dqmc_tpu_torch.measure.transforms import r_to_k, site_to_r_batched


class MeasurementManager:
    def __init__(self, lat: Lattice, *, n_walkers: int = 1,
                 out_dir: str | None = "results", device="cpu"):
        self.lat = lat
        self.ctx = make_context(lat, device)
        self.n_walkers = n_walkers
        self.out_dir = out_dir
        self.current_bin = 0
        self.bin_scalars: list = []        # per bin: name -> walker mean
        self._scalar_fns: Dict[str, Callable] = {}
        self._eq_fns: Dict[str, Callable] = {}
        self._writers = None

    def add_scalar(self, name: str, fn: Callable) -> None:
        self._scalar_fns[name] = fn

    def add_equal_time(self, name: str, fn: Callable) -> None:
        self._eq_fns[name] = fn

    def add_defaults(self) -> None:
        """The reference's default equal-time set (main.cpp:116-122)."""
        from dqmc_tpu_torch.measure import observables as obs
        for name, fn in obs.SCALAR_OBSERVABLES.items():
            self.add_scalar(name, fn)
        for name, fn in obs.EQUAL_TIME_OBSERVABLES.items():
            self.add_equal_time(name, fn)

    def add_spin(self) -> None:
        """The opt-in magnetic set ([simulation] measure_spin = true): the
        spin-z and spin-x correlation matrices."""
        from dqmc_tpu_torch.measure import observables as obs
        for name, fn in obs.SPIN_OBSERVABLES.items():
            self.add_equal_time(name, fn)

    def increments(self, G: torch.Tensor,
                   signs: torch.Tensor | None = None
                   ) -> Dict[tuple, torch.Tensor]:
        """One measurement of the walker batch G (W, nfl, ns, ns): a dict
        keyed (kind, name) with scalars (W,) and equal-time observables
        reduced to (W, L1, L2, n_orb^2).  With ``signs`` (W,) every value
        is multiplied by its walker's sign and ("scalar", "sign") holds
        the signs."""
        out = {} if signs is None else {("scalar", "sign"): signs.clone()}
        s = 1.0 if signs is None else signs
        for name, fn in self._scalar_fns.items():
            out[("scalar", name)] = fn(G, self.ctx) * s
        if signs is not None:
            s = signs[:, None, None, None]
        for name, fn in self._eq_fns.items():
            out[("eq", name)] = site_to_r_batched(fn(G, self.ctx),
                                                  self.ctx) * s
        return out

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

    def zero_acc(self, G: torch.Tensor,
                 signs: torch.Tensor | None = None
                 ) -> Dict[tuple, torch.Tensor]:
        return {k: torch.zeros_like(v)
                for k, v in self.increments(G, signs).items()}

    def ingest_bin(self, acc: Dict[tuple, torch.Tensor], count: int) -> None:
        """Close one bin from an accumulator of ``count`` measurements:
        record its walker-mean scalars in ``bin_scalars`` and, unless
        ``out_dir`` is None, write it."""
        scalars = {n: v.double().cpu().numpy() / max(count, 1)
                   for (kind, n), v in acc.items() if kind == "scalar"}
        eq_r = {n: v.double().cpu().numpy() / max(count, 1)
                for (kind, n), v in acc.items() if kind == "eq"}
        self.bin_scalars.append({n: float(v.mean())
                                 for n, v in scalars.items()})
        self.current_bin += 1
        if self.out_dir is None:
            return
        for w in range(self.n_walkers):
            self._writer(w).write_bin(
                self.current_bin - 1,
                {n: float(v[w]) for n, v in scalars.items()},
                {n: v[w] for n, v in eq_r.items()},
                {n: r_to_k(v[w], self.ctx) for n, v in eq_r.items()},
                {}, {})

    def _writer(self, w: int):
        # h5py is imported only when a bin is written
        from dqmc_tpu_torch.io.h5out import BinFileWriter
        if self._writers is None:
            self._writers = {}
        if w not in self._writers:
            path = os.path.join(self.out_dir, f"data_{w}.h5")
            self._writers[w] = BinFileWriter(path, mode="w")
        return self._writers[w]

    def close(self) -> None:
        for w in (self._writers or {}).values():
            w.close()
        self._writers = None
