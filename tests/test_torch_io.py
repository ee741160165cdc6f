"""dqmc_tpu_torch's checkpoint/resume (io/checkpoint.py) and spool sink
(io/spool.py, measure/manager.py) on the CPU.

- A run stopped and resumed equals an uninterrupted one bit for bit:
  fields, G, the walker generators' states and the bins, on the float32
  engine, on the df32 engine, and after a stop in the middle of
  thermalization under n_stab = auto; the loader's refusals (format
  version, leaf count, shape, device type, a checkpoint of the JAX
  package).  The analog of tests/test_checkpoint.py.
- The spool log: the JAX package's read_spool reads the port's log and
  its records equal the port's own h5 bins of the same run exactly; the
  JAX package's convert_spool_to_h5 gives the same h5 as the port's; the
  writer's bytes equal the native writer's (native/dqmc_spool.cpp) for
  the same records; a resumed spool run, which writes a bin again after
  its checkpoint, converts to the bins of an uninterrupted one; a resume
  with the other sink than the one holding the run's bins raises, and so
  does a log that cannot be written.
"""

import gc
import json
import os

import h5py
import numpy as np
import pytest
import torch

from dqmc_tpu import native
from dqmc_tpu.io import spool as jspool
from dqmc_tpu_torch.config import Parameters
import dqmc_tpu_torch.run as trun
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.io import checkpoint as ck
from dqmc_tpu_torch.io import spool as tspool
from dqmc_tpu_torch.run import run_simulation

torch.set_num_threads(1)

BASE = """
[Lattice]
L1 = 2
L2 = 2
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 1.0
nt = 4
n_therms = {n_therms}
n_sweeps = 1
n_bins = {n_bins}
n_stab = {n_stab}
seed = 21
dtype = {dtype}
checkpoint_every = {every}
[walkers]
n_walkers = 2
"""


class Stop(Exception):
    pass


def _run(out, *, n_bins, n_therms=2, n_stab="2", dtype="float32", every=1,
         extra="", stop_after=None, monkeypatch=None):
    """run_simulation in ``out``; ``stop_after = k`` raises Stop in the
    k-th sweep pair (counted over thermalization and measurement), as an
    interrupted run."""
    params = Parameters.from_string(BASE.format(
        n_bins=n_bins, n_therms=n_therms, n_stab=n_stab, dtype=dtype,
        every=every) + extra)
    if stop_after is not None:
        target = "df_sweep_pair" if dtype == "df32" else "sweep_pair"
        real, calls = getattr(trun, target), []

        def step(*a, **kw):
            calls.append(1)
            if len(calls) == stop_after:
                raise Stop
            return real(*a, **kw)
        monkeypatch.setattr(trun, target, step)
        with pytest.raises(Stop):
            run_simulation(params, out_dir=str(out), verbose=False,
                           device="cpu")
        monkeypatch.setattr(trun, target, real)
        gc.collect()       # the stopped run's files are closed
        return None
    return run_simulation(params, out_dir=str(out), verbose=False,
                          device="cpu")


def _h5_bins(path):
    with h5py.File(path) as f:
        return {f"{g}/{k}": np.asarray(f[g][k])
                for g in f for k in _walk(f[g])}


def _walk(group, prefix=""):
    for k, v in group.items():
        if isinstance(v, h5py.Group):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def _same_chain(a, b):
    assert torch.equal(a.fields, b.fields)
    assert torch.equal(a.G, b.G)
    assert all(torch.equal(x.get_state(), y.get_state())
               for x, y in zip(a.gens, b.gens))


def test_checkpoint_resume_is_bit_exact(tmp_path, monkeypatch):
    # float32 and df32: 2 bins, then a resume to 4, against 4 straight
    for dtype in ("float32", "df32"):
        full = _run(tmp_path / f"full_{dtype}", n_bins=4, dtype=dtype)
        part = tmp_path / f"part_{dtype}"
        _run(part, n_bins=2, dtype=dtype)
        assert ck.peek_meta(part / "checkpoint.npz")["bin"] == 2
        res = _run(part, n_bins=4, dtype=dtype)
        _same_chain(full.states, res.states)
        if dtype == "df32":
            assert torch.equal(full.states.G_df.lo, res.states.G_df.lo)
            assert torch.equal(full.states.stack.e, res.states.stack.e)
        for w in range(2):
            want = _h5_bins(tmp_path / f"full_{dtype}" / f"data_{w}.h5")
            got = _h5_bins(part / f"data_{w}.h5")
            assert sorted(want) == sorted(got) and len(want) == 4 * 5
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # a stop in the middle of thermalization under n_stab = auto: 8
    # thermalization pairs checkpointed every 2, stopped in the 6th; the
    # resumed run adapts n_stab at the marks the uninterrupted one does
    kw = dict(n_bins=2, n_therms=8, n_stab="auto", every=2)
    full = _run(tmp_path / "auto_full", **kw)
    _run(tmp_path / "auto_part", stop_after=6, monkeypatch=monkeypatch, **kw)
    meta = ck.peek_meta(tmp_path / "auto_part" / "checkpoint.npz")
    assert (meta["therm_done"], meta["therm_sweep"]) == (False, 4)
    res = _run(tmp_path / "auto_part", **kw)
    _same_chain(full.states, res.states)
    assert res.n_stab == full.n_stab
    for w in range(2):
        want = _h5_bins(tmp_path / "auto_full" / f"data_{w}.h5")
        got = _h5_bins(tmp_path / "auto_part" / f"data_{w}.h5")
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # an h5 run stopped between two checkpoints (bin 2 written after the
    # checkpoint at bin 2): its resume refuses to take bin 2 again, as the
    # JAX package's does, and loses nothing
    kw = dict(n_bins=4, every=2)
    _run(tmp_path / "h5_part", stop_after=2 + 4, monkeypatch=monkeypatch,
         **kw)
    with pytest.raises(ValueError, match=r"already holds bins \[2\]"):
        _run(tmp_path / "h5_part", **kw)
    assert sorted({int(k.split("/")[0][4:]) for k in _h5_bins(
        tmp_path / "h5_part" / "data_0.h5") if k.startswith("bin_")}) \
        == [0, 1, 2]

    # the refusals, each with its diagnosis
    states = full.states
    path = tmp_path / "ck.npz"
    ck.save_checkpoint(path, states, {"bin": 0})
    restored, meta = ck.load_checkpoint(path, states)
    _same_chain(states, restored)

    def forge(**changes):
        with np.load(path) as data:
            payload = {k: data[k] for k in data.files}
        m = json.loads(bytes(payload["__meta__"]).decode())
        m.update(changes)
        payload["__meta__"] = np.frombuffer(json.dumps(m).encode(),
                                            dtype=np.uint8)
        bad = tmp_path / "bad.npz"
        np.savez(bad, **payload)
        return bad
    for changes, match in (({"format_version": 0}, "format version"),
                           ({"device": "cuda"}, "cannot be loaded into a "
                            "cpu generator"),
                           ({"n_leaves": 3}, "state leaves")):
        with pytest.raises(ValueError, match=match):
            ck.load_checkpoint(forge(**changes), states)
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    model = AttractiveHubbard.build(square_lattice(2, 2), U=4.0, t=1.0,
                                    mu=-0.1, beta=1.0, nt=8,
                                    dtype=torch.float32)
    other = tsweep.init_state(model, EngineConfig(nt=8, n_stab=2),
                              make_generators(0, 2, "cpu"))
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(path, other)
    from dqmc_tpu.io.checkpoint import save_checkpoint as jax_save
    jax_save(tmp_path / "jax.npz", {"a": np.arange(3.0)}, {"bin": 0})
    for fn in (ck.peek_meta, lambda p: ck.load_checkpoint(p, states)):
        with pytest.raises(ValueError, match="JAX package"):
            fn(tmp_path / "jax.npz")


def test_spool_sink(tmp_path, monkeypatch):
    uneq = ("[simulation]\nisMeasureUnequalTime = true\n"
            "measure_spin = true\nmeasure_charge = true\n[hubbard]\n"
            "model = repulsive\nmu = -0.4\n[io]\nsink = {sink}\n")
    kw = dict(n_bins=3, every=0)
    _run(tmp_path / "h5", extra=uneq.format(sink="h5"), **kw)
    _run(tmp_path / "spool", extra=uneq.format(sink="spool"), **kw)
    for w in range(2):
        log = tmp_path / "spool" / f"data_{w}.spool"
        want = _h5_bins(tmp_path / "h5" / f"data_{w}.h5")
        records = list(jspool.read_spool(log))
        names = {n.split("/", 1)[0] if not n.startswith("K/") else "K"
                 for n, _, _ in records}
        assert names == {"scalar", "equaltime", "unequaltime", "K"}
        assert len(records) == len(want)
        assert {b for _, b, _ in records} == {0, 1, 2}
        for name, b, arr in records:
            if name.startswith("K/"):
                h5 = want[f"binK_{b}/{name[2:]}"]
                arr = np.stack([arr.real, arr.imag], axis=-1)
            else:
                h5 = want[f"bin_{b}/{name}"]
            np.testing.assert_array_equal(arr, h5, err_msg=name)
        # the port's conversion at close() and the JAX package's agree
        port_h5 = _h5_bins(tmp_path / "spool" / f"data_{w}.h5")
        jspool.convert_spool_to_h5(log, tmp_path / f"jax_{w}.h5")
        jax_h5 = _h5_bins(tmp_path / f"jax_{w}.h5")
        assert sorted(port_h5) == sorted(jax_h5) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(port_h5[k], want[k], err_msg=k)
            np.testing.assert_array_equal(jax_h5[k], want[k], err_msg=k)
    assert os.path.exists(tmp_path / "spool" / "data_0.spool")

    # the same records through the native writer give the same bytes
    # (where the JAX package's native library builds, as its own
    # tests/test_native.py requires)
    if native.load() is not None:
        recs = list(jspool.read_spool(tmp_path / "spool" / "data_1.spool"))
        nat = jspool.Spool(tmp_path / "native.spool")
        port = tspool.Spool(tmp_path / "port.spool")
        for name, b, arr in recs:
            nat.write(name, b, arr)
            port.write(name, b, arr)
        nat.close()
        port.close()
        assert (tmp_path / "native.spool").read_bytes() == \
            (tmp_path / "port.spool").read_bytes()

    # a resumed spool run: 4 bins checkpointed every 2, stopped in the 4th
    # bin (bin 2 is in the log after the checkpoint at bin 2), resumed to
    # 4: the log holds bin 2 twice and converts to the uninterrupted bins
    kw = dict(n_bins=4, every=2, extra=uneq.format(sink="spool"))
    _run(tmp_path / "full", **kw)
    _run(tmp_path / "part", stop_after=2 + 4, monkeypatch=monkeypatch, **kw)
    part_log = tmp_path / "part" / "data_0.spool"
    with open(part_log, "ab") as f:          # a record cut off mid-write
        f.write(b"\x0c\x00\x00\x00scalar/dens")
    with pytest.raises(ValueError, match="resume with the sink"):
        _run(tmp_path / "part", **dict(kw, extra=uneq.format(sink="h5")))
    _run(tmp_path / "part", **kw)
    bins = [b for n, b, _ in jspool.read_spool(part_log)
            if n == "scalar/density"]
    assert bins == [0, 1, 2, 2, 3]
    for w in range(2):
        want = _h5_bins(tmp_path / "full" / f"data_{w}.h5")
        got = _h5_bins(tmp_path / "part" / f"data_{w}.h5")
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # a resume with the other sink than the run's bins are in raises
    with pytest.raises(ValueError, match="resume with the sink"):
        _run(tmp_path / "h5_then_spool", n_bins=1, every=1)
        _run(tmp_path / "h5_then_spool", n_bins=2, every=1,
             extra="[io]\nsink = spool\n")

    # a log that cannot be written raises; nothing falls back to h5
    blocked = tmp_path / "blocked"
    blocked.mkdir()
    (blocked / "data_0.spool").mkdir()
    with pytest.raises(OSError):
        _run(blocked, n_bins=1, every=0, extra="[io]\nsink = spool\n")
    assert not os.path.exists(blocked / "data_0.h5")
