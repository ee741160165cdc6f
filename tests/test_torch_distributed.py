"""Walkers and parallel-tempering replicas of dqmc_tpu_torch across devices
and processes (dqmc_tpu_torch/parallel/distributed.py, walkers.py), on the
CPU: the contract of the JAX package's tests/test_distributed.py, held
between three runs of the port.

- the unsplit run;
- the walkers (replicas) split over ``devices = [cpu, cpu]``, the entry
  point's test seam in place of [walkers] n_devices;
- two processes on gloo over tcp://127.0.0.1:<free port>, formed through
  the [distributed] keys, each writing its own walkers' bins.

The split runs must make the unsplit run's Markov chains: final fields
bit for bit, every ``data_<w>`` bin within 1e-12, the summaries (and the
exchange decisions) equal.  Three test functions, so that the collected
count stays where the full xdist run survives (ROADMAP "Test-suite
constraints").
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.io.checkpoint import peek_meta
from dqmc_tpu_torch.io.spool import read_bins
from dqmc_tpu_torch.run import run_simulation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX tests/test_distributed.py's run, with the port's spool sink (h5py is
# not needed to read the bins back)
PARAMS = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 2.0
nt = 8
n_therms = 3
n_sweeps = 2
n_bins = 2
n_stab = 4
isMeasureUnequalTime = true
seed = 7
dtype = float64
checkpoint_every = 1
[io]
sink = spool
[walkers]
n_walkers = 8
"""

# a 4-beta ladder at 2x2; the shared-order kernels' twin (site_update =
# pallas) makes the second chunk draw walker 0's visit order
PT_PARAMS = """
[Lattice]
L1 = 2
L2 = 2
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 2.0
nt = 8
n_therms = 4
n_sweeps = 3
n_bins = 3
n_stab = 4
seed = 3
dtype = float64
isMeasureUnequalTime = true
site_update = pallas
checkpoint_every = 1
[io]
sink = spool
[ParallelTempering]
enabled = true
sweep_steps = 2
betas = 1.0, 1.5, 2.0, 2.5
"""

SUMMARY_KEYS = ("acc_rate", "max_precision_error", "mean_precision_error",
                "therm_max_precision_error", "err_uneq_max", "n_stab",
                "observables", "walker_signs", "exchange_rate")

# one worker process of a two-process run: it forms the group through the
# [distributed] keys of each job and runs the jobs in turn, writing its
# walkers' fields and the summary; a job may stop after its N-th sweep
# pair (a run killed mid-way) or expect a ValueError
_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.parallel import tempering
from dqmc_tpu_torch.run import run_simulation

class Stop(Exception):
    pass

spec, rank = json.load(open(sys.argv[1])), int(sys.argv[2])
for i, job in enumerate(spec["jobs"]):
    params = Parameters.from_string(job["text"])
    params.set("distributed", "process_id", str(rank))
    real, calls = tempering.sweep_pair, []

    def counted(*a, **k):
        calls.append(1)
        if len(calls) == job.get("stop_at"):
            raise Stop
        return real(*a, **k)
    tempering.sweep_pair = counted
    try:
        s = run_simulation(params, out_dir=job["out"], verbose=False,
                           device="cpu")
    except Stop:
        continue
    except ValueError as e:
        if not job.get("raises"):
            raise
        json.dump({"raised": str(e)},
                  open(f"{spec['dir']}/job{i}_{rank}.json", "w"))
        continue
    finally:
        tempering.sweep_pair = real
    if job.get("raises"):
        raise SystemExit(f"job {i} did not raise")
    np.save(f"{spec['dir']}/job{i}_{rank}.npy", s.states.fields.numpy())
    json.dump({k: getattr(s, k) for k in spec["keys"]},
              open(f"{spec['dir']}/job{i}_{rank}.json", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, jobs):
    """Run ``jobs`` (dicts: text, out, and stop_at or raises) in two
    processes on gloo; returns per job the summary dict of each rank and
    the fields of both ranks in walker order.  A rank that fails, or a
    pair that outlives 120 s, fails the test."""
    port = _free_port()
    dist = (f"[distributed]\nnum_processes = 2\ncoordinator_address = "
            f"127.0.0.1:{port}\ntimeout = 60\n")
    jobs = [dict(j, text=j["text"] + dist) for j in jobs]
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs, "dir": str(tmp_path),
                                "keys": SUMMARY_KEYS}))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(spec),
                               str(r), REPO], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    res = []
    for i, job in enumerate(jobs):
        if job.get("stop_at"):
            res.append(None)
            continue
        summ = [json.loads((tmp_path / f"job{i}_{r}.json").read_text())
                for r in range(2)]
        fields = None if job.get("raises") else np.concatenate(
            [np.load(tmp_path / f"job{i}_{r}.npy") for r in range(2)])
        res.append((summ, fields))
    return res


def _summary(s) -> dict:
    return json.loads(json.dumps({k: getattr(s, k) for k in SUMMARY_KEYS}))


def _same_bins(dir_a, dir_b, n):
    for w in range(n):
        A = read_bins(os.path.join(dir_a, f"data_{w}.spool"))
        B = read_bins(os.path.join(dir_b, f"data_{w}.spool"))
        assert sorted(A) == sorted(B) and A, (w, sorted(A), sorted(B))
        for b in A:
            assert A[b].keys() == B[b].keys()
            for group, vals in A[b].items():
                assert vals.keys() == B[b][group].keys()
                for name, x in vals.items():
                    np.testing.assert_allclose(
                        B[b][group][name], x, rtol=0, atol=1e-12,
                        err_msg=f"walker {w} bin {b} {group}/{name}")


def test_walkers_split_over_devices_and_processes(tmp_path):
    """The standard driver, n_walkers = 8: unsplit, over [cpu, cpu], and
    over two processes (which also trace the first measured bin into
    profile_dir, one Chrome trace each); then n_walkers = 7 over two
    processes raises in both, and a single-process resume of the
    two-process run's checkpoints is refused naming both counts."""
    un = run_simulation(Parameters.from_string(PARAMS),
                        out_dir=str(tmp_path / "un"), verbose=False,
                        device="cpu")
    sp = run_simulation(Parameters.from_string(PARAMS),
                        out_dir=str(tmp_path / "sp"), verbose=False,
                        device="cpu", devices=["cpu", "cpu"])
    trace = tmp_path / "trace"
    (two, two_fields), (odd, _) = _two_processes(tmp_path, [
        dict(text=PARAMS + f"[simulation]\nprofile_dir = {trace}\n",
             out=str(tmp_path / "mp")),
        dict(text=PARAMS.replace("n_walkers = 8", "n_walkers = 7"),
             out=str(tmp_path / "odd"), raises=True)])
    fields = un.states.fields.numpy()
    assert np.array_equal(sp.states.fields.numpy(), fields)
    assert np.array_equal(two_fields, fields)
    want = _summary(un)
    assert _summary(sp) == want
    assert two[0] == two[1] == want
    for d in ("sp", "mp"):
        _same_bins(tmp_path / "un", tmp_path / d, 8)
    # process p writes data_<4p + w> and its own checkpoint
    assert not (tmp_path / "mp" / "data_8.spool").exists()
    meta = [peek_meta(tmp_path / "mp" / f"checkpoint_{r}.npz")
            for r in range(2)]
    assert [(m["num_processes"], m["rank_offset"]) for m in meta] == [
        (2, 0), (2, 4)]
    for r in range(2):
        text = (trace / f"trace_{r}.json").read_text()
        assert '"traceEvents"' in text and "aten::" in text
    for r in range(2):
        assert "not divisible by [distributed] num_processes = 2" in \
            odd[r]["raised"]
    # the two-process run's checkpoints do not resume in one process
    with pytest.raises(ValueError, match="2 process.*this run has 1"):
        run_simulation(Parameters.from_string(PARAMS),
                       out_dir=str(tmp_path / "mp"), verbose=False,
                       device="cpu")


def _exchange_record(path):
    meta = peek_meta(path)
    return [meta[k] for k in ("attempt", "accepted", "exchange_gen")]


def test_tempering_split_over_devices_and_processes(tmp_path):
    """Parallel tempering on a 4-beta ladder: unsplit, replicas over
    [cpu, cpu], and over two processes straight and stopped twice (in
    thermalization pair 4, after the checkpoint of pair 3, and in
    measured sweep 5, after the checkpoint of bin 0 and two exchange
    attempts) and resumed each time: the same exchange decisions and
    rate, fields and bins."""
    un = run_simulation(Parameters.from_string(PT_PARAMS),
                        out_dir=str(tmp_path / "un"), verbose=False,
                        device="cpu")
    sp = run_simulation(Parameters.from_string(PT_PARAMS),
                        out_dir=str(tmp_path / "sp"), verbose=False,
                        device="cpu", devices=["cpu", "cpu"])
    assert 0.0 < un.exchange_rate < 1.0
    res = _two_processes(tmp_path, [
        dict(text=PT_PARAMS, out=str(tmp_path / "mp")),
        dict(text=PT_PARAMS, out=str(tmp_path / "re"), stop_at=4),
        dict(text=PT_PARAMS, out=str(tmp_path / "re"), stop_at=6),
        dict(text=PT_PARAMS, out=str(tmp_path / "re"))])
    (two, two_fields), (resumed, re_fields) = res[0], res[3]
    fields = un.states.fields.numpy()
    assert np.array_equal(sp.states.fields.numpy(), fields)
    assert np.array_equal(two_fields, fields)
    assert np.array_equal(re_fields, fields)
    want = _summary(un)
    assert _summary(sp) == want
    assert two[0] == two[1] == want
    # the resumed run's chain statistics come from its checkpoints (its
    # observables and transient error count only the bins it ran)
    chain = ("acc_rate", "max_precision_error", "mean_precision_error",
             "walker_signs", "exchange_rate")
    assert [resumed[r][k] for r in range(2) for k in chain] == [
        want[k] for _ in range(2) for k in chain]
    record = _exchange_record(tmp_path / "un" / "checkpoint.npz")
    assert record[0] == 4
    assert _exchange_record(tmp_path / "sp" / "checkpoint.npz") == record
    for d in ("mp", "re"):
        for r in range(2):
            assert _exchange_record(
                tmp_path / d / f"checkpoint_{r}.npz") == record
    for d in ("sp", "mp", "re"):
        _same_bins(tmp_path / "un", tmp_path / d, 4)


def test_checkpoint_resumes_under_any_split(tmp_path, monkeypatch,
                                            capsys):
    """One process keeps one checkpoint file of its gathered chunks, so a
    run over [cpu, cpu] stopped in the measurement resumes unsplit and
    ends as the straight run does; devices that do not divide the walkers
    warn and run unsplit; the helpers' single-process forms, and an
    address without a process count refused."""
    from dqmc_tpu_torch import run as trun
    from dqmc_tpu_torch.parallel import distributed, walkers
    straight = run_simulation(Parameters.from_string(PARAMS),
                              out_dir=str(tmp_path / "straight"),
                              verbose=False, device="cpu")
    real, calls = trun.sweep_pair, []

    def counted(*a, **k):
        calls.append(1)
        if len(calls) == 2 * 5 + 1:       # two chunks: pair 5, chunk 0
            raise RuntimeError("stopped")
        return real(*a, **k)
    monkeypatch.setattr(trun, "sweep_pair", counted)
    with pytest.raises(RuntimeError, match="stopped"):
        run_simulation(Parameters.from_string(PARAMS),
                       out_dir=str(tmp_path / "re"), verbose=False,
                       device="cpu", devices=["cpu", "cpu"])
    monkeypatch.setattr(trun, "sweep_pair", real)
    assert peek_meta(tmp_path / "re" / "checkpoint.npz")["bin"] == 1
    resumed = run_simulation(Parameters.from_string(PARAMS),
                             out_dir=str(tmp_path / "re"), verbose=False,
                             device="cpu")
    assert torch.equal(resumed.states.fields, straight.states.fields)
    assert torch.equal(resumed.states.G, straight.states.G)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in
               zip(resumed.states.gens, straight.states.gens))
    _same_bins(tmp_path / "straight", tmp_path / "re", 8)

    odd = run_simulation(Parameters.from_string(PARAMS),
                         out_dir=str(tmp_path / "odd"), verbose=False,
                         device="cpu",
                         devices=["cpu"] * 3)
    assert "n_walkers=8 not divisible by 3 devices" in capsys.readouterr().err
    assert torch.equal(odd.states.fields, straight.states.fields)

    distributed.initialize_distributed(None, 1, 0)   # one process: no-op
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs num_processes"):
        distributed.initialize_distributed("127.0.0.1:1", None, None)
    assert distributed.local_rank_offset(4, 2) == 0
    assert walkers.local_devices(0, "cpu") == [torch.device("cpu")]
    assert trun.process_checkpoint_path("a/c.npz", 1, 0) == "a/c.npz"
    assert trun.process_checkpoint_path("a/c.npz", 4, 3) == "a/c_3.npz"
    chunks = walkers.split_walkers(straight.states, [torch.device("cpu")] * 4)
    assert [c.G.shape[0] for c in chunks] == [2] * 4
    back = walkers.gather_walkers(chunks)
    assert torch.equal(back.G, straight.states.G)
    assert back.gens == straight.states.gens
