"""Memory-map budget of the test suite under pytest-xdist's load scheduler.

XLA:CPU maps three memory regions for every executable it holds and frees
them only at jax.clear_caches(); a process may hold vm.max_map_count regions
(65530 by default), and the compile that passes the limit kills the worker.
tests/test_parity.py alone leaves about 61000 regions behind, so whether a
run survives depends on which other tests share its worker -- and under
``--dist load`` that follows from the number of collected tests alone:
the scheduler hands out consecutive runs of tests whose lengths are
fractions of what is still pending.

Two uses.

1. As a plugin, record each worker's region count after every test::

       MAP_TRACE_DIR=/tmp/maps PYTHONPATH=tests python -m pytest tests/ \
           -m 'not slow' -p xdist -n 6 --dist load -p xdist_map_budget \
           --junitxml=/tmp/run.xml

2. As a script, replay the scheduler on that run's durations and region
   growth, for the collected tests as they are and with up to ``--extra``
   more port tests, and print how the test_parity.py tests split over
   workers and the highest region count any worker reaches::

       python tests/xdist_map_budget.py --junit /tmp/run.xml \
           --traces /tmp/maps --extra 80

   Keep the predicted peak well under the limit; a count that splits
   test_parity.py over two workers leaves the most room.  The schedule
   also follows the tests' durations (a free worker is handed the next
   run): ``--jitter 3`` replays the collected tests 200 times with every
   duration scaled at random by up to 3x either way and counts the
   replays whose peak passes the limit.
"""

import argparse
import glob
import heapq
import os
import random
import subprocess
import sys
import xml.etree.ElementTree as ET

LIMIT = 65530
BASELINE = 1500           # regions of a worker that has only imported
PORT_HIGH_WATER = 30000   # torch_port_util.release_jax_programs


def _n_maps():
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


_controller = False


def pytest_configure(config):
    # xdist's controller reports every test too, and runs none
    global _controller
    _controller = (getattr(config.option, "dist", "no") != "no"
                   and "PYTEST_XDIST_WORKER" not in os.environ)


def pytest_runtest_logfinish(nodeid, location):
    out = os.environ.get("MAP_TRACE_DIR")
    if out and not _controller:
        os.makedirs(out, exist_ok=True)
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(os.path.join(out, worker + ".txt"), "a") as f:
            f.write(f"{_n_maps()} {nodeid}\n")


def _collected(marker):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "--collect-only",
         "-m", marker, "-n", "0", "-p", "no:cacheprovider"],
        capture_output=True, text=True, env=dict(os.environ,
                                                 JAX_PLATFORMS="cpu"))
    return [line.strip() for line in out.stdout.splitlines() if "::" in line]


def _durations(junit):
    root = ET.parse(junit).getroot()
    suite = root if root.tag == "testsuite" else root[0]
    return {case.get("classname").replace(".", "/") + ".py::"
            + case.get("name"): float(case.get("time")) for case in suite}


def _growth(traces):
    """Regions each test added; a large drop marks a test that clears
    JAX's caches (in a port test that is the high-water fixture, which
    replay() applies itself).  A test that killed its worker left no line."""
    growth = {}
    for path in glob.glob(os.path.join(traces, "*.txt")):
        prev = BASELINE
        for line in open(path):
            count, nodeid = line.split(" ", 1)
            nodeid, grew = nodeid.strip(), int(count) - prev
            prev = int(count)
            if grew > -5000 or "tests/test_torch_" not in nodeid:
                growth[nodeid] = grew
    return growth


def replay(names, dur, growth, workers=6):
    """xdist's LoadScheduling on ``names``: returns (parity tests per worker
    that ran any, highest region count over workers, wall seconds)."""
    n = len(names)
    pending = list(range(n))
    queue = [[] for _ in range(workers)]
    maps = [BASELINE] * workers
    peak = BASELINE
    parity = [0] * workers
    first = max(n // workers // 4, 2)
    for w in range(workers):
        queue[w], pending = pending[:first], pending[first:]
    events = []

    def start(w, now):
        # a worker runs a test only once it knows the one after it
        if len(queue[w]) >= 2 or (not pending and queue[w]):
            i = queue[w][0]
            heapq.heappush(events, (now + dur.get(names[i], 1.0), w, i))

    for w in range(workers):
        start(w, 0.0)
    now = 0.0
    while events:
        now, w, i = heapq.heappop(events)
        queue[w].remove(i)
        name = names[i]
        if "tests/test_torch_" in name and maps[w] > PORT_HIGH_WATER:
            maps[w] = BASELINE
        grew = growth.get(name, 100)
        maps[w] = BASELINE if grew < -5000 else maps[w] + grew
        peak = max(peak, maps[w])
        parity[w] += "tests/test_parity.py" in name
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            took = dur.get(name, 1.0)
            if len(queue[w]) < low and not (took >= 0.1
                                            and len(queue[w]) >= 2):
                k = high - len(queue[w])
                queue[w] += pending[:k]
                del pending[:k]
        start(w, now)
    return [p for p in parity if p], peak, now


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--junit", required=True)
    ap.add_argument("--traces", required=True)
    ap.add_argument("--extra", type=int, default=0)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--marker", default="not slow")
    ap.add_argument("--jitter", type=float, default=0.0)
    args = ap.parse_args()
    names = _collected(args.marker)
    dur, growth = _durations(args.junit), _growth(args.traces)
    unknown = sum(name not in growth for name in names)
    print(f"{len(names)} tests collected, {unknown} without a trace "
          f"(taken as 100 regions, 1 s); limit {LIMIT}")
    at = max(i for i, name in enumerate(names) if "tests/test_torch_" in name)
    runs = []   # [first count, last count, split, worst peak, wall]
    for extra in range(args.extra + 1):
        padded = names[:at + 1] + [f"tests/test_torch_extra::{k}"
                                   for k in range(extra)] + names[at + 1:]
        split, peak, wall = replay(padded, dur, growth, args.workers)
        if runs and runs[-1][2] == split:
            runs[-1][1] = len(padded)
            runs[-1][3] = max(runs[-1][3], peak)
        else:
            runs.append([len(padded), len(padded), split, peak, wall])
    for first, last, split, peak, wall in runs:
        print(f"{first}-{last} tests: test_parity.py split {split}, "
              f"peak {peak} regions{' (DIES)' if peak >= LIMIT else ''}, "
              f"{wall:.0f} s")
    if args.jitter:
        rng = random.Random(0)
        peaks = [replay(names, {k: v * args.jitter ** rng.uniform(-1, 1)
                                for k, v in dur.items()}, growth,
                        args.workers)[1] for _ in range(200)]
        print(f"durations scaled by up to {args.jitter}x either way: "
              f"{sum(p >= LIMIT for p in peaks)} of 200 replays die, worst "
              f"peak {max(peaks)}")


if __name__ == "__main__":
    main()
