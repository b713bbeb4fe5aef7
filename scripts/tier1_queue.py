"""When each test file of a pytest-xdist run started and ended, and on which
worker: to see where the Tier-1 queue hands out its long poles.

As a pytest plugin it appends one line per test start and end to
$TIER1_QUEUE_DIR/<pid>.log (each xdist worker writes its own file). Run
the Tier-1 command (ROADMAP.md, "Tier-1 verify") with it loaded:

    mkdir -p /tmp/q
    TIER1_QUEUE_DIR=/tmp/q PYTHONPATH=scripts python -m pytest tests/ \\
        -q -m 'not slow' -p xdist -n 6 --dist loadfile -p tier1_queue

then read the logs:

    python scripts/tier1_queue.py /tmp/q [NAME ...]

It prints every file that held a worker for more than 20 s, and the files
whose names contain a NAME, as seconds from the first test: start, end,
duration and worker; then when the last test ended and when each worker
went idle.
"""
import collections
import glob
import os
import sys
import time

_log = None


def _out():
    global _log
    if _log is None:
        path = os.path.join(os.environ["TIER1_QUEUE_DIR"],
                            f"{os.getpid()}.log")
        _log = open(path, "a", buffering=1)
    return _log


def pytest_runtest_logstart(nodeid, location):
    _out().write(f"{time.time():.3f} start {nodeid}\n")


def pytest_runtest_logfinish(nodeid, location):
    _out().write(f"{time.time():.3f} end {nodeid}\n")


def file_spans(log_dir: str) -> list:
    """[(start, end, file, worker log)] in seconds from the first test;
    end is NaN for a file still running.  The controller's log (it sees
    every test, and is the largest) is left out."""
    logs = sorted(glob.glob(os.path.join(log_dir, "*.log")))
    controller = max(logs, key=os.path.getsize)
    first, last, worker = {}, {}, {}
    for path in logs:
        if path == controller:
            continue
        with open(path) as f:
            for line in f:
                t, kind, node = line.split(" ", 2)
                t, name = float(t), node.strip().split("::")[0]
                if kind == "start":
                    first[name] = min(first.get(name, t), t)
                    worker[name] = os.path.basename(path)
                else:
                    last[name] = max(last.get(name, t), t)
    t0 = min(first.values())
    return sorted((first[n] - t0, last.get(n, float("nan")) - t0, n,
                   worker[n]) for n in first)


def main() -> None:
    log_dir, names = sys.argv[1], sys.argv[2:]
    spans = file_spans(log_dir)
    for start, end, name, worker in spans:
        if end - start > 20 or any(n in name for n in names):
            print(f"{start:8.1f} {end:8.1f} {end - start:7.1f}  "
                  f"{worker:12s} {name}")
    ends = collections.defaultdict(float)
    for _, end, _, worker in spans:
        ends[worker] = max(ends[worker], end)
    print(f"last test ended at {max(e for _, e, _, _ in spans):.1f} s; "
          f"workers idle at {sorted(round(v) for v in ends.values())} s")


if __name__ == "__main__":
    main()
