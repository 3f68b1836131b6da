#!/usr/bin/env python3
"""Simulate pytest-xdist's `--dist loadfile` schedule from measured test times.

    python3 scripts/xdist_schedule_sim.py JUNIT_XML COLLECTED [-n 6]
        [--move FUNC=FILE ...] [--noise 0.3 --samples 300]

JUNIT_XML holds each test's seconds (pytest's `--junitxml` of a full run);
COLLECTED is `pytest tests/ -q --collect-only` output (one node id a
line): the tests to schedule, in collection order. A test absent from the
XML counts 0.05 s. `--move FUNC=FILE` puts every test of function FUNC
into file FILE (a what-if split: its times stay the measured ones).

The model follows xdist 3's LoadScopeScheduling: files ordered by their
test count, most first (`--loadscope-reorder`, the default; ties in
collection order); each worker gets one file, then one more whenever at
most 2 of its tests are still pending; a worker runs its tests in order.
Prints the makespan in seconds, and with `--noise S` the median and 90th
percentile over `--samples` runs whose every test time is multiplied by
a lognormal factor exp(N(0, S)).
"""

from __future__ import annotations

import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET


def load(junit: str, collected: str, moves: dict[str, str]) -> dict[str, list[float]]:
    """File -> its tests' seconds, files in collection order."""
    times = {}
    for tc in ET.parse(junit).iter("testcase"):
        times[(tc.get("classname").split(".")[-1], tc.get("name"))] = float(tc.get("time"))
    files: dict[str, list[float]] = collections.OrderedDict()
    for line in open(collected):
        path, sep, name = line.strip().partition("::")
        if not sep:
            continue
        f = path.rsplit("/", 1)[-1].removesuffix(".py")
        t = times.get((f, name), 0.05)
        files.setdefault(moves.get(name.split("[")[0], f), []).append(t)
    return collections.OrderedDict(sorted(files.items()))


def makespan(files: dict[str, list[float]], workers: int) -> float:
    queue = collections.deque(sorted(files.items(), key=lambda kv: -len(kv[1])))
    pending = [collections.deque() for _ in range(workers)]

    def give(w: int) -> None:
        if queue:
            pending[w].extend(queue.popleft()[1])

    for w in range(workers):
        give(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            give(w)
    heap, end = [(0.0, w) for w in range(workers)], 0.0
    while heap:
        t, w = heapq.heappop(heap)
        if not pending[w]:
            end = max(end, t)
            continue
        t += pending[w].popleft()
        if len(pending[w]) <= 2:
            give(w)
        heapq.heappush(heap, (t, w))
    return end


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("collected")
    ap.add_argument("-n", type=int, default=6)
    ap.add_argument("--move", action="append", default=[])
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--samples", type=int, default=300)
    a = ap.parse_args()
    files = load(a.junit, a.collected, dict(m.split("=", 1) for m in a.move))
    print(f"tests {sum(map(len, files.values()))}, files {len(files)}, "
          f"seconds {sum(map(sum, files.values())):.0f}, makespan {makespan(files, a.n):.0f}")
    if a.noise:
        runs = sorted(makespan({f: [t * random.Random(s * 7919 + i).lognormvariate(0, a.noise)
                                    for i, t in enumerate(ts)] for f, ts in files.items()}, a.n)
                      for s in range(a.samples))
        print(f"noise {a.noise}: median {runs[len(runs) // 2]:.0f}, "
              f"p90 {runs[int(len(runs) * 0.9)]:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
