"""Named-scope wall timing + optional jax.profiler trace annotations.

Replaces the reference's deal.II TimerOutput scopes ("vmult", "vanka", "gmg",
"step"; SURVEY.md section 5).  Device work is asynchronous: a scope waits for
it (block_until_ready) only when given a `sync_value`; traces feed the jax
profiler when a capture is active.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync_value=None):
        with jax.profiler.TraceAnnotation(name):
            t0 = time.time()
            yield
            if sync_value is not None:
                jax.block_until_ready(sync_value)
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        lines = ["+---------------------------------+------------+--------+",
                 "| Section                         | wall time  | calls  |",
                 "+---------------------------------+------------+--------+"]
        for name in sorted(self.totals):
            lines.append(f"| {name:<31} | {self.totals[name]:9.3f}s | "
                         f"{self.counts[name]:6d} |")
        lines.append(lines[0])
        return "\n".join(lines)

    def print_wall_time_statistics(self):
        print(self.summary())
