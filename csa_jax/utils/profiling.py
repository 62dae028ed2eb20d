"""Per-phase observability (SURVEY.md §5 tracing row — greenfield here;
the reference's only instrumentation is a tree-op counter and stdout dots,
gencycsuffixtrees.h:34, dynamicprogramming.c:917).

A process-global :class:`PhaseTimer` accumulates named wall-clock phases
and scalar counters (DP cells, device dispatches, bytes moved).  Disabled
(the default) it costs one attribute check per use.  ``--profile`` on the
CLI enables it and prints the report; ``CSA_JAX_TRACE=<dir>`` wraps
the run in a JAX profiler trace for xprof/tensorboard.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, TextIO


class PhaseTimer:
    """Phase times are summed across threads (concurrent phases of the
    same name accumulate their overlapping wall-clock)."""

    def __init__(self):
        self.enabled = False
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self.phases.clear()
            self.counts.clear()
            self.counters.clear()

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.phases[name] = self.phases.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, counter: str, value: float):
        if self.enabled:
            with self._lock:
                self.counters[counter] = self.counters.get(counter, 0.0) + value

    def report(self, out: TextIO):
        if not self.phases and not self.counters:
            return
        total = sum(self.phases.values())
        print("> [profile] phase breakdown:", file=out)
        for name, secs in sorted(
            self.phases.items(), key=lambda kv: -kv[1]
        ):
            n = self.counts.get(name, 1)
            per = f" ({n}x)" if n > 1 else ""
            print(f">   {name:<28} {secs:8.3f}s{per}", file=out)
        print(f">   {'TOTAL (instrumented)':<28} {total:8.3f}s", file=out)
        dp_cells = self.counters.get("dp_cells", 0.0)
        dp_secs = self.phases.get("align.dp_fill", 0.0)
        if dp_cells and dp_secs:
            print(
                f"> [profile] DP cell-updates: {dp_cells:.3g} cells, "
                f"{dp_cells / dp_secs / 1e9:.3f} Gcells/s",
                file=out,
            )
        for name in sorted(self.counters):
            if name != "dp_cells":
                print(
                    f"> [profile] {name}: {self.counters[name]:.6g}",
                    file=out,
                )


PROFILER = PhaseTimer()


@contextmanager
def jax_trace(trace_dir: Optional[str]):
    """Optional JAX profiler trace (xprof) around a region."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
