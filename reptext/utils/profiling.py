"""Tracing / profiling hooks (aux subsystem; the reference has none —
SURVEY.md §5 "Tracing/profiling: none. Only a tqdm progress bar").

Provides a jax.profiler trace context for TensorBoard-viewable device traces
and a lightweight step timer for throughput accounting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profiler trace viewable in TensorBoard/XProf/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class StepTimer:
    """Wall-clock step timing with warmup exclusion.

    Usage:
        timer = StepTimer(warmup=2)
        for _ in range(n):
            with timer.step():
                out = fn(x); jax.block_until_ready(out)
        print(timer.summary())
    """

    warmup: int = 1
    times: List[float] = dataclasses.field(default_factory=list)
    _seen: int = 0

    @contextlib.contextmanager
    def step(self):
        start = time.perf_counter()
        yield
        elapsed = time.perf_counter() - start
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(elapsed)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "min_s": ts[0],
            "max_s": ts[-1],
        }
