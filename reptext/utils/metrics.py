"""Lightweight structured metrics (counters / gauges / timings).

The reference has no metrics at all (SURVEY.md §5 "Metrics/logging: none").
This registry backs serving and benchmarking: thread-safe counters and
timing histograms, dumped as one JSON object.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Dict, List


class Metrics:
    """Process-local metrics registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, List[float]] = defaultdict(list)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timings[name].append(seconds)

    def time(self, name: str):
        """Context manager: with metrics.time("step"): ..."""
        registry = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.observe(name, time.perf_counter() - self._t0)
                return False

        return _Timer()

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {"counters": dict(self._counters), "gauges": dict(self._gauges)}
            timings = {}
            for name, vals in self._timings.items():
                if not vals:
                    continue
                s = sorted(vals)
                n = len(s)
                timings[name] = {
                    "count": n,
                    "mean_s": sum(s) / n,
                    "p50_s": s[n // 2],
                    "p95_s": s[min(n - 1, int(n * 0.95))],
                    "max_s": s[-1],
                }
            out["timings"] = timings
            return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot())


# default process-wide registry
default_metrics = Metrics()
