"""Tracing and metrics (port of ``omg_tpu/utils/profiling.py``).

  * ``trace(name)``: a ``torch.profiler.record_function`` range (visible
    in a ``torch.profiler`` capture) plus a host-clock record in
    ``METRICS``, taken in a ``finally`` so failed requests count too;
  * ``Metrics``: process-local counters and bounded latency records the
    server reports at ``/metrics``;
  * ``device_memory_stats``: the CUDA caching allocator's bytes in use,
    peak and reserved, and the card's size, per card.

The JAX module's ``start_server`` (the XLA profiler server) and
``compiled_peak_bytes`` (XLA's memory analysis of a compiled program)
have no counterpart: torch compiles no whole program ahead of time, and
``torch.cuda.max_memory_allocated`` reads the peak directly.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import threading
import time
from typing import Dict, Optional

import torch


class Metrics:
    """Thread-safe counters and latency records. Each timing keeps its
    most recent ``max_samples`` values, so a long-lived server neither
    leaks nor sorts an ever-growing list on each scrape."""

    def __init__(self, max_samples: int = 4096):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.timings: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=max_samples))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def record(self, name: str, seconds: float):
        with self._lock:
            self.timings[name].append(seconds)

    def summary(self) -> dict:
        with self._lock:
            out = {"counters": dict(self.counters), "latency": {}}
            for name, vals in self.timings.items():
                if not vals:
                    continue
                s = sorted(vals)
                out["latency"][name] = {
                    "n": len(s),
                    "p50": statistics.median(s),
                    "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                    "mean": sum(s) / len(s),
                }
            return out


METRICS = Metrics()


@contextlib.contextmanager
def trace(name: str, metrics: Optional[Metrics] = None):
    """A profiler range and a host-clock record around a block; recorded
    in a finally so that failing requests still contribute samples."""
    m = metrics or METRICS
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        m.record(name, time.perf_counter() - t0)


def device_memory_stats() -> dict:
    """Per-card memory of the CUDA caching allocator ({} without a card)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_reserved": stats.get("reserved_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
