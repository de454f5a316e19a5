"""The program's own records of a run's window, for the per-layer
metrics that read its spans and counters.

The program (``omg_tpu_torch.utils.profiling``) keeps a record of each
top-level call in ``REQUESTS``: a tree of spans (the request's root, its
phases, each denoise step, the UNet forward under it) with host times,
device times from CUDA events, and counters (``sync``, ``sync_wait_ns``,
``lora.lane_deltas``, ...). A run's window is the last ``len(rec.done)``
records of the cell's root before the traced request, which is the last
one; the warm-up's records come before them. Every reader returns None
where there is nothing to read: a program without records, fewer
records than requests, a record whose first stage has not the
configuration's step count, or (for device times) no CUDA events.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from omg_tpu_torch.utils import profiling


def window(rec, root: str) -> Optional[list]:
    """The window's records of root span ``root``, oldest first, their
    device times resolved; or None."""
    kept = getattr(profiling, "REQUESTS", None)     # None: an older program
    if kept is None:
        return None
    mine = [r for r in list(kept) if r.spans and r.root.name == root]
    n = len(rec.done)
    if n == 0 or len(mine) < n + 1:
        return None
    out = mine[-n - 1:-1]
    steps = rec.cfg["pipeline"]["num_steps"]
    for r in out:
        first = next((s for s in r.children(r.root) if r.children(s, "step")),
                     None)
        if first is None or len(r.children(first, "step")) != steps:
            return None
    return [r.resolve() for r in out]


def phase_steps(r, phase: str) -> list:
    """The step spans of every ``phase`` span of record ``r``."""
    return [s for p in r.children(r.root, phase)
            for s in r.children(p, "step")]


def per_step(rec, root: str, phase: str,
             value: Callable) -> Optional[float]:
    """The mean of ``value(record, step)`` over the window's steps of
    ``phase``; None where a value is None or there is no step."""
    records = window(rec, root)
    if records is None:
        return None
    vals: List[float] = [value(r, s) for r in records
                         for s in phase_steps(r, phase)]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def syncs(r, step) -> float:
    """Blocking host-device operations in a step and under it."""
    return float(r.total(step, "sync"))


def host_wait_ms(r, step) -> float:
    """The host's ms waiting in them."""
    return r.total(step, "sync_wait_ns") / 1e6


def device_s(span) -> Optional[float]:
    """A timed span's device seconds (None without CUDA events)."""
    if span.device_ns is None:
        return None
    return span.device_ns / 1e9
