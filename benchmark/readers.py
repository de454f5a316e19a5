"""What the per-layer metric files read from a run's ``Record``. Each
returns None where the run holds nothing to read, and the metric is then
left out of the line."""

from __future__ import annotations

from typing import Optional

from benchmark import flops


def mean_timing(rec, phase: str) -> Optional[float]:
    """Mean seconds per request of one ``GenerationResult.timings`` phase
    (host clock, each phase ended by a synchronize)."""
    vals = [d.output["timings"][phase] for d in rec.done
            if phase in d.output.get("timings", {})]
    return sum(vals) / len(vals) if vals else None


def mfu(rec) -> Optional[float]:
    """% of the bf16 dense peak: the model FLOPs of the window's requests
    over the window."""
    if not rec.done or rec.seconds <= 0:
        return None
    return 100.0 * sum(rec.flops) / rec.seconds / flops.PEAK_BF16_FLOPS


def k1_roofline(rec) -> Optional[float]:
    """% of its roofline: the sum of the K1 calls' bounds (from their
    shapes) over K1's device time, in the traced request. Nothing when
    the trace's K1 kernels are not the calls the shapes predict."""
    t = rec.trace
    if t is None or not t["k1_calls"] or t["k1_s"] <= 0 or \
            t["k1_calls"] != len(rec.k1_calls):
        return None
    bound = sum(flops.k1_bound_s(*c) for c in rec.k1_calls)
    return 100.0 * bound / t["k1_s"]


def device_idle(rec) -> Optional[float]:
    """% of the traced request's wall time with no operation on the
    device."""
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def unet_forward_ms(rec) -> Optional[float]:
    """Mean device ms of a UNet forward in the traced request: CUDA events
    recorded on the stream around each forward."""
    t = rec.trace
    if t is None:
        return None
    vals = [v for v in t["unet_forward_ms"] if v > 0]
    return sum(vals) / len(vals) if vals else None
