"""The benchmark's own spans and the reduction of a device trace.

``Spans`` times each forward of the program modules the benchmark names
(forward hooks: the program is not edited) while it records: host spans
on the wall clock that the profiler's device timestamps use
(``time.time_ns``), the batch of every UNet forward, and a pair of CUDA
events around each UNet forward. The profiler traces the device only
(CUPTI), which keeps its cost on the host small; ``reduce`` turns the raw
events of one traced request into numbers, in memory: the device's busy
time, the kernels by name, the flash-attention kernel's time, and the
idle gaps, each put to the innermost benchmark span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional

import torch

K1_NAME = "flash_fwd_kernel"
REQUEST = "bench.request"
UNET = "bench.unet"
TOP = 10


class Spans:
    """Host spans of named module forwards while ``recording``."""

    def __init__(self):
        self.handles = []
        self.spans: List[tuple] = []        # (start ns, end ns, name)
        self.lanes: List[int] = []          # batch of each UNet forward
        self.unet_events: List[tuple] = []  # CUDA event pairs
        self.recording = False

    def attach(self, module: torch.nn.Module, name: str) -> None:
        stack = []

        def pre(mod, args, kwargs):
            if not self.recording:
                return
            x = args[0] if args else next(iter(kwargs.values()))
            ev = None
            if name == UNET:
                self.lanes.append(int(x.shape[0]))
                if x.is_cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
            stack.append((time.time_ns(), ev))

        def post(mod, args, kwargs, out):
            if not self.recording or not stack:
                return
            t0, ev = stack.pop()
            if ev is not None:
                ev[1].record()
                self.unet_events.append(ev)
            self.spans.append((t0, time.time_ns(), name))

        self.handles += [
            module.register_forward_pre_hook(pre, with_kwargs=True),
            module.register_forward_hook(post, with_kwargs=True)]

    @contextlib.contextmanager
    def request(self):
        self.recording = True
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), REQUEST))
            self.recording = False

    def unet_ms(self) -> List[float]:
        """Device ms of each recorded UNet forward (after a synchronize)."""
        return [a.elapsed_time(b) for a, b in self.unet_events]

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def profile():
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CUDA])


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_events(prof) -> list:
    """(start ns, end ns, name) of every operation on the device, from the
    profiler's raw events (no per-event Python objects are built)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out)


def reduce(dev: list, spans: list) -> Optional[dict]:
    """One traced request -> {window_s, busy_s, kernels {name: s}, k1_s,
    k1_calls, gaps {span: s}}; None when the device ran nothing.

    ``dev``: ``device_events``; ``spans``: ``Spans.spans`` of the request
    (its own span included). The window runs from the request's start on
    the host to the later of its end and the last device operation."""
    req = [s for s in spans if s[2] == REQUEST]
    if not dev or not req:
        return None
    w0 = req[0][0]
    if not w0 - 10e9 < dev[0][0] < req[0][1]:
        raise RuntimeError(
            f"the device trace's clock is {(dev[0][0] - w0) / 1e9:.3f} s "
            "from the host's: spans and kernels cannot be aligned")
    w1 = max(req[0][1], max(e for _, e, _ in dev))
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in dev if e > w0])
    kernels: Dict[str, float] = {}
    k1_ns, k1_n = 0, 0
    for s, e, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
        if K1_NAME in name:
            k1_ns += e - s
            k1_n += 1
    inner = sorted((s for s in spans if s[2] != REQUEST), key=lambda s: s[0])
    starts = [s[0] for s in inner]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: Dict[str, float] = {}
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        # the named modules' forwards never nest: the latest span to
        # start before the middle holds it, or none does
        i = bisect.bisect_right(starts, mid) - 1
        owner = inner[i][2] if i >= 0 and inner[i][1] >= mid else REQUEST
        gaps[owner] = gaps.get(owner, 0.0) + (g1 - g0) / 1e9
    return dict(window_s=(w1 - w0) / 1e9,
                busy_s=sum(e - s for s, e in busy) / 1e9,
                kernels=kernels, k1_s=k1_ns / 1e9, k1_calls=k1_n, gaps=gaps)


def breakdown(red: dict) -> dict:
    """The line's ``breakdown``: the device operations that took most time
    and the idle gaps by span, at most ``TOP`` each."""
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
