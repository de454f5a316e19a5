"""The measured window: requests back to back from its start.

A request that begins before ``seconds`` have passed runs to its end and
counts; the window ends when the last one ends, and every rate divides by
that whole window. The first request always runs, so a window is never
empty.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, NamedTuple


class Done(NamedTuple):
    request: dict
    start: float            # seconds from the window's start
    end: float
    output: object


class Window(NamedTuple):
    done: List[Done]
    seconds: float          # from the window's start to the last end


def run_window(requests: Iterable[dict], run_one: Callable[[dict], object],
               seconds: float, clock: Callable[[], float] = time.perf_counter
               ) -> Window:
    """``run_one(request)`` must return only once the device is idle."""
    t0 = clock()
    done: List[Done] = []
    for req in requests:
        start = clock() - t0
        if done and start >= seconds:
            return Window(done, done[-1].end)
        out = run_one(req)
        done.append(Done(req, start, clock() - t0, out))
    if not done or done[-1].end < seconds:
        raise RuntimeError(f"the mix ran out of requests after {len(done)} "
                           f"in a window of {seconds} s")
    return Window(done, done[-1].end)
