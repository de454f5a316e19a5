"""Serving over a mesh: rank 0 serves HTTP and hands each job group it
runs to the follower ranks, which run the same calls in the same order.

    python -m omg_tpu_torch.cli.serve --mesh 2 ...

Every rank builds the same ``OMGServer`` over ``OMG(mesh=...)``. Rank 0's
queue worker decides what to run (``_run_group``: one job or a batch,
jobs abandoned by their clients dropped first); for each such group its
``Handover`` stores the cleaned job dicts (``OMGServer._clean``, so
without ``_req``) under the next job number in the world's rendezvous
store (``comm.store()``), then runs them. Each follower polls the store
for that number, makes the same ``_generate`` / ``_generate_batch`` call,
which rebuilds every request with ``_job_to_request``, and drops the
payload. The last rank to read a job deletes its key.

  * An idle follower waits on a store poll, not on a collective, so it
    waits for as long as no request comes; every collective keeps its
    finite timeout (``comm.init``).
  * An error raised before a rank's first collective of the job (request
    validation, which every rank meets alike) fails that job only: rank 0
    answers 500 and the followers go on. An error after the ranks began to
    communicate may leave them out of step, so it ends the server: rank 0
    stops serving and raises, a follower raises, and ``launch.spawn``
    stops every rank with that rank's traceback.
  * ``OMGServer.shutdown()`` on rank 0 stores a stop under the next number
    and the followers return. SIGTERM or SIGINT of a rank shuts it down the
    same way (rank 0 through ``shutdown``; a follower returns at its next
    poll).

Every rank prints one JSON line per job group it ran: {"serve_mesh_job":
n, "rank", "requests", "seconds", "error", "images": the sha256 of each
returned PNG (final image, then stage 1; equal on every rank that ran in
step), "launches": [K1, K1b] kernel launches during the job}.
"""

from __future__ import annotations

import hashlib
import json
import pickle
import signal
import sys
import threading
import time
from typing import Optional

from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.parallel import comm

KEY = "omg_serve/job/{}"
POLL_S = 0.01       # a follower's store poll


class LockstepError(RuntimeError):
    """A job failed after its ranks began to communicate."""


class Handover:
    """One rank's end of the job handover of a mesh of ``world_size``
    ranks; rank 0 leads, the others follow."""

    def __init__(self, rank: int, world_size: int, store=None):
        self.rank, self.world_size = rank, world_size
        self.store = comm.store() if store is None else store
        self.next = 0                       # the next job number
        self.stopped = False
        self.fatal: Optional[BaseException] = None
        self.on_fatal = None                # rank 0: ends the server
        self._lock = threading.Lock()

    # ------------------------------------------------------------ rank 0

    def _publish(self, msg: dict) -> int:
        n, self.next = self.next, self.next + 1
        if self.world_size > 1:         # a mesh of one rank has no reader
            self.store.set(KEY.format(n), pickle.dumps(msg))
        return n

    def lead(self, server, jobs: list):
        """Hand ``jobs`` to the followers, then run them here: the payload
        of one job, or the list of a batch's."""
        with self._lock:
            if self.fatal is not None or self.stopped:
                raise RuntimeError("the mesh server has stopped"
                                   + (f": {self.fatal}" if self.fatal else ""))
            n = self._publish({"jobs": [server._clean(j) for j in jobs]})
        try:
            return run_job(server, n, self.rank, jobs)
        except LockstepError as e:
            self.fatal = e
            if self.on_fatal is not None:
                threading.Thread(target=self.on_fatal, daemon=True).start()
            raise

    def stop(self) -> None:
        """Hand the followers a stop (once; rank 0 only)."""
        with self._lock:
            if self.rank == 0 and not self.stopped:
                self.stopped = True
                self._publish({"stop": True})

    # --------------------------------------------------------- followers

    def receive(self, stop: threading.Event) -> Optional[dict]:
        """The next message from rank 0, or None once ``stop`` is set."""
        key = KEY.format(self.next)
        while not self.store.check([key]):
            if stop.is_set():
                return None
            time.sleep(POLL_S)
        msg = pickle.loads(self.store.get(key))
        if self.store.add(key + "/read", 1) == self.world_size - 1:
            self.store.delete_key(key)
            self.store.delete_key(key + "/read")
        self.next += 1
        return msg


def _digest(b64: str) -> str:
    return hashlib.sha256(b64.encode()).hexdigest()


def run_job(server, n: int, rank: int, jobs: list):
    """``server``'s call for job group ``n`` (``_generate`` of one job,
    ``_generate_batch`` of several) with this rank's record line; an
    error after the job's first collective is a ``LockstepError``."""
    c0, k0, s0 = comm.COLLECTIVES, fa.LAUNCHES, fa.SEQ_LAUNCHES
    t0 = time.perf_counter()
    rec = {"serve_mesh_job": n, "rank": rank, "requests": len(jobs),
           "error": None, "images": []}
    try:
        out = (server._generate(jobs[0]) if len(jobs) == 1
               else server._generate_batch(jobs))
        rec["images"] = [_digest(p[k]) for p in
                         (out if isinstance(out, list) else [out])
                         for k in ("image", "stage1")]
        return out
    except Exception as e:
        rec["error"] = str(e)
        if comm.COLLECTIVES != c0:
            raise LockstepError(
                f"job {n} failed on rank {rank} after its ranks began to "
                f"communicate ({type(e).__name__}: {e}); the ranks may be "
                "out of step, so the server stops") from e
        raise
    finally:
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = [fa.LAUNCHES - k0, fa.SEQ_LAUNCHES - s0]
        # one write of the whole line: the ranks share one output pipe,
        # and print's separate write of the newline (unbuffered output,
        # PYTHONUNBUFFERED) lets another rank's line land inside this one
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()


def follow(server, handover: Handover, stop: threading.Event) -> int:
    """A follower's loop: run every job group rank 0 hands over until it
    hands a stop (or ``stop`` is set); returns the number of groups run."""
    ran = 0
    while True:
        msg = handover.receive(stop)
        if msg is None or msg.get("stop"):
            return ran
        try:
            run_job(server, handover.next - 1, handover.rank, msg["jobs"])
        except LockstepError:
            raise
        except Exception:
            # failed before any collective, as on rank 0 (which answers
            # 500); the job's record line carries the error
            pass
        ran += 1


def serve(server, host: str, port: int) -> None:
    """Run this rank of a mesh server until it is stopped: rank 0 serves
    HTTP on (``host``, ``port``), the others follow. SIGTERM and SIGINT
    stop the rank. Raises the ``LockstepError`` that ended the server."""
    handover = server.handover
    stop = threading.Event()

    def on_signal(*_):
        stop.set()
        if handover.rank == 0:
            threading.Thread(target=server.shutdown, daemon=True).start()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    if handover.rank != 0:
        follow(server, handover, stop)
        return
    handover.on_fatal = server.shutdown
    try:
        server.serve(host, port)
    finally:
        handover.stop()
        with server._running:           # the job in flight, if any, ends
            pass
    if handover.fatal is not None:
        raise handover.fatal
