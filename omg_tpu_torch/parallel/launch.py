"""Start the ranks of a multi-device run as processes on one host.

    results = launch.spawn(fn, 2, backend="gloo", devices=["cuda:0"] * 2,
                           args=(...))

runs ``fn(rank, device, *args)`` in ``world_size`` fresh processes
(``torch.multiprocessing``, start method ``spawn``), each a member of an
initialized ``torch.distributed`` world, and returns their results in rank
order. ``fn`` and ``args`` are pickled: ``fn`` must be importable by name
and ``args`` plain data (numpy arrays rather than JAX arrays).

  * Rendezvous is a ``FileStore`` in a fresh temporary directory, so runs
    side by side on one host (test workers) never share a port.
  * Every collective has a finite timeout, and the parent raises as soon
    as any rank fails (its traceback in the message) or dies, and then
    stops the other ranks: no rank is left waiting on a dead peer.
  * CPU ranks run one intra-op thread each, so a world of several ranks
    does not oversubscribe the host.

``backend``: ``"gloo"`` for CPU ranks and for ranks that share one card,
``"nccl"`` for one rank per card (``comm.py``).
"""

from __future__ import annotations

import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from omg_tpu_torch.parallel import comm


def _rank_main(fn, rank, world_size, backend, device, store_path, timeout,
               args, results):
    try:
        device = torch.device(device)
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        comm.init(store_path, rank, world_size, backend, timeout)
        results.put((rank, True, fn(rank, device, *args)))
    except BaseException:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        comm.shutdown()


def _stop(procs, grace: float) -> None:
    end = time.monotonic() + grace
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)


def spawn(fn: Callable, world_size: int, *, backend: str,
          devices: Optional[Sequence] = None, args: tuple = (),
          timeout: float = 300.0) -> list:
    """Run ``fn(rank, device, *args)`` on ``world_size`` ranks; returns the
    results in rank order. ``devices``: one per rank (all CPU when None).
    ``timeout``: seconds for the whole run and for any one collective."""
    devices = ["cpu"] * world_size if devices is None else list(devices)
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done: dict = {}
    with tempfile.TemporaryDirectory(prefix="omg_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world_size, backend, str(devices[r]), store,
                  timeout, args, results)) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_lib.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in done]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} died with "
                                           f"exit code {dead[0][1]}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(world_size)) - set(done))}"
                            f" still running after {timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                done[rank] = payload
        finally:
            _stop(procs, grace=30.0 if len(done) == world_size else 0.0)
            results.close()
    return [done[r] for r in range(world_size)]
