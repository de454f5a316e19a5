"""Collectives of the multi-device modes: the one module of the port that
calls ``torch.distributed``.

The JAX package leaves its collectives to XLA (GSPMD conv halos and norm
psums, ``all_gather`` and ``ppermute`` under ``shard_map``); here they are
explicit calls on a ``Group`` of ranks:

  * ``all_gather(x, dim, group)`` — concatenate every rank's piece along
    ``dim`` in group order (uneven pieces with ``sizes``);
  * ``all_reduce_sum(x, group)`` / ``all_reduce_max(x, group)`` — the
    elementwise sum / maximum over the group;
  * ``broadcast_rows(x, src, group)`` — the group member ``src``'s tensor
    on every member;
  * ``halo_rows(x, group, n)`` — the n rows above and below a rank's block
    of an H-split NCHW tensor, zeros at the global edges.

``COLLECTIVES`` counts the collectives this process has entered (the mesh
server reads it to tell a job that failed before its ranks communicated
from one that may have left them out of step); ``store()`` is the
rendezvous store ``init`` opened (the mesh server hands jobs through it).

Backends. The caller names the backend when the world starts (``init``);
nothing here switches it. ``nccl`` runs every collective on the device
tensors, one rank per card. ``gloo`` is the backend for ranks that share
one card (NCCL refuses two ranks on one device) and for CPU ranks; it
runs ``all_reduce`` and ``broadcast`` on CUDA tensors but not
``all_gather``, so for gloo every CUDA tensor is copied to host memory,
reduced there and copied back. That staging lives in ``_host`` and
``_back`` below and nowhere else. A group of one rank runs no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# Collectives entered by this process (the multi-rank ones only).
COLLECTIVES = 0
_STORE: Optional[dist.Store] = None


@dataclasses.dataclass(frozen=True)
class Group:
    """A set of world ranks that run collectives together, seen from one
    member: ``ranks`` in group order and this rank's ``index`` in it."""

    ranks: tuple
    index: int
    pg: Optional[object] = None     # the process group; None for one rank

    @property
    def size(self) -> int:
        return len(self.ranks)


def init(store_path: str, rank: int, world_size: int, backend: str,
         timeout_s: float) -> None:
    """Join the world: rendezvous through a ``FileStore`` at ``store_path``
    (no TCP port, so concurrent worlds on one host cannot collide), with a
    finite timeout on every collective."""
    global _STORE
    _STORE = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=_STORE, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    global _STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


def store() -> dist.Store:
    """The rendezvous store of the world ``init`` joined: a key-value store
    every rank reads and writes without a collective."""
    if _STORE is None:
        raise RuntimeError("no rendezvous store: the world was not joined "
                           "through comm.init (launch.spawn)")
    return _STORE


def _entered() -> None:
    global COLLECTIVES
    COLLECTIVES += 1


def world() -> tuple:
    """(rank, world size) of the initialized world."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: start the "
                           "ranks with omg_tpu_torch.parallel.launch.spawn")
    return dist.get_rank(), dist.get_world_size()


def new_groups(partition: Sequence[Sequence[int]]) -> Group:
    """Create one group per entry of ``partition`` (disjoint rank lists
    covering the world) and return the one this rank belongs to. Every
    rank must call this with the same partition, in the same order."""
    rank, _ = world()
    mine = None
    for ranks in partition:
        ranks = tuple(ranks)
        pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
        if rank in ranks:
            mine = Group(ranks, ranks.index(rank), pg)
    if mine is None:
        raise ValueError(f"rank {rank} is in no group of {partition}")
    return mine


def _host(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The tensor the collective runs on: contiguous, and in host memory
    when gloo would be handed a CUDA tensor."""
    x = x.contiguous()
    if x.device.type == "cuda" and dist.get_backend(group.pg) == "gloo":
        return x.cpu()
    return x


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device)


def all_gather(x: torch.Tensor, dim: int, group: Group,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in group order.

    ``sizes``: each member's extent along ``dim`` when they differ (an
    uneven lane split); pieces are zero-padded to the largest for the
    collective and cut back after it. Without it all pieces must match."""
    if group.size == 1:
        return x
    dim = dim % x.dim()
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * group.size
    if len(sizes) != group.size or x.shape[dim] != sizes[group.index]:
        raise ValueError(f"piece of {x.shape[dim]} along dim {dim} does not "
                         f"match sizes {sizes} at index {group.index}")
    top = max(sizes)
    if x.shape[dim] < top:
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    src = _host(x, group)
    outs = [torch.empty_like(src) for _ in range(group.size)]
    _entered()
    dist.all_gather(outs, src, group=group.pg)
    out = torch.cat([o.narrow(dim, 0, s) for o, s in zip(outs, sizes)],
                    dim=dim)
    return _back(out, x)


def _all_reduce(x: torch.Tensor, group: Group, op) -> torch.Tensor:
    if group.size == 1:
        return x
    y = _host(x, group)
    y = y.clone() if y.data_ptr() == x.data_ptr() else y
    _entered()
    dist.all_reduce(y, op=op, group=group.pg)
    return _back(y, x)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise sum of every member's ``x`` (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum of every member's ``x`` (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def broadcast_rows(x: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Member ``src``'s ``x`` on every member (a new tensor). The other
    members pass a tensor of the same shape and dtype; its values are
    ignored."""
    if group.size == 1:
        return x
    y = _host(x, group)
    y = y.clone() if y.data_ptr() == x.data_ptr() else y
    _entered()
    dist.broadcast(y, src=group.ranks[src], group=group.pg)
    return _back(y, x)


def halo_rows(x: torch.Tensor, group: Group, n: int) -> tuple:
    """(above, below): the ``n`` rows of the H axis (dim -2 of NCHW data)
    just above and just below this member's block, from its neighbours in
    group order; zeros beyond the global edges. Every member's block must
    have the same shape and at least ``n`` rows."""
    if x.shape[-2] < n:
        raise ValueError(f"a block of {x.shape[-2]} rows has no {n}-row halo")
    edges = torch.cat([x[..., :n, :], x[..., -n:, :]], dim=-2)
    if group.size == 1:
        zeros = torch.zeros_like(edges[..., :n, :])
        return zeros, zeros.clone()
    every = all_gather(edges[None], 0, group)      # [S, ..., 2n, W]
    i = group.index
    above = (every[i - 1][..., n:, :] if i > 0
             else torch.zeros_like(edges[..., :n, :]))
    below = (every[i + 1][..., :n, :] if i < group.size - 1
             else torch.zeros_like(edges[..., :n, :]))
    return above, below
