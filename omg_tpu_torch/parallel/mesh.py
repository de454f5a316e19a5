"""The (data, model) grid of ranks of the multi-device modes (port of
``omg_tpu/parallel/mesh.py``).

The JAX mesh is a grid of devices under one program; here it is a grid of
ranks, one process each, over the world that ``launch.spawn`` started.
Rank ``r`` sits at (data, model) = ``divmod(r, model)``. Each rank holds
three groups (``comm.Group``):

  * ``data_group`` — the ranks that share its model index: the grid's
    column, which spans the data axis (stage 1 splits the CFG lanes over
    it);
  * ``model_group`` — the ranks that share its data index: the grid's
    row, which spans the model axis (stage 1 splits the latent's H over
    it: the sequence group of the attention);
  * ``flat`` — every rank, the flat lane / H axis of stage 2 and the VAE
    decode.

``replicated`` and ``data_sharded`` are the placement helpers: the first
checks that every rank holds the same weights, the second says which rows
of a data-split axis this rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from omg_tpu_torch.parallel import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"


def split(n: int, *, data: Optional[int] = None,
          model: Optional[int] = None) -> tuple:
    """(data, model) for ``n`` ranks: JAX ``make_mesh``'s rule. Neither
    given: all data; one given: the other divides ``n`` by it. Raises when
    data * model != n."""
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def shard_range(n: int, parts: int, index: int) -> tuple:
    """[lo, hi) of part ``index`` when ``n`` rows split into ``parts``
    in ``torch.tensor_split`` order (the first ``n % parts`` parts hold one
    row more)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


@dataclasses.dataclass(frozen=True)
class Split:
    """``n`` rows (lanes of a batch) split over ``group`` in
    ``tensor_split`` order; this rank holds rows [lo, hi)."""

    n: int
    group: comm.Group

    def __post_init__(self):
        if self.n < self.group.size:
            raise ValueError(f"{self.n} rows over {self.group.size} ranks "
                             "would leave a rank without rows")

    @property
    def lo(self) -> int:
        return shard_range(self.n, self.group.size, self.group.index)[0]

    @property
    def hi(self) -> int:
        return shard_range(self.n, self.group.size, self.group.index)[1]

    @property
    def sizes(self) -> list:
        return [hi - lo for lo, hi in (shard_range(self.n, self.group.size, i)
                                       for i in range(self.group.size))]

    def owner(self, row: int) -> int:
        """The group index of the rank that holds ``row``."""
        for i in range(self.group.size):
            lo, hi = shard_range(self.n, self.group.size, i)
            if lo <= row < hi:
                return i
        raise IndexError(f"row {row} outside [0, {self.n})")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) grid."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: comm.Group
    model_group: comm.Group
    flat: comm.Group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.model)


def make_mesh(n_devices: Optional[int] = None, *,
              data: Optional[int] = None, model: Optional[int] = None,
              device=None) -> Mesh:
    """Build the (data, model) grid over the initialized world; every rank
    calls it with the same arguments. ``device``: this rank's device (the
    one ``launch.spawn`` handed it; CPU by default). The grid covers the
    whole world: ``n_devices`` defaults to the world size and must equal
    it."""
    rank, world_size = comm.world()
    n = world_size if n_devices is None else n_devices
    if n != world_size:
        raise ValueError(f"a mesh of {n} ranks over a world of {world_size}")
    data, model = split(n, data=data, model=model)
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    model_group = comm.new_groups(rows)
    data_group = comm.new_groups(cols)
    flat = comm.new_groups([list(range(n))])
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(data, model, rank, device, data_group, model_group, flat)


def make_latency_mesh(n: int, *, device=None) -> Mesh:
    """The latency layout's grid: (data, model) = (2, n/2) when n is even,
    (1, n) otherwise. Raises if the world has fewer than n ranks."""
    _, visible = comm.world()
    if visible < n:
        raise ValueError(f"latency mesh needs {n} devices; only "
                         f"{visible} visible")
    return make_mesh(n, data=2 if n % 2 == 0 else 1, device=device)


def data_sharded(mesh: Mesh, n: int) -> Split:
    """An n-row axis split over the data axis (this rank's rows in
    ``.lo``/``.hi``)."""
    return Split(n, mesh.data_group)


def _checksum(modules) -> torch.Tensor:
    """fp64 sum and sum of squares of every parameter, in module order."""
    sums = []
    for m in modules:
        for p in m.parameters():
            p64 = p.detach().double()
            sums += [p64.sum(), (p64 * p64).sum()]
    return torch.stack(sums)


def replicated(mesh: Mesh, *modules) -> tuple:
    """Check that every rank holds the same weights in ``modules`` (each
    rank builds its own copy, from a file or a seed) and that they live on
    this rank's device; raise on any difference. Returns ``modules``."""
    for m in modules:
        for p in m.parameters():
            if p.device != mesh.device:
                raise ValueError(f"weights on {p.device}, the mesh rank's "
                                 f"device is {mesh.device}")
    mine = _checksum(modules)
    every = comm.all_gather(mine[None], 0, mesh.flat)
    bad = [r for r in range(mesh.size) if not torch.equal(every[r], mine)]
    if bad:
        raise ValueError(f"weights differ between rank {mesh.rank} and "
                         f"ranks {bad}")
    return modules
