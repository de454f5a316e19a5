"""Tensor parallelism of the UNet's attention over the mesh's model axis,
and the request axis over its data axis (port of
``omg_tpu/parallel/sharding.py``).

The JAX package annotates its parameter tree with ``NamedSharding``s and
lets GSPMD place the collectives; here the plan is the same annotation,
one spec per tensor of a module's state dict, and ``shard_params`` cuts
each rank's share out of the module in place:

  * ``to_q``, ``to_k``, ``to_v``, ``to_k_ip`` and ``to_v_ip`` split by
    output columns (their bias and an int8 weight's per-column ``w_scale``
    with them);
  * ``to_out`` splits by input rows (its bias and ``w_scale`` stay whole:
    the bias is added after the sum over the group);
  * everything else is replicated.

A spec is the tuple of a tensor's dims, each the axis name ``"model"``
where that dim splits over the model axis and None where it does not,
in the port's layout (``weight`` [out, in]): JAX's ``P(None, "model")``
on a kernel [in, out] is ``("model", None)`` here. The attention then
runs each rank's heads and sums its partial ``to_out`` over the model
group (``nn/attention.py``, ``nn/layers.py``), one all-reduce per
attention layer. The feed-forward and the convs stay replicated, as in
JAX: the weights fit one card, and the split is a latency tool for the
attention-heavy blocks. The JAX tree's scan-stacked ``pack_params``
leaves have no counterpart (the port has no ``pack_params``).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.parallel import mesh as mesh_lib

MODEL_AXIS = mesh_lib.MODEL_AXIS
# Linear names split by output columns / by input rows.
COL_KEYS = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
ROW_KEYS = ("to_out",)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Specs over a module's state dict on ``mesh`` (the JAX sharding
    tree): ``specs[name]`` is the tensor's dims, ``"model"`` on the one
    split over the model axis; () replicated."""
    mesh: mesh_lib.Mesh
    specs: dict


def _linears(model: nn.Module):
    """(module path, Linear, "col" | "row" | None) of every Linear."""
    for name, m in model.named_modules():
        if not isinstance(m, layers.Linear):
            continue
        parts = name.split(".")
        # diffusers' to_out is a ModuleList: its Linear is ``to_out.0``
        key = parts[-2] if parts[-1].isdigit() and len(parts) > 1 \
            else parts[-1]
        kind = ("col" if key in COL_KEYS else
                "row" if key in ROW_KEYS else None)
        yield name, m, kind


def _spec(kind, attr: str, ndim: int) -> tuple:
    if kind == "col" and attr in ("weight", "weight_q", "bias", "w_scale"):
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if kind == "row" and attr in ("weight", "weight_q"):
        return (None, MODEL_AXIS)
    return ()


def unet_tp_sharding(model: nn.Module, mesh: mesh_lib.Mesh) -> Plan:
    """The tensor-parallel plan of ``model`` (a UNet, or a list of IP
    layers) over ``mesh``'s model axis: q/k/v and IP k/v split by output
    columns, ``to_out`` by input rows, the rest replicated; the plain and
    the int8 (``weight_q``, ``w_scale``) layouts alike."""
    kinds = {name: kind for name, _, kind in _linears(model)}
    specs = {}
    for name, tensor in model.state_dict().items():
        owner, _, attr = name.rpartition(".")
        specs[name] = _spec(kinds.get(owner), attr, tensor.dim())
    return Plan(mesh, specs)


def replicated_like(model: nn.Module, mesh: mesh_lib.Mesh) -> Plan:
    """A plan that replicates every tensor of ``model``."""
    return Plan(mesh, {name: () for name in model.state_dict()})


def shard_params(model: nn.Module, plan: Plan) -> nn.Module:
    """Cut this rank's share of every split tensor of ``model`` in place
    (``tensor_split`` order over the model group) and mark each split
    ``Linear`` (``nn.layers.TPSplit``), so its forward runs the rank's
    columns or rows; returns ``model``. A model group of one rank keeps
    everything."""
    group = plan.mesh.model_group
    if group.size == 1:
        return model
    for name, m, _ in _linears(model):
        wname = "weight_q" if m.quantized else "weight"
        spec = plan.specs.get(f"{name}.{wname}", ())
        if MODEL_AXIS not in spec:
            continue
        dim = spec.index(MODEL_AXIS)
        w = getattr(m, wname)
        split = mesh_lib.Split(w.shape[dim], group)
        lo, hi = split.lo, split.hi
        cut = {wname: w[lo:hi] if dim == 0 else w[:, lo:hi]}
        if dim == 0:
            for attr in ("bias", "w_scale"):
                if getattr(m, attr, None) is not None:
                    cut[attr] = getattr(m, attr)[lo:hi]
        for attr, t in cut.items():
            t = t.contiguous()
            if isinstance(getattr(m, attr), nn.Parameter):
                setattr(m, attr, nn.Parameter(t, requires_grad=False))
            else:
                setattr(m, attr, t)
        m.tp = layers.TPSplit(dim, split)
    return model


def request_sharding(mesh: mesh_lib.Mesh, n: int) -> mesh_lib.Split:
    """A leading request axis of ``n`` independent requests over the data
    axis: this rank's requests are [lo, hi) of the ``Split``."""
    return mesh_lib.data_sharded(mesh, n)
