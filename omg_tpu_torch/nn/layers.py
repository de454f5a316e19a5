"""Core layers (port of ``omg_tpu/nn/layers.py``).

Conventions:
  * ``Linear``:  weight [out, in] (torch layout); ``Conv2d``: weight
    OIHW over NCHW data.
  * Norm statistics and activations that the JAX package computes in
    fp32 are computed in fp32 here and cast back to the compute dtype;
    matmuls and convs run in the input dtype.

LoRA is a runtime input, as in JAX: a model takes one flat adapter dict
``{module_path: {"down": [in, r], "up": [r, out], "scale": ()}}`` keyed by
the path of the ``Linear`` it applies to (diffusers naming, e.g.
``mid_block.attentions.0.transformer_blocks.0.attn1.to_q``). Every
``Linear`` reads its own leaf and adds ``scale * (x @ down) @ up``, so one
module serves the base lanes and every concept lane. A per-lane leaf has
``down [B, in, r]``, ``up [B, r, out]`` and ``scale [B]`` (a batched
matmul: lane b runs adapter b).

Tensor parallelism (``parallel/sharding.py``): a ``Linear`` may hold
one rank's share of its weight over the mesh's model axis (``tp``, a
``TPSplit``). Split by output columns (q/k/v) it computes those columns,
its LoRA ``up`` cut to them; split by input rows (``to_out``) it takes
those features of its input, multiplies them by its rows (LoRA ``down``
cut to them) and sums the partial products over the group (in the
compute dtype, as GSPMD's psum in JAX), the bias added after the sum; an
int8 one takes the activation scale over the whole input axis and sums
its int32 products before dequantizing.

Spatial split (the multi-device modes): ``Conv2d`` and ``GroupNorm`` take
an optional ``seq_group`` (``parallel.comm.Group``) whose ranks each hold
an equal block of consecutive rows of the H axis, in group order. A 3x3
convolution then reads its neighbours' edge rows (``comm.halo_rows``)
and group-norm statistics are summed over the group; ``Linear``,
``LayerNorm`` and ``upsample_nearest_2x`` act on each token or row alone
and stay local.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.ops import quant
from omg_tpu_torch.parallel import comm
from omg_tpu_torch.utils import profiling


def target_device(device, who: str) -> torch.device:
    """``device`` as a torch.device for an entry point that defaults to the
    card; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device for the weights; pass "
                           "device='cpu' to keep them on the CPU")
    return device


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter that takes no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def lora_delta(leaf: dict, x: torch.Tensor) -> torch.Tensor:
    """``scale * (x @ down) @ up`` in x's dtype; per-lane when down is 3-D."""
    down = leaf["down"].to(x.dtype)
    up = leaf["up"].to(x.dtype)
    scale = leaf["scale"].to(x.dtype)
    delta = torch.matmul(torch.matmul(x, down), up)
    if down.dim() == 3:
        scale = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    return delta * scale


def lora_factors(leaf: dict, dtype) -> dict:
    """A leaf's factors in ``dtype``: ``down``, and ``up`` with the scale
    folded in (multiplied in fp32, then cast), so that
    ``(x @ down) @ up`` is ``lora_delta(leaf, x)``."""
    up = leaf["up"].float()
    scale = torch.as_tensor(leaf["scale"], dtype=torch.float32,
                            device=up.device)
    if up.dim() == 3:
        scale = scale.reshape(-1, 1, 1)
    return {"down": leaf["down"].to(dtype), "up": (up * scale).to(dtype)}


class LoraFactors(dict):
    """An adapter as the forward reads it: per module path the factors of
    ``lora_factors`` in the compute dtype, per lane when 3-D. A request
    makes it once (``lora.prepare``, ``lora.stack_loras(dtype=...)``) and
    drops it when it returns. ``live``: as ``lora.LaneStack``'s (None for
    a shared adapter); ``groups``: the factors of projections fused into
    one product (``lora_group``), made on first use."""

    def __init__(self, leaves: dict, live: Optional[dict] = None):
        super().__init__(leaves)
        self.live = live
        self.groups: dict = {}


def factors_of(leaf: dict, lora: dict, dtype) -> dict:
    """``leaf`` of ``lora`` as factors: a ``LoraFactors``' own, else made
    in ``dtype`` on the spot."""
    return leaf if isinstance(lora, LoraFactors) else lora_factors(leaf,
                                                                   dtype)


def add_lora_(y: torch.Tensor, x: torch.Tensor, down: torch.Tensor,
              up: torch.Tensor) -> torch.Tensor:
    """``y += (x @ down) @ up`` in place, the second product accumulated
    into y by its GEMM (beta = 1): no pass over y of its own. y: a
    product of x, [.., out]; a 3-D ``down`` is per lane (x [B, N, in])."""
    xd = torch.matmul(x, down)
    if up.dim() == 3:
        return y.baddbmm_(xd, up)
    y.view(-1, y.shape[-1]).addmm_(xd.reshape(-1, xd.shape[-1]), up)
    return y


def lora_group(members: tuple, lora: Optional[dict], x: torch.Tensor):
    """The LoRA of the projections ``members`` fused into one product of
    x (their outputs concatenated): None where no member has a leaf, else
    ``(down, up)`` with ``(x @ down) @ up`` the members' deltas, side by
    side. ``down`` is the members' down-projections concatenated, ``up``
    block-diagonal (a member without a leaf: zero blocks). Counted as each
    member's own (``Linear.count``). A ``LoraFactors`` keeps a group's
    factors for the request after its first use."""
    if lora is None:
        return None
    leaves = [m.lora_leaf(lora) for m in members]
    if all(leaf is None for leaf in leaves):
        return None
    for m, leaf in zip(members, leaves):
        if leaf is not None:
            m.count(x, lora, in_gemm=True)
    key = tuple(m.lora_key for m in members)
    kept = lora.groups.get(key) if isinstance(lora, LoraFactors) else None
    if kept is not None:
        return kept
    fs = [None if leaf is None else factors_of(leaf, lora, x.dtype)
          for leaf in leaves]
    ref = next(f for f in fs if f is not None)
    lead = ref["down"].shape[:-2]
    ranks = [0 if f is None else f["down"].shape[-1] for f in fs]
    widths = [m.weight.shape[0] for m in members]
    down = ref["down"].new_zeros(lead + (x.shape[-1], sum(ranks)))
    up = ref["up"].new_zeros(lead + (sum(ranks), sum(widths)))
    r0 = c0 = 0
    for f, r, c in zip(fs, ranks, widths):
        if f is not None:
            down[..., r0:r0 + r] = f["down"]
            up[..., r0:r0 + r, c0:c0 + c] = f["up"]
        r0, c0 = r0 + r, c0 + c
    if isinstance(lora, LoraFactors):
        lora.groups[key] = (down, up)
        if all(m.tp is None for m in members):
            # the members' own factors become views of the group's, so
            # that the request holds each factor once
            r0 = c0 = 0
            for m, f, r, c in zip(members, fs, ranks, widths):
                if f is not None:
                    lora[m.lora_key] = {
                        "down": down[..., r0:r0 + r],
                        "up": up[..., r0:r0 + r, c0:c0 + c]}
                r0, c0 = r0 + r, c0 + c
    return down, up


class TPSplit(NamedTuple):
    """A ``Linear``'s tensor-parallel split: ``dim`` 0 splits its output
    columns, 1 its input rows; ``split``: that axis's
    ``parallel.mesh.Split`` over the model group (this rank holds [lo,
    hi))."""
    dim: int
    split: object


class Linear(nn.Module):
    """``x @ W.T`` plus this layer's LoRA delta, then the bias.

    A float layer that holds its whole input axis adds the delta inside
    the GEMMs: the bias in the base product's epilogue, then ``x @ down``
    and ``(x @ down) @ up`` accumulated into the product (``add_lora_``),
    from factors the request prepared once (``LoraFactors``; a raw leaf
    is made into factors on the spot). An int8 layer, whose product comes
    back dequantized, and a row-split one, whose partial products are
    summed over the group before the bias, add the delta as a tensor of
    its own."""

    quantized = False

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = param((out_dim, in_dim), dtype, device)
        self.bias = param((out_dim,), dtype, device) if bias else None
        self.lora_key = ""      # module path; set by the model root
        self.tp: Optional[TPSplit] = None

    def lora_leaf(self, lora: Optional[dict]) -> Optional[dict]:
        """This layer's LoRA leaf, cut to its tensor-parallel share."""
        leaf = None if lora is None else lora.get(self.lora_key)
        if leaf is None or self.tp is None:
            return leaf
        lo, hi = self.tp.split.lo, self.tp.split.hi
        if self.tp.dim == 0:
            return dict(leaf, up=leaf["up"][..., lo:hi])
        return dict(leaf, down=leaf["down"][..., lo:hi, :])

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """The base product ``x @ W.T``, without LoRA or bias."""
        return F.linear(x, self.weight)

    def count(self, x: torch.Tensor, lora: dict, in_gemm: bool) -> None:
        """Count this layer's delta per lane: ``lora.lane_deltas`` each
        row of x, ``lora.live_lane_deltas`` those whose adapter is not a
        ``stack_loras`` zero pad (``lora.live``), and
        ``lora.gemm_accumulated`` each row whose delta a GEMM accumulates
        into the product."""
        n, live = x.shape[0], getattr(lora, "live", None)
        profiling.count("lora.lane_deltas", n)
        profiling.count("lora.live_lane_deltas",
                        n if live is None else sum(live[self.lora_key]))
        if in_gemm:
            profiling.count("lora.gemm_accumulated", n)

    def counted_delta(self, leaf: dict, x: torch.Tensor,
                      lora: dict) -> torch.Tensor:
        """This layer's delta as a tensor of its own, counted
        (``count``): ``lora_delta`` of a raw leaf, ``(x @ down) @ up`` of
        a ``LoraFactors``' one."""
        self.count(x, lora, in_gemm=False)
        if not isinstance(lora, LoraFactors):
            return lora_delta(leaf, x)
        f = factors_of(leaf, lora, x.dtype)
        return torch.matmul(torch.matmul(x, f["down"]), f["up"])

    def forward(self, x: torch.Tensor, lora: Optional[dict] = None):
        leaf = self.lora_leaf(lora)
        rows = self.tp is not None and self.tp.dim == 1
        if not self.quantized and not rows:
            y = F.linear(x, self.weight, self.bias)
            if leaf is None:
                return y
            self.count(x, lora, in_gemm=True)
            f = factors_of(leaf, lora, x.dtype)
            return add_lora_(y, x, f["down"], f["up"])
        y = self.matmul(x)
        delta = (self.counted_delta(leaf, x, lora) if leaf is not None
                 else None)
        if rows and self.quantized:
            # the int8 product comes back summed (its int32 sums are)
            if delta is not None:
                y = y + comm.all_reduce_sum(delta, self.tp.split.group)
        elif rows:
            y = comm.all_reduce_sum(y if delta is None else y + delta,
                                    self.tp.split.group)
        elif delta is not None:
            y = y + delta
        return y if self.bias is None else y + self.bias


class QuantLinear(Linear):
    """A ``Linear`` whose base product is int8 W8A8 (``ops/quant.py``):
    int8 ``weight_q`` [out, in] and fp32 ``w_scale`` [out] in place of
    ``weight``; the LoRA delta and the bias stay in the compute dtype."""

    quantized = True

    @staticmethod
    def quantize_(m: Linear) -> "QuantLinear":
        """Turn the Linear ``m`` into a QuantLinear in place; its float
        weight is dropped from ``m`` (not freed if another module holds
        it)."""
        wq, scale = quant.quantize_weight(m.weight)
        m.weight = None
        m.__class__ = QuantLinear
        m.register_buffer("weight_q", wq)
        m.register_buffer("w_scale", scale)
        return m

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        group = (self.tp.split.group
                 if self.tp is not None and self.tp.dim == 1 else None)
        return quant.int8_matmul(x, self.weight_q, self.w_scale, group)


class Conv2d(nn.Module):
    """NCHW conv; ``padding`` defaults to kernel // 2 (the JAX package's
    symmetric padding).

    Under a ``seq_group`` the rank's rows are padded with the neighbours'
    halo rows instead of zeros: one above and one below for a 3x3 stride-1
    conv, one above for the stride-2 downsample (its output row i reads
    input rows 2i-1..2i+1). A stride-2 split needs an even number of local
    rows, so that every block starts on an even global row; an odd one
    would silently shift the output and raises instead."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 stride: int = 1, padding: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = param((out_ch, in_ch, kernel, kernel), dtype, device)
        self.bias = param((out_ch,), dtype, device)
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding

    def forward(self, x: torch.Tensor,
                seq_group: Optional[comm.Group] = None) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        k = self.weight.shape[-1]
        if seq_group is None or seq_group.size == 1 or k == 1:
            return F.conv2d(x, w, b, stride=self.stride, padding=self.padding)
        if (k, self.padding) != (3, 1) or self.stride not in (1, 2):
            raise ValueError(f"no row split for a {k}x{k} conv with padding "
                             f"{self.padding} and stride {self.stride}")
        if self.stride == 2 and x.shape[-2] % 2:
            raise ValueError(f"a stride-2 conv over {x.shape[-2]} local rows: "
                             "the split must give every rank an even count")
        above, below = comm.halo_rows(x, seq_group, 1)
        rows = [above, x, below] if self.stride == 1 else [above, x]
        return F.conv2d(torch.cat(rows, dim=-2), w, b, stride=self.stride,
                        padding=(0, self.padding))


def conv_fp32(x: torch.Tensor, weight: torch.Tensor, bias, stride: int = 1,
              padding: int = 0, *, cudnn: bool = True,
              transposed: bool = False) -> torch.Tensor:
    """A convolution without TF32 whatever the process's cuDNN flag: on a
    CUDA tensor, ``torch._convolution`` with TF32 off for this call only
    (and cuDNN too with ``cudnn=False``: PyTorch's im2col and a GEMM);
    elsewhere (CPU, meta) ``F.conv2d`` or ``F.conv_transpose2d``."""
    if x.device.type != "cuda":
        conv = F.conv_transpose2d if transposed else F.conv2d
        return conv(x, weight, bias, stride, padding)
    return torch._convolution(x, weight, bias, (stride, stride),
                              (padding, padding), (1, 1), transposed,
                              (0, 0), 1, False, False, cudnn, False)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis of NCHW data, statistics in fp32.

    Under a ``seq_group`` the statistics cover every rank's rows: two
    passes, each summed over the group (the mean, then the mean squared
    deviation from it), divided by the global element count; the same
    biased variance as JAX's ``grouped.var``. A one-pass
    E[x^2] - E[x]^2 would cancel catastrophically at small variance."""

    def __init__(self, dim: int, num_groups: int, *, eps: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = param((dim,), dtype, device)
        self.bias = param((dim,), dtype, device)
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor,
                seq_group: Optional[comm.Group] = None) -> torch.Tensor:
        if seq_group is None or seq_group.size == 1:
            return F.group_norm(x.float(), self.num_groups,
                                self.weight.float(), self.bias.float(),
                                self.eps).to(x.dtype)
        xf = x.float()
        grouped = xf.reshape(x.shape[0], self.num_groups, -1)
        count = grouped.shape[-1] * seq_group.size
        mean = comm.all_reduce_sum(grouped.sum(-1), seq_group) / count
        dev = grouped - mean[..., None]
        var = comm.all_reduce_sum((dev * dev).sum(-1), seq_group) / count
        normed = (dev * torch.rsqrt(var + self.eps)[..., None]).reshape(xf.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        out = (normed * self.weight.float().reshape(shape)
               + self.bias.float().reshape(shape))
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, statistics in fp32."""

    def __init__(self, dim: int, *, eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = param((dim,), dtype, device)
        self.bias = param((dim,), dtype, device)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = param((num, dim), dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights with the JAX package's scheme: N(0, 1/fan_in)
    linears and convs with zero biases, unit norms, N(0, 0.02²)
    embeddings. Draws come from ``generator`` on the weights' device, in
    module order."""
    def normal(w, std):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32) * std)

    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)) and m.weight is not None:
            fan_in = m.weight[0].numel()
            normal(m.weight, 1.0 / math.sqrt(max(fan_in, 1)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Embedding):
            normal(m.weight, 0.02)
    return model


def set_lora_keys(model: nn.Module) -> None:
    """Give every Linear its module path, the key of its LoRA leaf."""
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            m.lora_key = name


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)            # exact erf form


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def geglu(p: Linear, x: torch.Tensor, lora: Optional[dict] = None):
    """diffusers GEGLU feed-forward gate: proj to 2*dim, gelu-gate."""
    h, gate = p(x, lora).chunk(2, dim=-1)
    return h * gelu(gate)


def timestep_embedding(timesteps: torch.Tensor, dim: int, *,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers), always fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample on NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def nearest_resize(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC or HW data to ``size`` (H, W) with
    torch ``F.interpolate(mode='nearest')``'s index rule,
    ``floor(i * in / out)`` taken in fp32 as the JAX package does."""
    axes = (0, 1) if x.dim() == 2 else (1, 2)
    idx = []
    for ax, n_out in zip(axes, size):
        ratio = np.float32(x.shape[ax] / n_out)
        rows = np.floor(np.arange(n_out, dtype=np.float32) * ratio)
        idx.append(profiling.sync(torch.as_tensor, rows.astype(np.int64),
                                  device=x.device))
    return x.index_select(axes[0], idx[0]).index_select(axes[1], idx[1])
