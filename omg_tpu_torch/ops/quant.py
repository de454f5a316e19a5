"""Int8 W8A8 for the UNet's transformer linears (port of
``omg_tpu/ops/quant.py``), an opt-in approximate serving mode
(``OMG(quantize="int8")``).

The JAX package's scheme, computed the same way:
  * weights: per-output-channel symmetric int8, scale ``max|w| / 127``
    floored at 1e-12, ``round(w / scale)`` clipped to [-127, 127];
  * activations: dynamic per-token symmetric int8, ``sx = max(max|x|,
    1e-8) / 127`` over the feature axis, ``round(x / sx)`` (a division,
    rounding half to even as ``jnp.round``) clipped to [-127, 127]; XLA
    compiles the division of sx by the constant 127 into a product with
    its fp32 reciprocal, and so does the port, so that its scales equal
    the compiled JAX program's;
  * the product accumulates in int32 and is dequantized as
    ``y.float() * sx * w_scale`` in that order, then cast to x's dtype;
    LoRA deltas and the bias stay on top in the compute dtype.

The int8 product is a plain GEMM that the JAX package runs outside any
Pallas kernel (``lax.dot_general`` with int32 accumulation), so on the
card it is ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM) where its
shape rules admit the operands; every other shape, and the CPU, takes an
exact fp64 product (int8 x int8 sums stay far below 2^53).

Scope (``quantize_unet``, the JAX ``_QUANT_SCOPES`` and ``min_dim``): the
linears under ``transformer_blocks``, ``proj_in`` and ``proj_out`` with
both dimensions at least 16. Convs, norms, the time embeddings,
ControlNets, the VAE and the text encoders stay as they are. The stacked
3-D weight form of the JAX ``int8_matmul`` serves its ``pack_params``
layout, which the port does not have.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from omg_tpu_torch.parallel import comm

_QUANT_SCOPES = ("transformer_blocks", "proj_in", "proj_out")
# 1/127 rounded to fp32, as XLA folds the constant divisor
_INV_127 = float(np.float32(1.0) / np.float32(127.0))

# int8 products that ran torch._int_mm (the rest took the exact fp64 path)
INT_MM_CALLS = 0


def quantize_weight(weight: torch.Tensor) -> tuple:
    """[out, in] weight -> (int8 [out, in], fp32 per-output scale [out]).
    The divisor 127 is a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which would move the scales by
    an ulp from JAX's (and from the CPU's) true division."""
    w = weight.float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale[:, 0]


def quantize_activations(x: torch.Tensor, group=None) -> tuple:
    """[..., in] -> (int8 [..., in], fp32 per-token scale [..., 1]).
    ``group``: x holds this rank's share of the feature axis (a row-split
    linear under tensor parallelism); the scale takes max|x| over the
    whole axis, the maximum over the group."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        amax = comm.all_reduce_max(amax, group)
    sx = torch.clamp_min(amax, 1e-8) * _INV_127
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 [M, K] and int8 [K, N]."""
    global INT_MM_CALLS
    m, k = a.shape
    if (a.device.type == "cuda" and m > 16 and k % 8 == 0
            and b.shape[1] % 8 == 0):
        INT_MM_CALLS += 1
        return torch._int_mm(a.contiguous(), b)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic per-token W8A8: x [..., in] against int8 wq [out, in] with
    scales [out] -> [..., out] in x's dtype. ``group``: x and wq hold this
    rank's share of the input axis (a row-split linear); the activation
    scale is the whole axis's and the int32 products are summed over the
    group before the dequantization, where GSPMD places the reduction in
    JAX, so the result equals the unsplit product bit for bit."""
    xq, sx = quantize_activations(x, group)
    y = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    if group is not None:
        y = comm.all_reduce_sum(y, group)
    y = y.reshape(tuple(x.shape[:-1]) + (wq.shape[0],))
    return (y.float() * sx * w_scale.float()).to(x.dtype)


def quantize_unet(model: torch.nn.Module, *, min_dim: int = 16):
    """A copy of ``model`` whose transformer linears with min(shape) >=
    ``min_dim`` are int8 (``nn.layers.QuantLinear``). Every other tensor
    is shared with ``model``, which is left as it was."""
    from omg_tpu_torch.nn import layers
    out = copy.deepcopy(model, {id(t): t for t in
                                [*model.parameters(), *model.buffers()]})
    for name, m in out.named_modules():
        if (type(m) is layers.Linear
                and any(part in _QUANT_SCOPES for part in name.split("."))
                and min(m.weight.shape) >= min_dim):
            layers.QuantLinear.quantize_(m)
    return out
