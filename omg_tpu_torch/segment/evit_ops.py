"""EfficientViT building blocks (port of ``omg_tpu/segment/evit_ops.py``).

NCHW inside. Submodule names follow the efficientvit torch modules
(ConvLayer -> ``conv``, ``norm``; MBConv -> ``inverted_conv``,
``depth_conv``, ``point_conv``; LiteMLA -> ``qkv``, ``aggreg``, ``proj``;
a residual wrapper -> ``main``), so a converted JAX tree or an upstream
state dict maps onto them by path.

LiteMLA is ReLU linear attention: q·(kᵀ[v;1]) over a denominator column,
all in fp32 (a bf16 denominator around the 1e-15 epsilon underflows).
BatchNorm runs in its inference form.

The resizes are torch's own (``F.interpolate``, taken in fp64), which the
JAX package rebuilds as interpolation matrices: bicubic with a = -0.75
and clamped taps, bilinear with and without ``align_corners``.
``resize_uint8`` is PIL's antialiased bilinear on uint8 images, rounded
back to uint8; ``pil_resize_uint8`` is PIL's bicubic or Lanczos
resampling itself (the resize of the CLIs' and the server's condition
images).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers


F32 = torch.float32


class Conv(nn.Module):
    """A plain conv on NCHW: weight [out, in/groups, k, k], optional bias."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 device=None):
        super().__init__()
        self.weight = layers.param((cout, cin // groups, kernel, kernel),
                                   F32, device)
        self.bias = layers.param((cout,), F32, device) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        groups=self.groups)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over the channel axis, in fp32."""

    def __init__(self, ch: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, layers.param((ch,), F32, device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x.float() * scale[:, None, None]
                + shift[:, None, None]).to(x.dtype)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of NCHW data (the reference's
    'ln2d'), statistics in fp32."""

    def __init__(self, ch: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = layers.param((ch,), F32, device)
        self.bias = layers.param((ch,), F32, device)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = (xf - mean).square().mean(1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.weight[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


def act(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return F.relu(x)
    if name == "gelu":
        return F.gelu(x)                        # exact erf form
    if name == "hswish":
        return x * F.relu6(x + 3.0) / 6.0
    raise ValueError(name)


class ConvLayer(nn.Module):
    """conv (+ BN) (+ act) with 'same' padding (ops.py:37-77)."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 groups: int = 1, norm: bool = True, bias: bool = False,
                 act_func: Optional[str] = None, device=None):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, groups=groups, bias=bias,
                         device=device)
        self.norm = BatchNorm(cout, device=device) if norm else None
        self.act_func = act_func

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return act(self.act_func, y)


class ResidualBlock(nn.Module):
    """``main(x)``, plus ``x`` when ``shortcut``."""

    def __init__(self, main: nn.Module, shortcut: bool):
        super().__init__()
        self.main = main
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main(x)
        return x + y if self.shortcut else y


class ResBlock(nn.Module):
    """conv3x3 + act, conv3x3."""

    def __init__(self, ch: int, *, act_func: str = "gelu", device=None):
        super().__init__()
        self.conv1 = ConvLayer(ch, ch, 3, act_func=act_func, device=device)
        self.conv2 = ConvLayer(ch, ch, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class FusedMBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: float, *, stride: int = 1,
                 fewer_norm: bool = False, act_func: str = "gelu",
                 device=None):
        super().__init__()
        mid = round(cin * expand)
        self.spatial_conv = ConvLayer(cin, mid, 3, stride=stride,
                                      norm=not fewer_norm, bias=fewer_norm,
                                      act_func=act_func, device=device)
        self.point_conv = ConvLayer(mid, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_conv(self.spatial_conv(x))


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: float, *, stride: int = 1,
                 fewer_norm: bool = False, act_func: str = "gelu",
                 device=None):
        super().__init__()
        mid = round(cin * expand)
        kw = dict(norm=not fewer_norm, bias=fewer_norm, act_func=act_func,
                  device=device)
        self.inverted_conv = ConvLayer(cin, mid, 1, **kw)
        self.depth_conv = ConvLayer(mid, mid, 3, stride=stride, groups=mid,
                                    **kw)
        self.point_conv = ConvLayer(mid, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_conv(self.depth_conv(self.inverted_conv(x)))


class LiteMLA(nn.Module):
    """ReLU linear attention with multi-scale token aggregation, per head
    of width ``dim`` (reference kernel: ops.py:404-441)."""

    def __init__(self, ch: int, *, dim: int = 32, scales: Sequence[int] = (3,),
                 eps: float = 1e-15, device=None):
        super().__init__()
        heads = ch // dim
        total = heads * dim
        self.dim, self.eps = dim, eps
        self.qkv = ConvLayer(ch, 3 * total, 1, norm=False, device=device)
        self.aggreg = nn.ModuleList(nn.ModuleList([
            Conv(3 * total, 3 * total, s, padding=s // 2, groups=3 * total,
                 device=device),
            Conv(3 * total, 3 * total, 1, groups=3 * heads, device=device),
        ]) for s in scales)
        self.proj = ConvLayer(total * (1 + len(scales)), ch, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        qkv = self.qkv(x)                                   # [B, 3D, H, W]
        multi = [qkv] + [agg[1](agg[0](qkv)) for agg in self.aggreg]
        stacked = torch.cat(multi, dim=1)                   # [B, G*3D, H, W]
        d = self.dim
        t = stacked.float().reshape(b, -1, 3 * d, hh * ww).transpose(-1, -2)
        q, k, v = F.relu(t[..., :d]), F.relu(t[..., d:2 * d]), t[..., 2 * d:]
        v1 = F.pad(v, (0, 1), value=1.0)                    # [B, g, N, d+1]
        kv = torch.matmul(k.transpose(-1, -2), v1)          # [B, g, d, d+1]
        out = torch.matmul(q, kv)                           # [B, g, N, d+1]
        out = out[..., :-1] / (out[..., -1:] + self.eps)
        out = out.transpose(-1, -2).reshape(b, -1, hh, ww).to(x.dtype)
        return self.proj(out)


class EfficientViTBlock(nn.Module):
    """LiteMLA residual, then MBConv residual (ops.py:457-493)."""

    def __init__(self, ch: int, *, dim: int, scales: Sequence[int],
                 expand: float, act_func: str = "gelu", device=None):
        super().__init__()
        self.context_module = ResidualBlock(
            LiteMLA(ch, dim=dim, scales=scales, device=device), True)
        self.local_module = ResidualBlock(
            MBConv(ch, ch, expand, fewer_norm=True, act_func=act_func,
                   device=device), True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.local_module(self.context_module(x))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 std: Callable[[nn.Module, str, torch.Tensor], float]
                 ) -> nn.Module:
    """Random weights in module order from ``generator``: norms get weight
    1 and bias 0 (BatchNorm's running statistics 0 and 1), other biases 0,
    every other parameter N(0, std(module, name, p)^2), ``module`` being
    the parameter's owner."""
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if isinstance(m, (BatchNorm, LayerNorm2d, layers.LayerNorm)):
                p.fill_(1.0 if pname in ("weight", "running_var") else 0.0)
            elif pname == "bias":
                p.zero_()
            else:
                name = f"{mname}.{pname}" if mname else pname
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * std(m, name, p))
    return model


# --------------------------------------------------------------------------
# Resizes (NCHW)
# --------------------------------------------------------------------------

def _interpolate(x: torch.Tensor, size: tuple, **kw) -> torch.Tensor:
    # in fp64: torch then takes its source coordinates in fp64 too, as
    # the JAX package builds its matrices (fp32 coordinates are off by
    # ~1e-5 of a pixel at ratios such as 8/3)
    return F.interpolate(x.double(), size=tuple(size), **kw).to(x.dtype)


def bicubic_resize(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """torch bicubic (a = -0.75, align_corners=False)."""
    return _interpolate(x, size, mode="bicubic", align_corners=False)


def bilinear_resize(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """torch bilinear (align_corners=False, no antialias)."""
    return _interpolate(x, size, mode="bilinear", align_corners=False)


def bilinear_resize_ac(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """torch bilinear with align_corners=True."""
    return _interpolate(x, size, mode="bilinear", align_corners=True)


def resize_uint8(image: np.ndarray, size: tuple,
                 device=None) -> torch.Tensor:
    """PIL's ``resize(BILINEAR)`` of a uint8 [H, W, 3] image to ``size``
    (H, W): antialiased bilinear (its support widens when it shrinks),
    rounded to uint8 levels. Returns fp32 [h, w, 3] on ``device``; within
    one level of PIL, which rounds between its two passes. The same size
    returns the image unchanged."""
    x = torch.as_tensor(np.ascontiguousarray(image), device=device).float()
    if tuple(size) == tuple(image.shape[:2]):
        return x
    y = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255)


def _bicubic(x: float) -> float:
    """PIL's bicubic kernel, a = -0.5, support 2."""
    a, x = -0.5, abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """PIL's Lanczos kernel: sinc truncated to [-3, 3)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# PIL's 8-bit resampling filters: (kernel, support)
PIL_FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}
_PRECISION_BITS = 22                    # PIL's 8-bit resampling: 32 - 8 - 2


def _pil_taps(n_in: int, n_out: int, filt: str = "bicubic") -> tuple:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one of
    ``PIL_FILTERS``: (source index [n_out, k], fixed-point weight
    [n_out, k]), unused taps weight 0."""
    kernel, base_support = PIL_FILTERS[filt]
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = base_support * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [kernel((x + xmin - center + 0.5) * (1.0 / fscale))
             for x in range(xmax)]
        ww = sum(w)
        w = [v / ww if ww != 0.0 else v for v in w]
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        kk[xx, :xmax] = [int(v * (1 << _PRECISION_BITS)
                             + (0.5 if v >= 0 else -0.5)) for v in w]
    return idx, kk


def _pil_pass(x: np.ndarray, axis: int, n_out: int,
              filt: str = "bicubic") -> np.ndarray:
    """One PIL resampling pass of uint8 data along ``axis`` (0 or 1):
    fixed-point sums, rounded and clipped to uint8."""
    idx, kk = _pil_taps(x.shape[axis], n_out, filt)
    xs = x.astype(np.int64)
    acc = np.full(x.shape[:axis] + (n_out,) + x.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = (-1, 1) if axis == 0 else (1, -1)
    for k in range(idx.shape[1]):
        acc += np.take(xs, idx[:, k], axis=axis) * \
            kk[:, k].reshape(shape + (1,) * (x.ndim - 2))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize_uint8(image: np.ndarray, size: tuple,
                     filt: str = "bicubic") -> np.ndarray:
    """PIL's ``Image.resize((w, h), BICUBIC or LANCZOS)`` of uint8
    [H, W, C] to ``size`` (H, W), bit for bit: its two fixed-point passes,
    horizontal first, each rounded and clipped to uint8. No single
    interpolation reproduces it: both kernels overshoot, and PIL clips the
    overshoot between the passes."""
    h, w = size
    x = np.asarray(image, np.uint8)
    if w != x.shape[1]:
        x = _pil_pass(x, 1, w, filt)
    if h != x.shape[0]:
        x = _pil_pass(x, 0, h, filt)
    return x
