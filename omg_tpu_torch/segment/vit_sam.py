"""SAM ViT image encoder, ViT-H/16 and its B/L siblings (port of
``omg_tpu/segment/vit_sam.py``).

segment_anything's ``ImageEncoderViT``: a 16x16 patch embedding plus an
absolute position grid, blocks of decomposed relative-position attention
over 14x14 windows (global attention at layers 7/15/23/31 in ViT-H), and
a two-conv 256-channel neck. It produces the [B, 64, 64, 256] embedding
the SAM decoder consumes, so ``SamPredictor`` runs over either encoder
family.

The blocks work on an NHWC token grid, as segment_anything's do; the
patch embedding and the neck convolve NCHW. Attention is plain torch
(head dim 80 with an additive bias falls outside the flash kernel's
gate): fp32 logits, the per-axis rel-pos terms gathered with a static
(i - j) index, one softmax. A global block's logits are
[B, 16, 4096, 4096] fp32 (1 GiB per image at 1024²).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch import convert
from omg_tpu_torch.nn import layers
from omg_tpu_torch.segment import evit_ops as ops


@dataclasses.dataclass(frozen=True)
class VitSamConfig:
    image_size: int = 1024
    patch_size: int = 16
    dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: int = 4
    window_size: int = 14
    # segment_anything's ViT-H: global attention every 8th block
    global_attn_indexes: Sequence[int] = (7, 15, 23, 31)
    out_chans: int = 256
    dtype: torch.dtype = torch.float32


def vit_h_config() -> VitSamConfig:
    """SAM-ViT-H/16 (sam_vit_h_4b8939.pth geometry)."""
    return VitSamConfig()


def vit_l_config() -> VitSamConfig:
    """SAM-ViT-L (sam_vit_l_0b3195.pth)."""
    return VitSamConfig(dim=1024, depth=24,
                        global_attn_indexes=(5, 11, 17, 23))


def vit_b_config() -> VitSamConfig:
    """SAM-ViT-B (sam_vit_b_01ec64.pth)."""
    return VitSamConfig(dim=768, depth=12, num_heads=12,
                        global_attn_indexes=(2, 5, 8, 11))


def config_from_params(state: Mapping) -> VitSamConfig:
    """Geometry read off an encoder state dict (torch layouts), so ViT-B/L/H
    states all resolve. A block is global iff its rel-pos table spans the
    whole token grid; a wrong ``global_attn_indexes`` would gather rel-pos
    rows out of range."""
    pe = state["pos_embed"]                               # [1, g, g, dim]
    g, dim = int(pe.shape[1]), int(pe.shape[-1])
    patch = int(state["patch_embed.proj.weight"].shape[-1])
    depth = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith("blocks."))
    rows = [int(state[f"blocks.{i}.attn.rel_pos_h"].shape[0])
            for i in range(depth)]
    head_dim = int(state["blocks.0.attn.rel_pos_h"].shape[-1])
    glb = tuple(i for i, r in enumerate(rows) if r == 2 * g - 1)
    windows = sorted({(r + 1) // 2 for i, r in enumerate(rows)
                      if i not in glb})
    mlp_hidden = int(state["blocks.0.mlp.lin1.weight"].shape[0])
    return VitSamConfig(
        image_size=g * patch, patch_size=patch, dim=dim, depth=depth,
        num_heads=dim // head_dim, mlp_ratio=mlp_hidden // dim,
        window_size=windows[0] if windows else 0,
        global_attn_indexes=glb,
        out_chans=int(state["neck.0.weight"].shape[0]))


def tiny_config() -> VitSamConfig:
    """CPU-testable miniature: one windowed (with padding) + one global
    block at a 4x4 token grid."""
    return VitSamConfig(image_size=64, patch_size=16, dim=16, depth=2,
                        num_heads=2, window_size=3,
                        global_attn_indexes=(1,), out_chans=8)


# segment_anything uses LayerNorm(eps=1e-6) throughout
_LN_EPS = 1e-6


def _rel_pos_select(table: torch.Tensor, size: int) -> torch.Tensor:
    """[2*size-1, head_dim] -> [size, size, head_dim] at offsets (i - j)
    (q_size == k_size always: square windows, a square global grid)."""
    idx = np.arange(size)[:, None] - np.arange(size)[None, :] + size - 1
    return table[torch.as_tensor(idx, device=table.device)]


class Attention(nn.Module):
    """Decomposed-rel-pos attention over an NHWC token grid
    (segment_anything ``Attention`` + ``add_decomposed_rel_pos``)."""

    def __init__(self, dim: int, num_heads: int, table_rows: int,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = layers.Linear(dim, 3 * dim, device=device)
        self.proj = layers.Linear(dim, dim, device=device)
        table = (table_rows, dim // num_heads)
        self.rel_pos_h = layers.param(table, ops.F32, device)
        self.rel_pos_w = layers.param(table, ops.F32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        m = self.num_heads
        hd = c // m
        qkv = self.qkv(x.reshape(b, h * w, c))
        q, k, v = qkv.reshape(b, h * w, 3, m, hd).permute(2, 0, 3, 1, 4)
        logits = torch.matmul(q.float() * hd ** -0.5,
                              k.float().transpose(-1, -2))
        r_q = q.reshape(b, m, h, w, hd)
        rel_h = torch.einsum("bmhwc,hkc->bmhwk", r_q,
                             _rel_pos_select(self.rel_pos_h, h))
        rel_w = torch.einsum("bmhwc,wkc->bmhwk", r_q,
                             _rel_pos_select(self.rel_pos_w, w))
        grid = logits.view(b, m, h, w, h, w)
        grid += rel_h[..., :, None].float()
        grid += rel_w[..., None, :].float()
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


def _window_partition(x: torch.Tensor,
                      ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC -> [B*nW, ws, ws, C] with bottom/right zero padding."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(x: torch.Tensor, ws: int, padded: Tuple[int, int],
                        out: Tuple[int, int]) -> torch.Tensor:
    hp, wp = padded
    h, w = out
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class Block(nn.Module):
    def __init__(self, cfg: VitSamConfig, table_size: int, windowed: bool,
                 device=None):
        super().__init__()
        d = cfg.dim
        self.window = cfg.window_size if windowed else 0
        self.norm1 = layers.LayerNorm(d, eps=_LN_EPS, device=device)
        self.attn = Attention(d, cfg.num_heads, 2 * table_size - 1, device)
        self.norm2 = layers.LayerNorm(d, eps=_LN_EPS, device=device)
        self.mlp = nn.Module()
        self.mlp.lin1 = layers.Linear(d, cfg.mlp_ratio * d, device=device)
        self.mlp.lin2 = layers.Linear(cfg.mlp_ratio * d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            hw = y.shape[1:3]
            y, padded = _window_partition(y, self.window)
            y = _window_unpartition(self.attn(y), self.window, padded, hw)
        else:
            y = self.attn(y)
        x = x + y
        y = self.mlp.lin2(layers.gelu(self.mlp.lin1(self.norm2(x))))
        return x + y


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: VitSamConfig, device=None):
        super().__init__()
        self.cfg = cfg
        g = cfg.image_size // cfg.patch_size
        d = cfg.dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = ops.Conv(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=True,
                                         device=device)
        self.pos_embed = layers.param((1, g, g, d), ops.F32, device)
        glb = frozenset(cfg.global_attn_indexes)
        self.blocks = nn.ModuleList(
            Block(cfg, g if i in glb else cfg.window_size,
                  cfg.window_size > 0 and i not in glb, device)
            for i in range(cfg.depth))
        # conv1x1 -> LN2d -> conv3x3 -> LN2d, no biases on the convs
        oc = cfg.out_chans
        self.neck = nn.ModuleList([
            ops.Conv(d, oc, 1, device=device),
            ops.LayerNorm2d(oc, eps=_LN_EPS, device=device),
            ops.Conv(oc, oc, 3, padding=1, device=device),
            ops.LayerNorm2d(oc, eps=_LN_EPS, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] normalized image -> [B, S/16, S/16, out_chans]."""
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = x.permute(0, 3, 1, 2)
        for op in self.neck:
            x = op(x)
        return x.permute(0, 2, 3, 1)


def convert_encoder(sd: Mapping, *, device="cuda") -> ImageEncoderViT:
    """The ``image_encoder.``-stripped state dict of a SAM ViT checkpoint
    (``sam_vit_h_4b8939.pth``) -> an encoder of the geometry its shapes
    give, on ``device``. The torch layouts load as they are: ``pos_embed``
    is token-major [1, g, g, C] and the rel-pos tables [2s - 1, hd] in
    both."""
    device = layers.target_device(device, "vit_sam.convert_encoder")
    return convert.copy_into(ImageEncoderViT(config_from_params(sd), device),
                             sd)


def init_params(generator: torch.Generator, cfg: VitSamConfig,
                device=None) -> ImageEncoderViT:
    """Random weights (the JAX package's scheme: N(0, 0.02^2) weights,
    tables and grids, zero biases, unit norms) from ``generator`` on
    ``device`` (the generator's device when None)."""
    return ops.init_weights(ImageEncoderViT(cfg, device or generator.device),
                            generator, lambda *_: 0.02)
