"""SDXL AutoencoderKL decoder (port of ``omg_tpu/models/vae.py``).

The OMG path only decodes, so only the decoder side and
``post_quant_conv`` are ported; submodule names follow the diffusers
state_dict. ``decode`` takes NHWC latents and returns NHWC images in
[-1, 1], computed in fp32. The mid-block attention (1 head x 512 dims)
runs the plain attention path, as the JAX gate routes it.

``decode(..., seq_group=g)`` decodes this rank's block of latent rows into
its block of image rows: halo convs, group norms over the group and the
mid-block attention on K/V gathered over it (``nn/``).
"""

from __future__ import annotations

import torch
from torch import nn

from omg_tpu_torch.config import VAEConfig
from omg_tpu_torch.nn import layers
from omg_tpu_torch.nn.attention import sdpa, seq_sharded_sdpa


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, groups, kw):
        super().__init__()
        self.norm1 = layers.GroupNorm(in_ch, groups, **kw)
        self.conv1 = layers.Conv2d(in_ch, out_ch, 3, **kw)
        self.norm2 = layers.GroupNorm(out_ch, groups, **kw)
        self.conv2 = layers.Conv2d(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = (layers.Conv2d(in_ch, out_ch, 1, **kw)
                              if in_ch != out_ch else None)

    def forward(self, x, seq=None):
        h = self.conv1(torch.nn.functional.silu(self.norm1(x, seq)), seq)
        h = self.conv2(torch.nn.functional.silu(self.norm2(h, seq)), seq)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, ch, groups, kw):
        super().__init__()
        self.group_norm = layers.GroupNorm(ch, groups, **kw)
        self.to_q = layers.Linear(ch, ch, **kw)
        self.to_k = layers.Linear(ch, ch, **kw)
        self.to_v = layers.Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([layers.Linear(ch, ch, **kw)])

    def forward(self, x, seq=None):
        b, c, hh, ww = x.shape
        h = self.group_norm(x, seq).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (lin(h)[:, None] for lin in (self.to_q, self.to_k,
                                                 self.to_v))
        att = (sdpa(q, k, v) if seq is None or seq.size == 1
               else seq_sharded_sdpa(q, k, v, seq))
        out = self.to_out[0](att[:, 0])
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, kw):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(cfg.block_out_channels)[::-1]
        n = len(rev)
        self.conv_in = layers.Conv2d(cfg.latent_channels, rev[0], 3, **kw)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(rev[0], rev[0], g, kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [AttentionBlock(rev[0], g, kw)])
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(n):
            in_ch, out_ch = out_ch, rev[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g, kw)
                 for j in range(cfg.layers_per_block + 1)])
            if i < n - 1:
                up = nn.Module()
                up.conv = layers.Conv2d(out_ch, out_ch, 3, **kw)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = layers.GroupNorm(rev[-1], g, **kw)
        self.conv_out = layers.Conv2d(rev[-1], cfg.out_channels, 3, **kw)

    def forward(self, x, seq=None):
        x = self.conv_in(x, seq)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, seq), seq),
                           seq)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x, seq)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(layers.upsample_nearest_2x(x), seq)
        x = torch.nn.functional.silu(self.conv_norm_out(x, seq))
        return self.conv_out(x, seq)


class AutoencoderKL(nn.Module):
    """Decoder half of the SDXL VAE."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.decoder = Decoder(cfg, kw)
        self.post_quant_conv = layers.Conv2d(
            cfg.latent_channels, cfg.latent_channels, 1, **kw)

    def decode(self, latents: torch.Tensor,
               seq_group=None) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in [-1, 1].
        ``seq_group``: latents hold this rank's block of rows, and so does
        the image."""
        cfg = self.cfg
        x = (latents.float() / cfg.scaling_factor).to(cfg.dtype)
        x = self.post_quant_conv(x.permute(0, 3, 1, 2))
        return self.decoder(x, seq_group).permute(0, 2, 3, 1)


def init_params(generator: torch.Generator, cfg: VAEConfig,
                device=None) -> AutoencoderKL:
    """A VAE decoder with random weights drawn from ``generator`` on
    ``device`` (the generator's device when None)."""
    return layers.init_params(AutoencoderKL(cfg, device or generator.device),
                              generator)
