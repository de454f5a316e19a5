"""SDXL AutoencoderKL (port of ``omg_tpu/models/vae.py``): both halves,
submodule names as in the diffusers state_dict.

``decode`` takes NHWC latents and returns NHWC images in [-1, 1],
computed in the config's dtype (fp32 for SDXL); ``encode`` takes NHWC
images in [-1, 1] and returns the scaled posterior mean, or a posterior
sample. The mid-block attentions (1 head x 512 dims; 16384 tokens in the
encoder at 1024²) run the plain attention path, as the JAX gate routes
them. ``decoder_copy(dtype)`` is the decoder half cast once and kept (the
bf16 decode of ``pipelines/sdxl.decode_latents``).

``decode(..., seq_group=g)`` decodes this rank's block of latent rows into
its block of image rows: halo convs, group norms over the group and the
mid-block attention on K/V gathered over it (``nn/``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def _mid_block(ch, groups, kw) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList(
        [ResnetBlock(ch, ch, groups, kw) for _ in range(2)])
    mid.attentions = nn.ModuleList([AttentionBlock(ch, groups, kw)])
    return mid


def _mid(mid: nn.Module, x, seq=None):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x, seq), seq), seq)


class Encoder(nn.Module):
    """Down blocks (each downsampler pads the right and bottom edge by one
    before its stride-2 VALID conv, as diffusers does), the mid block, then
    norm, SiLU and ``conv_out`` to the posterior's 2 x latent channels."""

    def __init__(self, cfg: VAEConfig, kw):
        super().__init__()
        g = cfg.norm_num_groups
        chs = list(cfg.block_out_channels)
        self.conv_in = layers.Conv2d(cfg.in_channels, chs[0], 3, **kw)
        self.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i, ch in enumerate(chs):
            in_ch, out_ch = out_ch, ch
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g, kw)
                 for j in range(cfg.layers_per_block)])
            if i < len(chs) - 1:
                down = nn.Module()
                down.conv = layers.Conv2d(out_ch, out_ch, 3, stride=2,
                                          padding=0, **kw)
                blk.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chs[-1], g, kw)
        self.conv_norm_out = layers.GroupNorm(chs[-1], g, **kw)
        self.conv_out = layers.Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                      **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(
                    torch.nn.functional.pad(x, (0, 1, 0, 1)))
        x = _mid(self.mid_block, x)
        return self.conv_out(torch.nn.functional.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, kw):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(cfg.block_out_channels)[::-1]
        n = len(rev)
        self.conv_in = layers.Conv2d(cfg.latent_channels, rev[0], 3, **kw)
        self.mid_block = _mid_block(rev[0], g, kw)
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
        x = _mid(self.mid_block, self.conv_in(x, seq), seq)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x, seq)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(layers.upsample_nearest_2x(x), seq)
        x = torch.nn.functional.silu(self.conv_norm_out(x, seq))
        return self.conv_out(x, seq)


class AutoencoderKL(nn.Module):
    """The SDXL VAE; ``encoder=False`` builds the decoder half alone (the
    cast copies of ``decoder_copy``)."""

    def __init__(self, cfg: VAEConfig, device=None, *, encoder: bool = True):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.decoder = Decoder(cfg, kw)
        self.post_quant_conv = layers.Conv2d(
            cfg.latent_channels, cfg.latent_channels, 1, **kw)
        if encoder:
            self.encoder = Encoder(cfg, kw)
            self.quant_conv = layers.Conv2d(
                2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, **kw)
        self._copies: dict = {}     # dtype -> decoder_copy, not submodules

    def decode(self, latents: torch.Tensor,
               seq_group=None) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in [-1, 1].
        ``seq_group``: latents hold this rank's block of rows, and so does
        the image."""
        cfg = self.cfg
        x = (latents.float() / cfg.scaling_factor).to(cfg.dtype)
        x = self.post_quant_conv(x.permute(0, 3, 1, 2))
        return self.decoder(x, seq_group).permute(0, 2, 3, 1)

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Images [B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8,
        4]: the posterior mean, or with ``generator`` a posterior sample
        mean + exp(logvar / 2) * eps, eps [B, H/8, W/8, 4] drawn in fp32 on
        the CPU from ``generator`` (a CPU generator, as
        ``sdxl.prepare_latents`` draws) and moved to the images' device.
        ``noise``: that eps given instead of drawn."""
        cfg = self.cfg
        x = self.encoder(images.to(cfg.dtype).permute(0, 3, 1, 2))
        mean, logvar = self.quant_conv(x).permute(0, 2, 3, 1).chunk(2, -1)
        if generator is not None and noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                dtype=torch.float32)
        if noise is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            mean = mean + std * noise.to(device=mean.device, dtype=mean.dtype)
        return mean * cfg.scaling_factor

    def decoder_copy(self, dtype: torch.dtype) -> "AutoencoderKL":
        """The decoder half (``decoder`` and ``post_quant_conv``) cast to
        ``dtype``, made on the first call and kept in this module's
        ``_copies`` (not a submodule: ``state_dict``, ``parameters`` and
        ``.to`` do not see it, and it is not refreshed if these weights
        change). Its ``decode`` computes in ``dtype``. For SDXL in bf16 it
        holds 49.5 M parameters, 94.4 MiB on the weights' device."""
        if dtype == self.cfg.dtype:
            return self
        if dtype not in self._copies:
            copy = AutoencoderKL(dataclasses.replace(self.cfg, dtype=dtype),
                                 self.post_quant_conv.weight.device,
                                 encoder=False)
            own = self.state_dict()
            with torch.no_grad():
                for k, v in copy.state_dict().items():
                    v.copy_(own[k])
            self._copies[dtype] = copy
        return self._copies[dtype]


def init_half(model: AutoencoderKL, half: str,
              generator: torch.Generator) -> None:
    """Draw one half's random weights from ``generator``: "decoder"
    (``decoder``, ``post_quant_conv``) or "encoder" (``encoder``,
    ``quant_conv``)."""
    mods = ((model.decoder, model.post_quant_conv) if half == "decoder"
            else (model.encoder, model.quant_conv))
    for m in mods:
        layers.init_params(m, generator)


def init_params(generator: torch.Generator, cfg: VAEConfig,
                device=None) -> AutoencoderKL:
    """A VAE with random weights drawn from ``generator`` on ``device``
    (the generator's device when None): the decoder half first, then the
    encoder half, so that a seed gives the decoder it gave before the
    encoder was ported (``sdxl.init_params`` draws the encoder after the
    text encoders, for the same reason)."""
    model = AutoencoderKL(cfg, device or generator.device)
    init_half(model, "decoder", generator)
    init_half(model, "encoder", generator)
    return model
