"""Perceiver resampler for IP-Adapter / InstantID (port of
``omg_tpu/models/resampler.py``).

Projects an identity embedding (InstantID: a 512-d ArcFace vector) into
``num_queries`` image-prompt tokens for the UNet's decoupled IP
cross-attention. Keys follow the upstream checkpoint's ``image_proj``
half: learned ``latents``, ``proj_in``/``proj_out``, ``norm_out`` and
``layers.{i}.{0|1}``, where ``0`` is the attention and ``1`` the
feed-forward Sequential ``{0: LayerNorm, 1: Linear, 2: GELU, 3: Linear}``.

The attention scales q and k each by ``dim_head ** -0.25``, the upstream
``PerceiverAttention``'s ``1 / sqrt(sqrt(dim_head))``: 1/sqrt(dim_head)
in all. The JAX package scales each by ``dim_head ** -0.5`` (ROADMAP §3,
a defect of the reference); its function equals this one with its
``to_q`` weights multiplied by ``dim_head ** 0.5``. The softmax runs in
fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from omg_tpu_torch.config import ResamplerConfig
from omg_tpu_torch.nn import layers


class PerceiverAttention(nn.Module):
    """The latent queries attend over cat(x, latents)."""

    def __init__(self, cfg: ResamplerConfig, kw):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.heads = cfg.heads
        self.norm1 = layers.LayerNorm(cfg.dim, **kw)
        self.norm2 = layers.LayerNorm(cfg.dim, **kw)
        self.to_q = layers.Linear(cfg.dim, inner, bias=False, **kw)
        self.to_kv = layers.Linear(cfg.dim, 2 * inner, bias=False, **kw)
        self.to_out = layers.Linear(inner, cfg.dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n_q, _ = latents.shape

        def split(t):
            return t.unflatten(-1, (self.heads, -1)).transpose(1, 2)

        q = split(self.to_q(latents))
        k, v = (split(t) for t in
                self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1))
        scale = q.shape[-1] ** -0.25
        w = torch.matmul((q * scale).float(), (k * scale).float()
                         .transpose(-1, -2))
        w = torch.softmax(w, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, n_q, -1)
        return self.to_out(out)


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.latents = layers.param((1, cfg.num_queries, cfg.dim), cfg.dtype,
                                    device)
        self.proj_in = layers.Linear(cfg.embedding_dim, cfg.dim, **kw)
        self.proj_out = layers.Linear(cfg.dim, cfg.output_dim, **kw)
        self.norm_out = layers.LayerNorm(cfg.output_dim, **kw)
        inner_ff = cfg.dim * cfg.ff_mult
        self.layers = nn.ModuleList([nn.ModuleList([
            PerceiverAttention(cfg, kw),
            nn.Sequential(layers.LayerNorm(cfg.dim, **kw),
                          layers.Linear(cfg.dim, inner_ff, bias=False, **kw),
                          nn.GELU(),
                          layers.Linear(inner_ff, cfg.dim, bias=False, **kw))])
            for _ in range(cfg.depth)])

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        """embeds [B, N, embedding_dim] -> tokens [B, num_queries,
        output_dim]."""
        embeds = embeds.to(self.cfg.dtype)
        latents = self.latents.expand(embeds.shape[0], -1, -1)
        x = self.proj_in(embeds)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ResamplerConfig,
                device=None) -> Resampler:
    """A resampler with random weights drawn from ``generator`` on
    ``device`` (the generator's device when None); the latents are
    N(0, 1/dim), as upstream."""
    model = layers.init_params(Resampler(cfg, device or generator.device),
                               generator)
    model.latents.copy_(torch.randn(model.latents.shape, generator=generator,
                                    device=model.latents.device)
                        / cfg.dim ** 0.5)
    return model
