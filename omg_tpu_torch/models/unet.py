"""SDXL UNet2DConditionModel (port of ``omg_tpu/models/unet.py``).

Submodule names follow the diffusers state_dict, which the JAX parameter
tree mirrors (``ff.net.0.proj``/``ff.net.2`` and ``to_out.0`` are
``net_0_proj``/``net_2``/``to_out`` there; ``from_jax.py`` renames them).

The forward takes and returns NHWC latents [B, h, w, 4] like the JAX
``apply``; inside, the convolutions run NCHW. LoRA (flat dict, see
``nn/layers.py``) and P2P control are runtime inputs, so one module
serves the base lanes and the stacked concept lanes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from omg_tpu_torch.config import UNetConfig
from omg_tpu_torch.nn import layers
from omg_tpu_torch.nn.attention import Attention


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups, kw):
        super().__init__()
        self.norm1 = layers.GroupNorm(in_ch, groups, **kw)
        self.conv1 = layers.Conv2d(in_ch, out_ch, 3, **kw)
        self.time_emb_proj = layers.Linear(temb_ch, out_ch, **kw)
        self.norm2 = layers.GroupNorm(out_ch, groups, **kw)
        self.conv2 = layers.Conv2d(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = (layers.Conv2d(in_ch, out_ch, 1, **kw)
                              if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(torch.nn.functional.silu(self.norm1(x)))
        t = self.time_emb_proj(torch.nn.functional.silu(temb))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(torch.nn.functional.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU(proj), net.2 = out linear."""

    def __init__(self, dim, kw):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = layers.Linear(dim, dim * 8, **kw)
        self.net = nn.ModuleList(
            [geglu, nn.Identity(), layers.Linear(dim * 4, dim, **kw)])

    def forward(self, x, lora):
        h = layers.geglu(self.net[0].proj, x, lora)
        return self.net[2](h, lora)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, head_dim, kw):
        super().__init__()
        heads = dim // head_dim
        self.norm1 = layers.LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, num_heads=heads, head_dim=head_dim, **kw)
        self.norm2 = layers.LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, context_dim=ctx_dim, num_heads=heads,
                               head_dim=head_dim, **kw)
        self.norm3 = layers.LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, kw)

    def forward(self, x, context, lora, control):
        x = x + self.attn1(self.norm1(x), lora=lora, p2p=control)
        x = x + self.attn2(self.norm2(x), context, lora=lora, p2p=control)
        return x + self.ff(self.norm3(x), lora)


class Transformer2DModel(nn.Module):
    def __init__(self, dim, depth, ctx_dim, head_dim, groups, kw):
        super().__init__()
        self.norm = layers.GroupNorm(dim, groups, **kw)
        self.proj_in = layers.Linear(dim, dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, head_dim, kw)
             for _ in range(depth)])
        self.proj_out = layers.Linear(dim, dim, **kw)

    def forward(self, x, context, lora, control):
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_in(h, lora)
        for blk in self.transformer_blocks:
            h = blk(h, context, lora, control)
        h = self.proj_out(h, lora)
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def _sampler(ch, stride, kw):
    m = nn.Module()
    m.conv = layers.Conv2d(ch, ch, 3, stride=stride, **kw)
    return nn.ModuleList([m])


class UNet2DConditionModel(nn.Module):
    """SDXL UNet; ``forward`` is the JAX ``apply`` on the exact path."""

    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        temb = cfg.time_embed_dim
        g = cfg.norm_num_groups
        chs = list(cfg.block_out_channels)
        n = len(chs)

        def pair(in_dim):
            m = nn.Module()
            m.linear_1 = layers.Linear(in_dim, temb, **kw)
            m.linear_2 = layers.Linear(temb, temb, **kw)
            return m

        def transformer(ch, depth):
            return Transformer2DModel(ch, depth, cfg.cross_attention_dim,
                                      cfg.attention_head_dim, g, kw)

        self.conv_in = layers.Conv2d(cfg.in_channels, chs[0], 3, **kw)
        self.time_embedding = pair(chs[0])
        self.add_embedding = pair(cfg.projection_class_embeddings_input_dim)

        self.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i in range(n):
            in_ch, out_ch = out_ch, chs[i]
            depth = cfg.transformer_layers_per_block[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, temb, g, kw)
                 for j in range(cfg.layers_per_block)])
            blk.attentions = nn.ModuleList(
                [transformer(out_ch, depth)
                 for _ in range(cfg.layers_per_block)] if depth else [])
            if i < n - 1:
                blk.downsamplers = _sampler(out_ch, 2, kw)
            self.down_blocks.append(blk)

        mid_ch, mid_depth = chs[-1], cfg.transformer_layers_per_block[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(mid_ch, mid_ch, temb, g, kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [transformer(mid_ch, mid_depth)] if mid_depth else [])

        rev = chs[::-1]
        rev_depth = list(cfg.transformer_layers_per_block)[::-1]
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(n):
            prev_out, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n - 1)]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                skip_ch = in_ch if j == cfg.layers_per_block else out_ch
                res_in = prev_out if j == 0 else out_ch
                blk.resnets.append(
                    ResnetBlock(res_in + skip_ch, out_ch, temb, g, kw))
            blk.attentions = nn.ModuleList(
                [transformer(out_ch, rev_depth[i])
                 for _ in range(cfg.layers_per_block + 1)]
                if rev_depth[i] else [])
            if i < n - 1:
                blk.upsamplers = _sampler(out_ch, 1, kw)
            self.up_blocks.append(blk)

        self.conv_norm_out = layers.GroupNorm(chs[0], g, **kw)
        self.conv_out = layers.Conv2d(chs[0], cfg.out_channels, 3, **kw)
        layers.set_lora_keys(self)

    def time_embeddings(self, timestep, text_embeds: torch.Tensor,
                        time_ids: torch.Tensor) -> torch.Tensor:
        """Timestep + SDXL text_time micro-conditioning -> [B, temb].
        The sinusoids run in fp32 and are cast to the model dtype before
        the two MLPs, as in the JAX package."""
        cfg = self.cfg
        b = text_embeds.shape[0]
        t = torch.as_tensor(timestep, dtype=torch.float32,
                            device=text_embeds.device).expand(b)
        t_emb = layers.timestep_embedding(t, cfg.block_out_channels[0])
        te = self.time_embedding
        temb = te.linear_2(torch.nn.functional.silu(
            te.linear_1(t_emb.to(cfg.dtype))))
        ids = time_ids.float().reshape(-1)
        id_emb = layers.timestep_embedding(
            ids, cfg.addition_time_embed_dim).reshape(b, -1)
        add = torch.cat([text_embeds.float(), id_emb], dim=-1)
        ae = self.add_embedding
        aemb = ae.linear_2(torch.nn.functional.silu(
            ae.linear_1(add.to(cfg.dtype))))
        return temb + aemb

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor, *,
                text_embeds: torch.Tensor, time_ids: torch.Tensor,
                lora: Optional[dict] = None, control=None) -> torch.Tensor:
        """sample: [B, h, w, 4] NHWC latents -> eps prediction, same shape."""
        ctx = encoder_hidden_states
        temb = self.time_embeddings(timestep, text_embeds, time_ids)
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        residuals = [x]
        for blk in self.down_blocks:
            for ri, res in enumerate(blk.resnets):
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[ri](x, ctx, lora, control)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                residuals.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        if len(mid.attentions):
            x = mid.attentions[0](x, ctx, lora, control)
        x = mid.resnets[1](x, temb)

        for blk in self.up_blocks:
            for ri, res in enumerate(blk.resnets):
                x = torch.cat([x, residuals.pop().to(x.dtype)], dim=1)
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[ri](x, ctx, lora, control)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(layers.upsample_nearest_2x(x))

        x = torch.nn.functional.silu(self.conv_norm_out(x))
        return self.conv_out(x).permute(0, 2, 3, 1)


def init_params(generator: torch.Generator, cfg: UNetConfig,
                device=None) -> UNet2DConditionModel:
    """A UNet with random weights drawn from ``generator`` on ``device``."""
    return layers.init_params(UNet2DConditionModel(cfg, device), generator)


def num_cross_attention_layers(cfg: UNetConfig) -> int:
    """Count of attn2 layers, traversal order."""
    depths = list(cfg.transformer_layers_per_block)
    return (cfg.layers_per_block * sum(depths) + depths[-1]
            + (cfg.layers_per_block + 1) * sum(depths))
