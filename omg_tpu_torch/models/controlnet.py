"""ControlNet-SDXL (port of ``omg_tpu/models/controlnet.py``).

The UNet's encoder half (conv_in, the time and text_time embeddings, the
down blocks and the mid block, built from ``models/unet.py``'s
``ResnetBlock`` and ``Transformer2DModel``), a conditioning embedder that
reduces the pixel-space condition image 8x to latent resolution, and
zero-conv heads: one per skip of the UNet and one for the mid block.
Submodule names follow diffusers ``ControlNetModel``'s state dict. It
serves the spatial ControlNets (openpose/canny/depth) and InstantID's
IdentityNet, whose encoder_hidden_states are the image-prompt tokens.

The encoder runs with no LoRA and no P2P control, so its self-attention
takes the same route as the UNet's: the flash kernel on a CUDA device
(``ops/flash_attention.py``), the plain version on the CPU.

``forward`` takes NHWC latents and an NHWC condition image like the JAX
``apply`` and returns the residuals NCHW, the layout the UNet's forward
adds them in.

``forward(..., seq_group=g)`` runs the spatially split layout of the
multi-device stage 1, as the UNet's does: ``sample`` holds this rank's
block of latent rows and ``cond_image`` the same block of pixel rows (8x
as many); every conv of the encoder and of the conditioning embedder
reads its neighbours' halo rows, group norms sum their statistics over
the group, the self-attentions run K1b, and the residuals come back split
by rows, as the UNet's levels are. The embedder's stride-2 convs need an
even number of local rows at each stage and raise otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.config import ControlNetConfig
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import layers
from omg_tpu_torch.utils import profiling


class ConditioningEmbedding(nn.Module):
    """diffusers ControlNetConditioningEmbedding: conv_in, pairs of
    (3x3, 3x3 stride 2) convs with SiLU, and conv_out (zero-initialized in
    an untrained ControlNet)."""

    def __init__(self, cfg: ControlNetConfig, out_ch: int, kw):
        super().__init__()
        chs = list(cfg.conditioning_embedding_out_channels)
        self.conv_in = layers.Conv2d(cfg.conditioning_channels, chs[0], 3,
                                     **kw)
        self.blocks = nn.ModuleList()
        for a, b in zip(chs[:-1], chs[1:]):
            self.blocks.append(layers.Conv2d(a, a, 3, **kw))
            self.blocks.append(layers.Conv2d(a, b, 3, stride=2, **kw))
        self.conv_out = layers.Conv2d(chs[-1], out_ch, 3, **kw)

    def forward(self, cond: torch.Tensor, seq=None) -> torch.Tensor:
        x = F.silu(self.conv_in(cond, seq))
        for conv in self.blocks:
            x = F.silu(conv(x, seq))
        return self.conv_out(x, seq)


class ControlNetModel(nn.Module):
    def __init__(self, cfg: ControlNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        u = cfg.unet
        kw = dict(dtype=u.dtype, device=device)
        temb = u.time_embed_dim
        g = u.norm_num_groups
        chs = list(u.block_out_channels)
        n = len(chs)

        def pair(in_dim):
            m = nn.Module()
            m.linear_1 = layers.Linear(in_dim, temb, **kw)
            m.linear_2 = layers.Linear(temb, temb, **kw)
            return m

        def transformer(ch, depth):
            return unet_lib.Transformer2DModel(ch, depth, u.cross_attention_dim,
                                               u.attention_head_dim, g, kw)

        self.conv_in = layers.Conv2d(u.in_channels, chs[0], 3, **kw)
        self.time_embedding = pair(chs[0])
        self.add_embedding = pair(u.projection_class_embeddings_input_dim)
        self.controlnet_cond_embedding = ConditioningEmbedding(cfg, chs[0], kw)

        self.down_blocks = nn.ModuleList()
        head_chs = [chs[0]]             # the channels of every skip
        out_ch = chs[0]
        for i in range(n):
            in_ch, out_ch = out_ch, chs[i]
            depth = u.transformer_layers_per_block[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [unet_lib.ResnetBlock(in_ch if j == 0 else out_ch, out_ch,
                                      temb, g, kw)
                 for j in range(u.layers_per_block)])
            blk.attentions = nn.ModuleList(
                [transformer(out_ch, depth)
                 for _ in range(u.layers_per_block)] if depth else [])
            head_chs += [out_ch] * u.layers_per_block
            if i < n - 1:
                blk.downsamplers = unet_lib._sampler(out_ch, 2, kw)
                head_chs.append(out_ch)
            self.down_blocks.append(blk)

        mid_ch, mid_depth = chs[-1], u.transformer_layers_per_block[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [unet_lib.ResnetBlock(mid_ch, mid_ch, temb, g, kw)
             for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [transformer(mid_ch, mid_depth)] if mid_depth else [])

        self.controlnet_down_blocks = nn.ModuleList(
            [layers.Conv2d(ch, ch, 1, **kw) for ch in head_chs])
        self.controlnet_mid_block = layers.Conv2d(mid_ch, mid_ch, 1, **kw)
        layers.set_lora_keys(self)

    @profiling.spanned("controlnet", timed=True)
    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor,
                cond_image: torch.Tensor, *, text_embeds: torch.Tensor,
                time_ids: torch.Tensor, conditioning_scale=1.0,
                guess_mode: bool = False, seq_group=None) -> tuple:
        """-> (down residuals, mid residual), NCHW, scaled.

        ``sample``: [B, h, w, 4] NHWC latents; ``cond_image``: [B, H, W, C]
        at pixel resolution (8x the latents'). ``conditioning_scale``: a
        scalar or a per-lane [B, 1, 1, 1] tensor. ``guess_mode``: diffusers'
        residual ramp, the shallowest residual scaled by 0.1 rising
        log-linearly to 1.0 at the mid block. ``seq_group``: both hold
        this rank's block of rows (``parallel.comm.Group``, equal blocks in
        group order), and so do the residuals."""
        u, seq = self.cfg.unet, seq_group
        ctx = encoder_hidden_states.to(u.dtype)
        temb = unet_lib.time_embeddings(self, u, timestep, text_embeds,
                                        time_ids)
        x = self.conv_in(sample.permute(0, 3, 1, 2), seq)
        x = x + self.controlnet_cond_embedding(
            cond_image.permute(0, 3, 1, 2).to(x.dtype), seq).to(x.dtype)
        residuals = [x]
        for blk in self.down_blocks:
            for ri, res in enumerate(blk.resnets):
                x = res(x, temb, seq)
                if len(blk.attentions):
                    x = blk.attentions[ri](x, ctx, None, None, seq)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x, seq)
                residuals.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb, seq)
        if len(mid.attentions):
            x = mid.attentions[0](x, ctx, None, None, seq)
        x = mid.resnets[1](x, temb, seq)

        scale = conditioning_scale
        if not torch.is_tensor(scale):      # a host number: a fill, no copy
            scale = torch.full((), float(scale), device=x.device)
        elif scale.device.type != x.device.type:
            scale = profiling.sync(scale.to, x.device)  # a blocking copy
        scale = scale.to(device=x.device, dtype=x.dtype)
        n = len(residuals)
        if guess_mode:
            ramp = torch.logspace(-1.0, 0.0, n + 1, dtype=torch.float32,
                                  device=x.device).to(x.dtype)
            scales = [scale * ramp[j] for j in range(n + 1)]
        else:
            scales = [scale] * (n + 1)
        down = [zc(r) * s for zc, r, s in
                zip(self.controlnet_down_blocks, residuals, scales)]
        return down, self.controlnet_mid_block(x) * scales[n]


def init_params(generator: torch.Generator, cfg: ControlNetConfig,
                device=None) -> ControlNetModel:
    """A ControlNet with random weights drawn from ``generator`` on
    ``device`` (the generator's device when None). Unlike a freshly
    initialized diffusers ControlNet, the zero-convs are random too: a
    zero-initialized one is an exact no-op."""
    return layers.init_params(ControlNetModel(cfg, device or generator.device),
                              generator)
