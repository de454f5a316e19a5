"""SDXL building blocks (port of ``omg_tpu/pipelines/sdxl.py``): configs,
random weights, text encoding, micro-conditioning, initial latents and
the fp32 VAE decode. The single-prompt ``text_to_image`` loop comes with
the batching slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omg_tpu_torch import config as cfglib
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import clip, unet, vae
from omg_tpu_torch.parallel import comm


class SDXLParams(NamedTuple):
    """The four SDXL submodels."""
    unet: unet.UNet2DConditionModel
    vae: vae.AutoencoderKL
    text_encoder: clip.CLIPTextModel
    text_encoder_2: clip.CLIPTextModel


class SDXLConfig(NamedTuple):
    unet: cfglib.UNetConfig
    vae: cfglib.VAEConfig
    text_encoder: cfglib.CLIPTextConfig
    text_encoder_2: cfglib.CLIPTextConfig


def sdxl_config() -> SDXLConfig:
    return SDXLConfig(cfglib.sdxl_unet(), cfglib.sdxl_vae(),
                      cfglib.sdxl_text_encoder(), cfglib.sdxl_text_encoder_2())


def tiny_config() -> SDXLConfig:
    return SDXLConfig(cfglib.tiny_unet(), cfglib.tiny_vae(),
                      cfglib.tiny_text_encoder(), cfglib.tiny_text_encoder_2())


def init_params(generator: torch.Generator, cfg: SDXLConfig,
                device=None) -> SDXLParams:
    """Random weights for all four models, drawn from ``generator`` on
    ``device`` (the generator's device when None)."""
    return SDXLParams(
        unet=unet.init_params(generator, cfg.unet, device),
        vae=vae.init_params(generator, cfg.vae, device),
        text_encoder=clip.init_params(generator, cfg.text_encoder, device),
        text_encoder_2=clip.init_params(generator, cfg.text_encoder_2,
                                        device))


def encode_tokens(cfg: SDXLConfig, params: SDXLParams, ids1: torch.Tensor,
                  ids2: torch.Tensor, lora1: Optional[dict] = None,
                  lora2: Optional[dict] = None) -> tuple:
    """Token ids [B, 77] x2 -> (embeds [B, 77, H1+H2], pooled [B, P]):
    penultimate states of both encoders concatenated, and the projected
    EOS state of encoder 2. ``lora1``/``lora2``: text-encoder adapters."""
    out1 = params.text_encoder(ids1, lora1)
    out2 = params.text_encoder_2(ids2, lora2)
    embeds = torch.cat([out1.penultimate, out2.penultimate], dim=-1)
    return embeds, out2.projected


def add_time_ids(original_size: tuple, crops_coords_top_left: tuple,
                 target_size: tuple, device=None) -> torch.Tensor:
    """SDXL micro-conditioning vector [1, 6]."""
    ids = list(original_size) + list(crops_coords_top_left) + list(target_size)
    return torch.tensor([ids], dtype=torch.float32, device=device)


def prepare_latents(generator: torch.Generator, batch: int, height: int,
                    width: int, sched: schedulers.Schedule,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit noise [B, h, w, 4] from ``generator``, scaled by the
    schedule's initial sigma."""
    noise = torch.randn((batch, height // 8, width // 8, 4),
                        generator=generator, device=device,
                        dtype=torch.float32).to(dtype)
    return schedulers.scale_initial_noise(sched, noise)


def decode_latents(cfg: SDXLConfig, vae_model: vae.AutoencoderKL,
                   latents: torch.Tensor, *,
                   spatial: Optional[comm.Group] = None) -> torch.Tensor:
    """Latents -> images [B, H, W, 3] in [0, 1], decoded in fp32.

    ``spatial``: decode H-split over the group (the mesh latency mode):
    every rank passes the whole latents, decodes its block of rows (the
    VAE is convs and one attention, token-parallel with replicated
    weights) and gets the whole image back, gathered along H."""
    latents = latents.to(cfg.vae.dtype)
    if spatial is None or spatial.size == 1:
        img = vae_model.decode(latents)
    else:
        h = latents.shape[1]
        if h % spatial.size:
            raise ValueError(f"{h} latent rows do not split over "
                             f"{spatial.size} ranks")
        rows = h // spatial.size
        local = latents[:, spatial.index * rows:(spatial.index + 1) * rows]
        img = comm.all_gather(vae_model.decode(local, seq_group=spatial), 1,
                              spatial)
    return torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
