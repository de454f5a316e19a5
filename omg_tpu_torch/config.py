"""Model/architecture configs (port of ``omg_tpu/config.py``).

One dataclass per model family, with two presets each:
  * ``sdxl_*`` (and ``instantid_resampler``) — the real geometry;
  * ``tiny_*`` — CPU-runnable miniatures for tests.

Dtypes are torch dtypes. The CLIP ViT-B/32 pair serves the open-vocabulary
detector (``segment/detector.py``); the ControlNet and resampler configs
serve the conditioned paths (BASELINE configs #3 and #4).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SDXL UNet2DConditionModel geometry (diffusers-compatible naming)."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280)
    # Number of resnets per down block (up blocks get +1).
    layers_per_block: int = 2
    # Transformer depth per block level; 0 => plain (no-attention) block.
    transformer_layers_per_block: Sequence[int] = (0, 2, 10)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    # "text_time" micro-conditioning: pooled text emb (1280) + 6 packed
    # time/size ids through a 256-dim sinusoidal embedding.
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL geometry (SDXL VAE). Decoded in fp32."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text encoder geometry (covers both SDXL encoders)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    # OpenCLIP bigG uses "gelu"; CLIP-L uses "quick_gelu".
    hidden_act: str = "quick_gelu"
    projection_dim: int = 0  # >0 => has text_projection (encoder 2)
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT image tower (transformers CLIPVisionModelWithProjection),
    the detector's crop scorer."""

    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    hidden_act: str = "quick_gelu"
    projection_dim: int = 512
    dtype: torch.dtype = torch.float32


def clip_vit_b32_vision() -> CLIPVisionConfig:
    """openai/clip-vit-base-patch32 image tower."""
    return CLIPVisionConfig()


def clip_vit_b32_text() -> CLIPTextConfig:
    """openai/clip-vit-base-patch32 text tower: pairs with the vision tower
    above (a 512-d shared embedding space). fp32: the detector ranks
    cosine similarities, and the tower is small."""
    return CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                          num_heads=8, projection_dim=512,
                          dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet-SDXL geometry: the UNet's encoder half, a conditioning
    embedder and zero-conv heads. Serves the spatial ControlNets
    (openpose/canny/depth) and InstantID's IdentityNet alike (the same
    architecture, conditioned on a face-keypoint image with the
    image-prompt tokens as encoder_hidden_states)."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Sequence[int] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """IP-Adapter Perceiver resampler. InstantID's preset: dim 1280, depth
    4, 20 heads of 64, 16 latent tokens, a 512-d ArcFace embedding in,
    cross_attention_dim out."""

    dim: int = 1280
    depth: int = 4
    dim_head: int = 64
    heads: int = 20
    num_queries: int = 16
    embedding_dim: int = 512
    output_dim: int = 2048
    ff_mult: int = 4
    dtype: torch.dtype = torch.bfloat16


def sdxl_unet() -> UNetConfig:
    return UNetConfig()


def sdxl_vae() -> VAEConfig:
    return VAEConfig()


def sdxl_text_encoder() -> CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (SDXL text_encoder)."""
    return CLIPTextConfig()


def sdxl_text_encoder_2() -> CLIPTextConfig:
    """OpenCLIP ViT-bigG text encoder (SDXL text_encoder_2)."""
    return CLIPTextConfig(hidden_size=1280, intermediate_size=5120,
                          num_layers=32, num_heads=20, hidden_act="gelu",
                          projection_dim=1280)


def sdxl_controlnet() -> ControlNetConfig:
    return ControlNetConfig()


def instantid_resampler() -> ResamplerConfig:
    return ResamplerConfig()


# Tiny presets: every code path (cross-attn blocks, no-attn block level,
# up/down sampling, dual text encoders) runs on the CPU in seconds.

def tiny_unet() -> UNetConfig:
    return UNetConfig(
        sample_size=16,
        block_out_channels=(32, 64),
        layers_per_block=1,
        transformer_layers_per_block=(0, 1),
        attention_head_dim=8,
        # tiny_text_encoder.hidden (32) + tiny_text_encoder_2.hidden (16)
        cross_attention_dim=48,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=16 + 6 * 8,
        norm_num_groups=8,
        dtype=torch.float32,
    )


def tiny_vae() -> VAEConfig:
    # four levels like the SDXL VAE, so the pixel/latent ratio stays 8x
    return VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                     norm_num_groups=8, dtype=torch.float32)


def tiny_text_encoder(projection_dim: int = 0) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=1000, hidden_size=32,
                          intermediate_size=64, num_layers=2, num_heads=4,
                          max_position_embeddings=77,
                          projection_dim=projection_dim, dtype=torch.float32)


def tiny_text_encoder_2() -> CLIPTextConfig:
    """Tiny stand-in for OpenCLIP bigG (has a text projection)."""
    return CLIPTextConfig(vocab_size=1000, hidden_size=16,
                          intermediate_size=32, num_layers=2, num_heads=4,
                          max_position_embeddings=77, hidden_act="gelu",
                          projection_dim=16, dtype=torch.float32)


def tiny_controlnet() -> ControlNetConfig:
    # four embedder stages -> three stride-2 convs: the pixel-space
    # condition image reduces 8x to latent resolution, as in the SDXL preset
    return ControlNetConfig(unet=tiny_unet(),
                            conditioning_embedding_out_channels=(8, 8, 16, 16))


def tiny_resampler() -> ResamplerConfig:
    # output_dim == tiny_unet's cross_attention_dim: the tokens drop
    # straight into the concept UNet's IP cross-attention
    return ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                           num_queries=4, embedding_dim=16, output_dim=48,
                           ff_mult=2, dtype=torch.float32)
