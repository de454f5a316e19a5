"""Model/architecture configs (port of ``omg_tpu/config.py``).

One dataclass per model family of the two-concept LoRA path, with two
presets each:
  * ``sdxl_*`` — the real SDXL-base geometry;
  * ``tiny_*`` — CPU-runnable miniatures for tests.

Dtypes are torch dtypes. The CLIP ViT-B/32 pair serves the open-vocabulary
detector (``segment/detector.py``). ControlNet and resampler configs come
with the slices that port those models.
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
