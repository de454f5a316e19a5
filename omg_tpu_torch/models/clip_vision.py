"""CLIP ViT image tower, transformers ``CLIPVisionModelWithProjection``
(port of ``omg_tpu/models/clip_vision.py``).

The open-vocabulary detector (``segment/detector.py``) ranks SAM mask
proposals by CLIP image-text similarity; this is its image half.
Submodule names follow the transformers state dict
(``vision_model.embeddings.*``, ``vision_model.encoder.layers.N.*``,
``vision_model.pre_layrnorm`` [sic, transformers' own key],
``vision_model.post_layernorm``, ``visual_projection``). The transformer
layer is the text encoder's (``models/clip.py:EncoderLayer``); the towers
differ only in embeddings and pooling. Pixels are NHWC, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.config import CLIPVisionConfig
from omg_tpu_torch.models.clip import EncoderLayer
from omg_tpu_torch.nn import layers


class CLIPVisionOutput(NamedTuple):
    last_hidden_state: torch.Tensor     # [B, 1+P, H]
    pooled: torch.Tensor                # [B, H] post_layernorm(CLS)
    projected: torch.Tensor             # [B, proj] visual_projection(pooled)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(
            torch.empty(d, **kw), requires_grad=False)
        vm.embeddings.patch_embedding = nn.Module()
        vm.embeddings.patch_embedding.weight = nn.Parameter(
            torch.empty(d, 3, cfg.patch_size, cfg.patch_size, **kw),
            requires_grad=False)
        vm.embeddings.position_embedding = layers.Embedding(n_patches + 1, d,
                                                            **kw)
        vm.pre_layrnorm = layers.LayerNorm(d, **kw)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList(
            [EncoderLayer(cfg, kw) for _ in range(cfg.num_layers)])
        vm.post_layernorm = layers.LayerNorm(d, **kw)
        self.visual_projection = layers.Linear(d, cfg.projection_dim,
                                               bias=False, **kw)

    def forward(self, pixels: torch.Tensor) -> CLIPVisionOutput:
        """pixels [B, S, S, 3] NHWC, CLIP-normalized."""
        vm, cfg = self.vision_model, self.cfg
        emb = vm.embeddings
        x = F.conv2d(pixels.permute(0, 3, 1, 2).to(cfg.dtype),
                     emb.patch_embedding.weight, stride=cfg.patch_size)
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(b, 1, d), x], dim=1)
        pos = emb.position_embedding.weight
        if pos.shape[0] != x.shape[1]:
            # a prefix slice would silently apply scrambled 2D positions;
            # callers must resize inputs to cfg.image_size (preprocess does)
            raise ValueError(
                f"input grid {gh}x{gw} does not match the position table "
                f"({pos.shape[0] - 1} patches); resize to cfg.image_size")
        x = vm.pre_layrnorm(x + pos[None])
        for layer in vm.encoder.layers:
            x = layer(x, None, None)
        pooled = vm.post_layernorm(x[:, 0])
        return CLIPVisionOutput(x, pooled, self.visual_projection(pooled))


def init_params(generator: torch.Generator, cfg: CLIPVisionConfig,
                device=None) -> CLIPVisionModel:
    """Random weights from ``generator`` on ``device`` (the generator's
    device when None): the package's linear/norm/embedding scheme, and
    N(0, 0.02^2) class embedding and patch kernel."""
    model = layers.init_params(
        CLIPVisionModel(cfg, device or generator.device), generator)
    emb = model.vision_model.embeddings
    with torch.no_grad():
        for p in (emb.class_embedding, emb.patch_embedding.weight):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
    return model


# CLIP pixel normalization (openai preprocessing).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(images_uint8: np.ndarray, size: int,
               device=None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, size, size, 3] CLIP-normalized fp32 on
    ``device`` (antialiased bilinear when the size differs)."""
    x = torch.as_tensor(np.asarray(images_uint8), device=device).float() / 255
    if x.shape[1] != size or x.shape[2] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mean = torch.tensor(IMAGE_MEAN, device=x.device)
    std = torch.tensor(IMAGE_STD, device=x.device)
    return (x - mean) / std
