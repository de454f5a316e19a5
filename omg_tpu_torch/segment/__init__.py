"""Visual comprehension: open-vocabulary detection and segmentation (port
of ``omg_tpu/segment/``).

The pipeline consumes a ``MaskProvider`` callable, (stage-1 image uint8
[H, W, 3], class text) -> binary [H, W] mask or None, and this module
builds providers:

  * "sam" (and its aliases "yoloworld", "groundingdino", "openvocab"):
    SAM over either encoder family, EfficientViT-SAM
    (``segment/efficientvit.py``) or the original SAM ViT
    (``segment/vit_sam.py``), prompted by a detector box. With the CLIP
    B/32 towers and a tokenizer (and no explicit ``box_provider``) the
    detector is the SAM-proposal x CLIP open-vocabulary one
    (``segment/detector.py``); otherwise the box is the whole image.
  * "external": any user callable.
  * "none": disables stage 2.

The models are the port's modules, built by the caller (random weights
from a seed, or ``from_jax``), or read from checkpoint files: SAM from
``sam_checkpoint`` (either family, ``sam_provider.convert_sam_checkpoint``)
and the CLIP B/32 towers from ``clip_checkpoint`` (a CLIPModel or
CLIPVisionModelWithProjection file) and ``clip_text_checkpoint`` (the
text tower's file; the CLIP file when empty).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

import numpy as np


def image_fingerprint(image: np.ndarray) -> tuple:
    """Content key for per-image caches. id(image) is NOT a valid key:
    CPython reuses ids after GC, so a steady-state serving loop can hand
    a new image the previous image's cached features."""
    h = hashlib.blake2b(np.ascontiguousarray(image).tobytes(),
                        digest_size=16).hexdigest()
    return (image.shape, str(image.dtype), h)


def build_mask_provider(kind: str, *, sam=None,
                        external: Optional[Callable] = None,
                        box_provider: Optional[Callable] = None,
                        clip_vision=None, clip_text=None, tokenizer=None,
                        sam_checkpoint: str = "", clip_checkpoint: str = "",
                        clip_text_checkpoint: str = "", device="cuda",
                        **_ignored):
    """``sam``: a ``sam_provider.Sam``, or else ``sam_checkpoint``'s.
    ``clip_vision`` / ``clip_text``: the matched CLIP ViT-B/32 pair
    (``config.clip_vit_b32_vision`` / ``clip_vit_b32_text``, one 512-d
    embedding space), or else ``clip_checkpoint``'s and
    ``clip_text_checkpoint``'s, with ``tokenizer``; given both and no
    ``box_provider``, detection is the open-vocabulary detector. The
    models run on ``device``, the card unless the caller asks for the
    CPU."""
    kind = (kind or "none").lower()
    if kind in ("none", ""):
        return None
    if kind == "external":
        if external is None:
            raise ValueError("external mask provider requires `external=`")
        return external
    if kind not in ("sam", "yoloworld", "groundingdino", "openvocab"):
        raise ValueError(f"unknown segment kind: {kind}")
    from omg_tpu_torch.segment.sam_provider import (SamMaskProvider,
                                                    convert_sam_checkpoint)
    if sam is None and sam_checkpoint:
        sam = convert_sam_checkpoint(sam_checkpoint, device=device)
    if clip_vision is None and clip_checkpoint:
        from omg_tpu_torch import config, convert
        clip_vision = convert.convert_clip_vision(
            clip_checkpoint, config.clip_vit_b32_vision(), device=device)
        clip_text = convert.convert_clip(
            clip_text_checkpoint or clip_checkpoint,
            config.clip_vit_b32_text(), device=device)
    if sam is None:
        raise ValueError(f"segment kind {kind!r} needs `sam=` or "
                         "`sam_checkpoint=`")
    provider = SamMaskProvider(sam=sam, box_provider=box_provider,
                               device=device)
    if box_provider is None and clip_vision is not None:
        from omg_tpu_torch.segment.detector import build_openvocab_detector
        provider.box_provider = build_openvocab_detector(
            provider.predictor.sam, clip_vision=clip_vision.to(device),
            clip_text=clip_text.to(device), tokenizer=tokenizer)
    return provider
