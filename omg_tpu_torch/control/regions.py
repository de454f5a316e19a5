"""Stage-2 region noise fusion (port of ``omg_tpu/control/regions.py``).

After ``fusion_start`` steps of stage 2, each concept's masked latent
region takes its noise prediction from that concept's LoRA lanes. The
fusion is one elementwise expression over the [K, 2, h, w, C] stack of
region predictions; masks are brought to latent resolution once per
request.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from omg_tpu_torch.nn import layers

# Fuse when step index i > FUSION_START_STEP (of 50).
FUSION_START_STEP = 15
# Full replacement inside mask regions.
REPLACE_RATIO = 1.0


def union_mask(masks: torch.Tensor) -> torch.Tensor:
    """[K, h, w] -> [h, w] union of masks."""
    return ((masks == 1).sum(dim=0) > 0).to(masks.dtype)


def fuse_region_edit(edit: torch.Tensor, region_preds: torch.Tensor,
                     masks: torch.Tensor, *, active: bool) -> torch.Tensor:
    """Fuse per-concept masked predictions into copy B's (uncond, cond) rows.

    edit [2, h, w, C] (uncond_B, cond_B); region_preds [K, 2, h, w, C];
    masks [K, h, w] at latent resolution (zero rows are no-ops). Outside
    the union of masks the base prediction stays; inside each mask it
    becomes REPLACE_RATIO * concept_eps / mask_value
    (+ (1 - ratio) * base). Overlapping masks sum their contributions, as
    the reference's per-concept ``+=`` does."""
    if not active:
        return edit
    union = union_mask(masks)[None, :, :, None]               # [1, h, w, 1]
    new = torch.where(union == 0, edit, (1.0 - REPLACE_RATIO) * edit)
    m = masks[:, None, :, :, None]                            # [K, 1, h, w, 1]
    safe = torch.where(m == 1, m, torch.ones_like(m)).to(region_preds.dtype)
    contrib = torch.where(m == 1, region_preds / safe,
                          torch.zeros_like(region_preds))
    return new + REPLACE_RATIO * contrib.sum(dim=0).to(new.dtype)


def fuse_region_noise(noise_pred: torch.Tensor, region_preds: torch.Tensor,
                      masks: torch.Tensor, *, active: bool) -> torch.Tensor:
    """The reference's 4-row layout [uncond_A, uncond_B, cond_A, cond_B]:
    rows 1 and 3 (copy B) take ``fuse_region_edit``; copy A's rows stay."""
    if not active:
        return noise_pred
    new = fuse_region_edit(noise_pred[[1, 3]], region_preds, masks,
                           active=True)
    return torch.stack([noise_pred[0], new[0], noise_pred[2], new[1]])


def make_concept_mask_stack(masks: Sequence[Optional[np.ndarray]],
                            latent_hw: tuple, max_concepts: int,
                            device=None) -> torch.Tensor:
    """Pack optional per-concept pixel masks into a dense fp32
    [max_K, h, w] stack at latent resolution; None masks are zero rows."""
    rows = []
    for i in range(max_concepts):
        m = masks[i] if i < len(masks) else None
        if m is None:
            rows.append(torch.zeros(latent_hw, dtype=torch.float32,
                                    device=device))
            continue
        m = torch.as_tensor(np.asarray(m, np.float32), device=device)
        if tuple(m.shape) != tuple(latent_hw):
            m = layers.nearest_resize(m, latent_hw)
        rows.append(m)
    return torch.stack(rows)
