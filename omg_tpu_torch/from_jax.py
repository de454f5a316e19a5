"""Move weights and LoRA adapters from the JAX package into the port.

The caller hands over the JAX trees with numpy leaves
(``jax.tree.map(np.asarray, tree)``); this module never imports jax.
Conversions: linear weights [in, out] -> [out, in], conv kernels
HWIO -> OIHW, and the JAX tree's renames of diffusers modules
(``to_out`` -> ``to_out.0``, ``ff.net_0_proj`` -> ``ff.net.0.proj``,
``ff.net_2`` -> ``ff.net.2``). LoRA leaves keep their [in, r]/[r, out]
layout and are keyed by the port's module paths.

Both entry points put the weights on ``device``, the card unless the
caller asks for the CPU; without a CUDA device a call that names none
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from omg_tpu_torch.models import clip, unet, vae
from omg_tpu_torch.pipelines import sdxl

_RENAMES = {"to_out": "to_out.0", "net_0_proj": "net.0.proj", "net_2": "net.2"}
_EMBEDDINGS = ("token_embedding", "position_embedding")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, prefix + (k,))


def _torch_path(path) -> str:
    """JAX tree path -> the port's dotted module path."""
    return ".".join(_RENAMES.get(str(p), str(p)) for p in path)


def _to_torch_layout(path, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:                                   # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2 and not set(path[-2:-1]) & set(_EMBEDDINGS):
        return arr.T                                    # [in, out] -> [out, in]
    return arr


def _state_dict(tree, *, skip=()) -> dict:
    """JAX parameter tree (numpy leaves) -> torch state_dict (numpy);
    top-level keys in ``skip`` are dropped."""
    sd = {}
    for path, leaf in _flatten(tree):
        if path[0] in skip:
            continue
        arr = np.asarray(leaf)
        sd[_torch_path(path)] = _to_torch_layout(path, arr)
    return sd


def load_into(model: nn.Module, tree, *, skip=()) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (every parameter must be
    present), cast to each parameter's dtype and device."""
    sd = _state_dict(tree, skip=skip)
    own = model.state_dict()
    missing = set(own) - set(sd)
    unexpected = set(sd) - set(own)
    if missing or unexpected:
        raise KeyError(f"JAX tree does not match {type(model).__name__}: "
                       f"missing {sorted(missing)[:5]}, unexpected "
                       f"{sorted(unexpected)[:5]}")
    with torch.no_grad():
        for k, arr in sd.items():
            own[k].copy_(torch.from_numpy(np.ascontiguousarray(
                arr.astype(np.float32))))
    return model


def _target(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax: no CUDA device for the weights; pass "
                           "device='cpu' to keep them on the CPU")
    return device


def sdxl_from_jax(params, cfg: sdxl.SDXLConfig, *,
                  device="cuda") -> sdxl.SDXLParams:
    """JAX ``SDXLParams`` (numpy leaves) -> the port's four modules on
    ``device``. The VAE's encoder half is dropped (the port decodes
    only)."""
    device = _target(device)
    return sdxl.SDXLParams(
        unet=load_into(unet.UNet2DConditionModel(cfg.unet, device),
                       params.unet),
        vae=load_into(vae.AutoencoderKL(cfg.vae, device), params.vae,
                      skip=("encoder", "quant_conv")),
        text_encoder=load_into(clip.CLIPTextModel(cfg.text_encoder, device),
                               params.text_encoder),
        text_encoder_2=load_into(clip.CLIPTextModel(cfg.text_encoder_2,
                                                    device),
                                 params.text_encoder_2))


def lora_from_jax(tree: Optional[dict], *,
                  device="cuda") -> Optional[dict]:
    """JAX LoRA delta tree (numpy leaves) -> the port's flat dict
    ``{module_path: {"down", "up", "scale"}}`` of fp32 tensors on
    ``device``. A tree with "unet" / "text_encoder" / "text_encoder_2"
    keys converts per model."""
    device = _target(device)
    if tree is None:
        return None
    if any(k in tree for k in ("unet", "text_encoder", "text_encoder_2")):
        return {k: lora_from_jax(v, device=device) for k, v in tree.items()}
    out: dict = {}
    for path, arr in _flatten(tree):
        key, role = _torch_path(path[:-1]), path[-1]
        out.setdefault(key, {})[role] = torch.tensor(
            np.asarray(arr, np.float32), device=device)
    return out
