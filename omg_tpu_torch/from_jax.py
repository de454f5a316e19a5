"""Move weights and LoRA adapters from the JAX package into the port.

The caller hands over the JAX trees with numpy leaves
(``jax.tree.map(np.asarray, tree)``); this module never imports jax.
Conversions: linear weights [in, out] -> [out, in], conv kernels
HWIO -> OIHW, and the JAX tree's renames of diffusers modules
(``to_out`` -> ``to_out.0``, ``ff.net_0_proj`` -> ``ff.net.0.proj``,
``ff.net_2`` -> ``ff.net.2``). Tables and position grids keep their
layout (embeddings, SAM's ``pos_embed`` [1, g, g, C], rel-pos tables,
Fourier matrix and prompt/token embeddings); a transposed-conv kernel
[k, k, out, in] comes out as torch's [in, out, k, k] through the same
rule as a conv. LoRA leaves keep their [in, r]/[r, out] layout and are
keyed by the port's module paths. The resampler keeps its upstream
names (its ``to_out`` is a plain linear, not diffusers' ``to_out.0``).
OpenPose's tree is flat by layer name; DPT's is renamed to transformers'
keys, and its reassemble transposed convs, stored [k, k, in, out], come
out as torch's [in, out, k, k].

Every entry point puts the weights on ``device``, the card unless the
caller asks for the CPU; without a CUDA device a call that names none
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from omg_tpu_torch.config import (CLIPVisionConfig, ControlNetConfig,
                                  ResamplerConfig, UNetConfig)
from omg_tpu_torch.models import (clip, clip_vision, controlnet, dpt,
                                  openpose, resampler, unet, vae)
from omg_tpu_torch.nn import attention, layers
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.segment import sam_decoder, sam_provider

_RENAMES = {"to_out": "to_out.0", "net_0_proj": "net.0.proj", "net_2": "net.2"}
# modules whose weight is a table, stored [rows, dim] in both layouts
_EMBEDDINGS = ("token_embedding", "position_embedding", "not_a_point_embed",
               "no_mask_embed", "iou_token", "mask_tokens")
# leaves stored as they are whatever their rank
_AS_IS = ("pos_embed", "rel_pos_h", "rel_pos_w",
          "positional_encoding_gaussian_matrix")


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


def _torch_path(path, renames=_RENAMES) -> str:
    """JAX tree path -> the port's dotted module path."""
    return ".".join(renames.get(str(p), str(p)) for p in path)


def _as_is(path) -> bool:
    return (path[-1] in _AS_IS or path[-2:-1] and path[-2] in _EMBEDDINGS
            or path[-3:-2] == ("point_embeddings",))


def _to_torch_layout(path, arr: np.ndarray) -> np.ndarray:
    if _as_is(path):
        return arr
    if arr.ndim == 4:                               # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:                               # [in, out] -> [out, in]
        return arr.T
    return arr


def _state_dict(tree, *, skip=(), renames=_RENAMES) -> dict:
    """JAX parameter tree (numpy leaves) -> torch state_dict (numpy);
    top-level keys in ``skip`` are dropped."""
    sd = {}
    for path, leaf in _flatten(tree):
        if path[0] in skip:
            continue
        arr = np.asarray(leaf)
        sd[_torch_path(path, renames)] = _to_torch_layout(path, arr)
    return sd


def load_into(model: nn.Module, tree, *, skip=(),
              renames=_RENAMES) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (every parameter must be
    present), cast to each parameter's dtype and device."""
    return _load_state(model, _state_dict(tree, skip=skip, renames=renames))


def _load_state(model: nn.Module, sd: dict) -> nn.Module:
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


def sdxl_from_jax(params, cfg: sdxl.SDXLConfig, *,
                  device="cuda") -> sdxl.SDXLParams:
    """JAX ``SDXLParams`` (numpy leaves) -> the port's four modules on
    ``device``. The VAE's encoder half is dropped (the port decodes
    only)."""
    device = layers.target_device(device, "from_jax")
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
    device = layers.target_device(device, "from_jax")
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


def sam_from_jax(tree, *, cfg: Optional[sam_provider.EncoderConfig] = None,
                 device="cuda") -> sam_provider.Sam:
    """JAX SAM tree ``{"image_encoder", "prompt_encoder", "mask_decoder"}``
    (numpy leaves) -> the port's ``Sam`` on ``device``. The encoder family
    and geometry come from ``cfg``, or else from the tree
    (``sam_provider.encoder_config``)."""
    device = layers.target_device(device, "from_jax")
    sd = _state_dict(tree)
    if cfg is None:
        pre = "image_encoder."
        cfg = sam_provider.encoder_config(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})
    sam = sam_provider.Sam(sam_provider.make_encoder(cfg, device),
                           sam_decoder.PromptEncoder(device),
                           sam_decoder.MaskDecoder(device))
    return _load_state(sam, sd)


def clip_vision_from_jax(tree, cfg: CLIPVisionConfig, *,
                         device="cuda") -> clip_vision.CLIPVisionModel:
    """JAX CLIP vision tree (numpy leaves) -> the port's model on
    ``device``."""
    device = layers.target_device(device, "from_jax")
    return load_into(clip_vision.CLIPVisionModel(cfg, device), tree)


def controlnet_from_jax(tree, cfg: ControlNetConfig, *,
                        device="cuda") -> controlnet.ControlNetModel:
    """JAX ControlNet or IdentityNet tree (numpy leaves) -> the port's
    ``ControlNetModel`` on ``device``."""
    device = layers.target_device(device, "from_jax")
    return load_into(controlnet.ControlNetModel(cfg, device), tree)


def resampler_from_jax(tree, cfg: ResamplerConfig, *,
                       device="cuda") -> resampler.Resampler:
    """JAX resampler tree (numpy leaves) -> the port's ``Resampler`` on
    ``device``. The weights are taken as they are: the port's attention
    scale differs from the JAX package's (``models/resampler.py``)."""
    device = layers.target_device(device, "from_jax")
    return load_into(resampler.Resampler(cfg, device), tree, renames={})


def ip_layers_from_jax(layers_tree, cfg: UNetConfig, *,
                       device="cuda") -> nn.ModuleList:
    """JAX IP-Adapter layers, a list of ``{to_k_ip, to_v_ip}`` in attn2
    order (numpy leaves) -> a ``ModuleList`` of ``IPKV`` in the UNet's
    dtype on ``device``, the same order."""
    device = layers.target_device(device, "from_jax")
    mods = nn.ModuleList([attention.IPKV(
        *np.shape(leaf["to_k_ip"]["weight"]), dtype=cfg.dtype, device=device)
        for leaf in layers_tree])
    return load_into(mods, list(layers_tree))


def openpose_from_jax(tree, *, width_mult: float = 1.0,
                      device="cuda") -> openpose.BodyModel:
    """JAX OpenPose tree ``{layer: {weight HWIO, bias}}`` (numpy leaves)
    -> the port's ``BodyModel`` on ``device``."""
    device = layers.target_device(device, "from_jax")
    return load_into(openpose.BodyModel(width_mult, device), tree)


def dpt_from_jax(tree, cfg: dpt.DPTConfig, *, device="cuda") -> dpt.DPT:
    """JAX DPT tree (numpy leaves) -> the port's ``DPT`` on ``device``."""
    device = layers.target_device(device, "from_jax")
    sd = {}

    def put(prefix, leaf):
        for path, arr in _flatten(leaf):
            sd[".".join((prefix,) + tuple(map(str, path)))] = \
                _to_torch_layout(path, np.asarray(arr))

    e = tree["embeddings"]
    sd["dpt.embeddings.cls_token"] = np.asarray(e["cls_token"])
    sd["dpt.embeddings.position_embeddings"] = np.asarray(
        e["position_embeddings"])
    put("dpt.embeddings.patch_embeddings.projection", e["projection"])
    for i, lp in enumerate(tree["encoder"]):
        b = f"dpt.encoder.layer.{i}"
        a = lp["attention"]
        for name in ("query", "key", "value"):
            put(f"{b}.attention.attention.{name}", a[name])
        put(f"{b}.attention.output.dense", a["output"])
        put(f"{b}.intermediate.dense", lp["intermediate"])
        put(f"{b}.output.dense", lp["output"])
        put(f"{b}.layernorm_before", lp["layernorm_before"])
        put(f"{b}.layernorm_after", lp["layernorm_after"])
    neck = tree["neck"]
    for i, rp in enumerate(neck["reassemble"]):
        b = f"neck.reassemble_stage.layers.{i}"
        put(f"neck.reassemble_stage.readout_projects.{i}.0", rp["readout"])
        put(f"{b}.projection", rp["projection"])
        if "resize_up" in rp:
            sd[f"{b}.resize.weight"] = np.asarray(
                rp["resize_up"]["weight"]).transpose(2, 3, 0, 1)
            sd[f"{b}.resize.bias"] = np.asarray(rp["resize_up"]["bias"])
        if "resize_down" in rp:
            put(f"{b}.resize", rp["resize_down"])
    for i, cp in enumerate(neck["convs"]):
        put(f"neck.convs.{i}", cp)
    for i, fp in enumerate(neck["fusion"]):
        put(f"neck.fusion_stage.layers.{i}", fp)
    for name, idx in (("conv1", 0), ("conv2", 2), ("conv3", 4)):
        put(f"head.head.{idx}", tree["head"][name])
    return _load_state(dpt.DPT(cfg, device), sd)
