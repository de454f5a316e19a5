"""Checkpoint files -> the port's modules (port of ``omg_tpu/convert.py``).

The reference loads HF checkpoints with diffusers/transformers
``from_pretrained``. The port's modules already carry the diffusers and
transformers names and torch layouts (``from_jax.py`` undoes exactly the
JAX package's renames), so converting a state dict is: drop the keys the
JAX package skips, cast, and copy into the module. The copy is strict: a
missing or unexpected key, or a shape that differs, raises.

Casts follow the JAX package: an fp16 or fp64 tensor goes to fp32 first,
then to the module's dtype (round to nearest even).

Files are read without the ``safetensors`` package (the GPU host has
none). A safetensors file is an 8-byte little-endian header length, a
JSON header (``{key: {"dtype", "shape", "data_offsets"}}`` and an optional
``__metadata__`` of strings), then the raw buffer, offsets relative to
its start. ``load_safetensors`` maps the file copy-on-write and returns
tensors that view its pages, so a 5 GB UNet file is read one tensor at a
time as each is copied to the device, and never sits twice in host
memory. ``.bin``/``.pt``/``.pth`` pickles go through
``torch.load(weights_only=True)``.

Every entry point builds its module on ``device``, the card unless the
caller asks for the CPU; without a CUDA device a call that names none
raises.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import re
import struct
import sys
import zipfile
from typing import Iterable, Mapping, Optional

import torch
from torch import nn

from omg_tpu_torch.config import (CLIPTextConfig, CLIPVisionConfig,
                                  ControlNetConfig, ResamplerConfig,
                                  UNetConfig, VAEConfig)
from omg_tpu_torch.models import (clip, clip_vision, controlnet, dpt,
                                  resampler, unet, vae)
from omg_tpu_torch.nn import attention, layers

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

# Keys the JAX package skips per model (omg_tpu/convert.py:142-178), and
# the other tower's keys of a full CLIPModel file.
UNET_SKIP = (r"position_net", r"\.alpha", r"num_batches_tracked")
CLIP_SKIP = (r"position_ids", r"logit_scale", r"embeddings\.class_embedding",
             r"^vision_model\.", r"^visual_projection\.")
CLIP_VISION_SKIP = (r"position_ids", r"logit_scale", r"^text_model\.",
                    r"^text_projection\.")
# The port decodes only.
VAE_SKIP = (r"^encoder\.", r"^quant_conv\.")
# Depth estimation does not read the backbone's final norm (the JAX
# converter ignores it too).
DPT_SKIP = (r"^dpt\.layernorm\.",)


# --------------------------------------------------------------------------
# safetensors
# --------------------------------------------------------------------------

def read_safetensors_header(path: str) -> tuple:
    """-> (tensor entries {key: {"dtype", "shape", "data_offsets"}},
    metadata dict or None, byte offset of the data buffer)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        (n,) = struct.unpack("<Q", raw)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes in a file of "
                             f"{size}")
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_safetensors(path: str) -> dict:
    """Every tensor of a safetensors file, as CPU tensors that view the
    file's pages (a copy-on-write map: nothing is written back). A tensor
    whose bytes are not aligned to its element size is copied."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian")
    header, _, start = read_safetensors_header(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for key, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        shape = tuple(info["shape"])
        b, e = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if e - b != math.prod(shape) * itemsize or start + e > len(mm):
            raise ValueError(f"{path}: {key} spans bytes [{b}, {e}), not "
                             f"{shape} x {info['dtype']}")
        if e == b:
            out[key] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=e - b,
                               offset=start + b)
        if (start + b) % itemsize:
            raw = raw.clone()
        out[key] = raw.view(dtype).reshape(shape)
    return out


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device; moved to the host one at a time) as
    a safetensors file, the header padded with spaces to a multiple of 8
    bytes as the ``safetensors`` package pads it. Returns the file's
    size in bytes."""
    entries: dict = {}
    if metadata:
        entries["__metadata__"] = {str(k): str(v) for k, v in
                                   metadata.items()}
    offset = 0
    for key, t in tensors.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{key}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        entries[key] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(entries, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            if t.numel():
                host = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
    return 8 + len(head) + offset


# --------------------------------------------------------------------------
# state dicts
# --------------------------------------------------------------------------

def _flatten_sd(sd: Mapping, prefix: str = "") -> dict:
    """Nested sub-state-dicts -> dotted keys: the IP-Adapter / InstantID
    ``.bin`` is ``{"image_proj": {...}, "ip_adapter": {...}}``."""
    out: dict = {}
    for k, v in sd.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten_sd(v, key + "."))
        else:
            out[key] = torch.as_tensor(v)
    return out


def load_state_dict(path: str) -> dict:
    """A checkpoint file -> {key: CPU tensor}: ``.safetensors`` through
    ``load_safetensors``; torch pickles (``.bin``, ``.pt``, ``.pth``)
    through ``torch.load(weights_only=True)`` (memory-mapped when the file
    is a zip archive), a ``state_dict`` wrapper unwrapped and nested
    dicts flattened."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd.get("state_dict"), Mapping):
        sd = sd["state_dict"]
    return _flatten_sd(sd)


def as_state_dict(sd_or_path) -> dict:
    """A path is read with ``load_state_dict``; a dict is flattened."""
    if isinstance(sd_or_path, (str, os.PathLike)):
        return load_state_dict(os.fspath(sd_or_path))
    return _flatten_sd(sd_or_path)


def filter_keys(sd: Mapping, skip: Iterable[str]) -> dict:
    """``sd`` without the keys that match a ``skip`` pattern (re.search)."""
    res = [re.compile(s) for s in skip]
    return {k: v for k, v in sd.items() if not any(r.search(k) for r in res)}


@torch.no_grad()
def copy_into(model: nn.Module, sd: Mapping) -> nn.Module:
    """Copy ``sd`` into ``model``'s parameters, tensor by tensor: every
    key must name a parameter of the same shape and every parameter must
    be given. fp16/fp64 values go through fp32, then to the parameter's
    dtype and device."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match {type(model).__name__}: "
                       f"missing {missing[:5]} ({len(missing)}), unexpected "
                       f"{unexpected[:5]} ({len(unexpected)})")
    for k, src in sd.items():
        dst = own[k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(src.shape)}, "
                             f"module shape {tuple(dst.shape)}")
        if src.dtype in (torch.float16, torch.float64):
            src = src.float()
        dst.copy_(src)
    return model


def _convert(module_cls, cfg, sd_or_path, skip, device, who):
    device = layers.target_device(device, who)
    sd = filter_keys(as_state_dict(sd_or_path), skip)
    return copy_into(module_cls(cfg, device), sd)


# --------------------------------------------------------------------------
# Per-model entry points
# --------------------------------------------------------------------------

def convert_unet(sd_or_path, cfg: UNetConfig, *,
                 device="cuda") -> unet.UNet2DConditionModel:
    """diffusers UNet2DConditionModel state dict (or file) -> the port's
    UNet in ``cfg.dtype`` on ``device``."""
    return _convert(unet.UNet2DConditionModel, cfg, sd_or_path, UNET_SKIP,
                    device, "convert_unet")


def convert_vae(sd_or_path, cfg: VAEConfig, *,
                device="cuda") -> vae.AutoencoderKL:
    """diffusers AutoencoderKL -> the port's decoder half (``encoder.*``
    and ``quant_conv.*`` dropped) in ``cfg.dtype``, fp32 for SDXL."""
    return _convert(vae.AutoencoderKL, cfg, sd_or_path, VAE_SKIP, device,
                    "convert_vae")


def convert_clip(sd_or_path, cfg: CLIPTextConfig, *,
                 device="cuda") -> clip.CLIPTextModel:
    """transformers CLIPTextModel(WithProjection), or the text half of a
    CLIPModel file -> the port's text encoder."""
    return _convert(clip.CLIPTextModel, cfg, sd_or_path, CLIP_SKIP, device,
                    "convert_clip")


def convert_clip_vision(sd_or_path, cfg: CLIPVisionConfig, *,
                        device="cuda") -> clip_vision.CLIPVisionModel:
    """transformers CLIPVisionModelWithProjection, or the image half of a
    CLIPModel file -> the detector's image tower (its class embedding is
    a parameter here)."""
    return _convert(clip_vision.CLIPVisionModel, cfg, sd_or_path,
                    CLIP_VISION_SKIP, device, "convert_clip_vision")


def convert_controlnet(sd_or_path, cfg: ControlNetConfig, *,
                       device="cuda") -> controlnet.ControlNetModel:
    """diffusers ControlNetModel (a spatial ControlNet or InstantID's
    IdentityNet) -> the port's ``ControlNetModel``."""
    return _convert(controlnet.ControlNetModel, cfg, sd_or_path, UNET_SKIP,
                    device, "convert_controlnet")


def convert_dpt(sd_or_path, cfg: Optional[dpt.DPTConfig] = None, *,
                device="cuda") -> dpt.DPT:
    """transformers ``DPTForDepthEstimation`` (plain-ViT backbone) -> the
    port's ``DPT`` of ``cfg`` (dpt-large's geometry when None), strict on
    keys and shapes."""
    return _convert(dpt.DPT, cfg or dpt.DPTConfig(), sd_or_path, DPT_SKIP,
                    device, "convert_dpt")


def convert_ip_adapter(sd_or_path, cfg: Optional[ResamplerConfig] = None,
                       *, dtype=torch.bfloat16, device="cuda") -> dict:
    """InstantID / IP-Adapter ``.bin`` (nested or flat) -> {"image_proj":
    ``Resampler``, "ip_adapter": ``ModuleList`` of ``IPKV`` in attn2
    traversal order}. The file numbers its IP layers 1, 3, 5, ... (every
    other attention processor is a cross-attention); they are taken in
    that order. The resampler's weights load as they are (upstream's
    attention scale, ``models/resampler.py``). ``cfg``: the resampler's
    geometry, read off the file when None; ``dtype`` is the IP layers'
    (the UNet's)."""
    device = layers.target_device(device, "convert_ip_adapter")
    sd = as_state_dict(sd_or_path)
    if cfg is None:
        cfg = infer_resampler_cfg(sd, dtype=dtype)
    image_proj = {k.split("image_proj.", 1)[1]: v for k, v in sd.items()
                  if k.startswith("image_proj.")}
    by_layer: dict = {}
    for k, v in sd.items():
        if k.startswith("ip_adapter."):
            idx, name = k[len("ip_adapter."):].split(".", 1)
            by_layer.setdefault(int(idx), {})[name] = v
    order = sorted(by_layer)
    ip = nn.ModuleList([attention.IPKV(
        int(by_layer[i]["to_k_ip.weight"].shape[1]),
        int(by_layer[i]["to_k_ip.weight"].shape[0]), dtype=dtype,
        device=device) for i in order])
    copy_into(ip, {f"{n}.{name}": by_layer[i][name]
                   for n, i in enumerate(order) for name in by_layer[i]})
    return {"image_proj": copy_into(resampler.Resampler(cfg, device),
                                    image_proj),
            "ip_adapter": ip}


def infer_resampler_cfg(sd_or_path, *, dim_head: Optional[int] = None,
                        dtype=torch.bfloat16) -> ResamplerConfig:
    """Resampler geometry from an IP-Adapter checkpoint's own shapes (the
    JAX package's rule): the head size is the one thing the file does not
    store; 64, the published adapters' (upstream resampler.py:77), when
    the fused width divides by it, else 4 heads. Pass ``dim_head`` for
    an adapter whose split differs: a wrong split changes the softmax
    silently."""
    sd = as_state_dict(sd_or_path)
    try:
        latents = sd["image_proj.latents"]
        proj_in = sd["image_proj.proj_in.weight"]
        proj_out = sd["image_proj.proj_out.weight"]
        inner = int(sd["image_proj.layers.0.0.to_q.weight"].shape[0])
        ff_hidden = int(sd["image_proj.layers.0.1.1.weight"].shape[0])
    except KeyError as e:
        raise ValueError(
            f"not an IP-Adapter resampler checkpoint (missing {e})") from e
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("image_proj.layers."))
    dim = int(latents.shape[2])
    if dim_head is None:
        dim_head = 64 if inner % 64 == 0 else max(inner // 4, 1)
    if inner % dim_head:
        raise ValueError(
            f"cannot factor the adapter's fused attention width {inner} "
            f"into heads x dim_head={dim_head}; pass dim_head= explicitly")
    return ResamplerConfig(
        dim=dim, depth=depth, dim_head=dim_head, heads=inner // dim_head,
        num_queries=int(latents.shape[1]), embedding_dim=int(proj_in.shape[1]),
        output_dim=int(proj_out.shape[0]), ff_mult=ff_hidden // dim,
        dtype=dtype)
