"""Save and restore the port's modules (port of ``omg_tpu/checkpoint.py``).

The JAX package saves converted trees with orbax; the port writes
safetensors files with its own writer (``convert.save_safetensors``),
one tensor at a time, so any safetensors reader opens them. A module's
file holds its ``state_dict`` in its own dtypes; ``save_sdxl`` writes one
file per SDXL model with the model's config as JSON in the file's
``__metadata__``, so ``load_sdxl`` rebuilds each module before filling it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional

import torch
from torch import nn

from omg_tpu_torch import config as cfglib
from omg_tpu_torch import convert
from omg_tpu_torch.models import clip, unet, vae
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import sdxl

# SDXLParams field -> (module class, config class)
_SDXL_MODULES = {
    "unet": (unet.UNet2DConditionModel, cfglib.UNetConfig),
    "vae": (vae.AutoencoderKL, cfglib.VAEConfig),
    "text_encoder": (clip.CLIPTextModel, cfglib.CLIPTextConfig),
    "text_encoder_2": (clip.CLIPTextModel, cfglib.CLIPTextConfig),
}


def config_json(cfg) -> str:
    """A config dataclass as JSON (torch dtypes by name)."""
    def value(v):
        if isinstance(v, torch.dtype):
            return str(v).removeprefix("torch.")
        return list(v) if isinstance(v, (tuple, list)) else v
    return json.dumps({f.name: value(getattr(cfg, f.name))
                       for f in dataclasses.fields(cfg)})


def config_from_json(cls, text: str):
    """The inverse of ``config_json`` for config class ``cls``."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in json.loads(text).items():
        if fields[k].type in ("torch.dtype", torch.dtype):
            v = getattr(torch, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def save_module(path: str, module: nn.Module,
                metadata: Optional[Mapping[str, str]] = None) -> int:
    """``module.state_dict()`` -> a safetensors file; returns its bytes."""
    return convert.save_safetensors(path, module.state_dict(), metadata)


def load_module(path: str, module: nn.Module) -> nn.Module:
    """Fill ``module`` from a file ``save_module`` wrote (strict)."""
    return convert.copy_into(module, convert.load_safetensors(path))


def save_sdxl(path: str, params: sdxl.SDXLParams) -> int:
    """Write ``params`` as ``path/{unet,vae,text_encoder,
    text_encoder_2}.safetensors``, each with its config; returns the bytes
    written."""
    os.makedirs(path, exist_ok=True)
    return sum(save_module(os.path.join(path, f"{name}.safetensors"), m,
                           {"config": config_json(m.cfg)})
               for name, m in zip(sdxl.SDXLParams._fields, params))


def load_sdxl(path: str, *, device="cuda") -> sdxl.SDXLParams:
    """The ``SDXLParams`` that ``save_sdxl`` wrote, on ``device``."""
    device = layers.target_device(device, "checkpoint.load_sdxl")
    out = {}
    for name, (module_cls, cfg_cls) in _SDXL_MODULES.items():
        f = os.path.join(path, f"{name}.safetensors")
        _, meta, _ = convert.read_safetensors_header(f)
        cfg = config_from_json(cfg_cls, meta["config"])
        out[name] = load_module(f, module_cls(cfg, device))
    return sdxl.SDXLParams(**out)
