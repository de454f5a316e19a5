"""Load an HF-layout SDXL checkpoint directory into the port (port of
``omg_tpu/loader.py``).

The directory the reference's ``from_pretrained`` calls read
(inference_lora.py:153-155): ``unet/``, ``vae/``, ``text_encoder/``,
``text_encoder_2/``, ``tokenizer/`` and ``tokenizer_2/``. Geometry comes
from each subfolder's ``config.json`` (SDXL-base values where a field or
the file is missing); the weights from every ``*.safetensors`` in the
subfolder (``*.bin`` when there is none), merged in name order so a later
file wins a key, as the JAX loader merges them.

Each module is built on the target device without its random init (a
parameter starts uninitialized) and filled tensor by tensor from the
mapped files (``convert.copy_into``). The scan-packing of the JAX loader
(``pack``) has no counterpart (ROADMAP "Not ported").
"""

from __future__ import annotations

import glob
import json
import os

import torch

from omg_tpu_torch import config as cfglib
from omg_tpu_torch import convert
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.text.tokenizer import HFCLIPTokenizer


def _load_folder_sd(folder: str) -> dict:
    """Every weight file of a subfolder merged into one state dict, in
    name order (mapped, not read: a key's bytes are read when it is
    copied)."""
    files = sorted(glob.glob(os.path.join(folder, "*.safetensors")))
    if not files:
        files = sorted(glob.glob(os.path.join(folder, "*.bin")))
    if not files:
        raise FileNotFoundError(f"no weights in {folder}")
    sd: dict = {}
    for f in files:
        sd.update(convert.load_state_dict(f))
    return sd


def _read_json(folder: str) -> dict:
    path = os.path.join(folder, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _unet_cfg(folder: str, dtype) -> cfglib.UNetConfig:
    """diffusers UNet2DConditionModel / ControlNetModel config.json ->
    UNetConfig.

    The published SDXL file gives ``attention_head_dim`` as a per-level
    list ([5, 10, 20]: diffusers' name for the head counts), which leaves
    the head size at SDXL's 64, as the JAX loader reads it; and
    ``transformer_layers_per_block`` as [1, 2, 10] beside
    ``down_block_types``, whose plain ``DownBlock2D`` levels carry no
    transformer: those count 0."""
    import dataclasses
    j = _read_json(folder)
    base = cfglib.sdxl_unet()
    if not j:
        return dataclasses.replace(base, dtype=dtype)
    chans = tuple(j.get("block_out_channels", base.block_out_channels))
    tl = j.get("transformer_layers_per_block",
               base.transformer_layers_per_block)
    if isinstance(tl, int):
        tl = (tl,) * len(chans)
    kinds = j.get("down_block_types")
    if kinds:
        tl = [d if "CrossAttn" in kind else 0 for d, kind in zip(tl, kinds)]
    return cfglib.UNetConfig(
        sample_size=j.get("sample_size", base.sample_size),
        in_channels=j.get("in_channels", base.in_channels),
        out_channels=j.get("out_channels", base.out_channels),
        block_out_channels=chans,
        layers_per_block=j.get("layers_per_block", base.layers_per_block),
        transformer_layers_per_block=tuple(tl),
        attention_head_dim=(j["attention_head_dim"]
                            if isinstance(j.get("attention_head_dim"), int)
                            else base.attention_head_dim),
        cross_attention_dim=j.get("cross_attention_dim",
                                  base.cross_attention_dim),
        addition_time_embed_dim=j.get("addition_time_embed_dim",
                                      base.addition_time_embed_dim),
        projection_class_embeddings_input_dim=j.get(
            "projection_class_embeddings_input_dim",
            base.projection_class_embeddings_input_dim),
        norm_num_groups=j.get("norm_num_groups", base.norm_num_groups),
        dtype=dtype,
    )


def _vae_cfg(folder: str) -> cfglib.VAEConfig:
    j = _read_json(folder)
    base = cfglib.sdxl_vae()
    return cfglib.VAEConfig(
        in_channels=j.get("in_channels", base.in_channels),
        out_channels=j.get("out_channels", base.out_channels),
        latent_channels=j.get("latent_channels", base.latent_channels),
        block_out_channels=tuple(j.get("block_out_channels",
                                       base.block_out_channels)),
        layers_per_block=j.get("layers_per_block", base.layers_per_block),
        norm_num_groups=j.get("norm_num_groups", base.norm_num_groups),
        scaling_factor=j.get("scaling_factor", base.scaling_factor),
    )


def _clip_cfg(folder: str, fallback: cfglib.CLIPTextConfig,
              dtype) -> cfglib.CLIPTextConfig:
    """``architectures``, when the file declares it, decides whether the
    encoder has a projection; only without it does the fallback's."""
    import dataclasses
    j = _read_json(folder)
    if not j:
        return dataclasses.replace(fallback, dtype=dtype)
    arch = (j.get("architectures") or [""])[0]
    with_proj = ("WithProjection" in arch if arch
                 else fallback.projection_dim > 0)
    return cfglib.CLIPTextConfig(
        vocab_size=j.get("vocab_size", fallback.vocab_size),
        hidden_size=j.get("hidden_size", fallback.hidden_size),
        intermediate_size=j.get("intermediate_size",
                                fallback.intermediate_size),
        num_layers=j.get("num_hidden_layers", fallback.num_layers),
        num_heads=j.get("num_attention_heads", fallback.num_heads),
        max_position_embeddings=j.get("max_position_embeddings",
                                      fallback.max_position_embeddings),
        hidden_act=j.get("hidden_act", fallback.hidden_act),
        projection_dim=(j.get("projection_dim", fallback.projection_dim)
                        if with_proj else 0),
        dtype=dtype,
    )


def load_sdxl(checkpoint_dir: str, *, dtype=torch.bfloat16, device="cuda"):
    """-> (SDXLConfig, SDXLParams, tokenizer, tokenizer_2), the four
    models in ``dtype`` (the VAE in its config's fp32) on ``device``."""
    device = layers.target_device(device, "load_sdxl")
    sub = {name: os.path.join(checkpoint_dir, name) for name in
           ("unet", "vae", "text_encoder", "text_encoder_2")}
    cfg = sdxl.SDXLConfig(
        unet=_unet_cfg(sub["unet"], dtype),
        vae=_vae_cfg(sub["vae"]),
        text_encoder=_clip_cfg(sub["text_encoder"],
                               cfglib.sdxl_text_encoder(), dtype),
        text_encoder_2=_clip_cfg(sub["text_encoder_2"],
                                 cfglib.sdxl_text_encoder_2(), dtype))
    params = sdxl.SDXLParams(
        unet=convert.convert_unet(_load_folder_sd(sub["unet"]), cfg.unet,
                                  device=device),
        vae=convert.convert_vae(_load_folder_sd(sub["vae"]), cfg.vae,
                                device=device),
        text_encoder=convert.convert_clip(
            _load_folder_sd(sub["text_encoder"]), cfg.text_encoder,
            device=device),
        text_encoder_2=convert.convert_clip(
            _load_folder_sd(sub["text_encoder_2"]), cfg.text_encoder_2,
            device=device))
    tok1 = HFCLIPTokenizer(os.path.join(checkpoint_dir, "tokenizer"))
    tok2 = HFCLIPTokenizer(os.path.join(checkpoint_dir, "tokenizer_2"))
    return cfg, params, tok1, tok2


def load_controlnet(checkpoint_dir: str, *, dtype=torch.bfloat16,
                    device="cuda"):
    """-> (ControlNetConfig, ControlNetModel) from a ControlNet or
    IdentityNet directory (or its ``controlnet/`` subfolder): the trunk and
    the conditioning embedder's channels from config.json, SDXL values
    where absent."""
    folder = checkpoint_dir
    if os.path.isdir(os.path.join(checkpoint_dir, "controlnet")):
        folder = os.path.join(checkpoint_dir, "controlnet")
    j = _read_json(folder)
    base = cfglib.sdxl_controlnet()
    cfg = cfglib.ControlNetConfig(
        unet=_unet_cfg(folder, dtype),
        conditioning_channels=j.get("conditioning_channels",
                                    base.conditioning_channels),
        conditioning_embedding_out_channels=tuple(j.get(
            "conditioning_embedding_out_channels",
            base.conditioning_embedding_out_channels)))
    return cfg, convert.convert_controlnet(_load_folder_sd(folder), cfg,
                                           device=device)
