"""The system under test, built through its public loading path.

The port's configuration objects are made from the configuration file's
published numbers, the weights reach it as checkpoint state dicts through
``convert.convert_*`` and ``lora.lora_from_state_dict``, and the
benchmark's tokenizer stands in for CLIP's BPE files.
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.tokenizer import HashTokenizer
from omg_tpu_torch import config as cfglib
from omg_tpu_torch import convert, lora
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import sdxl

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sdxl_config(cfg: dict) -> sdxl.SDXLConfig:
    u, v, prec = cfg["unet"], cfg["vae"], cfg["precision"]
    chs = tuple(u["block_out_channels"])
    head_dims = {c // h for c, h in zip(chs, u["attention_head_dim"])}
    if len(head_dims) != 1:
        raise ValueError(f"head widths differ by level: {head_dims}")
    ucfg = cfglib.UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"], block_out_channels=chs,
        layers_per_block=u["layers_per_block"],
        transformer_layers_per_block=weights.attention_depths(u),
        attention_head_dim=head_dims.pop(),
        cross_attention_dim=u["cross_attention_dim"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=u[
            "projection_class_embeddings_input_dim"],
        norm_num_groups=u["norm_num_groups"], dtype=DTYPES[prec["unet"]])
    vcfg = cfglib.VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"],
        dtype=DTYPES[prec["vae_decode"]])

    def text(t):
        proj = "CLIPTextModelWithProjection" in t["architectures"]
        return cfglib.CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            max_position_embeddings=t["max_position_embeddings"],
            hidden_act=t["hidden_act"],
            projection_dim=t["projection_dim"] if proj else 0,
            dtype=DTYPES[prec["text_encoders"]])

    return sdxl.SDXLConfig(ucfg, vcfg, text(cfg["text_encoder"]),
                           text(cfg["text_encoder_2"]))


def build(cfg: dict, seed: int, device) -> tuple:
    """(SDXLConfig, SDXLParams) with the seed's weights."""
    scfg = sdxl_config(cfg)
    sds = weights.model_state_dicts(cfg, seed, device)
    params = sdxl.SDXLParams(
        unet=convert.convert_unet(sds.pop("unet"), scfg.unet, device=device),
        vae=convert.convert_vae(sds.pop("vae"), scfg.vae, device=device),
        text_encoder=convert.convert_clip(sds.pop("text_encoder"),
                                          scfg.text_encoder, device=device),
        text_encoder_2=convert.convert_clip(sds.pop("text_encoder_2"),
                                            scfg.text_encoder_2,
                                            device=device))
    return scfg, params


def loras(cfg: dict, seed: int, count: int, device, weight: float = 1.0):
    """``count`` LoRAs of the seed in the concept form
    {"unet", "text_encoder", "text_encoder_2"}."""
    return [lora.lora_from_state_dict(sd, weight=weight, device=device)
            for sd in weights.lora_state_dicts(cfg, seed, count, device)]


def tokenizer(cfg: dict) -> HashTokenizer:
    return HashTokenizer(cfg["text_encoder"]["vocab_size"])


class Steps:
    """The scheduler steps of the timed path: ``schedulers.step`` wrapped
    (every denoise loop of the program calls it through its module), so
    that for the calls of a request that ``keep`` names (counted from 0 in
    the order the program makes them) the latents it steps from, the
    guided prediction it steps with and the latents it returns are kept,
    NHWC in the program's dtype, on the device. ``take`` hands over one
    request's and starts the count again."""

    def __init__(self, keep):
        self.keep = frozenset(keep)
        self.seen: dict = {}
        self.calls = 0
        self.orig = None

    def attach(self) -> None:
        orig = self.orig = schedulers.step

        def step(sched, state, eps, i, x, **kw):
            out = orig(sched, state, eps, i, x, **kw)
            if self.calls in self.keep:
                self.seen[self.calls] = (i, x.clone(), eps.clone(),
                                         out[0].clone())
            self.calls += 1
            return out

        schedulers.step = step

    def take(self) -> dict:
        out, self.seen, self.calls = self.seen, {}, 0
        return out

    def close(self) -> None:
        if self.orig is not None:
            schedulers.step = self.orig
            self.orig = None


def bf16_decode(on: bool):
    """Switch the program's bf16 VAE decode (``sdxl.decode_latents`` with
    ``dtype=torch.bfloat16``, a cast copy of the decoder) on for every
    caller, or back off: the decode's control."""
    orig = getattr(sdxl.decode_latents, "__wrapped__", sdxl.decode_latents)
    if not on:
        sdxl.decode_latents = orig
        return

    def decode(cfg, vae_model, latents, **kw):
        kw["dtype"] = torch.bfloat16
        return orig(cfg, vae_model, latents, **kw)

    decode.__wrapped__ = orig
    sdxl.decode_latents = decode
