"""Plain SDXL text-to-image (port of ``omg_tpu/pipelines/sdxl.py``):
configs, random weights, text encoding, micro-conditioning, initial
latents, the CFG denoise and the VAE decode (fp32, or bf16 on a cast copy
of the decoder), and ``text_to_image`` (BASELINE config #1) built from
them. The loop is plain Python over ``sampling.denoise_loop``; every
self-attention of the UNet at 1024² takes the flash kernel on the card.
On a card each forward but a run's first replays a CUDA graph that reads
the run's LoRA factors (``_graphs_engage``, ``models/unet.py``'s
``graphed``): captured on its second step, once a request, so the host
issues one launch a step in place of the forward's kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omg_tpu_torch import config as cfglib
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.diffusion import sampling, schedulers
from omg_tpu_torch.models import clip, unet, vae
from omg_tpu_torch.parallel import comm
from omg_tpu_torch.utils import profiling


class SDXLParams(NamedTuple):
    """The four SDXL submodels."""
    unet: unet.UNet2DConditionModel
    vae: vae.AutoencoderKL
    text_encoder: clip.CLIPTextModel
    text_encoder_2: clip.CLIPTextModel


class SDXLConfig(NamedTuple):
    unet: cfglib.UNetConfig
    vae: cfglib.VAEConfig
    text_encoder: cfglib.CLIPTextConfig
    text_encoder_2: cfglib.CLIPTextConfig


def sdxl_config() -> SDXLConfig:
    return SDXLConfig(cfglib.sdxl_unet(), cfglib.sdxl_vae(),
                      cfglib.sdxl_text_encoder(), cfglib.sdxl_text_encoder_2())


def tiny_config() -> SDXLConfig:
    return SDXLConfig(cfglib.tiny_unet(), cfglib.tiny_vae(),
                      cfglib.tiny_text_encoder(), cfglib.tiny_text_encoder_2())


def init_params(generator: torch.Generator, cfg: SDXLConfig,
                device=None) -> SDXLParams:
    """Random weights for all four models, drawn from ``generator`` on
    ``device`` (the generator's device when None): the UNet, the VAE's
    decoder half, the two text encoders, then the VAE's encoder half. The
    encoder comes last so that a seed gives every other weight it gave
    before the encoder was ported."""
    u = unet.init_params(generator, cfg.unet, device)
    v = vae.AutoencoderKL(cfg.vae, device or generator.device)
    vae.init_half(v, "decoder", generator)
    te1 = clip.init_params(generator, cfg.text_encoder, device)
    te2 = clip.init_params(generator, cfg.text_encoder_2, device)
    vae.init_half(v, "encoder", generator)
    return SDXLParams(unet=u, vae=v, text_encoder=te1, text_encoder_2=te2)


def encode_tokens(cfg: SDXLConfig, params: SDXLParams, ids1: torch.Tensor,
                  ids2: torch.Tensor, lora1: Optional[dict] = None,
                  lora2: Optional[dict] = None) -> tuple:
    """Token ids [B, 77] x2 -> (embeds [B, 77, H1+H2], pooled [B, P]):
    penultimate states of both encoders concatenated, and the projected
    EOS state of encoder 2. ``lora1``/``lora2``: text-encoder adapters."""
    out1 = params.text_encoder(ids1, lora1)
    out2 = params.text_encoder_2(ids2, lora2)
    embeds = torch.cat([out1.penultimate, out2.penultimate], dim=-1)
    return embeds, out2.projected


def add_time_ids(original_size: tuple, crops_coords_top_left: tuple,
                 target_size: tuple, device=None) -> torch.Tensor:
    """SDXL micro-conditioning vector [1, 6]."""
    ids = list(original_size) + list(crops_coords_top_left) + list(target_size)
    return profiling.sync(torch.tensor, [ids], dtype=torch.float32,
                          device=device)


class DenoiseInputs(NamedTuple):
    """CFG-stacked conditioning of one denoise run ([neg; pos] rows)."""
    prompt_embeds: torch.Tensor     # [2B, 77, D]
    text_embeds: torch.Tensor       # [2B, P]
    time_ids: torch.Tensor          # [2B, 6]
    guidance_scale: torch.Tensor    # fp32 scalar


def make_inputs(embeds_pos: torch.Tensor, pooled_pos: torch.Tensor,
                embeds_neg: torch.Tensor, pooled_neg: torch.Tensor,
                time_ids: torch.Tensor, guidance_scale: float
                ) -> DenoiseInputs:
    b = embeds_pos.shape[0]
    return DenoiseInputs(
        prompt_embeds=torch.cat([embeds_neg, embeds_pos]),
        text_embeds=torch.cat([pooled_neg, pooled_pos]),
        time_ids=time_ids.expand(2 * b, 6).contiguous(),
        guidance_scale=profiling.sync(torch.tensor, guidance_scale,
                                      dtype=torch.float32,
                                      device=embeds_pos.device))


def _graphs_engage(x: torch.Tensor) -> bool:
    """Whether the denoise's forwards replay CUDA graphs
    (``unet.forward``'s ``graphed``): its latents ``x`` on a card. Every
    step's forward is then the same plain one but for the timestep and
    the latents."""
    return x.is_cuda


def denoise(cfg: SDXLConfig, sched: schedulers.Schedule,
            unet_model: unet.UNet2DConditionModel, latents: torch.Tensor,
            inputs: DenoiseInputs, *, lora: Optional[dict] = None
            ) -> torch.Tensor:
    """The full CFG denoise, latents [B, h, w, 4] -> [B, h, w, 4]: each
    step runs the UNet on [x; x] against the [neg; pos] conditioning and
    combines the halves. ``lora``: one adapter for every lane, made into
    the UNet's factors for the run (``lora.prepare``), which they leave
    with; on a card the forwards replay a graph that reads them
    (``_graphs_engage``)."""
    factors = lora_lib.prepare(lora, cfg.unet.dtype)
    graphed = _graphs_engage(latents)

    def model_fn(x, t, i):
        eps = unet_model(torch.cat([x, x]), t, inputs.prompt_embeds,
                         text_embeds=inputs.text_embeds,
                         time_ids=inputs.time_ids, lora=factors,
                         graphed=graphed)
        return sampling.cfg_combine(eps, inputs.guidance_scale)

    return sampling.denoise_loop(sched, model_fn, latents)


def prepare_latents(generator: torch.Generator, batch: int, height: int,
                    width: int, sched: schedulers.Schedule,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit noise [B, h, w, 4] drawn in fp32 on the CPU from
    ``generator`` (a CPU generator: one seed gives the same latents on
    every device, as the JAX package's counter-based draws do), moved to
    ``device`` and scaled by the schedule's initial sigma."""
    noise = torch.randn((batch, height // 8, width // 8, 4),
                        generator=generator, dtype=torch.float32)
    return schedulers.scale_initial_noise(
        sched, profiling.sync(noise.to, device=device, dtype=dtype))


def decode_latents(cfg: SDXLConfig, vae_model: vae.AutoencoderKL,
                   latents: torch.Tensor, *, dtype=torch.float32,
                   spatial: Optional[comm.Group] = None) -> torch.Tensor:
    """Latents -> images [B, H, W, 3] in [0, 1].

    ``dtype``: fp32 by default (the reference upcasts the VAE to decode).
    ``torch.bfloat16`` decodes bf16 latents on ``vae_model.decoder_copy``,
    a bf16 copy of the decoder half made on the first such call and kept
    on the VAE module (94.4 MiB for SDXL's), so a run pays no cast. Its
    convolutions and activations are bf16, with group-norm statistics and
    attention scores in fp32; the JAX decode casts the weights and latents
    to bf16 but computes in the config's fp32, so the two agree within
    bf16 rounding, not to fp32 precision.

    ``spatial``: decode H-split over the group (the mesh latency mode):
    every rank passes the whole latents, decodes its block of rows (the
    VAE is convs and one attention, token-parallel with replicated
    weights) and gets the whole image back, gathered along H."""
    vae_model = vae_model.decoder_copy(dtype)
    latents = latents.to(dtype)
    if spatial is None or spatial.size == 1:
        img = vae_model.decode(latents)
    else:
        h = latents.shape[1]
        if h % spatial.size:
            raise ValueError(f"{h} latent rows do not split over "
                             f"{spatial.size} ranks")
        rows = h // spatial.size
        local = latents[:, spatial.index * rows:(spatial.index + 1) * rows]
        img = comm.all_gather(vae_model.decode(local, seq_group=spatial), 1,
                              spatial)
    return torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)


def _unet_device(cfg: SDXLConfig, params: SDXLParams,
                 **kwargs) -> torch.device:
    """The device of ``text_to_image``'s request record: the UNet's."""
    return next(params.unet.parameters()).device


@profiling.requested("sdxl.text_to_image", _unet_device)
def text_to_image(cfg: SDXLConfig, params: SDXLParams, *,
                  ids1_pos: torch.Tensor, ids2_pos: torch.Tensor,
                  ids1_neg: torch.Tensor, ids2_neg: torch.Tensor,
                  generator: torch.Generator, height: int = 1024,
                  width: int = 1024, steps: int = 50,
                  guidance_scale: float = 7.5, scheduler: str = "euler",
                  lora: Optional[dict] = None) -> torch.Tensor:
    """Single-prompt generation (BASELINE config #1): token ids [B, 77]
    of both tokenizers for the prompt and the negative prompt -> images
    [B, H, W, 3] in [0, 1], decoded in fp32. ``generator`` draws the
    initial noise (``prepare_latents``); the ids move to the UNet's
    device. ``lora``: one adapter for every lane (``denoise``'s). The
    call is one request of ``utils/profiling`` (spans ``encode``,
    ``denoise`` and a timed ``decode``)."""
    device = next(params.unet.parameters()).device
    with profiling.span("encode"):
        ids = [profiling.sync(x.to, device)
               for x in (ids1_pos, ids2_pos, ids1_neg, ids2_neg)]
        embeds_pos, pooled_pos = encode_tokens(cfg, params, ids[0], ids[1])
        embeds_neg, pooled_neg = encode_tokens(cfg, params, ids[2], ids[3])
        tids = add_time_ids((height, width), (0, 0), (height, width),
                            device=device)
        inputs = make_inputs(embeds_pos, pooled_pos, embeds_neg, pooled_neg,
                             tids, guidance_scale)
    with profiling.span("denoise"):
        sched = schedulers.make_schedule(scheduler, steps)
        latents = prepare_latents(generator, embeds_pos.shape[0], height,
                                  width, sched, cfg.unet.dtype, device=device)
        latents = denoise(cfg, sched, params.unet, latents, inputs,
                          lora=lora)
    with profiling.span("decode", timed=True):
        return decode_latents(cfg, params.vae, latents)
