"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is non-zero:
  1. device  — a CUDA device must be present (no CPU run); prints its
     name, count, nvidia-smi name and power limit; turns TF32 off for
     matmuls and cuDNN so the fp32 VAE decode is fp32.
  2. build   — compiles the flash-attention kernel from
     omg_tpu_torch/ops/csrc with nvcc; prints seconds and, for every
     instantiation (head dim, query rows per CTA), ptxas's registers and
     spills.
  3. kernel  — K1 vs its plain PyTorch version on seeded bf16 inputs
     at the UNet's and the ControlNets' self-attention shapes (batch 1,
     2, 3, 4 and 7, and 8 and 28 for four requests in one batch), the
     crop strips' (2048 tokens at batch 4, 8 and 16; the base lanes of
     four requests at batch 12), and the non-square serving buckets'
     (3952/988, 4032/1008 and 3840/960 tokens at batch 2 and 7); for
     every shape the error
     bound, kernel / plain / SDPA (the library yardstick, never called by
     the port) ms per call, the bound (the larger of FLOPs over the bf16
     peak and bytes over the memory rate) and the kernel's share of it;
     then the host time per launch and the part of it that encodes the
     tensor maps.
  3b. seq    — K1b (the kernel on one sequence shard's query rows against
     the whole K/V) vs the plain version at the shapes of 2- and 4-way
     sequence splits, data-split lanes and the 1216x832 bucket, with the
     same columns.
  4. model   — one SDXL-width UNet forward at the 7-lane stage-2 layout
     (P2P inside its self-replace window, stacked LoRA lanes) through the
     kernel and with attention forced to the plain version; 70 launches.
  5. main    — ``OMG.generate`` at SDXL widths, 1024x1024, 50 Euler steps,
     two concepts with rank-32 LoRAs, random weights from a seed;
     5880 kernel launches, finite latents, stage times, peak memory.
  7. masks   — the mask stage (``omg_tpu_torch/segment``), run after phase
     5 while the SDXL weights are live: SAM ViT-H, EfficientViT-SAM-XL1
     and the CLIP ViT-B/32 pair at full geometry, random weights from
     seeds; ``SamPredictor`` with each encoder on phase 5's stage-1 image
     (1024x1024) and a seeded 1216x832 image (the resize-and-pad path):
     encoder ms (median of 3), ``predict_box`` of the whole image, the
     embedding repeated within 1e-5; both encoders at full width and cut
     depth, and the decoder, on the card against the CPU within 1e-4;
     the SAM-proposal x CLIP detector through ``build_mask_provider``;
     then ``OMG.generate`` as in phase 5 with ``SamMaskProvider`` over
     ViT-H (whole-image box): both masks, 5880 kernel launches.
  8. conditioned — run after phase 7 while the SDXL weights are live, at
     1024x1024 with random weights from seeds (every zero-conv head
     non-zero): (a) one SDXL ControlNet forward at b=3 (the stage-2 base
     rows) through K1 and through the plain attention, residuals within
     MODEL_REL_BOUND and non-zero, 34 launches; (b) BASELINE config #3:
     ``generate`` as in phase 5 with a spatial ControlNet (a seeded
     condition image, scale 1.0, the whole window): 8736 launches, a
     stage-2 image unlike phase 5's; (c) config #4: ``generate`` with
     ``InstantIDModels`` (the InstantID resampler, IP layers on all 70
     attn2, an IdentityNet, two seeded 512-d face embeddings, a
     ``draw_kps`` image, guidance 3.0, IP and IdentityNet scales 0.8):
     7036 launches; (d) DDIM and DPM++2M at 25 steps and LCM at 4 (twice,
     identical images). Each run: phase seconds, peak memory, launches
     (with K1's launches by shape).
  9. checkpoint — run after phase 8 while phase 5's SDXL weights are
     live, in a temporary directory of the checkout that is removed at
     the end (the free disk space printed first): (a) the live weights as
     an HF-layout SDXL directory (the port's safetensors writer, each
     model in its live dtype, the published config.json fields),
     synthetic tokenizers at CLIP's vocab size (``tokenizer_2`` pads with
     "!"), phase 5's LoRAs as kohya files and an EfficientViT-SAM-XL1
     ``xl1.pt`` in the upstream layout, bytes and seconds of each write;
     (b) ``loader.load_sdxl`` from it, every tensor bit-equal to the live
     one (the VAE's encoder half included), and ``load_lora`` equal to the
     live LoRAs, seconds and GB/s per model and the peak memory; (c) ``cli.inference_lora.main`` in-process
     as phase 5 (1024x1024, 50 Euler steps, seed 14, the two LoRAs, SAM
     XL1 masks from the file): 5880 launches, both PNGs read back; (d)
     ``cli.inference_instantid.main`` from an IdentityNet directory and an
     ``ip-adapter.bin`` (upstream nested layout, phase 8's seeds) with two
     face PNGs and their ``.arcface.npy`` sidecars, 20 steps: with no face
     analysis of the stage-1 image the IdentityNet gets no condition, so
     2310 launches (``path_launches(20, 70, 70)``). Each CLI: the wall
     seconds from ``main``'s start, loading included, and its timings;
     (e) ``tools.fidelity_harness.main`` in-process on (a)'s files with
     (c)'s two masks as ``.npy`` sidecars, 1024x1024, 20 Euler steps,
     seed 14, guidance 7.5: rc 0, the report saying the reference was
     skipped (no diffusers on the card), 2310 launches by q shape beside
     ``path_launches``' reckoning, the engine's load and generate
     seconds and the peak over the start; then once more with a stub
     reference (an empty ``diffusers`` and an ``inference_lora.py`` on
     ``sys.path``) whose ``sample_image`` answers with the live engine's
     images from the noise it draws from the harness's generator: the
     noise is ``initial_latents``, the report compares stage 2, and the
     harness's image (weights from the files) is within
     HARNESS_MEAN_LEVELS mean uint8 levels of the live engine's.
  10. serving — run after phase 9 while phase 5's SDXL weights are live,
     at 1024x1024: (a) one ``OMG.generate_batch`` of R = 4 config #2
     requests (50 Euler steps, seeds 14-17, guidance 7.5/7.5/5.0/7.5,
     adapters: phase 5's two rank-32 LoRAs, the two swapped, one rank-32
     with one rank-16, one with None): 5880 K1 launches at B = 8 (stage
     1) and 28 (stage 2), stage and total seconds, peak memory, the
     per-lane LoRA copies' bytes, images per minute beside phase 5's
     single request, request 0's image against phase 5's; (b) batches of
     R = 2 at 6 steps, each request's stage-1 and stage-2 latents against
     its own serial ``generate`` within MODEL_REL_BOUND: two config #2
     requests, then a config #5 request (InstantID, the canny ControlNet,
     a style LoRA) beside a ControlNet-only request with a guidance
     window (per-lane ControlNet scales and windows, zero IP tokens and
     zero-scale IdentityNet rows, each request's own keypoints); (c)
     BASELINE config #5:
     a batch of 2 requests at 20 steps, guidance 3.0, each with InstantID
     (phase 8's seeds, two face embeddings, a ``draw_kps`` image), the
     spatial ControlNet on ``serving.conditions.prepare_condition(photo,
     "canny", 1024, 1024)`` of a seeded photo and a rank-16 style LoRA:
     3874 launches; then one guess-mode ControlNet request, served
     serially: 3432 launches, K1 at B = 1; (d) ``OMGServer.serve`` on
     127.0.0.1, port 0, in a thread, with a registry of two characters
     whose LoRAs are kohya files: /healthz, /registry, one POST
     /generate of 4 prompts at 20 steps (one batch: 2310 launches), every
     PNG 1024x1024x3 with stage 2 run, /metrics counting 4 batched
     requests; then ``serving.warmup.warmup`` of the 1024² bucket with
     batch width 4, seconds per program.
  11. preprocessors — run after phase 10 while phase 5's SDXL weights
     are live, in a temporary directory of the checkout: (a) the
     committed baseline-JPEG fixtures (tests/port/data) decoded by
     ``utils/jpeg`` and held equal to their PIL decodes, the 1024x1024
     4:2:0 one's host seconds; (b) OpenPose at full width, seeded weights
     written as ``body_pose_model.pth`` with controlnet_aux's prefixes and
     loaded by ``load_body_model``: the network on the card against the
     CPU on the server's input for a 1024² photo ([1, 3, 184, 184])
     within CARD_CPU_REL, ms per forward beside the fp32 bound, the
     decode's and ``BodyEstimator``'s host seconds; (c) DPT-large at full
     width, seeded ``config.json`` + ``model.safetensors`` loaded by
     ``load_depth_model``: card against CPU at PRE_DPT_LAYERS layers, ms
     per forward at 384² (fp32, TF32 off) beside the fp32 bound,
     ``DepthEstimator`` seconds to a 1024² map and its peak memory; (d)
     ``OMGServer`` with both providers and phase 8's ControlNet under
     "pose" and "depth": one POST each with the 1024² JPEG fixture as the
     condition photo at 6 steps, HTTP 200, the returned condition equal to
     the provider's own map, 1872 K1 launches by shape.
  12. approximate — run after phase 11 while phase 5's SDXL weights are
     live, at 1024x1024: (a) one UNet forward at b = 2 keeping its
     DeepCache feature, then ``apply_shallow`` from it at the same (sample,
     t): equal within one bf16 ulp, no K1 launch, ms of each; (b) config
     #2 with ``cache_interval=3``: 2100 K1 launches (6 + 12 full forwards
     at b = 2, 12 at b = 7), then with ``cache_schedule="front"``: the
     launches its own full steps give (``deepcache_forwards``); (c) config
     #3 with interval 3: the ControlNet on the full steps only (30
     forwards, 3120 launches); (d) config #2 on ``OMG(concept_crop=True)``:
     6220 launches, K1 at [4,10,2048,64] on the strips; (f) a server
     whose engine has interval 3 answering one POST with a per-request
     "front" schedule: (b)'s front launches by shape; (e) W8A8: the mid
     block's ff.net.0.proj quantized on the card and on the CPU (int8
     weights, scales and activations equal, int32 sums exact, output
     within one bf16 ulp; ``torch._int_mm``, the W8A8 linear and the bf16
     linear timed), the quantized UNet at b = 2 against the bf16 one
     (cosine > 0.995), ``generate`` on ``OMG(quantize="int8")``: 5880
     launches; (h) the progressive and CMYK JPEG fixtures equal to their
     PIL decodes, the 1024x1024 one's host seconds. Each run: phase
     seconds, peak memory, launches by q shape; (g) runs in phase 6.
  14. API surface — run after phase 12 while phase 5's SDXL weights are
     live: (a) ``sdxl.text_to_image`` (BASELINE config #1) at 1024x1024,
     50 Euler steps, guidance 7.5: 3500 K1 launches (500 at
     [2,10,4096,64], 3000 at [2,20,1024,64]), seconds (denoise, decode),
     peak over the start; (b) ``decode_latents`` of (a)'s latents in fp32
     and in bf16 (the cast copy's first call, then again): seconds, peak
     over the start, the uint8 images' largest difference; (c)
     ``AutoencoderKL.encode`` of (a)'s image, seconds and peak, card
     against CPU within CARD_CPU_REL; (d) ``python -m
     omg_tpu_torch.cli.serve --mesh 2 --port 0`` in a subprocess on phase
     9's files written again (the VAE with its encoder) and a registry of
     phase 5's LoRAs, 2 gloo ranks on this card: one POST of both
     characters at 6 steps, HTTP 200, a 1024x1024x3 PNG with stage 2 run,
     each rank's K1b / K1 launches for it 0 / 630 (the layout of 13 (f)),
     rank 1's images identical to rank 0's (their job records), then
     SIGTERM with every process gone.
  15. serving tools — run after phase 14 while phase 5's SDXL weights are
     live, at 1024x1024: (a) ``tools.serve_bench.main`` at 20 Euler steps,
     two concepts, R = 2 in one chunk, one rep: the engine ceiling
     (``generate_batch`` of the pair, timed between synchronizes), the
     single request, the POST of two prompts and two concurrent POSTs, K1
     launches by q shape of the single request, the pair and the ceiling
     call (``serve_shapes``), every response with stage 2 and both HTTP
     rates within 5% of the ceiling; (b) ``tools.soak_bench.main`` at 20
     steps, one storm of two Euler jobs, a DeepCache-3 "front" job and a
     gate miss: stage-2 status, distinct images, each storm image and
     each image of the POSTed Euler pair within SOAK_MEAN_BOUND mean uint8
     levels of its serial baseline (batching drift, far below a mix-up of
     two jobs' images); (c)
     ``tools.fidelity_harness.run_self_check`` at 1024x1024 and 4 steps:
     two runs bit-equal, crop and DeepCache drift reported; (d)
     ``examples/torch_quickstart_random_weights.py`` on the card.
  16. bench — run after phase 15 while phase 5's SDXL weights are live:
     ``python -m omg_tpu_torch.bench``'s ``main`` in-process at 10 steps,
     one rep: (a) latency at 1024² with the crop drift measured live;
     (b) latency at the 1216x832 bucket (3952 and 988 tokens, padded keys
     masked in K1), and one 7-lane UNet forward there through K1 and the
     plain attention, eps within MODEL_REL_BOUND; (c) throughput, two
     requests in one chunk (4, then 14 lanes). Each prints exactly one
     JSON line, its value positive, its latents finite, K1 by q shape in
     the timed call as ``serve_shapes`` reckons it and no K1b; (d)
     ``tools.validate_detector.validate_image`` on phase 7's SAM x CLIP
     detector (XL1, CLIP B/32) and its seeded 1216x832 image, the sweep's
     threshold restored, then the tool's ``main`` without files: SKIP and
     rc 0; (e) throughput with OMG_BENCH_CROP=strips, two requests in one
     chunk (``sample_stage2_batch(concept_crop=True)``: 4 lanes, then 6
     base lanes and 8 strip lanes, K1 as BENCH_CROP_SHAPES), each
     request's decoded copy B within SOAK_MEAN_BOUND mean uint8 levels of
     the same request run alone through ``sample_stage2_resumed(
     concept_crop=True)``, the two requests' images far further apart.
  6. mesh    — the multi-device latency mode, ``OMG(mesh=...)``, on 2 ranks
     that share this card through ``gloo`` (mesh data=1, model=2): the
     same seeded weights on both (checked), one H-split stage-1 UNet
     forward and one lane-split 8-lane stage-2 forward against the
     unsharded ones, then ``generate`` as in phase 5: 3500 K1b and 2380
     K1 launches per rank, identical images on both ranks; then phase 12
     (g): ``generate`` with ``cache_interval=2`` at 6 steps, 280 K1b and
     140 K1 launches per rank (K1b and K1 on the full steps only).
  13. mesh, conditioned — in phase 6's ranks and weights after it, at
     1024², 6 steps: (a) one SDXL ControlNet forward at b = 2 split by
     rows, 34 K1b per rank, the residuals within MODEL_REL_BOUND of the
     unsharded forward's; (b) config #3 (phase 8's seeded ControlNet and
     condition) on the mesh: 624 K1b per rank in stage 1, 312 K1 on rank
     0 (UNet and base ControlNet on the 4 base lanes) and 210 on rank 1 in
     stage 2; (c) config #4 (phase 8's InstantID stack, keypoint image and
     faces): 420 K1b, 210 / 312 K1 (the IdentityNet on rank 1's concept
     lanes); both ranks' images identical, each run's latents within
     MODEL_REL_BOUND of the unsharded engine's; (d) one UNet forward at
     b = 4 with its attention split over the model axis
     (``parallel/sharding.py``): 70 K1 per rank at [4,5,4096,64] and
     [4,10,1024,64], the all-reduces' calls, bytes and seconds, eps
     within MODEL_REL_BOUND; (f) ``cli.inference_lora.main([...,
     "--mesh", "2"])`` on the checkpoint files of phase 9 (written again),
     630 K1 per rank, against the single-device CLI; then, in this
     process, (e) ``parallel.dryrun.dryrun_multichip(2)`` on the card.
  5b. reference step — after phase 5: the reference's 4-row program
     (``sample_stage``, stage 1 and 2 at 6 steps: 1050 K1 launches at
     b = 4) against ``two_stage_latents`` (630 at b = 2 and 7) from the
     same noise, latents within MODEL_REL_BOUND.
The last twelve lines are JSON records of the mask stage, of phases 8,
9, 10, 11, 12, 13, 14, 15 and 16 and of the kernels, and ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --profile

runs phases 1 and 2, then profiles one stage-1 UNet forward (2 lanes),
one stage-2 forward (7 lanes, LoRA lanes, P2P), one ControlNet forward
(3 lanes) and phase 7's two SAM image encoders at 1024² with
``torch.profiler``: wall time, kernel time,
K1's share, the device's idle share, host microseconds per K1 launch and
the largest kernels.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from omg_tpu_torch import (bench, config, convert, instantid, loader,
                           lora as lora_lib, segment)
from omg_tpu_torch.cli import inference_instantid as cli_iid
from omg_tpu_torch.cli import inference_lora as cli_lora
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import (clip, clip_vision, controlnet, dpt,
                                  openpose, resampler, unet as unet_lib,
                                  vae as vae_lib)
from omg_tpu_torch.nn import layers as nn_layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.ops import quant
from omg_tpu_torch.parallel import comm, dryrun, launch, mesh as mesh_lib
from omg_tpu_torch.parallel import sharding
from omg_tpu_torch.pipelines import multiconcept, omg as omg_lib, sdxl
from omg_tpu_torch.segment import (detector, efficientvit, sam_decoder,
                                   sam_provider, vit_sam)
from omg_tpu_torch.serving import conditions, registry as registry_lib
from omg_tpu_torch.serving import warmup as warmup_lib
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.text.tokenizer import HFCLIPTokenizer, ToyTokenizer
from omg_tpu_torch.tools import (fidelity_harness, serve_bench,
                                 soak_bench, validate_detector)
from omg_tpu_torch.utils import image as image_io

HEIGHT = WIDTH = 1024
STEPS = 50
SEED = 14
# Self-attention layers per UNet forward at 1024x1024 that take the
# kernel: level 1 (64x64 = 4096 tokens) has 2 + 3 blocks of depth 2 = 10,
# level 2 (32x32 = 1024 tokens) 2 + 1 (mid) + 3 blocks of depth 10 = 60.
LAUNCHES_PER_FORWARD = 70
# Stage 1 runs all 50 steps (2 lanes); stage 2 resumes after
# fusion_start = 15, i.e. steps 16..49 (7 lanes).
MAIN_PATH_LAUNCHES = STEPS * 70 + (STEPS - 16) * 70
# The step of the forward checks: inside the self-replace window [0, 20).
P2P_STEP = 16
# The mesh phase: 2 ranks on this card, (data, model) = (1, 2). Stage 1
# runs H-split, so every self-attention is K1b (50 steps x 70); stage 2
# runs the 4+2K = 8 lanes 4 per rank, K1 on each (34 steps x 70).
MESH_RANKS = 2
MESH_SEQ_LAUNCHES = STEPS * LAUNCHES_PER_FORWARD
MESH_LAUNCHES = (STEPS - 16) * LAUNCHES_PER_FORWARD
MESH_TIMEOUT_S = 900
# Phase 13 (mesh, conditioned), in phase 6's ranks at 6 steps. Stage 1
# runs H-split with the ControlNet beside the UNet (K1b, 70 + 34 a step);
# stage 2 the steps after fusion_start = round(6 * 15 / 50) = 2, the 8
# lanes 4 per rank: rank 0 the base lanes (the base ControlNet's), rank 1
# the concept lanes (the IdentityNet's). (K1b, (K1 on rank 0, rank 1)):
MESH_COND_STEPS = 6
MESH_COND_2 = MESH_COND_STEPS - round(MESH_COND_STEPS * 15 / 50) - 1
MESH_CN_LAUNCHES = (MESH_COND_STEPS * (70 + 34),
                    (MESH_COND_2 * (70 + 34), MESH_COND_2 * 70))
MESH_IID_LAUNCHES = (MESH_COND_STEPS * 70,
                     (MESH_COND_2 * 70, MESH_COND_2 * (70 + 34)))
# (d) one UNet forward at b = 4, its attention split over the 2-way model
# axis: 5 of level 1's 10 heads and 10 of level 2's 20 on each rank
TP_SHAPES = {"4,5,4096,64": 10, "4,10,1024,64": 60}
# ... and the same forward in fp32 (plain attention, TF32 off) against the
# unsharded one: fp32 rounding (~6e-8) amplified as bf16's ulp is (~10x)
# is ~1e-6 of max |eps|; a wrong split is O(1)
TP_FP32_REL = 1e-4
# (f) the CLI's --mesh 2 is make_latency_mesh(2), (data, model) = (2, 1):
# one CFG lane a rank with H whole (K1 at b = 1) in stage 1, 4 lanes a
# rank in stage 2; no K1b
MESH_CLI_LAUNCHES = (MESH_COND_STEPS + MESH_COND_2) * 70
# Phase 5b: the reference's 4-row program (sample_stage) at 6 steps: the
# 4 base rows every step of both stages, the 2K = 4 concept lanes on
# stage 2's fused steps; two_stage_latents: 2 lanes, then 7
REF_STEPS = 6


def path_launches(steps: int, per_step_1: int, per_step_2: int) -> int:
    """K1 launches of one ``generate``: every stage-1 step and the stage-2
    steps after fusion_start = round(steps * 15 / 50)."""
    return steps * per_step_1 + (steps - round(steps * 15 / 50) - 1) * \
        per_step_2


# Phase 8. A ControlNet forward takes K1 in its 34 self-attentions: level 1
# has 2 blocks of depth 2 (4096 tokens), level 2 2 blocks of depth 10
# and the mid block 10 (1024 tokens).
CN_LAUNCHES = 34
# Config #3: the spatial ControlNet runs on every step of both stages.
CN_PATH_LAUNCHES = path_launches(STEPS, 70 + CN_LAUNCHES, 70 + CN_LAUNCHES)
# Config #4: the IdentityNet runs on the 4 concept lanes in stage 2 only.
IID_PATH_LAUNCHES = path_launches(STEPS, 70, 70 + CN_LAUNCHES)
SCHEDULER_RUNS = (("ddim", 25), ("dpmpp_2m", 25), ("lcm", 4))


def serve_shapes(steps: int, lanes1: int, lanes2: int, cn1: tuple = (),
                 cn2: tuple = (), height: int = HEIGHT,
                 width: int = WIDTH) -> dict:
    """K1 launches by q shape "B,H,N,D" of one two-stage run at ``height``
    x ``width``: the UNet (10 self-attentions at level 1, 60 at level 2) on
    ``lanes1`` lanes every stage-1 step and on ``lanes2`` every stage-2
    step after fusion_start, and a ControlNet (4 and 30) at each lane
    count of ``cn1`` in stage 1 and ``cn2`` in stage 2."""
    n2 = steps - round(steps * 15 / 50) - 1
    tokens = ((10, (height // 16) * (width // 16)),
              (20, (height // 32) * (width // 32)))
    out: dict = {}
    for b, n, per in ([(lanes1, steps, (10, 60)), (lanes2, n2, (10, 60))]
                      + [(c, steps, (4, 30)) for c in cn1]
                      + [(c, n2, (4, 30)) for c in cn2]):
        for (heads, nt), k in zip(tokens, per):
            key = f"{b},{heads},{nt},64"
            out[key] = out.get(key, 0) + n * k
    return out


# Phase 10. (a) four requests at 50 steps: 2R = 8 lanes in stage 1, R(3 +
# 2K) = 28 in stage 2; (c) config #5, two requests at 20 steps with the
# ControlNet on the 2R stage-1 lanes and the 3R stage-2 base lanes and
# the IdentityNet on the 2KR concept lanes; guess mode alone: the
# ControlNet on the cond row in stage 1 and on the two conditional base
# rows in stage 2; (d) the HTTP batch of four at 20 steps.
SERVE_R = 4
BATCH_SHAPE_LAUNCHES = serve_shapes(STEPS, 2 * SERVE_R, 7 * SERVE_R)
SERVE_CHECK_STEPS = 6
CONFIG5_STEPS = 20
CONFIG5_SHAPES = serve_shapes(CONFIG5_STEPS, 4, 14, (4,), (6, 8))
GUESS_SHAPES = serve_shapes(CONFIG5_STEPS, 2, 7, (1,), (2,))
HTTP_SHAPES = serve_shapes(CONFIG5_STEPS, 2 * SERVE_R, 7 * SERVE_R)

# Kernel vs plain, bf16 in and out: bf16 keeps 8 mantissa bits. The
# kernel rounds the unnormalized probabilities to bf16 before P.V and
# both sides round O, so they may differ by a few ulps of the output's
# scale: 4 * 2^-8 of max(|o|, 1).
KERNEL_ULPS = 4 * 2.0 ** -8
# UNet eps through the kernel vs through the plain path: the two round
# attention at different points, and 70 residual transformer blocks of
# bf16 activations carry that forward: 5% of max |eps|.
MODEL_REL_BOUND = 0.05

# Phase 7: set_image twice on one image may differ by 1e-5 of max |emb|;
# an encoder or the decoder on the card and on the CPU (the same fp32
# weights and inputs, TF32 off) by 1e-4 of max |out|, at CHECK_SIZE².
EMBED_REPEAT = 1e-5
CARD_CPU_REL = 1e-4
CHECK_SIZE = 1024
EMBED_HW = 64                   # both encoders' [1, 64, 64, 256] at 1024²

# The H100 SXM's published dense bf16 rate and memory rate (the bound's
# denominators; the card's power limit is printed beside every time).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# and its fp32 rate outside the tensor cores (the mask stage runs fp32
# with TF32 off)
PEAK_FP32_FLOPS = 67e12

KERNEL_SHAPES = [  # (B, H, N, D): main-path, bucket, D=128, ragged tiles
    (2, 10, 4096, 64), (7, 10, 4096, 64), (2, 20, 1024, 64),
    (7, 20, 1024, 64),
    # the ControlNets: guess mode's cond row, the stage-2 base rows, the
    # IdentityNet on the 4 concept lanes
    (1, 10, 4096, 64), (3, 10, 4096, 64), (4, 10, 4096, 64),
    (1, 20, 1024, 64), (3, 20, 1024, 64), (4, 20, 1024, 64),
    (2, 10, 3952, 64), (2, 20, 988, 64),
    (2, 20, 960, 64), (2, 20, 1008, 64), (2, 10, 3840, 64),
    (2, 10, 1024, 128), (2, 20, 1088, 64), (2, 20, 1025, 64),
    # four requests in one batch (phase 10): stage 1, stage 2
    (8, 10, 4096, 64), (8, 20, 1024, 64), (28, 10, 4096, 64),
    (28, 20, 1024, 64),
    # two requests in one batch (phase 10 (b), (c)): the base ControlNet
    # on 3R stage-2 lanes, the stage-2 UNet on 7R
    (6, 10, 4096, 64), (6, 20, 1024, 64), (14, 10, 4096, 64),
    (14, 20, 1024, 64),
    # the concept-crop strips (phase 12): 2K = 4 concept lanes on
    # 128 x 64 latent strips, level 1 (2048 tokens; level 2's 512 take
    # the plain attention, as the gate sends them in JAX)
    (4, 10, 2048, 64),
    # the strips batched (phase 16 (e), the bench's throughput crop): the
    # 2KR strip lanes of R = 2 and 4, and the 3R base lanes of R = 4
    (8, 10, 2048, 64), (12, 10, 4096, 64), (12, 20, 1024, 64),
    (16, 10, 2048, 64),
    # tensor parallelism (phase 13 (d)): a rank's heads of a b = 4 forward
    (4, 5, 4096, 64), (4, 10, 1024, 64),
    # the non-square serving buckets' stage 2 (phase 16 and the bench):
    # 1216x832 and 832x1216; 1152x896, 1344x768 and their transposes;
    # 1536x640 and 640x1536 (stage 1's b = 2 rows are above)
    (7, 10, 3952, 64), (7, 20, 988, 64), (2, 10, 4032, 64),
    (7, 10, 4032, 64), (7, 20, 1008, 64), (7, 10, 3840, 64),
    (7, 20, 960, 64)]
TIMED_SHAPE = (7, 10, 4096, 64)
SEQ_SHAPES = [  # (B, H, Nq local, Nk): q rows of a shard against all K/V
    (2, 10, 2048, 4096), (2, 20, 512, 1024),     # 2-way seq at 1024^2
    (2, 10, 1024, 4096), (2, 20, 256, 1024),     # 4-way seq
    (1, 10, 2048, 4096),                         # data-split lanes
    (2, 10, 1976, 3952), (2, 20, 494, 988)]      # the 1216x832 bucket
SEQ_TIMED_SHAPE = (2, 10, 2048, 4096)            # the mesh phase's level 1


def log(*args):
    print(*args, flush=True)


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_phase() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's main path "
                           "runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device:", torch.cuda.get_device_name(0), "| count:",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    log("nvidia-smi:", power_line())
    log("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)
    return torch.device("cuda", 0)


def ptxas_usage(text: str) -> list:
    """(D, rows per CTA, registers, spill store bytes, spill load bytes)
    of every kernel instantiation in ptxas's -v report."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function .*flash_fwd_kernelILi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = [int(m.group(1)), 64 * int(m.group(2)), None, None, None]
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur[3], cur[4] = (int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif cur is not None and "Used" in line and "registers" in line:
            cur[2] = int(re.search(r"Used (\d+) registers", line).group(1))
    return [tuple(r) for r in out]


def build_phase() -> None:
    fa.build()
    log(f"build: {fa.BUILD_INFO['seconds']:.2f} s -> {fa.BUILD_INFO['path']}")
    usage = ptxas_usage(fa.BUILD_INFO["log"])
    if not usage and fa.BUILD_INFO["log"] != "(cached build)":
        raise AssertionError("no ptxas report for the kernel")
    for d, rows, regs, st, ld in usage:
        log(f"  ptxas: D={d}, {rows} query rows per CTA: {regs} registers at "
            f"entry, {st} bytes spill stores, {ld} bytes spill loads")
    for line in fa.BUILD_INFO["log"].splitlines():
        if "(C75" in line:
            log("  ptxas:", line.strip())


def cuda_ms(fn, iters: int, graph: bool = False) -> float:
    """Device ms per call of ``fn`` after a warm-up, by CUDA events around
    ``iters`` calls; with ``graph`` the calls are captured in one CUDA graph
    and replayed, so the host's launch cost does not hide a short kernel."""
    fn()
    torch.cuda.synchronize()
    calls = [fn] * iters
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for call in calls:
                call()
        calls = [g.replay]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(q, k) -> tuple:
    """(bound ms, "operations" or "bytes") of attention on q/k/v: 4 B H
    Nq Nk D flops over the bf16 peak against q, k, v read once and o
    written once over the memory rate."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    flops = 4 * b * h * nq * nk * d
    nbytes = q.element_size() * b * h * d * (2 * nq + 2 * nk)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check_kernel(kernel, name, q, k, v) -> dict:
    """The kernel against the plain version on q/k/v, and its times beside
    the plain version's, SDPA's and the bound; raises on NaN or an error
    past the bound."""
    out = kernel(q, k, v)
    ref = fa.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} output not finite")
    err = (out.float() - ref).abs().max().item()
    bound = KERNEL_ULPS * max(ref.abs().max().item(), 1.0)
    ms = cuda_ms(lambda: kernel(q, k, v), 50, graph=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 50,
        graph=True)
    bound_ms, bound_by = roofline(q, k)
    log(f"  {name} max_abs_err {err:.3e} (bound {bound:.3e})  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.3f} ms  sdpa {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({bound_by})  share "
        f"{100 * bound_ms / ms:.1f}%  sdpa/kernel {library_ms / ms:.2f}")
    if err > bound:
        raise AssertionError(f"{name} disagrees: {err} > {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def host_cost(device) -> None:
    """Host microseconds per launch at [2,20,1024,64] (stage 1's level-2
    shape; stage 1 is host-bound): the whole wrapper, and the part of it
    that encodes the three tensor maps."""
    q, k, v = (torch.randn(2, 20, 1024, 64, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    n = 200
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fa.flash_attention(q, k, v)
    wrapper_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    lib = fa.build()
    plan = fa.launch_plan(2, 20, 1024, 1024, 64, (q.stride(),) * 4,
                          torch.cuda.get_device_properties(device)
                          .multi_processor_count).pack()
    t0 = time.perf_counter()
    for _ in range(n):
        err = lib.omg_flash_attention_encode(q.data_ptr(), k.data_ptr(),
                                             v.data_ptr(), plan)
        if err:
            raise AssertionError(f"tensor-map encode failed: {err}")
    encode_us = (time.perf_counter() - t0) / n * 1e6
    log(f"host: {wrapper_us:.1f} us per launch through the wrapper, "
        f"{encode_us:.1f} us of it encoding the three tensor maps")


def kernel_phase(device) -> tuple:
    """(the timed shape's numbers with the worst error of all shapes, every
    shape's numbers keyed "B,H,N,D")."""
    g = torch.Generator(device).manual_seed(0)
    worst, timed, by_shape = 0.0, None, {}
    for b, h, n, d in KERNEL_SHAPES:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        res = _check_kernel(fa.flash_attention, f"[{b},{h},{n},{d}]", q, k, v)
        worst = max(worst, res["max_abs_err"])
        by_shape[f"{b},{h},{n},{d}"] = res
        if (b, h, n, d) == TIMED_SHAPE:
            timed = res
        del q, k, v
    host_cost(device)
    return dict(timed, max_abs_err=worst), by_shape


def seq_kernel_phase(device) -> dict:
    """K1b: the wrapper ``flash_attention_seq_local`` on gathered K/V."""
    g = torch.Generator(device).manual_seed(3)
    worst, timed = 0.0, None
    for b, h, nq, nk in SEQ_SHAPES:
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device=device,
                               dtype=torch.bfloat16) for n in (nq, nk, nk))
        res = _check_kernel(fa.flash_attention_seq_local,
                            f"q [{b},{h},{nq},64] kv {nk}", q, k, v)
        worst = max(worst, res["max_abs_err"])
        if (b, h, nq, nk) == SEQ_TIMED_SHAPE:
            timed = res
        del q, k, v
    return dict(timed, max_abs_err=worst)


def mid_block_lora(device, seed: int, cfg, rank: int = 32) -> dict:
    """The bench's character LoRA (``bench.mid_block_lora``: rank 32 on
    every attention projection of the mid block, scale 0.8) from numpy
    seed ``seed``, its factors in the UNet's dtype on ``device``."""
    return bench.lora_tensors(bench.mid_block_lora(cfg, seed, rank), device,
                              cfg.unet.dtype)


def unet_inputs(device, cfg, b: int, seed: int, height: int = HEIGHT,
                width: int = WIDTH) -> tuple:
    """Seeded UNet inputs at height x width: (sample, ehs, pooled, time
    ids)."""
    g = torch.Generator(device).manual_seed(seed)
    ucfg = cfg.unet
    h, w = height // 8, width // 8

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(ucfg.dtype)

    sample, ehs, pooled = r(b, h, w, 4), r(b, 77, ucfg.cross_attention_dim), \
        r(b, cfg.text_encoder_2.projection_dim)
    tids = sdxl.add_time_ids((height, width), (0, 0), (height, width),
                             device=device).expand(b, 6)
    return sample, ehs, pooled, tids


def compare_eps(name: str, eps, eps_ref) -> float:
    """Max |eps - eps_ref|; raises past MODEL_REL_BOUND of max |eps_ref|
    or on a non-finite value."""
    if not (torch.isfinite(eps).all() and torch.isfinite(eps_ref).all()):
        raise AssertionError(f"{name}: UNet eps not finite")
    err = (eps.float() - eps_ref.float()).abs().max().item()
    scale = eps_ref.float().abs().max().item()
    log(f"{name}: eps {tuple(eps.shape)} max |diff| {err:.3e}, max |eps| "
        f"{scale:.3e} (bound {MODEL_REL_BOUND} relative)")
    if err > MODEL_REL_BOUND * scale:
        raise AssertionError(f"{name} disagrees: {err}")
    return err


def model_phase(device, cfg, params, loras, height: int = HEIGHT,
                width: int = WIDTH, name: str = "model") -> float:
    """One 7-lane stage-2 UNet forward at height x width through K1 (70
    launches) and through the plain attention: eps within
    MODEL_REL_BOUND; returns max |diff|."""
    sample, ehs, pooled, tids = unet_inputs(device, cfg, 7, 1, height, width)
    lane_lora = lora_lib.stack_loras(
        [None] * 3 + [loras[0]] * 2 + [loras[1]] * 2)
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=width // 32,
                               height=height // 32, device=device)
    step = P2P_STEP
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[step])

    def forward():
        return params.unet(sample, t, ehs, text_embeds=pooled,
                           time_ids=tids, lora=lane_lora,
                           control=ctl.at_step(step, src_lane=0, dst_lane=2))

    fa.LAUNCHES = 0
    eps = forward()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    with bench.plain_attention():
        eps_plain = forward()
    torch.cuda.synchronize()
    if launches != LAUNCHES_PER_FORWARD or fa.LAUNCHES != launches:
        raise AssertionError(f"kernel launches per forward: {launches}, "
                             f"want {LAUNCHES_PER_FORWARD}")
    log(f"{name}: 7-lane UNet at {height}x{width}, {launches} launches")
    return compare_eps(f"{name}: kernel vs plain", eps, eps_plain)


@contextlib.contextmanager
def record_latents(store: dict, batch: bool = False, peaks: dict = None):
    """Keep the two stages' output latents (the engine returns images);
    ``batch``: of ``generate_batch``'s programs ([R, 2, h, w, 4]).
    ``peaks`` gets each stage's peak bytes ("stage1", "stage2") and the
    peak before stage 2 ("before_stage2"); the device's peak counter then
    restarts at stage 2."""
    names = (("sample_stage1_batch", "sample_stage2_batch") if batch else
             ("sample_stage1_cached", "sample_stage2_resumed"))
    s1, s2 = (getattr(multiconcept, n) for n in names)

    def peak_of(name, fn, *args, **kwargs):
        if peaks is None:
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        peaks[f"before_{name}"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        return out

    def stage1(*args, **kwargs):
        lat, cache = peak_of("stage1", s1, *args, **kwargs)
        store["stage1"] = lat
        return lat, cache

    def stage2(*args, **kwargs):
        store["stage2"] = peak_of("stage2", s2, *args, **kwargs)
        return store["stage2"]

    setattr(multiconcept, names[0], stage1)
    setattr(multiconcept, names[1], stage2)
    try:
        yield
    finally:
        setattr(multiconcept, names[0], s1)
        setattr(multiconcept, names[1], s2)


def left_right_masks(image, cls):
    """'man' owns the left half of the image, anyone else the right (the
    bench's masks, ``bench.left_right_masks``)."""
    return bench.left_right_masks(*image.shape[:2])[0 if cls == "man" else 1]


def generate(engine, loras, **overrides):
    kw = dict(negative_prompt="ugly",
              prompt_rewrite="[photo of the man]-*-[ugly]|"
                             "[photo of the woman]-*-[ugly]",
              concept_loras=loras, seed=SEED, height=HEIGHT, width=WIDTH,
              guidance_scale=7.5, num_steps=STEPS)
    kw.update(overrides)
    return engine.generate("photo of the man and the woman at the beach",
                           **kw)


@contextlib.contextmanager
def launch_shapes(store: dict):
    """Tally K1's launches by q shape into ``store`` (beside
    ``fa.LAUNCHES``)."""
    with serve_bench.k1_launches({"by_shape": store}):
        yield


def check_result(res, latents: dict) -> None:
    if res.stage2 is None or "stage2" not in latents:
        raise AssertionError("stage 2 did not run")
    for name, lat in latents.items():
        if tuple(lat.shape) != (2, HEIGHT // 8, WIDTH // 8, 4) or \
                not torch.isfinite(lat).all():
            raise AssertionError(f"{name} latents bad: {tuple(lat.shape)}")
    for name in ("stage1", "stage2"):
        img = getattr(res, name)
        if img.shape != (2, HEIGHT, WIDTH, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{name} image bad: {img.shape} {img.dtype}")


def main_phase(device, cfg, params, loras, provider=left_right_masks,
               name: str = "main", expect: int = MAIN_PATH_LAUNCHES,
               shapes: dict = None, engine_kw: dict = None,
               memory: dict = None, **overrides) -> tuple:
    """Run ``OMG.generate`` once with ``provider`` (and ``overrides`` of
    phase 5's arguments; ``engine_kw``: engine fields), counts zeroed just
    before and read just after; raises unless K1 launched ``expect``
    times. Returns (kernel launches, result, peak bytes); ``shapes`` gets
    the launches by q shape, ``memory`` the bytes live at the start
    ("start") and the peak ("peak")."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=provider,
                         num_steps=STEPS, **(engine_kw or {}))
    return run_generate(engine, loras, name=name, expect=expect,
                        shapes=shapes, memory=memory, **overrides)


def run_generate(engine, loras, *, name: str, expect: int,
                 shapes: dict = None, memory: dict = None,
                 **overrides) -> tuple:
    """``main_phase`` on a built engine."""
    latents: dict = {}
    by_shape: dict = {} if shapes is None else shapes
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    stage_peaks: dict = {} if memory is not None else None
    with record_latents(latents, peaks=stage_peaks), \
            launch_shapes(by_shape):
        res = generate(engine, loras, **overrides)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = fa.LAUNCHES
    # the counter restarted at each stage: the run's peak is the largest
    peak = max([torch.cuda.max_memory_allocated()]
               + list((stage_peaks or {}).values()))
    if memory is not None:
        memory.update(stage_peaks, start=start, peak=peak)
    check_result(res, latents)
    if launches != expect:
        raise AssertionError(f"{name}: kernel launches in generate: "
                             f"{launches}, want {expect}")
    tm = res.timings
    log(f"{name}: stage1 {tm['stage1']:.3f} s, masks {tm['masks']:.3f} s, "
        f"stage2 {tm['stage2']:.3f} s, decode {tm['decode']:.3f} s, "
        f"encode {tm['encode']:.3f} s, total {total:.3f} s")
    stages = "" if memory is None else (
        f" (stage 1 {(memory['stage1'] - start) / 2**30:.3f}, stage 2 "
        f"{(memory['stage2'] - start) / 2**30:.3f} GiB over it)")
    log(f"{name}: kernel launches {launches} (by q shape {by_shape}); peak "
        f"memory {peak / 2**30:.2f} GiB, {(peak - start) / 2**30:.2f} GiB "
        f"over the {start / 2**30:.2f} GiB live at the start{stages}; masks "
        f"{[m is not None for m in res.masks]}; image mean "
        f"{res.image.mean():.2f} std {res.image.std():.2f}")
    return launches, res, peak


def weights(device):
    """SDXL at full width with random weights from seed 0, and the two
    rank-32 concept LoRAs (seeds 10, 11)."""
    cfg = sdxl.sdxl_config()
    t0 = time.perf_counter()
    params = sdxl.init_params(torch.Generator(device).manual_seed(0), cfg,
                              device)
    loras = [mid_block_lora(device, 10, cfg), mid_block_lora(device, 11, cfg)]
    torch.cuda.synchronize()
    log(f"weights: {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for m in params for p in m.parameters()) / 1e9:.3f}"
        " B parameters")
    return cfg, params, loras


def _rel_err(name: str, got, want) -> float:
    """max |got - want| / max |want|; raises past MODEL_REL_BOUND or on a
    non-finite value."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: not finite")
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    if rel > MODEL_REL_BOUND:
        raise AssertionError(f"{name}: max |diff| / max |ref| {rel:.3e} > "
                             f"{MODEL_REL_BOUND}")
    return rel


def reference_step_phase(device, cfg, params, loras) -> dict:
    """Phase 5b: the reference's 4-row program, ``sample_stage`` stage 1
    and stage 2 at REF_STEPS, against ``two_stage_latents`` from the same
    noise (phase 5's prompts, LoRAs and left/right masks): latents within
    MODEL_REL_BOUND, copy B's stage-2 images, K1 launches by shape."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok)
    prompt = "photo of the man and the woman at the beach"
    tids = sdxl.add_time_ids((HEIGHT, WIDTH), (0, 0), (HEIGHT, WIDTH),
                             device=device)
    base = multiconcept.make_base_inputs(*engine.encode(prompt, "ugly"),
                                         tids, 7.5)
    concepts = [multiconcept.make_concept_inputs(
        *engine.encode(p, "ugly"), tids)
        for p in ("photo of the man", "photo of the woman")]
    masks = torch.stack([torch.as_tensor(left_right_masks(
        np.zeros((HEIGHT // 8, WIDTH // 8)), c), device=device)
        for c in ("man", "woman")])
    ctl = p2p.P2PControl.build([prompt, prompt], REF_STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, tokenizer=tok,
                               device=device)
    sched = schedulers.make_schedule("euler", REF_STEPS)
    fusion = round(REF_STEPS * 15 / 50)
    noise = torch.randn((1, HEIGHT // 8, WIDTH // 8, 4),
                        generator=torch.Generator().manual_seed(SEED))

    def four_row():
        return [multiconcept.sample_stage(
            cfg, sched, params.unet, height=HEIGHT, width=WIDTH,
            base_inputs=base, controller=ctl, concept_inputs=concepts,
            concept_loras=loras, masks=masks, stage=stage,
            fusion_start=fusion, initial_noise=noise.numpy(),
            noise_seed=SEED) for stage in (1, 2)]

    def fast():
        lat0 = schedulers.scale_initial_noise(
            sched, noise.to(device=device, dtype=cfg.unet.dtype))
        return list(multiconcept.two_stage_latents(
            cfg, sched, params.unet, lat0, base, ctl, concepts, loras,
            masks, fusion_start=fusion, noise_seed=SEED))

    n2 = REF_STEPS - fusion - 1
    expect = {"sample_stage": forward_shapes(2 * REF_STEPS + n2, 0, 4),
              "two_stage_latents": forward_shapes(REF_STEPS, n2)}
    rec, outs = {}, {}
    for name, fn in (("sample_stage", four_row),
                     ("two_stage_latents", fast)):
        shapes: dict = {}
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        with launch_shapes(shapes):
            outs[name] = fn()
        torch.cuda.synchronize()
        rec[name] = {"s": time.perf_counter() - t0, "launches": fa.LAUNCHES,
                     "launches_by_shape": shapes}
        if shapes != expect[name]:
            raise AssertionError(f"reference step: {name} launches by shape "
                                 f"{shapes}, want {expect[name]}")
    for j, stage in enumerate(("stage1", "stage2")):
        rec[f"{stage}_rel_err"] = _rel_err(
            f"reference step {stage}", outs["sample_stage"][j],
            outs["two_stage_latents"][j])
    imgs = [(sdxl.decode_latents(cfg, params.vae, out[1][1:2]) * 255).to(
        torch.uint8).cpu().numpy().astype(int) for out in outs.values()]
    rec["stage2_image_max_diff"] = int(np.abs(imgs[0] - imgs[1]).max())
    log(f"reference step: sample_stage (4 rows) {rec['sample_stage']['s']:.3f}"
        f" s, {rec['sample_stage']['launches']} K1 launches; "
        f"two_stage_latents {rec['two_stage_latents']['s']:.3f} s, "
        f"{rec['two_stage_latents']['launches']}; latents max |diff| / max "
        f"|ref| {rec['stage1_rel_err']:.3e} (stage 1), "
        f"{rec['stage2_rel_err']:.3e} (stage 2), bound {MODEL_REL_BOUND}; "
        f"copy B's stage-2 image max |diff| {rec['stage2_image_max_diff']}")
    return rec


def single_card_phases(device) -> tuple:
    """Phases 4, 5, 7, 8, 9, 10, 11, 12, 14, 15 and 16; the weights are
    freed on return. Returns (phase 5's launches, phase 5's result, phase
    7's record, phase 8's, phase 9's, phase 10's, phase 11's, phase 12's,
    phase 14's, phase 15's, phase 16's)."""
    with torch.inference_mode():
        log("== weights")
        cfg, params, loras = weights(device)
        log("== model")
        model_phase(device, cfg, params, loras)
        log("== main path")
        phase5_memory: dict = {}
        launches, res, peak = main_phase(device, cfg, params, loras,
                                         memory=phase5_memory)
        log("== reference step")
        ref_step = reference_step_phase(device, cfg, params, loras)
        log("== masks")
        masks = masks_phase(device, cfg, params, loras, res.stage1[1])
        gc.collect()
        torch.cuda.empty_cache()
        log("== conditioned")
        cond = conditioned_phase(device, cfg, params, loras, res)
        gc.collect()
        torch.cuda.empty_cache()
        log("== checkpoint")
        ckpt = checkpoint_phase(device, cfg, params, loras)
        log("== serving")
        serve = serving_phase(device, cfg, params, loras, res)
        gc.collect()
        torch.cuda.empty_cache()
        log("== preprocessors")
        pre = preprocessors_phase(device, cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
        log("== approximate modes")
        approx = approximate_phase(device, cfg, params, loras)
        # phase 5's own record, beside which phase 12's runs read
        approx["phase5"] = _run_record(launches, res, peak, None,
                                       phase5_memory)
        cond["reference_step"] = ref_step
        gc.collect()
        torch.cuda.empty_cache()
        log("== API surface")
        api = api_phase(device, cfg, params, loras)
        gc.collect()
        torch.cuda.empty_cache()
        log("== serving tools")
        tools = serving_tools_phase(device, cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
        log("== bench")
        bench_rec = bench_phase(device, cfg, params, loras)
        return (launches, res, masks, cond, ckpt, serve, pre, approx, api,
                tools, bench_rec)


# --------------------------------------------------------------- phase 7

def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock ms of ``fn()`` over ``runs`` calls after one
    warm-up, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def product_flops(build, *shapes) -> int:
    """FLOPs of the products (matmuls, convs) of ``build()(*inputs)``,
    counted on the meta device: shapes only, nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"), FlopCounterMode(display=False) as counter:
        build()(*(torch.empty(s) for s in shapes))
    return counter.get_total_flops()


def work_counts() -> dict:
    """Product FLOPs per call of the mask stage's models at full geometry,
    and the fp32 bound in ms of each (FLOPs over PEAK_FP32_FLOPS)."""
    def decode(b):
        def run(emb, sparse):
            pe = sam_decoder.PromptEncoder()
            return sam_decoder.decode_masks(
                sam_decoder.MaskDecoder(), pe, emb, sparse,
                sam_decoder.no_mask_dense(pe, b))
        return run
    flops = {
        "vit_h_encoder": product_flops(
            lambda: vit_sam.ImageEncoderViT(vit_sam.vit_h_config()),
            (1, 1024, 1024, 3)),
        "xl1_encoder": product_flops(
            lambda: efficientvit.EfficientViTSamImageEncoder(
                efficientvit.xl1_config()), (1, 1024, 1024, 3)),
        "decoder_1_box": product_flops(lambda: decode(1), (1, 64, 64, 256),
                                       (1, 2, 256)),
        "decoder_64_points": product_flops(lambda: decode(64),
                                           (64, 64, 64, 256), (64, 2, 256)),
        "clip_b32_24_crops": product_flops(
            lambda: clip_vision.CLIPVisionModel(config.clip_vit_b32_vision()),
            (24, 224, 224, 3)),
    }
    out = {k: {"gflop": v / 1e9, "fp32_bound_ms": v / PEAK_FP32_FLOPS * 1e3}
           for k, v in flops.items()}
    log("masks: product GFLOP per call (fp32 bound ms): " + ", ".join(
        f"{k} {v['gflop']:.1f} ({v['fp32_bound_ms']:.2f})"
        for k, v in out.items()))
    return out


def n_params(*modules) -> int:
    return sum(p.numel() for m in modules for p in m.parameters())


def mask_models(device, sams: tuple = ("vit_h", "xl1")) -> dict:
    """SAM ViT-H, EfficientViT-SAM-XL1 (each with its prompt encoder and
    mask decoder; those named in ``sams``) and the CLIP ViT-B/32 pair,
    random weights from seeds 20-23, on the card."""
    out = {}
    for name, cfg, seed in (("vit_h", vit_sam.vit_h_config(), 20),
                            ("xl1", efficientvit.xl1_config(), 21)):
        if name not in sams:
            continue
        t0 = time.perf_counter()
        out[name] = sam_provider.init_sam(
            torch.Generator(device).manual_seed(seed), cfg, device)
        torch.cuda.synchronize()
        sam = out[name]
        heads = n_params(sam.prompt_encoder, sam.mask_decoder)
        log(f"masks: {name} built in {time.perf_counter() - t0:.2f} s: "
            f"encoder {n_params(sam.image_encoder) / 1e6:.1f} M, prompt "
            f"encoder + mask decoder {heads / 1e6:.2f} M fp32 parameters")
    t0 = time.perf_counter()
    out["clip_vision"] = clip_vision.init_params(
        torch.Generator(device).manual_seed(22), config.clip_vit_b32_vision(),
        device)
    out["clip_text"] = clip.init_params(
        torch.Generator(device).manual_seed(23), config.clip_vit_b32_text(),
        device)
    torch.cuda.synchronize()
    log(f"masks: CLIP B/32 built in {time.perf_counter() - t0:.2f} s: vision "
        f"{n_params(out['clip_vision']) / 1e6:.1f} M, text "
        f"{n_params(out['clip_text']) / 1e6:.1f} M parameters")
    return out


def predictor_phase(name: str, sam, images: dict) -> dict:
    """set_image and predict_box(full image) on each image: encoder ms,
    set_image ms, predict_box ms, the mask, and the embedding's
    repeatability."""
    pred = sam_provider.SamPredictor(sam)
    out = {}
    for shape, img in images.items():
        x = pred._preprocess(img)
        enc_ms = host_ms(lambda: sam.image_encoder(x))
        set_ms = host_ms(lambda: pred.set_image(img), runs=1)
        emb = pred._embedding.clone()
        box = sam_provider.full_image_box(img, "")
        box_ms = host_ms(lambda: pred.predict_box(box))
        mask, score = pred.predict_box(box)
        pred.set_image(img)
        drift = (pred._embedding - emb).abs().max().item()
        scale = emb.abs().max().item()
        log(f"masks: {name} {shape}: encoder {enc_ms:.2f} ms (median of 3), "
            f"set_image {set_ms:.2f} ms, predict_box {box_ms:.2f} ms; "
            f"embedding {tuple(emb.shape)}; mask {mask.shape} {mask.dtype}, "
            f"{100 * mask.mean():.2f}% ones, IoU score {score:.4f}; "
            f"set_image again: max |diff| {drift:.3e} of max |emb| "
            f"{scale:.3e}")
        if tuple(emb.shape) != (1, EMBED_HW, EMBED_HW, 256) or \
                not torch.isfinite(emb).all():
            raise AssertionError(f"{name} {shape}: bad embedding")
        if mask.shape != img.shape[:2] or mask.dtype != np.bool_:
            raise AssertionError(f"{name} {shape}: bad mask {mask.shape}")
        if drift > EMBED_REPEAT * scale:
            raise AssertionError(f"{name} {shape}: set_image not repeatable")
        out[shape] = {"encoder_ms": enc_ms, "set_image_ms": set_ms,
                      "predict_box_ms": box_ms}
    return out


def card_vs_cpu(name: str, device, card, cpu, args,
                who: str = "masks") -> float:
    """``card(*args)`` on the card against ``cpu(*args)`` on the CPU, the
    same weights and fp32 inputs; raises past CARD_CPU_REL of max |out|."""
    got = card(*(a.to(device) for a in args))
    want = cpu(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        if not torch.isfinite(g).all() or err > CARD_CPU_REL * scale:
            raise AssertionError(f"{name}: card vs CPU {err} > "
                                 f"{CARD_CPU_REL} x {scale}")
        worst = max(worst, err / scale)
    log(f"{who}: {name}, card vs CPU: max |diff| / max |out| {worst:.3e} "
        f"(bound {CARD_CPU_REL})")
    return worst


def cut_depth_phase(device, sams) -> dict:
    """Full widths at cut depth on the card and on the CPU: ViT-H with one
    windowed and one global block, XL1's widths one block a stage, and the
    full decoder on one box."""
    g = torch.Generator().manual_seed(24)
    x = torch.randn(1, CHECK_SIZE, CHECK_SIZE, 3, generator=g)
    out = {}
    for name, mod, cfg in (
            ("ViT-H depth 2", vit_sam, dataclasses.replace(
                vit_sam.vit_h_config(), image_size=CHECK_SIZE, depth=2,
                global_attn_indexes=(1,))),
            ("XL1 one block a stage", efficientvit, dataclasses.replace(
                efficientvit.xl1_config(), image_size=CHECK_SIZE,
                neck_feature_hw=CHECK_SIZE // 16, depth_list=(1,) * 6,
                neck_depth=1))):
        cpu = mod.init_params(g, cfg, "cpu")
        card = sam_provider.make_encoder(cfg, device)
        card.load_state_dict(cpu.state_dict())
        out[name] = card_vs_cpu(name, device, card, cpu, (x,))
    sam = sams["xl1"]
    pe_cpu, md_cpu = sam_decoder.PromptEncoder("cpu"), \
        sam_decoder.MaskDecoder("cpu")
    pe_cpu.load_state_dict(sam.prompt_encoder.state_dict())
    md_cpu.load_state_dict(sam.mask_decoder.state_dict())
    emb = torch.randn(1, 64, 64, 256, generator=g)
    box = torch.tensor([[100.0, 200.0, 700.0, 900.0]])

    def decode(pe, md):
        def run(e, b):
            return sam_decoder.decode_masks(
                md, pe, e, sam_decoder.encode_boxes(pe, b, 1024.0),
                sam_decoder.no_mask_dense(pe, 1))
        return run
    out["decoder"] = card_vs_cpu(
        "decoder on one box", device,
        decode(sam.prompt_encoder, sam.mask_decoder),
        decode(pe_cpu, md_cpu), (emb, box))
    return out


@contextlib.contextmanager
def timed(owner, attr: str, store: dict, key: str):
    """Wrap ``owner.attr`` so that each call ends in a synchronize and its
    host ms add up in ``store[key]``."""
    fn = getattr(owner, attr)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store[key] = store.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    setattr(owner, attr, wrapper)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def detector_phase(device, models, image) -> dict:
    """``build_mask_provider("sam", ...)`` with the XL1 parts, CLIP B/32 and
    a ToyTokenizer (grid 8), ``masks_for(image, ["man", "woman"])``: the
    detector's encoder, grid decode, host selection, crops, CLIP image and
    text, then the provider's box -> mask pass; then CLIP alone on 24
    crops, whatever the proposals were."""
    provider = segment.build_mask_provider(
        "sam", sam=models["xl1"], clip_vision=models["clip_vision"],
        clip_text=models["clip_text"], tokenizer=ToyTokenizer(49408),
        device=device)
    det_ = provider.box_provider
    ms: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed(det_.proposal_fn.predictor, "set_image", ms, "encoder"), \
            timed(detector, "_decode_point_grid", ms, "grid_decode"), \
            timed(det_, "proposal_fn", ms, "proposals"), \
            timed(det_, "embed_image", ms, "clip_image"), \
            timed(det_, "embed_texts", ms, "clip_text"), \
            timed(det_, "assign_jointly", ms, "detect"):
        found = provider.masks_for(image, ["man", "woman"])
    torch.cuda.synchronize()
    ms["masks_for"] = (time.perf_counter() - t0) * 1e3
    ms["host_selection"] = ms["proposals"] - ms["encoder"] - \
        ms["grid_decode"]
    ms["crops"] = ms["detect"] - ms["proposals"] - ms.get("clip_image", 0) \
        - ms.get("clip_text", 0)
    ms["box_to_mask"] = ms["masks_for"] - ms["detect"]
    props = det_._proposals
    log(f"masks: detector: {len(props)} proposals (grid 8, random weights)"
        + ("" if props else ": none passed the IoU/area bounds"))
    for cls, m in zip(("man", "woman"), found):
        log(f"masks: detector: {cls} -> "
            + ("None" if m is None else f"mask of {int(m.sum())} pixels"))
    crops = np.random.default_rng(25).integers(0, 256, (24, 224, 224, 3),
                                               dtype=np.uint8)
    ms["clip_image_24_crops"] = host_ms(lambda: det_.embed_image(crops))
    ms["clip_texts_2_classes"] = host_ms(
        lambda: det_.embed_texts(["man", "woman"]))
    log("masks: detector ms: " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in ms.items()))
    return {"proposals": len(props), "ms": ms,
            "found": [None if m is None else int(m.sum()) for m in found]}


def masks_phase(device, cfg, params, loras, image) -> dict:
    """Phase 7 on phase 5's stage-1 image (copy B, 1024x1024)."""
    torch.cuda.reset_peak_memory_stats()
    work = work_counts()
    models = mask_models(device)
    tall = np.random.default_rng(26).integers(0, 256, (1216, 832, 3),
                                              dtype=np.uint8)
    images = {"1024x1024": image, "1216x832": tall}
    rec = {name: predictor_phase(name, models[name], images)
           for name in ("vit_h", "xl1")}
    rec["card_vs_cpu"] = cut_depth_phase(device, models)
    rec["detector"] = detector_phase(device, models, image)
    rec["work"] = work
    rec["peak_before_generate_gib"] = \
        torch.cuda.max_memory_allocated() / 2**30
    log(f"masks: peak memory before generate "
        f"{rec['peak_before_generate_gib']:.2f} GiB")
    provider = sam_provider.SamMaskProvider(sam=models["vit_h"],
                                            device=device)
    launches, res, peak = main_phase(device, cfg, params, loras, provider,
                                     name="masks generate")
    if not all(m is not None for m in res.masks):
        raise AssertionError("SAM gave no mask for a concept")
    log(f"masks generate: mask shares "
        f"{[round(float(m.mean()), 4) for m in res.masks]}")
    rec.update(generate_masks_s=res.timings["masks"],
               generate_s=res.timings, launches=launches,
               peak_gib=peak / 2**30)
    return rec


# --------------------------------------------------------------- phase 8

def cn_inputs(device, cfg, b: int, seed: int) -> tuple:
    """A ControlNet's inputs at 1024x1024: phase 4's UNet inputs and one
    seeded condition image in [0, 1] for every lane."""
    sample, ehs, pooled, tids = unet_inputs(device, cfg, b, seed)
    g = torch.Generator(device).manual_seed(seed + 1)
    cond = torch.rand(1, HEIGHT, WIDTH, 3, generator=g, device=device)
    return sample, ehs, cond.expand(b, -1, -1, -1), pooled, tids


def controlnet_forward_phase(device, cfg, cn) -> dict:
    """(a) One ControlNet forward at b=3 through K1 (34 launches) and
    through the plain attention: every residual non-zero, finite and
    within MODEL_REL_BOUND of its max."""
    sample, ehs, cond, pooled, tids = cn_inputs(device, cfg, 3, seed=5)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[P2P_STEP])

    def forward():
        return cn(sample, t, ehs, cond, text_embeds=pooled, time_ids=tids,
                  conditioning_scale=1.0)

    fa.LAUNCHES = 0
    down, mid = forward()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    with bench.plain_attention():
        down_p, mid_p = forward()
    torch.cuda.synchronize()
    if launches != CN_LAUNCHES or fa.LAUNCHES != launches:
        raise AssertionError(f"kernel launches per ControlNet forward: "
                             f"{launches}, want {CN_LAUNCHES}")
    worst = 0.0
    for j, (r, r_p) in enumerate(zip(down + [mid], down_p + [mid_p])):
        scale = r_p.float().abs().max().item()
        err = (r.float() - r_p.float()).abs().max().item()
        if not (torch.isfinite(r).all() and torch.isfinite(r_p).all()):
            raise AssertionError(f"ControlNet residual {j} not finite")
        if scale == 0.0:
            raise AssertionError(f"ControlNet residual {j} is zero")
        if err > MODEL_REL_BOUND * scale:
            raise AssertionError(f"ControlNet residual {j} disagrees: {err} "
                                 f"> {MODEL_REL_BOUND} x {scale}")
        worst = max(worst, err / scale)
    ms = host_ms(forward)
    log(f"conditioned: ControlNet forward at b=3: {launches} launches, "
        f"{len(down)} + 1 residuals, kernel vs plain max |diff| / max |res| "
        f"{worst:.3e} (bound {MODEL_REL_BOUND}); {ms:.2f} ms (median of 3)")
    return {"launches": launches, "rel_err": worst, "ms": ms}


def face_kps(cx: float, cy: float) -> np.ndarray:
    """Five keypoints (eyes, nose, mouth corners) of a face centred at
    (cx, cy) on the 1024² canvas."""
    return np.float32([[cx - 40, cy - 30], [cx + 40, cy - 30], [cx, cy + 5],
                       [cx - 30, cy + 45], [cx + 30, cy + 45]])


def _run_record(launches, res, peak, shapes, memory: dict = None) -> dict:
    rec = {"launches": launches, "timings": res.timings,
           "total_s": sum(res.timings.values()), "peak_gib": peak / 2**30,
           "launches_by_shape": shapes}
    if memory is not None:
        # the run's own memory, whatever earlier phases left live; each
        # stage's (DeepCache's feature, the crop strips' lanes) apart from
        # the fp32 VAE decode's
        for key in ("peak", "stage1", "stage2"):
            rec[f"{key}_over_start_gib"] = (memory[key]
                                            - memory["start"]) / 2**30
        rec["start_gib"] = memory["start"] / 2**30
    return rec


def conditioned_phase(device, cfg, params, loras, single) -> dict:
    """Phase 8 on the live SDXL weights; ``single`` is phase 5's result."""
    rec: dict = {}
    t0 = time.perf_counter()
    cn = controlnet.init_params(torch.Generator(device).manual_seed(30),
                                config.sdxl_controlnet())
    torch.cuda.synchronize()
    log(f"conditioned: SDXL ControlNet built in {time.perf_counter() - t0:.2f}"
        f" s, {n_params(cn) / 1e9:.3f} B parameters")
    rec["controlnet_forward"] = controlnet_forward_phase(device, cfg, cn)

    # (b) config #3
    cond = np.random.default_rng(35).integers(0, 256, (HEIGHT, WIDTH, 3),
                                              dtype=np.uint8)
    shapes: dict = {}
    launches, res, peak = main_phase(
        device, cfg, params, loras, name="config #3 (ControlNet)",
        expect=CN_PATH_LAUNCHES, shapes=shapes, controlnet_params=cn,
        spatial_condition=cond, controlnet_scale=1.0)
    diff = np.abs(res.stage2.astype(int) - single.stage2.astype(int))
    log(f"config #3: stage-2 image vs phase 5's: max |diff| {diff.max()}, "
        f"mean {diff.mean():.3f}")
    if diff.max() == 0:
        raise AssertionError("the ControlNet left the stage-2 image as it was")
    rec["config3"] = _run_record(launches, res, peak, shapes)
    del cn
    gc.collect()
    torch.cuda.empty_cache()

    # (c) config #4
    t0 = time.perf_counter()
    iid = omg_lib.InstantIDModels(
        resampler_cfg=config.instantid_resampler(),
        resampler_params=resampler.init_params(
            torch.Generator(device).manual_seed(31),
            config.instantid_resampler()),
        ip_adapter_layers=unet_lib.init_ip_layers(
            torch.Generator(device).manual_seed(32), cfg.unet),
        identitynet_params=controlnet.init_params(
            torch.Generator(device).manual_seed(33), config.sdxl_controlnet()),
        identitynet_cfg=config.sdxl_controlnet(), ip_scale=0.8,
        identitynet_scale=0.8)
    torch.cuda.synchronize()
    log(f"conditioned: InstantID stack built in {time.perf_counter() - t0:.2f}"
        f" s: resampler {n_params(iid.resampler_params) / 1e6:.1f} M, "
        f"{len(iid.ip_adapter_layers)} IP layers "
        f"{n_params(iid.ip_adapter_layers) / 1e6:.1f} M, IdentityNet "
        f"{n_params(iid.identitynet_params) / 1e9:.3f} B parameters")
    rng = np.random.default_rng(36)
    faces = [rng.standard_normal(512).astype(np.float32) for _ in range(2)]
    kps = instantid.draw_kps(HEIGHT, WIDTH, [face_kps(300, 380),
                                             face_kps(724, 380)])
    shapes = {}
    launches, res, peak = main_phase(
        device, cfg, params, [], name="config #4 (InstantID)",
        expect=IID_PATH_LAUNCHES, shapes=shapes, instantid=iid,
        face_embeddings=faces, face_kps_image=kps, guidance_scale=3.0)
    rec["config4"] = _run_record(launches, res, peak, shapes)
    del iid
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the other schedulers
    for kind, steps in SCHEDULER_RUNS:
        shapes = {}
        launches, res, peak = main_phase(
            device, cfg, params, loras, name=f"{kind} {steps} steps",
            expect=path_launches(steps, 70, 70), shapes=shapes,
            scheduler=kind, num_steps=steps)
        rec[kind] = _run_record(launches, res, peak, shapes)
        if kind == "lcm":
            again = main_phase(device, cfg, params, loras,
                               name="lcm again", expect=launches,
                               scheduler=kind, num_steps=steps)[1]
            for name in ("stage1", "stage2"):
                if not np.array_equal(getattr(again, name),
                                      getattr(res, name)):
                    raise AssertionError(f"LCM {name} differs between two "
                                         "runs with one seed")
            log("lcm: two runs with one seed gave identical images")
    return rec


# --------------------------------------------------------------- phase 9

# The published SDXL-base config.json fields the loaders read, at their
# published values (stable-diffusion-xl-base-1.0).
SDXL_UNET_JSON = {
    "_class_name": "UNet2DConditionModel", "sample_size": 128,
    "in_channels": 4, "out_channels": 4,
    "block_out_channels": [320, 640, 1280], "layers_per_block": 2,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D"],
    "mid_block_type": "UNetMidBlock2DCrossAttn",
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "UpBlock2D"],
    "transformer_layers_per_block": [1, 2, 10],
    "attention_head_dim": [5, 10, 20], "cross_attention_dim": 2048,
    "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
    "projection_class_embeddings_input_dim": 2816, "norm_num_groups": 32,
    "use_linear_projection": True}
SDXL_VAE_JSON = {
    "_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
    "latent_channels": 4, "block_out_channels": [128, 256, 512, 512],
    "layers_per_block": 2, "norm_num_groups": 32, "sample_size": 1024,
    "scaling_factor": 0.13025}
SDXL_TE_JSON = {
    "architectures": ["CLIPTextModel"], "vocab_size": 49408,
    "hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
    "num_attention_heads": 12, "max_position_embeddings": 77,
    "hidden_act": "quick_gelu", "projection_dim": 768}
SDXL_TE2_JSON = {
    "architectures": ["CLIPTextModelWithProjection"], "vocab_size": 49408,
    "hidden_size": 1280, "intermediate_size": 5120, "num_hidden_layers": 32,
    "num_attention_heads": 20, "max_position_embeddings": 77,
    "hidden_act": "gelu", "projection_dim": 1280}
CONTROLNET_JSON = dict(
    SDXL_UNET_JSON, _class_name="ControlNetModel", conditioning_channels=3,
    conditioning_embedding_out_channels=[16, 32, 96, 256])
BOS, EOS = "<|startoftext|>", "<|endoftext|>"
CLI_PROMPT = "photo of the man and the woman at the beach"
IID_STEPS = 20


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def write_tokenizer(folder: str, pad: str) -> int:
    """A CLIP tokenizer folder at CLIP's vocab size, 49408: the 512 byte
    symbols, 48894 synthetic merges (pairs of byte symbols, letters and
    digits first), BOS 49406 and EOS 49407; ``pad`` "!" (id 0) makes it
    SDXL's ``tokenizer_2``. Returns the vocab size."""
    from omg_tpu_torch.text.tokenizer import bytes_to_unicode
    os.makedirs(folder)
    syms = list(bytes_to_unicode().values())
    alnum = "abcdefghijklmnopqrstuvwxyz0123456789"
    order = list(alnum) + [s for s in syms if s not in alnum]
    merges = [(x, y + end) for x in order for y in order
              for end in ("</w>", "")][:49408 - 512 - 2]
    vocab = syms + [s + "</w>" for s in syms] + ["".join(m) for m in merges]
    vocab = {s: i for i, s in enumerate(vocab + [BOS, EOS])}
    _write_json(os.path.join(folder, "vocab.json"), vocab)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    specials = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS,
                "pad_token": pad}
    _write_json(os.path.join(folder, "special_tokens_map.json"), specials)
    _write_json(os.path.join(folder, "tokenizer_config.json"), dict(
        specials, model_max_length=77, tokenizer_class="CLIPTokenizer",
        added_tokens_decoder={str(vocab[t]): {"content": t, "special": True}
                              for t in {pad, BOS, EOS}}))
    return len(vocab)


def _timed_write(rec: dict, name: str, fn) -> int:
    t0 = time.perf_counter()
    n = fn()
    s = time.perf_counter() - t0
    rec[name] = {"bytes": n, "s": s}
    log(f"checkpoint: wrote {name}: {n / 1e9:.3f} GB in {s:.2f} s "
        f"({n / 1e9 / s:.2f} GB/s)")
    return n


def write_sdxl_dir(root: str, params, rec: dict) -> None:
    """(a) The live SDXL weights as an HF-layout directory, each model in
    its live dtype (the UNet and text encoders bf16, the VAE decoder
    fp32), with the published config.json of each."""
    files = (("unet", "diffusion_pytorch_model.safetensors", SDXL_UNET_JSON),
             ("vae", "diffusion_pytorch_model.safetensors", SDXL_VAE_JSON),
             ("text_encoder", "model.safetensors", SDXL_TE_JSON),
             ("text_encoder_2", "model.safetensors", SDXL_TE2_JSON))
    for (name, fname, cfg_json), module in zip(files, params):
        os.makedirs(os.path.join(root, name))
        _write_json(os.path.join(root, name, "config.json"), cfg_json)
        _timed_write(rec, name, lambda: convert.save_safetensors(
            os.path.join(root, name, fname), module.state_dict()))
    for name, pad in (("tokenizer", EOS), ("tokenizer_2", "!")):
        n = write_tokenizer(os.path.join(root, name), pad)
        log(f"checkpoint: {name}/: vocab {n}, pad {pad!r}")


def write_kohya(path: str, tree: dict) -> int:
    """A flat LoRA dict (down [in, r], up [r, out]) as a kohya file,
    alpha = rank."""
    sd = {}
    for key, leaf in tree.items():
        k = "lora_unet_" + key.replace(".", "_")
        sd[k + ".lora_down.weight"] = leaf["down"].T.contiguous()
        sd[k + ".lora_up.weight"] = leaf["up"].T.contiguous()
        sd[k + ".alpha"] = torch.tensor(float(leaf["down"].shape[-1]))
    return convert.save_safetensors(path, sd)


def write_xl1(path: str, device) -> int:
    """EfficientViT-SAM-XL1 from seed 21 in the upstream layout: the
    BatchNorm counters and the mask-prompt downscaler included."""
    sam = sam_provider.init_sam(torch.Generator(device).manual_seed(21),
                                efficientvit.xl1_config(), device)
    sd = {k: v.cpu() for k, v in sam.state_dict().items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    g = torch.Generator().manual_seed(34)
    for i, shape in ((0, (4, 1, 2, 2)), (1, (4,)), (3, (16, 4, 2, 2)),
                     (4, (16,)), (6, (256, 16, 1, 1))):
        pre = f"prompt_encoder.mask_downscaling.{i}."
        sd[pre + "weight"] = torch.randn(shape, generator=g)
        sd[pre + "bias"] = torch.zeros(shape[0])
    torch.save(sd, path)
    return os.path.getsize(path)


def write_instantid(root: str, device, cfg, rec: dict) -> tuple:
    """(d)'s inputs from phase 8's seeds: an IdentityNet directory (seed
    33, bf16), an ``ip-adapter.bin`` in the upstream nested layout with IP
    keys 1, 3, 5, ... in diffusers' order, down, up, mid (the resampler
    seed 31, the IP layers seed 32, fp16 as published) and two face PNGs
    with ``.arcface.npy`` sidecars."""
    idnet = os.path.join(root, "ControlNetModel")
    os.makedirs(idnet)
    _write_json(os.path.join(idnet, "config.json"), CONTROLNET_JSON)
    cn = controlnet.init_params(torch.Generator(device).manual_seed(33),
                                config.sdxl_controlnet())
    _timed_write(rec, "identitynet", lambda: convert.save_safetensors(
        os.path.join(idnet, "diffusion_pytorch_model.safetensors"),
        cn.state_dict()))
    del cn
    rs = resampler.init_params(torch.Generator(device).manual_seed(31),
                               config.instantid_resampler())
    ip = unet_lib.init_ip_layers(torch.Generator(device).manual_seed(32),
                                 cfg.unet)
    nested = {"image_proj": {k: v.half().cpu()
                             for k, v in rs.state_dict().items()},
              "ip_adapter": {f"{2 * slot + 1}.{name}.weight":
                             getattr(ip[pos], name).weight.half().cpu()
                             for slot, pos in enumerate(
                                 unet_lib.ip_file_order(cfg.unet))
                             for name in ("to_k_ip", "to_v_ip")}}
    adapter = os.path.join(root, "ip-adapter.bin")

    def save():
        torch.save(nested, adapter)
        return os.path.getsize(adapter)
    _timed_write(rec, "ip_adapter", save)
    del rs, ip, nested
    rng = np.random.default_rng(36)
    faces = []
    for i in range(2):
        face = os.path.join(root, f"face{i}.png")
        image_io.write_png(face, rng.integers(0, 256, (256, 256, 3),
                                              dtype=np.uint8))
        np.save(face + ".arcface.npy",
                rng.standard_normal(512).astype(np.float32))
        faces.append(face)
    return idnet, adapter, faces


@contextlib.contextmanager
def copy_times(rows: list):
    """Wrap ``convert.copy_into``: (module class, bytes, synchronized
    seconds) of each module it fills go to ``rows``."""
    copy = convert.copy_into

    def timed_copy(model, sd):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = copy(model, sd)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
        rows.append((type(model).__name__, nbytes, time.perf_counter() - t0))
        return out

    convert.copy_into = timed_copy
    try:
        yield
    finally:
        convert.copy_into = copy


def load_back(device, root: str, cfg, params, loras,
              lora_files) -> dict:
    """(b) ``loader.load_sdxl`` from the directory: the config equals the
    live one, every tensor equals the live module's bit for bit, and
    ``load_lora`` gives the live LoRAs exactly."""
    times: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with copy_times(times):
        got_cfg, got, _, _ = loader.load_sdxl(root, device=device)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if got_cfg != cfg:
        raise AssertionError(f"loaded config {got_cfg} is not {cfg}")
    for name, a, b in zip(sdxl.SDXLParams._fields, got, params):
        sa, sb = a.state_dict(), b.state_dict()
        bad = [k for k in sb if k not in sa or sa[k].dtype != sb[k].dtype
               or not torch.equal(sa[k], sb[k])]
        if bad or set(sa) != set(sb):
            raise AssertionError(f"{name}: {len(bad)} tensors differ from "
                                 f"the live module's, e.g. {bad[:3]}")
    rows = []
    for (name, nbytes, s), field in zip(times, sdxl.SDXLParams._fields):
        rows.append({"model": field, "bytes": nbytes, "s": s,
                     "gb_per_s": nbytes / 1e9 / s})
        log(f"checkpoint: load {field} ({name}): {nbytes / 1e9:.3f} GB in "
            f"{s:.2f} s ({nbytes / 1e9 / s:.2f} GB/s), bit-equal")
    del got
    for path, live in zip(lora_files, loras):
        got = lora_lib.load_lora(path, weight=0.8, device=device)["unet"]
        if set(got) != set(live):
            raise AssertionError(f"{path}: keys differ from the live LoRA")
        for key, leaf in live.items():
            for role in ("down", "up", "scale"):
                if not torch.equal(got[key][role], leaf[role].float()):
                    raise AssertionError(f"{path}: {key}.{role} differs")
    log(f"checkpoint: load_sdxl {total:.2f} s in all, peak device memory "
        f"{peak / 2**30:.2f} GiB (the live weights included); both LoRAs "
        "load exactly")
    gc.collect()
    torch.cuda.empty_cache()
    return {"models": rows, "total_s": total, "peak_gib": peak / 2**30}


def run_cli(name: str, cli, argv: list, expect: int,
            keep: dict = None) -> dict:
    """A CLI's ``main(argv)`` in-process, K1's count zeroed just before
    and read just after; its stage images read back finite and not
    constant. ``keep`` gets ``main``'s result ("result")."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != expect:
        raise AssertionError(f"{name}: kernel launches {launches}, want "
                             f"{expect}")
    out = os.path.join(argv[argv.index("--save_dir") + 1],
                       f"seed_{argv[argv.index('--seed') + 1]}")
    stats = {}
    for png in ("stage-1.png", "stage-2.png"):
        img = image_io.read_png(os.path.join(out, png))
        if img.shape != (HEIGHT, WIDTH, 3) or img.std() == 0:
            raise AssertionError(f"{name}: {png} is {img.shape}, std "
                                 f"{img.std()}")
        stats[png] = {"mean": float(img.mean()), "std": float(img.std())}
    if keep is not None:
        keep["result"] = res
    tm = res.timings
    log(f"{name}: {wall:.2f} s from main's start (loading included); "
        f"generate: " + ", ".join(f"{k} {v:.3f} s" for k, v in tm.items())
        + f"; {launches} K1 launches; peak {peak / 2**30:.2f} GiB; "
        f"masks {[m is not None for m in res.masks]}; images {stats}")
    return {"wall_s": wall, "timings": tm, "launches": launches,
            "peak_gib": peak / 2**30, "images": stats}


# (e) the fidelity harness on (a)'s files at 20 Euler steps with (c)'s two
# masks as sidecars: K1 on 2 lanes every stage-1 step and on 7 every
# stage-2 step after fusion_start
HARNESS_STEPS = 20
HARNESS_SHAPES = serve_shapes(HARNESS_STEPS, 2, 7)
HARNESS_LAUNCHES = path_launches(HARNESS_STEPS, 70, 70)
# The stub reference answers with the live engine's images from the noise
# the harness's generator gives it and the same masks, on weights
# bit-equal to the files' ((b)): the expected difference is none. The
# bound leaves room for a GEMM that cuBLAS runs by another algorithm in
# the second engine's run (its choice may follow the workspace it finds),
# which moves a bf16 activation by an ulp and, over 20 guided steps, a
# pixel by a level or so; other noise, masks or weights move the image by
# tens of levels (PERF.md §6, PR 12: two jobs 68 levels apart).
HARNESS_MEAN_LEVELS = 1.0
STUB_REFERENCE = '''"""The reference's inference_lora.py entry points, answered by the
live engine: sample_image draws the noise from the harness's generator as
diffusers' randn_tensor does (on the generator's device) and returns
ANSWER(noise, stage)."""
import torch

ANSWER = None
NOISE = []


class _Controller:
    def reset(self):
        pass


class _Concepts:
    def load_lora_weights(self, path, adapter_name):
        pass


def build_model_sd(pretrained, controlnet, device, prompts):
    return None, _Controller(), _Concepts()


def prepare_text(prompt, rewrite):
    return [prompt] + rewrite.split("|")


def sample_image(pipe, generator, stage, height, width, **_):
    noise = torch.randn((1, 4, height // 8, width // 8),
                        generator=generator, device=generator.device)
    NOISE.append(noise.cpu())
    return ANSWER(noise, stage)
'''


def harness_run(name: str, argv: list, expect: int, shapes: dict) -> tuple:
    """``fidelity_harness.main(argv)`` in-process (its printed report
    captured), K1's count zeroed just before and read just after, which
    must be ``expect`` launches by q shape ``shapes``; the report read
    back. Returns (record, report, ``run_ours``'s result)."""
    kept: dict = {}
    run_ours = fidelity_harness.run_ours

    def timed_run_ours(*args, **kwargs):
        t0 = time.perf_counter()
        res = run_ours(*args, **kwargs)
        torch.cuda.synchronize()
        kept.update(result=res, s=time.perf_counter() - t0)
        return res
    by_shape: dict = {}
    printed = io.StringIO()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fidelity_harness.run_ours = timed_run_ours
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with launch_shapes(by_shape), contextlib.redirect_stdout(printed):
            rc = fidelity_harness.main(argv)
    finally:
        fidelity_harness.run_ours = run_ours
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or launches != expect or by_shape != shapes:
        raise AssertionError(f"{name}: rc {rc}, K1 launches {launches} "
                             f"{by_shape}, want {expect} {shapes}")
    with open(argv[argv.index("--out") + 1]) as f:
        report = json.load(f)
    res = kept["result"]
    if res.stage2 is None or res.image.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"{name}: stage 2 did not run, or the image "
                             f"is {res.image.shape}")
    tm = res.timings
    generate_s = sum(tm.values())
    rec = {"wall_s": wall, "load_s": kept["s"] - generate_s,
           "generate_s": generate_s, "timings": tm, "launches": launches,
           "by_shape": by_shape, "reckoned": expect,
           "peak_over_start_gib": (peak - start) / 2**30}
    log(f"{name}: {wall:.2f} s in main: the engine's load {rec['load_s']:.2f}"
        f" s (SDXL, the mask provider, the LoRAs), generate "
        f"{generate_s:.2f} s (" + ", ".join(f"{k} {v:.3f}"
                                          for k, v in tm.items())
        + f"); peak {(peak - start) / 2**30:.2f} GiB over the "
        f"{start / 2**30:.2f} GiB live at the start; K1 launches {launches}"
        f" by q shape {by_shape} (path_launches reckons {expect}); report "
        + json.dumps({k: v for k, v in report.items() if k != "config"}))
    return rec, report, res


def harness_phase(device, cfg, params, tmp: str, sdxl_dir: str,
                  lora_files: list, xl1: str, masks: list) -> dict:
    """(e) ``fidelity_harness.main`` on the checkpoint files with (c)'s
    masks as sidecars, first with no reference (the card has no
    diffusers), then with a stub reference (an empty ``diffusers`` and an
    ``inference_lora.py``) that answers with the live engine's images:
    the compare and report code on the card, the stage-2 images of the
    weights loaded from the files against the live weights'."""
    if any(m is None for m in masks):
        raise AssertionError("harness: (c) found no mask for a concept")
    sidecars = []
    for i, m in enumerate(masks):
        sidecars.append(os.path.join(tmp, f"mask{i}.npy"))
        np.save(sidecars[-1], np.asarray(m, np.float32))
    argv = ["--pretrained_sdxl_model", sdxl_dir,
            "--lora_path", "|".join(lora_files),
            "--efficientViT_checkpoint", xl1, "--prompt", CLI_PROMPT,
            "--negative_prompt", "ugly", "--prompt_rewrite",
            "[photo of the man]-*-[ugly]|[photo of the woman]-*-[ugly]",
            "--seed", str(SEED), "--steps", str(HARNESS_STEPS),
            "--height", str(HEIGHT), "--width", str(WIDTH),
            "--guidance_scale", "7.5", "--masks", "|".join(sidecars),
            "--device", str(device)]
    rec: dict = {}
    rec["no_reference"], report, _ = harness_run(
        "harness (e)", argv + ["--out", os.path.join(tmp, "report.json")],
        HARNESS_LAUNCHES, HARNESS_SHAPES)
    if report.get("reference") != "skipped (diffusers/repo unavailable)":
        raise AssertionError(f"harness (e): report {report}")
    gc.collect()
    torch.cuda.empty_cache()

    stub_dir = os.path.join(tmp, "reference")
    os.makedirs(os.path.join(stub_dir, "diffusers"))
    open(os.path.join(stub_dir, "diffusers", "__init__.py"), "w").close()
    with open(os.path.join(stub_dir, "inference_lora.py"), "w") as f:
        f.write(STUB_REFERENCE)
    saved_path = list(sys.path)
    sys.path.insert(0, stub_dir)
    live: dict = {}
    try:
        import inference_lora as stub
        tok1, tok2 = (HFCLIPTokenizer(os.path.join(sdxl_dir, name))
                      for name in ("tokenizer", "tokenizer_2"))
        engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok1,
                             tokenizer_2=tok2, num_steps=HARNESS_STEPS)
        file_loras = [lora_lib.load_lora(p, device=device)
                      for p in lora_files]
        sidecar_masks = [np.load(p) for p in sidecars]

        def answer(noise, stage):
            if stage == 1:
                live["result"] = generate(
                    engine, file_loras, num_steps=HARNESS_STEPS,
                    masks=sidecar_masks, initial_noise=noise.permute(
                        0, 2, 3, 1).contiguous().numpy())
            return getattr(live["result"], f"stage{stage}")
        stub.ANSWER = answer
        rec["stub_reference"], report, res = harness_run(
            "harness (e) stub reference",
            argv + ["--reference_repo", stub_dir,
                    "--out", os.path.join(tmp, "report_stub.json")],
            2 * HARNESS_LAUNCHES,
            {k: 2 * v for k, v in HARNESS_SHAPES.items()})
        want = fidelity_harness.initial_latents(SEED, 1, HEIGHT, WIDTH)
        for noise in stub.NOISE:
            if not np.array_equal(noise.permute(0, 2, 3, 1).numpy(), want):
                raise AssertionError("harness (e): the stub reference's "
                                     "noise is not initial_latents")
        if len(stub.NOISE) != 2 or report.get("compared") != "stage2":
            raise AssertionError(f"harness (e): {len(stub.NOISE)} stub "
                                 f"calls, report {report}")
        diff = np.abs(res.image.astype(np.int16)
                      - live["result"].image.astype(np.int16))
        rec["stub_reference"].update(
            psnr=report["psnr"], ssim=report["ssim"],
            mean_levels=float(diff.mean()), max_levels=int(diff.max()))
        log(f"harness (e): the harness's stage-2 image (weights from the "
            f"files) against the live engine's: {diff.mean():.4f} mean, "
            f"{diff.max()} max uint8 levels (bound {HARNESS_MEAN_LEVELS} "
            f"mean); PSNR {report['psnr']:.2f} dB, SSIM {report['ssim']:.6f}")
        if diff.mean() > HARNESS_MEAN_LEVELS:
            raise AssertionError(f"harness (e): {diff.mean()} mean levels "
                                 "from the live engine's image")
    finally:
        sys.path[:] = saved_path
        for name in ("inference_lora", "diffusers"):
            sys.modules.pop(name, None)
        live.clear()
    return rec


def checkpoint_phase(device, cfg, params, loras) -> dict:
    """Phase 9 in a temporary directory of the checkout, removed at the
    end."""
    here = os.path.dirname(os.path.abspath(__file__))
    log(f"checkpoint: {shutil.disk_usage(here).free / 1e9:.1f} GB free "
        f"on the disk of {here}")
    tmp = tempfile.mkdtemp(prefix=".phase9-", dir=here)
    rec: dict = {"write": {}}
    t0 = time.perf_counter()
    try:
        sdxl_dir = os.path.join(tmp, "stable-diffusion-xl-base-1.0")
        write_sdxl_dir(sdxl_dir, params, rec["write"])
        lora_files = []
        for i, tree in enumerate(loras):
            path = os.path.join(tmp, f"char{i}.safetensors")
            _timed_write(rec["write"], f"lora{i}",
                         lambda: write_kohya(path, tree))
            lora_files.append(path)
        xl1 = os.path.join(tmp, "xl1.pt")
        _timed_write(rec["write"], "xl1", lambda: write_xl1(xl1, device))
        rec["load"] = load_back(device, sdxl_dir, cfg, params, loras,
                                lora_files)
        rewrite = "[photo of the man]-*-[ugly]|[photo of the woman]-*-[ugly]"
        cli_out: dict = {}
        rec["inference_lora"] = run_cli(
            "cli inference_lora", cli_lora,
            ["--pretrained_sdxl_model", sdxl_dir,
             "--lora_path", "|".join(lora_files), "--prompt", CLI_PROMPT,
             "--negative_prompt", "ugly", "--prompt_rewrite", rewrite,
             "--efficientViT_checkpoint", xl1, "--seed", str(SEED),
             "--num_steps", str(STEPS), "--height", str(HEIGHT),
             "--width", str(WIDTH), "--save_dir", os.path.join(tmp, "lora"),
             "--device", str(device)],
            MAIN_PATH_LAUNCHES, keep=cli_out)
        gc.collect()
        torch.cuda.empty_cache()
        idnet, adapter, faces = write_instantid(tmp, device, cfg,
                                                rec["write"])
        # no face analysis of the stage-1 image (insightface is the
        # reference's): stage 2 runs without the IdentityNet, as the JAX
        # CLI degrades, so K1 runs the UNet's 70 a step in both stages
        rec["inference_instantid"] = run_cli(
            "cli inference_instantid", cli_iid,
            ["--pretrained_model", sdxl_dir, "--controlnet_path", idnet,
             "--face_adapter_path", adapter, "--prompt", CLI_PROMPT,
             "--prompt_rewrite",
             f"[photo of the man]-*-[ugly]-*-[{faces[0]}]|"
             f"[photo of the woman]-*-[ugly]-*-[{faces[1]}]",
             "--efficientViT_checkpoint", xl1, "--seed", "53",
             "--num_steps", str(IID_STEPS), "--height", str(HEIGHT),
             "--width", str(WIDTH), "--save_dir", os.path.join(tmp, "iid"),
             "--device", str(device)],
            path_launches(IID_STEPS, 70, 70))
        gc.collect()
        torch.cuda.empty_cache()
        rec["harness"] = harness_phase(
            device, cfg, params, tmp, sdxl_dir, lora_files, xl1,
            cli_out.pop("result").masks)
        rec["phase_s"] = time.perf_counter() - t0
        log(f"checkpoint: phase 9 took {rec['phase_s']:.1f} s")
    finally:
        shutil.rmtree(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


# -------------------------------------------------------------- phase 10

def serve_request(loras, seed: int, guidance: float, **kw) -> dict:
    """A config #2 request for ``generate_batch`` (phase 5's prompts)."""
    return dict(dict(prompt="photo of the man and the woman at the beach",
                     negative_prompt="ugly",
                     prompt_rewrite="[photo of the man]-*-[ugly]|"
                                    "[photo of the woman]-*-[ugly]",
                     concept_loras=loras, seed=seed, height=HEIGHT,
                     width=WIDTH, guidance_scale=guidance, num_steps=STEPS),
                **kw)


def run_batch(name: str, engine, requests: list, expect: dict,
              latents: dict = None) -> tuple:
    """``engine.generate_batch(requests)`` with K1's counts zeroed just
    before and read just after; raises unless K1 launched ``expect`` (by
    q shape) or a result lacks stage 2. -> (results, record)."""
    by_shape: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(launch_shapes(by_shape))
        if latents is not None:
            stack.enter_context(record_latents(latents, batch=True))
        results = engine.generate_batch(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = fa.LAUNCHES, torch.cuda.max_memory_allocated()
    if by_shape != expect or launches != sum(expect.values()):
        raise AssertionError(f"{name}: K1 launches {launches} by q shape "
                             f"{by_shape}, want {expect}")
    for r in results:
        if r.stage2 is None or r.stage2.shape != (2, HEIGHT, WIDTH, 3):
            raise AssertionError(f"{name}: stage 2 missing or misshapen")
    tm = results[0].timings
    log(f"{name}: {len(requests)} requests in {wall:.3f} s; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tm.items())
        + f"; {launches} K1 launches {by_shape}; peak {peak / 2**30:.2f} GiB")
    return results, {"requests": len(requests), "wall_s": wall,
                     "timings": tm, "launches": launches,
                     "launches_by_shape": by_shape, "peak_gib": peak / 2**30}


def lane_lora_gib(requests: list) -> float:
    """GiB of the stage-2 lane-stacked LoRA of ``requests`` (each adapter
    copied once per lane: 3 zero lanes and 2 per concept, per request)."""
    stacked = lora_lib.stack_loras([
        lo for r in requests for lo in
        [None] * 3 + [x for x in r["concept_loras"] for _ in range(2)]])
    return sum(t.numel() * t.element_size() for leaf in stacked.values()
               for t in leaf.values()) / 2**30


def throughput_phase(engine, loras, rank16, single) -> dict:
    """(a) four config #2 requests in one batch at 50 steps."""
    l0, l1 = loras
    reqs = [serve_request([l0, l1], 14, 7.5),
            serve_request([l1, l0], 15, 7.5),
            serve_request([l0, rank16], 16, 5.0),
            serve_request([l1, None], 17, 7.5)]
    results, rec = run_batch("serving (a)", engine, reqs,
                             BATCH_SHAPE_LAUNCHES)
    single_s = sum(single.timings.values())
    rec["images_per_min"] = 60 * len(reqs) / rec["wall_s"]
    rec["single_images_per_min"] = 60 / single_s
    rec["lane_lora_gib"] = lane_lora_gib(reqs)
    diff = np.abs(results[0].image.astype(int) - single.image.astype(int))
    rec["request0_vs_phase5"] = {"max": int(diff.max()),
                                 "mean": float(diff.mean())}
    log(f"serving (a): {rec['images_per_min']:.2f} images per minute "
        f"batched, phase 5's single request {rec['single_images_per_min']:.2f}"
        f" ({single_s:.3f} s); stage-2 lane LoRA copies "
        f"{rec['lane_lora_gib']:.3f} GiB; request 0's image vs phase 5's: "
        f"max |diff| {diff.max()}, mean {diff.mean():.3f}")
    for r in results:
        log(f"  image mean {r.image.mean():.2f} std {r.image.std():.2f}")
    return rec


def batch_vs_serial(name: str, engine, reqs: list, expect: dict,
                    errs: dict) -> None:
    """Each request's stage-1 and stage-2 latents from one
    ``generate_batch`` of ``reqs`` against its own serial ``generate``
    (into ``errs``)."""
    batched: dict = {}
    run_batch(f"{name} batch", engine, reqs, expect, latents=batched)
    for i, r in enumerate(reqs):
        serial: dict = {}
        r = dict(r)
        with record_latents(serial):
            engine.generate(r.pop("prompt"), **r)
        for stage in ("stage1", "stage2"):
            errs[f"{name} request{i}_{stage}"] = compare_eps(
                f"{name} request {i} {stage} batched vs serial",
                batched[stage][i], serial[stage])


def batch_vs_serial_phase(engine, loras, c5) -> dict:
    """(b) batches of two at SERVE_CHECK_STEPS against serial runs: two
    config #2 requests; then config #5 (InstantID, ControlNet, style
    LoRA) beside a ControlNet-only request whose guidance window drops
    the ControlNet on some steps (fusion at step 2 of 6: the window
    [0.2, 0.8] keeps steps 2 and 3)."""
    l0, l1 = loras
    errs: dict = {}
    batch_vs_serial(
        "serving (b) config #2", engine,
        [serve_request([l0, l1], 21, 7.5, num_steps=SERVE_CHECK_STEPS),
         serve_request([l1, None], 22, 5.0, num_steps=SERVE_CHECK_STEPS)],
        serve_shapes(SERVE_CHECK_STEPS, 4, 14), errs)
    windowed = serve_request([l1, l0], 24, 5.0, num_steps=SERVE_CHECK_STEPS,
                             spatial_condition=c5["cond"],
                             controlnet_params=c5["cn"], controlnet_scale=0.6,
                             control_guidance_start=0.2,
                             control_guidance_end=0.8)
    batch_vs_serial(
        "serving (b) config #5", engine,
        [config5_request(c5, 23, SERVE_CHECK_STEPS, [l0, l1], 0), windowed],
        serve_shapes(SERVE_CHECK_STEPS, 4, 14, (4,), (6, 8)), errs)
    return errs


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded uint8 "photo": discs of random colour over a ramp, with
    a little noise (edges for the canny condition)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 3))
    for _ in range(12):
        cx, cy, rad = r.uniform(0, w), r.uniform(0, h), r.uniform(40, h / 4)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < rad ** 2] += r.uniform(
            -120, 120, 3)
    img += 40 * np.sin(xx / 37 + yy / 53)[..., None] + r.normal(0, 6,
                                                                 (h, w, 3))
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def config5_models(device, cfg) -> dict:
    """Config #5's shared models (the spatial ControlNet, the InstantID
    stack, a rank-16 style LoRA), the canny condition of a seeded photo,
    and two face-keypoint images and their face embeddings."""
    t0 = time.perf_counter()
    iid_cfg = config.instantid_resampler()
    c5 = {"cn": controlnet.init_params(torch.Generator(device).manual_seed(30),
                                       config.sdxl_controlnet()),
          "iid": omg_lib.InstantIDModels(
              resampler_cfg=iid_cfg,
              resampler_params=resampler.init_params(
                  torch.Generator(device).manual_seed(31), iid_cfg),
              ip_adapter_layers=unet_lib.init_ip_layers(
                  torch.Generator(device).manual_seed(32), cfg.unet),
              identitynet_params=controlnet.init_params(
                  torch.Generator(device).manual_seed(33),
                  config.sdxl_controlnet()),
              identitynet_cfg=config.sdxl_controlnet(), ip_scale=0.8,
              identitynet_scale=0.8),
          "style": mid_block_lora(device, 13, cfg, rank=16),
          "kps": [instantid.draw_kps(HEIGHT, WIDTH, [face_kps(300, 380),
                                                     face_kps(724, 380)]),
                  instantid.draw_kps(HEIGHT, WIDTH, [face_kps(280, 420),
                                                     face_kps(700, 360)])],
          "rng": np.random.default_rng(38)}
    t1 = time.perf_counter()
    c5["cond"] = conditions.prepare_condition(photo(37, 768, 1152), "canny",
                                              HEIGHT, WIDTH)
    c5["canny_s"] = time.perf_counter() - t1
    cond = c5["cond"]
    if cond.shape != (HEIGHT, WIDTH, 3) or not 0 < (cond > 0).mean() < 0.5:
        raise AssertionError(f"canny condition {cond.shape}, edge share "
                             f"{(cond > 0).mean()}")
    torch.cuda.synchronize()
    log(f"serving: ControlNet, InstantID stack and style LoRA built in "
        f"{t1 - t0:.2f} s; canny condition (768x1152 photo, Lanczos cover "
        f"crop) in {c5['canny_s']:.2f} s, {(cond[..., 0] > 0).mean():.4f} "
        f"edges")
    return c5


def config5_request(c5, seed: int, steps: int, loras, kps: int) -> dict:
    """A config #5 request: InstantID (two seeded face embeddings and
    keypoint image ``kps``), the canny ControlNet and the style LoRA."""
    dim = config.instantid_resampler().embedding_dim
    faces = [c5["rng"].standard_normal(dim).astype(np.float32)
             for _ in range(2)]
    return serve_request(loras, seed, 3.0, num_steps=steps,
                         style_lora=c5["style"], instantid=c5["iid"],
                         face_embeddings=faces, face_kps_image=c5["kps"][kps],
                         spatial_condition=c5["cond"],
                         controlnet_params=c5["cn"], controlnet_scale=0.8)


def config5_phase(engine, loras, c5) -> tuple:
    """(c) config #5 as a batch of two (each with its own keypoints), then
    guess mode alone."""
    _, rec = run_batch("serving (c) config #5", engine,
                       [config5_request(c5, 41, CONFIG5_STEPS, [], 0),
                        config5_request(c5, 42, CONFIG5_STEPS, [], 1)],
                       CONFIG5_SHAPES)
    rec["canny_s"] = c5["canny_s"]
    guess = serve_request(loras, 43, 7.5, num_steps=CONFIG5_STEPS,
                          spatial_condition=c5["cond"],
                          controlnet_params=c5["cn"],
                          controlnet_guess_mode=True)
    _, grec = run_batch("serving (c) guess mode", engine, [guess],
                        GUESS_SHAPES)
    return rec, grec


def kohya_registry(tmp: str, loras) -> registry_lib.Registry:
    """A registry of two characters, "char0" (man) and "char1" (woman),
    whose LoRAs are ``loras`` written to kohya files in ``tmp``."""
    chars = []
    for i, (group, tree) in enumerate(zip(("man", "woman"), loras)):
        path = os.path.join(tmp, f"char{i}.safetensors")
        write_kohya(path, tree)
        chars.append({"name": f"char{i}", "path": path,
                      "prompt": f"photo of the {group}",
                      "negative_prompt": "ugly"})
    reg_path = os.path.join(tmp, "registry.json")
    _write_json(reg_path, {"man": chars[:1], "woman": chars[1:]})
    return registry_lib.Registry.from_json(reg_path)


def start_server(srv):
    """Serve ``srv`` on 127.0.0.1 in a thread -> call(path, body=None),
    the JSON answer of a GET (no body) or a POST."""
    import urllib.request
    threading.Thread(target=srv.serve, args=("127.0.0.1", 0),
                     daemon=True).start()
    url = "http://" + srv.wait_bound()

    def call(path, body=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else
            json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())
    return call


def http_phase(device, engine, loras) -> dict:
    """(d) the HTTP server on a registry of kohya files, one POST of four
    prompts, then the warmup of the 1024² bucket at batch width 4."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".phase10-", dir=here)
    rec: dict = {}
    srv = None
    try:
        srv = OMGServer(engine, kohya_registry(tmp, loras),
                        max_batch=SERVE_R)
        call = start_server(srv)
        health, reg = call("/healthz"), call("/registry")
        if not health["ok"] or reg["man"] != ["char0"] or \
                reg["deepcache_per_request"] is not True:
            raise AssertionError(f"serving (d): {health} {reg}")
        before = call("/metrics")["counters"].get("batched_requests", 0)
        by_shape: dict = {}
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        with launch_shapes(by_shape):
            out = call("/generate", {
                "prompts": [f"photo of the man and the woman in scene {i}"
                            for i in range(SERVE_R)],
                "character1": "char0", "character2": "char1",
                "negative_prompt": "ugly", "seed": 60, "steps": CONFIG5_STEPS,
                "height": HEIGHT, "width": WIDTH})
        wall = time.perf_counter() - t0
        launches = fa.LAUNCHES
        if by_shape != HTTP_SHAPES or launches != sum(HTTP_SHAPES.values()):
            raise AssertionError(f"serving (d): K1 launches {launches} "
                                 f"{by_shape}, want {HTTP_SHAPES}")
        for res in out["results"]:
            img = image_io.decode_png(base64.b64decode(res["image"]))
            if img.shape != (HEIGHT, WIDTH, 3) or not res["stage2_ran"]:
                raise AssertionError(f"serving (d): image {img.shape}, "
                                     f"stage 2 {res['stage2_ran']}")
        batched = call("/metrics")["counters"]["batched_requests"] - before
        if batched != SERVE_R:
            raise AssertionError(f"serving (d): {batched} batched requests")
        rec.update(wall_s=wall, launches=launches, launches_by_shape=by_shape,
                   batched_requests=batched,
                   seconds=[r["seconds"] for r in out["results"]])
        log(f"serving (d): POST /generate of {SERVE_R} prompts at "
            f"{CONFIG5_STEPS} steps in {wall:.3f} s (server's seconds "
            f"{rec['seconds']}), {launches} K1 launches, /metrics "
            f"batched_requests +{batched}")
        lines: list = []
        t0 = time.perf_counter()
        sample = next(iter(srv.loras.values()))
        rec["warmup_programs"] = warmup_lib.warmup(
            engine.cfg, unet_params=engine.params.unet,
            steps=CONFIG5_STEPS, buckets=((HEIGHT, WIDTH),),
            sample_lora=sample["unet"], vae_params=engine.params.vae,
            batch_sizes=(SERVE_R,), log=lines.append)
        rec["warmup_s"] = time.perf_counter() - t0
        rec["warmup_log"] = lines
        for line in lines:
            log("  " + line)
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp)
    return rec


def serving_phase(device, cfg, params, loras, single) -> dict:
    """Phase 10 on phase 5's live weights; ``single`` is phase 5's
    result."""
    t0 = time.perf_counter()
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS, cn_cfg=config.sdxl_controlnet())
    rec = {"throughput": throughput_phase(
        engine, loras, mid_block_lora(device, 12, cfg, rank=16), single)}
    gc.collect()
    torch.cuda.empty_cache()
    c5 = config5_models(device, cfg)
    rec["batched_vs_serial"] = batch_vs_serial_phase(engine, loras, c5)
    rec["config5"], rec["guess_mode"] = config5_phase(engine, loras, c5)
    del c5
    gc.collect()
    torch.cuda.empty_cache()
    rec["http"] = http_phase(device, engine, loras)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"serving: phase 10 took {rec['phase_s']:.1f} s")
    return rec


# -------------------------------------------------------------- phase 11

# The committed JPEG fixtures (tests/port/test_torch_jpeg.py made them with
# PIL) and the two HTTP requests of (d) at SERVE_CHECK_STEPS, each with the
# ControlNet on the 2 stage-1 lanes and the 3 stage-2 base lanes.
JPEG_FIXTURES = ("small_444", "gray", "smooth_1024_420")
# OpenPose and DPT-large (Intel/dpt-large, ViT-L/16 at 384²) at their
# published widths; the card-vs-CPU check cuts DPT to 4 layers
PRE_OPENPOSE_WIDTH = 1.0
PRE_DPT_CONFIG = dpt.DPTConfig()
PRE_DPT_LAYERS = 4
PRE_PHOTO = 1024                 # the seeded photos' side
PRE_HTTP_SHAPES = {k: 2 * v for k, v in serve_shapes(
    SERVE_CHECK_STEPS, 2, 7, (2,), (3,)).items()}


def jpeg_phase(names=JPEG_FIXTURES, label: str = "preprocessors (a)"
               ) -> dict:
    """(a) Each fixture decoded and held to its PIL decode; host seconds
    of the 1024x1024 ones (median of 3)."""
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "port", "data")
    rec: dict = {}
    for name in names:
        with open(os.path.join(data_dir, f"{name}.jpg"), "rb") as f:
            data = f.read()
        want = image_io.read_png(os.path.join(data_dir, f"{name}.png"))
        t = []
        for _ in range(3 if "_1024_" in name else 1):
            t0 = time.perf_counter()
            got = image_io.decode_image(data, name)
            t.append(time.perf_counter() - t0)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"jpeg: {name} differs from its PIL decode")
        rec[name] = {"shape": list(got.shape), "bytes": len(data),
                     "decode_s": sorted(t)[len(t) // 2]}
        log(f"{label}: {name}.jpg {got.shape} ({len(data)} B) "
            f"equals its PIL decode; decoded in {rec[name]['decode_s']:.3f}"
            " s on the host")
    return rec


def _save_body_model(path: str, model) -> None:
    """``model``'s weights as ``body_pose_model.pth`` with controlnet_aux's
    segment prefixes (model0 for the trunk, model{stage}_{branch})."""
    sd = {}
    for k, v in model.state_dict().items():
        layer = k.split(".")[0]
        if layer.startswith("Mconv"):
            seg = f"model{layer.split('stage')[1][0]}_{layer[-1]}"
        elif layer.startswith("conv5"):
            seg = f"model1_{layer[-1]}"
        else:
            seg = "model0"
        sd[f"{seg}.{k}"] = v.cpu()
    torch.save(sd, path)


def openpose_phase(device, tmp: str) -> tuple:
    """(b) A seeded full-width body model written as body_pose_model.pth
    and loaded back; the network on the card against the CPU on the
    server's input for a 1024² photo; ms per forward, the decode's and
    the estimator's host seconds."""
    path = os.path.join(tmp, "body_pose_model.pth")
    gen = torch.Generator(device).manual_seed(40)
    _save_body_model(path, openpose.init_params(gen, PRE_OPENPOSE_WIDTH,
                                                device))
    est = openpose.load_body_model(path)
    img = photo(41, PRE_PHOTO, PRE_PHOTO)
    x, _ = est.network_input(img, est.scale_search[0])
    cpu = openpose.BodyModel(PRE_OPENPOSE_WIDTH)
    cpu.load_state_dict(est.model.state_dict())
    rec = {"input": list(x.shape),
           "card_vs_cpu": card_vs_cpu("OpenPose network", device, est.model,
                                      cpu, (x,), who="preprocessors")}
    xd = x.to(device)
    rec["forward_ms"] = cuda_ms(lambda: est.model(xd), 10)
    flops = product_flops(lambda: openpose.BodyModel(PRE_OPENPOSE_WIDTH),
                          tuple(x.shape))
    rec["gflop"] = flops / 1e9
    rec["fp32_bound_ms"] = flops / PEAK_FP32_FLOPS * 1e3
    t0 = time.perf_counter()
    heat, paf = est.maps(img)
    rec["maps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand, subset = est.decode(heat, paf, img.shape[0])
    rec["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = est(img)
    rec["estimator_s"] = time.perf_counter() - t0
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"openpose: canvas {out.shape} {out.dtype}")
    rec.update(peaks=len(cand), people=len(subset),
               heat_max=float(np.abs(heat).max()))
    log(f"preprocessors (b): OpenPose at {list(x.shape)}: "
        f"{rec['forward_ms']:.3f} ms per forward on the card, "
        f"{rec['gflop']:.1f} GFLOP, fp32 bound "
        f"{rec['fp32_bound_ms']:.3f} ms;"
        f" maps {rec['maps_s']:.3f} s, decode {rec['decode_s']:.3f} s "
        f"({len(cand)} peaks, {len(subset)} people; random weights, max "
        f"|heat| {rec['heat_max']:.2e}), BodyEstimator on a 1024² photo "
        f"{rec['estimator_s']:.3f} s")
    return est, rec


def write_dpt_dir(folder: str, cfg, device) -> int:
    """A transformers DPT directory with seeded weights: config.json and
    model.safetensors. Returns the file's bytes."""
    os.makedirs(folder)
    model = dpt.init_params(torch.Generator(device).manual_seed(42), cfg,
                            device)
    _write_json(os.path.join(folder, "config.json"), {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(cfg).items() if k != "dtype"})
    path = os.path.join(folder, "model.safetensors")
    convert.save_safetensors(path, {k: v.cpu() for k, v in
                                    model.state_dict().items()})
    return os.path.getsize(path)


def dpt_phase(device, tmp: str) -> tuple:
    """(c) DPT-large with seeded weights written and loaded back; the card
    against the CPU at full width and PRE_DPT_LAYERS layers; ms per
    forward at 384² beside its fp32 bound; DepthEstimator seconds to a
    1024² map and its peak memory."""
    cfg = PRE_DPT_CONFIG
    folder = os.path.join(tmp, "dpt-large")
    t0 = time.perf_counter()
    nbytes = write_dpt_dir(folder, cfg, device)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = dpt.load_depth_model(folder)
    torch.cuda.synchronize()
    rec = {"file_bytes": nbytes, "write_s": write_s,
           "load_s": time.perf_counter() - t0}
    s = cfg.image_size
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.standard_normal((1, 3, s, s)).astype(
        np.float32))
    cut = dataclasses.replace(cfg, num_hidden_layers=PRE_DPT_LAYERS,
                              backbone_out_indices=tuple(
                                  range(PRE_DPT_LAYERS)))
    full_sd = est.model.state_dict()
    card = dpt.DPT(cut, device)
    card.load_state_dict({k: full_sd[k] for k in card.state_dict()})
    cpu = dpt.DPT(cut, "cpu")
    cpu.load_state_dict(card.state_dict())
    rec["card_vs_cpu"] = card_vs_cpu(f"DPT-large at {PRE_DPT_LAYERS} "
                                     "layers", device, card, cpu, (x,),
                                     who="preprocessors")
    del card, cpu
    xd = x.to(device)
    rec["forward_ms"] = cuda_ms(lambda: est.model(xd), 10)
    flops = product_flops(lambda: dpt.DPT(cfg), (1, 3, s, s))
    rec["gflop"] = flops / 1e9
    rec["fp32_bound_ms"] = flops / PEAK_FP32_FLOPS * 1e3
    img = photo(44, PRE_PHOTO, PRE_PHOTO)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = est(img, (PRE_PHOTO, PRE_PHOTO))
    rec["estimator_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec["peak_gib"] = peak / 2**30
    rec["peak_over_live_gib"] = (peak - base) / 2**30
    if out.shape != (PRE_PHOTO, PRE_PHOTO, 3) or out.max() != 255 or \
            out.min():
        raise AssertionError(f"dpt: map {out.shape}, range {out.min()}-"
                             f"{out.max()}")
    log(f"preprocessors (c): DPT-large written ({nbytes / 1e9:.3f} GB in "
        f"{write_s:.2f} s) and loaded in {rec['load_s']:.2f} s; "
        f"{rec['forward_ms']:.3f} ms per forward at {s}², "
        f"{rec['gflop']:.1f} GFLOP, fp32 bound "
        f"{rec['fp32_bound_ms']:.3f} ms; DepthEstimator to {PRE_PHOTO}² "
        f"{rec['estimator_s']:.3f} s, peak "
        f"{rec['peak_gib']:.2f} GiB ({rec['peak_over_live_gib']:.3f} GiB "
        "over the live weights)")
    return est, rec


def preprocessor_http_phase(device, cfg, params, pose, depth) -> dict:
    """(d) The server with both providers and phase 8's ControlNet under
    "pose" and "depth": one POST each with the 1024² JPEG fixture as the
    condition photo, SERVE_CHECK_STEPS steps; each condition map equal to
    the provider's own."""
    import urllib.request
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "port", "data")
    with open(os.path.join(data_dir, "smooth_1024_420.jpg"), "rb") as f:
        jpeg_bytes = f.read()
    cn = controlnet.init_params(torch.Generator(device).manual_seed(30),
                                config.sdxl_controlnet())
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=SERVE_CHECK_STEPS,
                         cn_cfg=config.sdxl_controlnet())
    srv = OMGServer(engine, registry_lib.Registry(),
                    controlnets={"pose": cn, "depth": cn},
                    pose_provider=pose, depth_provider=depth)
    threading.Thread(target=srv.serve, args=("127.0.0.1", 0),
                     daemon=True).start()
    rec: dict = {}
    try:
        url = "http://" + srv.wait_bound()
        img = image_io.to_rgb(image_io.decode_image(jpeg_bytes))
        by_shape: dict = {}
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        with launch_shapes(by_shape):
            for i, kind in enumerate(("pose", "depth")):
                t0 = time.perf_counter()
                req = urllib.request.Request(
                    url + "/generate", data=json.dumps({
                        "prompt": CLI_PROMPT, "negative_prompt": "ugly",
                        "prompt_rewrite": "[photo of the man]-*-[ugly]|"
                                          "[photo of the woman]-*-[ugly]",
                        "seed": 70 + i, "steps": SERVE_CHECK_STEPS,
                        "height": HEIGHT, "width": WIDTH, "condition": kind,
                        "condition_image": base64.b64encode(
                            jpeg_bytes).decode()}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, out = r.status, json.loads(r.read())
                wall = time.perf_counter() - t0
                got = image_io.decode_png(
                    base64.b64decode(out["condition"]))
                want = conditions.prepare_condition(
                    img, kind, HEIGHT, WIDTH, pose_provider=pose,
                    depth_provider=depth)
                if status != 200 or not np.array_equal(got, want):
                    raise AssertionError(
                        f"preprocessors (d): {kind}: HTTP {status}, "
                        f"condition equal to the provider's map: "
                        f"{np.array_equal(got, want)}")
                final = image_io.decode_png(base64.b64decode(out["image"]))
                if final.shape != (HEIGHT, WIDTH, 3) or \
                        not out["stage2_ran"]:
                    raise AssertionError(f"preprocessors (d): {kind} image "
                                         f"{final.shape}")
                rec[kind] = {"status": status, "wall_s": wall,
                             "server_s": out["seconds"],
                             "condition_nonzero": float((got > 0).mean())}
                log(f"preprocessors (d): POST {kind} with a JPEG photo: "
                    f"HTTP {status} in {wall:.3f} s, condition equal to the "
                    f"provider's map ({rec[kind]['condition_nonzero']:.4f} "
                    "non-zero)")
        torch.cuda.synchronize()
        launches = fa.LAUNCHES
        if by_shape != PRE_HTTP_SHAPES or \
                launches != sum(PRE_HTTP_SHAPES.values()):
            raise AssertionError(f"preprocessors (d): K1 launches "
                                 f"{launches} {by_shape}, want "
                                 f"{PRE_HTTP_SHAPES}")
        rec.update(launches=launches, launches_by_shape=by_shape)
    finally:
        srv.shutdown()
    return rec


def preprocessors_phase(device, cfg, params) -> dict:
    """Phase 11 on phase 5's live SDXL weights, in a temporary directory
    of the checkout that is removed at the end."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".phase11-", dir=here)
    t0 = time.perf_counter()
    try:
        rec = {"jpeg": jpeg_phase()}
        pose, rec["openpose"] = openpose_phase(device, tmp)
        depth, rec["dpt"] = dpt_phase(device, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        rec["http"] = preprocessor_http_phase(device, cfg, params, pose,
                                              depth)
    finally:
        shutil.rmtree(tmp)
    rec["card"] = power_line()
    rec["phase_s"] = time.perf_counter() - t0
    log(f"preprocessors: phase 11 took {rec['phase_s']:.1f} s on "
        f"{rec['card']}")
    return rec


# ------------------------------------------------------------ --profile

# -------------------------------------------------------------- phase 12

# DeepCache at interval 3 on config #2: full forwards on each range's first
# step and every third after it (stage 1's [0, 16) and [16, 50), stage 2's
# [16, 50)); shallow steps run no attention at SDXL's geometry.
DC_INTERVAL = 3
DC_UNIFORM_LAUNCHES = 2100       # (6 + 12) x 70 at b = 2, 12 x 70 at b = 7
# Config #2 with concept_crop: stage 1 as phase 5; stage 2's base rows at
# b = 3 full-frame and the 2K = 4 concept lanes on 128 x 64 strips, whose
# level-2 self-attention (512 tokens) takes the plain attention.
CROP_SHAPES = {"2,10,4096,64": 500, "2,20,1024,64": 3000,
               "3,10,4096,64": 340, "3,20,1024,64": 2040,
               "4,10,2048,64": 340}
# The W8A8 forward against the bf16 one: JAX's own criterion
# (tests/test_quant.py).
QUANT_COS = 0.995
# The mesh DeepCache run: 6 steps at interval 2 (fusion after step 2).
MESH_DC_STEPS, MESH_DC_INTERVAL = 6, 2
JPEG_NEW_FIXTURES = ("progressive_1024_420", "progressive_444_rst", "cmyk")


def full_steps(spec, i0: int, i1: int) -> int:
    """Full UNet forwards of a DeepCache range [i0, i1) under ``spec`` (an
    int interval or a per-step tuple; the range's first step is full)."""
    return sum(1 for i in range(i0, i1) if i == i0 or (
        spec[i] if isinstance(spec, tuple) else (i - i0) % spec == 0))


def deepcache_forwards(steps: int, spec) -> tuple:
    """(stage-1, stage-2) full forwards of one DeepCache ``generate``."""
    b = round(steps * 15 / 50) + 1
    n2 = full_steps(spec, b, steps)
    return full_steps(spec, 0, b) + n2, n2


def forward_shapes(n1: int, n2: int, lanes1: int = 2, lanes2: int = 7,
                   cn1: int = 0, cn2: int = 0) -> dict:
    """K1 launches by q shape of n1 stage-1 and n2 stage-2 full forwards
    (a ControlNet beside each on cn1 / cn2 lanes when given)."""
    out: dict = {}
    for b, n, per in ((lanes1, n1, (10, 60)), (lanes2, n2, (10, 60)),
                      (cn1, n1, (4, 30)), (cn2, n2, (4, 30))):
        for (heads, tokens), k in zip(((10, 4096), (20, 1024)), per):
            if b and n:
                key = f"{b},{heads},{tokens},64"
                out[key] = out.get(key, 0) + n * k
    return out


def deepcache_invariant(device, cfg, params) -> dict:
    """(a) A full forward keeping its cache, then the shallow forward from
    it at the same (sample, t), b = 2: equal, and no K1 launch."""
    sample, ehs, pooled, tids = unet_inputs(device, cfg, 2, seed=40)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[STEPS // 5])
    kw = dict(text_embeds=pooled, time_ids=tids)
    eps, cache = params.unet(sample, t, ehs, return_cache=True, **kw)
    torch.cuda.synchronize()
    fa.LAUNCHES = 0
    shallow = params.unet.apply_shallow(sample, t, ehs, cache=cache, **kw)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    err = (shallow.float() - eps.float()).abs().max().item()
    scale = eps.float().abs().max().item()
    ulp = 2.0 ** -7 * scale
    ms_full = cuda_ms(lambda: params.unet(sample, t, ehs, **kw), 3)
    ms_shallow = cuda_ms(lambda: params.unet.apply_shallow(
        sample, t, ehs, cache=cache, **kw), 3)
    log(f"approximate (a): shallow vs full forward at the same step: max "
        f"|diff| {err:.3e} (one bf16 ulp of max |eps| {scale:.3e}: "
        f"{ulp:.3e}); cache {tuple(cache.shape)} {cache.dtype} "
        f"{cache.numel() * cache.element_size() / 1e6:.1f} MB; "
        f"{launches} K1 launches in the shallow forward; forward "
        f"{ms_full:.2f} ms, shallow {ms_shallow:.2f} ms")
    if launches or err > ulp or not torch.isfinite(shallow).all():
        raise AssertionError(f"approximate (a): {err} {launches}")
    return {"max_abs": err, "shallow_launches": launches,
            "cache_mb": cache.numel() * cache.element_size() / 1e6,
            "full_ms": ms_full, "shallow_ms": ms_shallow}


def deepcache_runs(device, cfg, params, loras) -> dict:
    """(b) config #2 with DeepCache, uniform interval 3 and "front"."""
    rec: dict = {}
    fs = round(STEPS * 15 / 50)
    for name, spec, kw in (
            ("uniform", DC_INTERVAL, dict(cache_interval=DC_INTERVAL)),
            ("front", multiconcept.deepcache_schedule(
                STEPS, DC_INTERVAL, kind="front", fusion_start=fs),
             dict(cache_interval=DC_INTERVAL, cache_schedule="front"))):
        n1, n2 = deepcache_forwards(STEPS, spec)
        want = forward_shapes(n1, n2)
        if name == "uniform" and sum(want.values()) != DC_UNIFORM_LAUNCHES:
            raise AssertionError(f"uniform DeepCache plan: {want}")
        shapes, memory = {}, {}
        launches, res, peak = main_phase(
            device, cfg, params, loras, name=f"deepcache {name}",
            expect=sum(want.values()), shapes=shapes, memory=memory, **kw)
        if shapes != want:
            raise AssertionError(f"deepcache {name}: {shapes} != {want}")
        rec[name] = dict(_run_record(launches, res, peak, shapes, memory),
                         full_forwards=[n1, n2])
    return rec


def deepcache_controlnet(device, cfg, params, loras) -> dict:
    """(c) config #3 with DeepCache at interval 3: the ControlNet runs on
    the full steps only."""
    cn = controlnet.init_params(torch.Generator(device).manual_seed(30),
                                config.sdxl_controlnet())
    cond = np.random.default_rng(35).integers(0, 256, (HEIGHT, WIDTH, 3),
                                              dtype=np.uint8)
    n1, n2 = deepcache_forwards(STEPS, DC_INTERVAL)
    want = forward_shapes(n1, n2, cn1=2, cn2=3)
    calls = []
    forward = controlnet.ControlNetModel.forward
    controlnet.ControlNetModel.forward = \
        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k)
    try:
        shapes, memory = {}, {}
        launches, res, peak = main_phase(
            device, cfg, params, loras, name="deepcache config #3",
            expect=sum(want.values()), shapes=shapes, memory=memory,
            controlnet_params=cn, spatial_condition=cond,
            cache_interval=DC_INTERVAL)
    finally:
        controlnet.ControlNetModel.forward = forward
    log(f"approximate (c): {len(calls)} ControlNet forwards for {n1} + {n2}"
        " full steps")
    if len(calls) != n1 + n2 or shapes != want:
        raise AssertionError(f"approximate (c): {len(calls)} {shapes}")
    return dict(_run_record(launches, res, peak, shapes, memory),
                controlnet_forwards=len(calls))


def crop_run(device, cfg, params, loras) -> dict:
    """(d) config #2 with concept_crop."""
    shapes, memory = {}, {}
    launches, res, peak = main_phase(
        device, cfg, params, loras, name="concept crop",
        expect=sum(CROP_SHAPES.values()), shapes=shapes, memory=memory,
        engine_kw={"concept_crop": True})
    if shapes != CROP_SHAPES:
        raise AssertionError(f"concept crop: {shapes} != {CROP_SHAPES}")
    return _run_record(launches, res, peak, shapes, memory)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| in bf16 ulps of |b| (2^-7 of the power of two below)."""
    b = b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return ((a.float() - b).abs() / ulp).max().item()


def quant_linear_check(device, params) -> dict:
    """(e) The mid block's ff.net.0.proj (1280 -> 10240) quantized on the
    card and on the CPU at b = 2 x 1024 tokens: int8 weights and scales
    equal, the int32 sums exact, the output within one bf16 ulp; the
    int8 product and the W8A8 linear timed beside the bf16 one."""
    lin = params.unet.mid_block.attentions[0].transformer_blocks[0] \
        .ff.net[0].proj
    g = torch.Generator(device).manual_seed(41)
    x = torch.randn(2048, lin.weight.shape[1], generator=g, device=device,
                    dtype=lin.weight.dtype)
    wq, ws = quant.quantize_weight(lin.weight)
    wq_c, ws_c = quant.quantize_weight(lin.weight.cpu())
    xq, sx = quant.quantize_activations(x)
    xq_c, _ = quant.quantize_activations(x.cpu())
    calls = quant.INT_MM_CALLS
    y = quant.int_mm(xq, wq.t())
    if quant.INT_MM_CALLS != calls + 1:
        raise AssertionError("the int8 product did not take torch._int_mm")
    y_c = quant.int_mm(xq_c, wq_c.t())
    out = quant.int8_matmul(x, wq, ws)
    out_c = quant.int8_matmul(x.cpu(), wq_c, ws_c)
    same_w = torch.equal(wq.cpu(), wq_c) and torch.equal(ws.cpu(), ws_c)
    same_x = torch.equal(xq.cpu(), xq_c)
    exact = torch.equal(y.cpu(), y_c)
    ulps = bf16_ulps(out.cpu(), out_c)
    ms = {"int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, wq.t()), 20,
                               graph=True),
          "w8a8_ms": cuda_ms(lambda: quant.int8_matmul(x, wq, ws), 20,
                             graph=True),
          "bf16_ms": cuda_ms(lambda: torch.nn.functional.linear(
              x, lin.weight), 20, graph=True)}
    log(f"approximate (e): W8A8 {tuple(x.shape)} x {tuple(lin.weight.shape)}"
        f": weights/scales equal {same_w}, activations equal {same_x}, "
        f"int32 sums exact {exact}, output {ulps:.2f} bf16 ulps from the "
        f"CPU's; int8 GEMM {ms['int_mm_ms']:.4f} ms, W8A8 linear "
        f"{ms['w8a8_ms']:.4f} ms, bf16 linear {ms['bf16_ms']:.4f} ms")
    if not (same_w and same_x and exact) or ulps > 1.0:
        raise AssertionError("approximate (e): the card's W8A8 differs")
    return dict(ms, ulps=ulps)


def quant_runs(device, cfg, params, loras) -> dict:
    """(e) the W8A8 UNet forward against the bf16 one, then ``generate``
    with quantize="int8"."""
    rec = {"linear": quant_linear_check(device, params)}
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    t0 = time.perf_counter()
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS, quantize="int8")
    torch.cuda.synchronize()
    qlin = [m for m in engine.params.unet.modules()
            if isinstance(m, nn_layers.QuantLinear)]
    int8_gb = sum(m.weight_q.numel() + 4 * m.w_scale.numel()
                  for m in qlin) / 2**30
    bf16_gb = sum(2 * m.weight_q.numel() for m in qlin) / 2**30
    rec.update(quantize_s=time.perf_counter() - t0, quantized_linears=len(
        qlin), int8_weights_gib=int8_gb, bf16_weights_gib=bf16_gb)
    sample, ehs, pooled, tids = unet_inputs(device, cfg, 2, seed=42)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[STEPS // 5])
    kw = dict(text_embeds=pooled, time_ids=tids)
    ref = params.unet(sample, t, ehs, **kw).double().flatten()
    got = engine.params.unet(sample, t, ehs, **kw).double().flatten()
    cos = float(ref @ got / (ref.norm() * got.norm()))
    rec["unet_cosine"] = cos
    rec["unet_ms"] = cuda_ms(lambda: engine.params.unet(sample, t, ehs, **kw),
                             3)
    rec["bf16_unet_ms"] = cuda_ms(lambda: params.unet(sample, t, ehs, **kw), 3)
    log(f"approximate (e): {len(qlin)} int8 linears ({int8_gb:.2f} GiB "
        f"beside their {bf16_gb:.2f} GiB in bf16) in {rec['quantize_s']:.1f}"
        f" s; W8A8 UNet vs bf16 at b = 2: cosine {cos:.6f} (bound "
        f"{QUANT_COS}); forward {rec['unet_ms']:.2f} ms vs bf16 "
        f"{rec['bf16_unet_ms']:.2f} ms")
    if not cos > QUANT_COS:
        raise AssertionError(f"approximate (e): cosine {cos}")
    shapes, memory = {}, {}
    calls = quant.INT_MM_CALLS
    launches, res, peak = run_generate(engine, loras, name="w8a8",
                                       expect=MAIN_PATH_LAUNCHES,
                                       shapes=shapes, memory=memory)
    rec["generate"] = dict(_run_record(launches, res, peak, shapes, memory),
                           int_mm_calls=quant.INT_MM_CALLS - calls)
    if quant.INT_MM_CALLS == calls:
        raise AssertionError("approximate (e): no int8 GEMM in generate")
    return rec


def deepcache_serving(device, cfg, params, loras, front: dict) -> dict:
    """(f) a server whose engine has cache_interval 3 answers a POST with a
    per-request "front" schedule: (b)'s front launches."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS, cache_interval=DC_INTERVAL)
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".phase12-", dir=here)
    srv = None
    try:
        srv = OMGServer(engine, kohya_registry(tmp, loras))
        call = start_server(srv)
        caps = call("/registry")
        if not caps["deepcache_per_request"] or \
                caps["approx_modes"]["cache_interval"] != DC_INTERVAL:
            raise AssertionError(f"approximate (f): {caps}")
        shapes: dict = {}
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        with launch_shapes(shapes):
            out = call("/generate", {
                "prompt": "photo of the man and the woman at the beach",
                "character1": "char0", "character2": "char1",
                "negative_prompt": "ugly", "seed": SEED, "steps": STEPS,
                "height": HEIGHT, "width": WIDTH,
                "cache_schedule": "front"})
        wall = time.perf_counter() - t0
        launches = fa.LAUNCHES
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp)
    img = image_io.decode_png(base64.b64decode(out["image"]))
    log(f"approximate (f): POST /generate with cache_schedule front in "
        f"{wall:.3f} s, {launches} K1 launches ({shapes})")
    if shapes != front["launches_by_shape"] or img.shape != (HEIGHT, WIDTH,
                                                             3):
        raise AssertionError(f"approximate (f): {shapes} {img.shape}")
    return {"wall_s": wall, "launches": launches,
            "launches_by_shape": shapes}


def approximate_phase(device, cfg, params, loras) -> dict:
    """Phase 12 on phase 5's live weights."""
    t0 = time.perf_counter()
    rec = {"invariant": deepcache_invariant(device, cfg, params)}
    rec["deepcache"] = deepcache_runs(device, cfg, params, loras)
    rec["deepcache_config3"] = deepcache_controlnet(device, cfg, params,
                                                    loras)
    gc.collect()
    torch.cuda.empty_cache()
    rec["crop"] = crop_run(device, cfg, params, loras)
    rec["serving"] = deepcache_serving(device, cfg, params, loras,
                                       rec["deepcache"]["front"])
    rec["w8a8"] = quant_runs(device, cfg, params, loras)
    gc.collect()
    torch.cuda.empty_cache()
    rec["jpeg"] = jpeg_phase(JPEG_NEW_FIXTURES, "approximate (h)")
    rec["phase_s"] = time.perf_counter() - t0
    log(f"approximate: phase 12 took {rec['phase_s']:.1f} s")
    return rec


# --------------------------------------------------------------- phase 14

# (a) text_to_image at 1024², 50 Euler steps: the UNet at b = 2 (one CFG
# pair) every step, 10 self-attentions at level 1 and 60 at level 2
T2I_SHAPES = {"2,10,4096,64": STEPS * 10, "2,20,1024,64": STEPS * 60}
T2I_LAUNCHES = STEPS * LAUNCHES_PER_FORWARD
T2I_PROMPT = "photo of the man and the woman at the beach"
# (d) cli.serve --mesh 2: make_latency_mesh(2) is (data, model) = (2, 1),
# the layout and request shape of 13 (f) at its 6 steps: per rank (K1b,
# K1) = (0, stage 1's 6 x 70 at b = 1 + stage 2's 3 x 70 at b = 4)
SERVE_MESH_STEPS = MESH_COND_STEPS
SERVE_MESH_LAUNCHES = (0, MESH_CLI_LAUNCHES)
SERVE_MESH_TIMEOUT_S = 600


def _peak_run(fn, *args, **kwargs) -> tuple:
    """(fn's result, seconds, peak bytes over the bytes live at the start)
    of one call ending in a synchronize."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - start)


def text_to_image_run(device, cfg, params) -> tuple:
    """(a) ``sdxl.text_to_image`` (BASELINE config #1), counts zeroed just
    before and read just after: 3500 K1 launches, 500 at [2,10,4096,64]
    and 3000 at [2,20,1024,64]. Returns (record, image, latents)."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    ids = {f"ids{i}_{side}": torch.as_tensor(tok([text]), dtype=torch.long)
           for i in (1, 2) for side, text in (("pos", T2I_PROMPT),
                                              ("neg", "ugly"))}
    ms: dict = {}
    kept: dict = {}
    decode = sdxl.decode_latents

    def keep(cfg_, vae_, latents, **kw):
        kept["latents"] = latents
        return decode(cfg_, vae_, latents, **kw)
    by_shape: dict = {}
    sdxl.decode_latents = keep
    try:
        fa.LAUNCHES = 0
        with launch_shapes(by_shape), timed(sdxl, "denoise", ms, "denoise"), \
                timed(sdxl, "decode_latents", ms, "decode"):
            img, seconds, peak = _peak_run(
                sdxl.text_to_image, cfg, params,
                generator=torch.Generator().manual_seed(SEED), height=HEIGHT,
                width=WIDTH, steps=STEPS, guidance_scale=7.5, **ids)
        launches = fa.LAUNCHES
    finally:
        sdxl.decode_latents = decode
    lat = kept["latents"]
    if tuple(img.shape) != (1, HEIGHT, WIDTH, 3) or \
            not torch.isfinite(img).all() or not torch.isfinite(lat).all():
        raise AssertionError(f"text_to_image: image {tuple(img.shape)} or "
                             "latents not finite")
    if launches != T2I_LAUNCHES or by_shape != T2I_SHAPES:
        raise AssertionError(f"text_to_image: K1 launches {launches} "
                             f"{by_shape}, want {T2I_LAUNCHES} {T2I_SHAPES}")
    rec = {"launches": launches, "launches_by_shape": by_shape,
           "seconds": seconds, "denoise_s": ms["denoise"] / 1e3,
           "decode_s": ms["decode"] / 1e3, "peak_over_start_gib":
           peak / 2**30, "image_mean": img.mean().item()}
    log(f"api (a): text_to_image {HEIGHT}x{WIDTH}, {STEPS} Euler steps: "
        f"{seconds:.3f} s (denoise {rec['denoise_s']:.3f} s, fp32 decode "
        f"{rec['decode_s']:.3f} s), {peak / 2**30:.3f} GiB peak over the "
        f"start; K1 launches {launches} {by_shape}")
    return rec, img, lat


def decode_runs(cfg, params, latents) -> dict:
    """(b) ``decode_latents`` of (a)'s latents in fp32, then bf16 twice
    (the first call makes the bf16 copy of the decoder): seconds, peak
    over the start, and the uint8 images' largest difference."""
    rec: dict = {}
    imgs = {}
    for name, dtype in (("fp32", torch.float32), ("bf16_first", torch.bfloat16),
                        ("bf16", torch.bfloat16)):
        img, s, peak = _peak_run(sdxl.decode_latents, cfg, params.vae,
                                 latents, dtype=dtype)
        if not torch.isfinite(img).all():
            raise AssertionError(f"api (b): {name} decode not finite")
        imgs[name] = (img * 255).to(torch.uint8).int()
        rec[name] = {"seconds": s, "peak_over_start_gib": peak / 2**30}
    rec["max_uint8_diff"] = int((imgs["bf16"] - imgs["fp32"]).abs().max())
    rec["mean_uint8_diff"] = float((imgs["bf16"] - imgs["fp32"]).abs()
                                   .float().mean())
    copy = params.vae.decoder_copy(torch.bfloat16)
    rec["bf16_copy_gib"] = sum(p.numel() * p.element_size()
                               for p in copy.parameters()) / 2**30
    log(f"api (b): decode fp32 {rec['fp32']['seconds']:.3f} s, "
        f"{rec['fp32']['peak_over_start_gib']:.3f} GiB over the start; bf16 "
        f"{rec['bf16']['seconds']:.3f} s ({rec['bf16_first']['seconds']:.3f} s"
        f" with the cast), {rec['bf16']['peak_over_start_gib']:.3f} GiB; the "
        f"bf16 copy {rec['bf16_copy_gib']:.4f} GiB; uint8 max |diff| "
        f"{rec['max_uint8_diff']}, mean {rec['mean_uint8_diff']:.3f}")
    return rec


def encode_run(device, cfg, params, image) -> dict:
    """(c) ``AutoencoderKL.encode`` of (a)'s image at 1024² (fp32, TF32
    off) on the card, seconds and peak, against the CPU within
    CARD_CPU_REL."""
    x = image * 2.0 - 1.0
    lat, s, peak = _peak_run(params.vae.encode, x)
    lat2, s2, _ = _peak_run(params.vae.encode, x)
    if tuple(lat.shape) != (1, HEIGHT // 8, WIDTH // 8, 4) or \
            not torch.equal(lat, lat2):
        raise AssertionError(f"api (c): encode {tuple(lat.shape)}, or two "
                             "calls differ")
    cpu = vae_lib.AutoencoderKL(cfg.vae, "cpu")
    cpu.load_state_dict(params.vae.state_dict())
    t0 = time.perf_counter()
    rel = card_vs_cpu(f"encode at {HEIGHT}x{WIDTH}", device,
                      params.vae.encode,
                      cpu.encode, (x.cpu(),), who="api (c)")
    rec = {"seconds": s, "seconds_second_call": s2,
           "peak_over_start_gib": peak / 2**30, "card_vs_cpu": rel,
           "check_s": time.perf_counter() - t0}
    log(f"api (c): encode {HEIGHT}x{WIDTH} {s:.3f} s ({s2:.3f} s again), "
        f"{peak / 2**30:.3f} GiB over the start; card vs CPU took "
        f"{rec['check_s']:.1f} s")
    return rec


def _proc_state(pid: int):
    """The state letter of a live process (Z: a zombie), else None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return fields[0]


def _children(pid: int) -> list:
    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(entry))
        except (OSError, ValueError, IndexError):
            pass
    return out


def _read_lines(proc, lines: list) -> None:
    for line in proc.stdout:
        lines.append(line)
        log("serve --mesh 2 |", line.rstrip()[:300])


def serve_mesh_run(device, params, loras) -> dict:
    """(d) ``python -m omg_tpu_torch.cli.serve --mesh 2 --port 0`` on
    phase 9's checkpoint files (written again, the VAE with its encoder
    half) and a registry of phase 5's LoRAs as kohya files, in a
    subprocess whose 2 ranks share this card through gloo: one POST of
    config #2's two characters at SERVE_MESH_STEPS steps (HTTP 200, a
    1024x1024x3 PNG, stage 2 run); each rank's K1b and K1 launches for it
    SERVE_MESH_LAUNCHES; rank 1's images identical to rank 0's; then
    SIGTERM, every process gone."""
    import signal
    import urllib.request
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".phase14-", dir=here)
    rec: dict = {}
    proc = None
    try:
        t0 = time.perf_counter()
        write_sdxl_dir(os.path.join(tmp, "sdxl"), params, {})
        kohya_registry(tmp, loras)
        write_xl1(os.path.join(tmp, "xl1.pt"), device)
        rec["write_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "omg_tpu_torch.cli.serve", "--mesh", "2",
             "--port", "0", "--pretrained_sdxl_model",
             os.path.join(tmp, "sdxl"), "--efficientViT_checkpoint",
             os.path.join(tmp, "xl1.pt"), "--registry",
             os.path.join(tmp, "registry.json"), "--num_steps",
             str(SERVE_MESH_STEPS), "--device", device.type],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        lines: list = []
        reader = threading.Thread(target=_read_lines, args=(proc, lines),
                                  daemon=True)
        reader.start()
        url = None
        deadline = time.monotonic() + SERVE_MESH_TIMEOUT_S
        while url is None:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("serve --mesh 2 did not bind")
            m = next((re.search(r"serving on (http://\S+)", x) for x in lines
                      if "serving on" in x), None)
            url = m.group(1) if m else None
            time.sleep(0.2)
        rec["bind_s"] = time.perf_counter() - t0
        kids = _children(proc.pid)
        t1 = time.perf_counter()
        req = urllib.request.Request(
            url + "/generate", json.dumps({
                "prompt": CLI_PROMPT, "character1": "char0",
                "character2": "char1", "seed": SEED, "height": HEIGHT,
                "width": WIDTH, "guidance_scale": 7.5}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_MESH_TIMEOUT_S) as r:
            code, out = r.status, json.loads(r.read())
        rec["request_s"] = time.perf_counter() - t1
        png = image_io.decode_png(base64.b64decode(out["image"]))
        if code != 200 or png.shape != (HEIGHT, WIDTH, 3) or \
                not out["stage2_ran"]:
            raise AssertionError(f"serve --mesh 2: HTTP {code}, image "
                                 f"{png.shape}, stage 2 {out['stage2_ran']}")
        recs = []
        while len(recs) < 2 and time.monotonic() < deadline:
            recs = [json.loads(x) for x in list(lines)
                    if x.startswith('{"serve_mesh_job"')]
            time.sleep(0.2)
        recs.sort(key=lambda r: r["rank"])
        if [r["rank"] for r in recs] != [0, 1]:
            raise AssertionError(f"serve --mesh 2: job records {recs}")
        for r in recs:
            got = (r["launches"][1], r["launches"][0])
            if r["error"] is not None or got != SERVE_MESH_LAUNCHES:
                raise AssertionError(
                    f"serve --mesh 2: rank {r['rank']} error {r['error']}, "
                    f"K1b/K1 {got}, want {SERVE_MESH_LAUNCHES}")
        if recs[1]["images"] != recs[0]["images"]:
            raise AssertionError("serve --mesh 2: rank 1's images differ "
                                 "from rank 0's")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(30)
        time.sleep(1.0)
        alive = [k for k in kids if _proc_state(k) not in (None, "Z")]
        if rc != 0 or len(kids) < 2 or alive:
            raise AssertionError(f"serve --mesh 2: exit {rc} after SIGTERM, "
                                 f"children {kids}, still alive {alive}")
        rec.update(launches_by_rank=[r["launches"][0] for r in recs],
                   seq_launches_by_rank=[r["launches"][1] for r in recs],
                   rank_seconds=[r["seconds"] for r in recs],
                   exit_code=rc, children=len(kids))
        log(f"api (d): serve --mesh 2: files {rec['write_s']:.1f} s, bound "
            f"{rec['bind_s']:.1f} s after the start, the request "
            f"{rec['request_s']:.3f} s (ranks {rec['rank_seconds']}); K1 "
            f"{rec['launches_by_rank']}, K1b {rec['seq_launches_by_rank']} "
            f"a rank; both ranks' images identical; SIGTERM: exit {rc}, "
            f"{len(kids)} children gone")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def api_phase(device, cfg, params, loras) -> dict:
    """Phase 14 on phase 5's live weights."""
    t0 = time.perf_counter()
    rec, img, lat = text_to_image_run(device, cfg, params)
    out = {"text_to_image": rec}
    out["decode"] = decode_runs(cfg, params, lat)
    out["encode"] = encode_run(device, cfg, params, img)
    del img, lat
    gc.collect()
    torch.cuda.empty_cache()
    out["serve_mesh"] = serve_mesh_run(device, params, loras)
    out["phase_s"] = time.perf_counter() - t0
    log(f"api: phase 14 took {out['phase_s']:.1f} s")
    return out


# -------------------------------------------------------------- phase 15

# The tools' geometry ("sdxl": 1024x1024 on the live weights). (a)
# serve_bench at phase 10 (d)'s depth (cut from 50 steps, which took the
# script to 899 s of its 1200) with R = 2 in one chunk and one rep: the
# single request runs 2 lanes, then 7; the pair and the ceiling call 4,
# then 14. Every request that runs stage 2 asks the strip provider once a
# class: the warm-up single and pair, then per rep the ceiling pair, the
# single request, the POSTed pair and the two concurrent POSTs.
TOOLS_SIZE = "sdxl"
TOOLS_R = 2
TOOLS_REPS = 1
TOOLS_STEPS = CONFIG5_STEPS
TOOLS_SINGLE_SHAPES = serve_shapes(TOOLS_STEPS, 2, 7)
TOOLS_PAIR_SHAPES = serve_shapes(TOOLS_STEPS, 2 * TOOLS_R, 7 * TOOLS_R)
TOOLS_MASK_CALLS = 2 * (1 + TOOLS_R + TOOLS_REPS * (3 * TOOLS_R + 1))
# (b) the soak at phase 10 (d)'s depth. A request batched with another
# drifts from its serial run in bf16 (other GEMM shapes, other rounding);
# a seed, mask or face mix-up gives another job's image, tens of levels
# away on average. The mean uint8 difference of a storm image, and of
# each image of the POSTed Euler pair (always one batch), from its serial
# baseline must stay within SOAK_MEAN_BOUND, and the least mean
# difference between two jobs' baselines must exceed it 4 times over.
SOAK_STEPS = CONFIG5_STEPS
SOAK_MEAN_BOUND = 8.0
SOAK_SEPARATION = 4.0


def environ(**values):
    """``os.environ`` with ``values`` set inside the block."""
    return mock.patch.dict(os.environ,
                           {k: str(v) for k, v in values.items()})


def serve_bench_run(device, cfg, params) -> dict:
    """(a) ``serve_bench.main`` on the live weights."""
    fa.LAUNCHES = 0
    with environ(OMG_SERVE_SIZE=TOOLS_SIZE, OMG_SERVE_R=TOOLS_R,
                 OMG_SERVE_CHUNK=TOOLS_R, OMG_SERVE_REPS=TOOLS_REPS,
                 OMG_SERVE_STEPS=TOOLS_STEPS):
        rec = serve_bench.main(["--device", str(device)],
                               weights=(cfg, params))
    launches = fa.LAUNCHES
    want = {"single": TOOLS_SINGLE_SHAPES, "multi": TOOLS_PAIR_SHAPES,
            "ceiling": TOOLS_PAIR_SHAPES}
    for part, shapes in want.items():
        got = rec["k1"][part]
        if got["by_shape"] != shapes or \
                got["launches"] != sum(shapes.values()):
            raise AssertionError(f"serving tools (a): {part}: K1 launches "
                                 f"{got}, want {shapes}")
    if rec["mask_provider_calls"] != TOOLS_MASK_CALLS:
        raise AssertionError(f"serving tools (a): mask provider calls "
                             f"{rec['mask_provider_calls']}, want "
                             f"{TOOLS_MASK_CALLS}")
    if rec["ceiling_checked"] is not True:
        raise AssertionError("serving tools (a): the ceiling was not checked")
    for key in ("multi_prompt_img_per_min_chip",
                "concurrent_img_per_min_chip"):
        if rec[key] > serve_bench.CEILING_SLACK * \
                rec["bare_compute_ceiling_ipm"]:
            raise AssertionError(f"serving tools (a): {key} {rec[key]} over "
                                 f"{rec['bare_compute_ceiling_ipm']}")
    rec["launches"] = launches
    log(f"serving tools (a): engine {rec['engine_s']:.3f} s for {TOOLS_R} "
        f"-> ceiling {rec['bare_compute_ceiling_ipm']:.3f} img/min; HTTP "
        f"pair {rec['multi_prompt_wall_s']:.3f} s "
        f"({rec['multi_prompt_img_per_min_chip']:.3f} img/min, "
        f"{rec['http_over_engine']:.4f}x the engine), concurrent "
        f"{rec['concurrent_img_per_min_chip']:.3f} img/min, single "
        f"{rec['single_request_latency_s']:.3f} s; {launches} K1 launches")
    return rec


def soak_run(device, cfg, params) -> dict:
    """(b) ``soak_bench.main`` on the live weights."""
    fa.LAUNCHES = 0
    with environ(OMG_SOAK_SIZE=TOOLS_SIZE, OMG_SOAK_REPS=1,
                 OMG_SOAK_STEPS=SOAK_STEPS):
        rec = soak_bench.main(["--device", str(device)],
                              weights=(cfg, params))
    rec["launches"] = fa.LAUNCHES
    log(f"serving tools (b): storm vs serial by class "
        f"{rec['storm_vs_serial']}, the batched pair vs serial "
        f"{rec['pair_vs_serial']}, two jobs {rec['mixup_mean_diff']:.3f} "
        f"levels apart; latency {rec['per_class_latency_s']}; "
        f"{rec['launches']} K1 launches")
    worst = max(d["mean"] for d in [rec["pair_vs_serial"],
                                    *rec["storm_vs_serial"].values()])
    if worst > SOAK_MEAN_BOUND or \
            rec["mixup_mean_diff"] < SOAK_SEPARATION * SOAK_MEAN_BOUND:
        raise AssertionError(
            f"serving tools (b): storm vs serial {rec['storm_vs_serial']}, "
            f"pair vs serial {rec['pair_vs_serial']} (bound "
            f"{SOAK_MEAN_BOUND} mean levels), two jobs' baselines "
            f"{rec['mixup_mean_diff']:.3f} apart")
    return rec


def serving_tools_phase(device, cfg, params) -> dict:
    """Phase 15 on phase 5's live weights."""
    t0 = time.perf_counter()
    out = {"serve_bench": serve_bench_run(device, cfg, params)}
    gc.collect()
    torch.cuda.empty_cache()
    out["soak"] = soak_run(device, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fa.LAUNCHES = 0
    report = fidelity_harness.run_self_check(device=device, size=TOOLS_SIZE,
                                             weights=(cfg, params))
    if report["self_exact_equal"] is not True or report["lpips"] is not None:
        raise AssertionError(f"serving tools (c): {report}")
    out["self_check"] = dict(report, seconds=time.perf_counter() - t1,
                             launches=fa.LAUNCHES)
    log(f"serving tools (c): self_exact_equal {report['self_exact_equal']}, "
        f"crop PSNR {report.get('crop_psnr')}, DeepCache PSNR "
        f"{report['deepcache_psnr']}")
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=".phase15-", dir=here)
    try:
        spec = importlib.util.spec_from_file_location(
            "torch_quickstart", os.path.join(
                here, "examples", "torch_quickstart_random_weights.py"))
        quick = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(quick)
        t1 = time.perf_counter()
        res = quick.main(["--device", str(device),
                          "--out", os.path.join(tmp, "quickstart.png")])
        written = image_io.read_png(os.path.join(tmp, "quickstart.png"))
    finally:
        shutil.rmtree(tmp)
    if res.image.shape != (32, 32, 3) or res.stage2 is None or \
            not np.array_equal(written, res.image):
        raise AssertionError(f"serving tools (d): {res.image.shape}")
    out["quickstart"] = {"seconds": time.perf_counter() - t1,
                         "timings": res.timings}
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = power_line()
    log(f"serving tools: phase 15 took {out['phase_s']:.1f} s")
    return out


# -------------------------------------------------------------- phase 16

# ``python -m omg_tpu_torch.bench`` in-process on the live weights, cut
# from its 50 steps and 3 reps to BENCH_STEPS and one rep. A timed call
# of the latency mode runs every stage-1 step at b = 2 and the steps after
# fusion_start = round(10 * 15 / 50) = 3 at b = 7: path_launches(10, 70,
# 70) = 1120 K1; at the 1216x832 bucket the same counts at 3952 and 988
# tokens; the throughput pair in one chunk at 4, then 14. The pair with
# the crop strips: 4 lanes in stage 1, then per stage-2 step the 3R = 6
# base lanes full-frame and the 2KR = 8 strip lanes at level 1 (128 x 64
# latent strips: 2048 tokens; level 2's 512 take the plain attention),
# 1180 in all.
BENCH_STEPS = 10
BENCH_BUCKET = (1216, 832)
BENCH_R = 2
BENCH_SHAPES = serve_shapes(BENCH_STEPS, 2, 7)
BENCH_BUCKET_SHAPES = serve_shapes(BENCH_STEPS, 2, 7, height=BENCH_BUCKET[0],
                                   width=BENCH_BUCKET[1])
BENCH_PAIR_SHAPES = serve_shapes(BENCH_STEPS, 2 * BENCH_R, 7 * BENCH_R)
BENCH_CROP_SHAPES = {"4,10,4096,64": 100, "4,20,1024,64": 600,
                     "6,10,4096,64": 60, "6,20,1024,64": 360,
                     "8,10,2048,64": 60}
DETECTOR_CLASSES = ["man", "woman"]
DETECTOR_SWEEP = [0.12, 0.15, 0.18, 0.22, 0.26, 0.30]


def bench_run(name: str, device, cfg, params, shapes: dict,
              latents_shape: tuple, **env) -> tuple:
    """``bench.main`` on the live weights with OMG_BENCH_* = ``env`` (SDXL
    size, BENCH_STEPS, one rep), counts zeroed just before and read just
    after: exactly one JSON line on stdout, the record's value positive,
    its stage-2 latents finite of ``latents_shape``, K1 by q shape in the
    timed call ``shapes`` and K1b none -> (record, stage-2 latents)."""
    out = io.StringIO()
    fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
    t0 = time.perf_counter()
    with environ(OMG_BENCH_SIZE="sdxl", OMG_BENCH_STEPS=BENCH_STEPS,
                 OMG_BENCH_REPS=1, **env), contextlib.redirect_stdout(out):
        rec, lat = bench.main(["--device", str(device)],
                              weights=(cfg, params))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, seq = fa.LAUNCHES, fa.SEQ_LAUNCHES
    lines = [line for line in out.getvalue().splitlines() if line.strip()]
    if len(lines) != 1 or json.loads(lines[0])["metric"] != rec["metric"]:
        raise AssertionError(f"bench {name}: stdout must be one JSON line, "
                             f"got {lines}")
    ex = rec["extra"]
    if not rec["value"] > 0 or tuple(lat.shape) != latents_shape or \
            not torch.isfinite(lat).all():
        raise AssertionError(f"bench {name}: value {rec['value']}, latents "
                             f"{tuple(lat.shape)} (want {latents_shape}), "
                             f"finite {bool(torch.isfinite(lat).all())}")
    if ex["k1_by_shape"] != shapes or \
            ex["k1_launches"] != sum(shapes.values()) or ex["k1b_launches"]:
        raise AssertionError(f"bench {name}: K1 {ex['k1_launches']} by "
                             f"shape {ex['k1_by_shape']}, K1b "
                             f"{ex['k1b_launches']}; want {shapes}, no K1b")
    log(f"bench {name}: {rec['metric']} = {rec['value']:.4f} {rec['unit']} "
        f"({seconds:.1f} s with the warm-up); K1 {ex['k1_launches']} in the "
        f"timed call, {launches} in the run, K1b {seq}; peak "
        f"{ex['peak_gib']} GiB, {ex['peak_over_start_gib']} over the start")
    return dict(rec, seconds=seconds, launches=launches,
                seq_launches=seq), lat


def crop_against_serial(device, cfg, params, lat: torch.Tensor) -> dict:
    """(e) each request's batched copy B, decoded, against the same
    request run alone on the card (``sample_stage1_cached`` then
    ``sample_stage2_resumed(concept_crop=True)`` from its noise row and
    LCM seed): the mean uint8 difference within SOAK_MEAN_BOUND, and the
    two requests' serial images SOAK_SEPARATION times that apart."""
    work = bench.build_workload(cfg, HEIGHT, WIDTH, BENCH_STEPS,
                                requests=BENCH_R)
    cond = bench.conditioning(cfg, work, HEIGHT, WIDTH, BENCH_STEPS, device)
    sched = schedulers.make_schedule("euler", BENCH_STEPS)
    fusion_start = work["fusion_start"]

    def image(x):
        return bench.to_uint8(sdxl.decode_latents(
            cfg, params.vae, x, dtype=torch.float32)).astype(np.int16)

    batched, serial = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for r in range(BENCH_R):
            _, cache = multiconcept.sample_stage1_cached(
                cfg, sched, params.unet, generator=None, height=HEIGHT,
                width=WIDTH, base_inputs=cond.base, fusion_start=fusion_start,
                initial_noise=work["noise"][r:r + 1],
                noise_seed=bench.NOISE_SEED + r)
            alone = multiconcept.sample_stage2_resumed(
                cfg, sched, params.unet, cache, base_inputs=cond.base,
                controller=cond.controller,
                concept_inputs=[cond.concept, cond.concept],
                concept_loras=cond.loras, masks=cond.masks,
                fusion_start=fusion_start, concept_crop=True)
            serial.append(image(alone[1:2]))
            batched.append(image(lat[r, 1:2]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diffs = [float(np.abs(b - s).mean()) for b, s in zip(batched, serial)]
    maxes = [int(np.abs(b - s).max()) for b, s in zip(batched, serial)]
    mixup = float(np.abs(serial[0] - serial[1]).mean())
    log(f"bench (e): batched copy B vs the serial crop run, mean uint8 "
        f"{diffs} (max {maxes}; bound {SOAK_MEAN_BOUND}), the two requests "
        f"{mixup:.3f} apart; serial runs and decodes {seconds:.1f} s")
    if max(diffs) > SOAK_MEAN_BOUND or \
            mixup < SOAK_SEPARATION * SOAK_MEAN_BOUND:
        raise AssertionError(f"bench (e): batched vs serial mean {diffs} "
                             f"(bound {SOAK_MEAN_BOUND}), requests {mixup} "
                             f"apart (want >= "
                             f"{SOAK_SEPARATION * SOAK_MEAN_BOUND})")
    return {"mean_uint8_diff": diffs, "max_uint8_diff": maxes,
            "requests_mean_diff": mixup, "serial_s": seconds}


def detector_validation(device) -> dict:
    """(d) ``validate_detector.validate_image`` on the SAM x CLIP detector
    of phase 7 (XL1 and CLIP B/32 from seeds 21-23, a ToyTokenizer) and
    phase 7's seeded 1216x832 image; then the tool's ``main`` on a missing
    checkpoint: SKIP, rc 0."""
    models = mask_models(device, sams=("xl1",))
    provider = segment.build_mask_provider(
        "sam", sam=models["xl1"], clip_vision=models["clip_vision"],
        clip_text=models["clip_text"], tokenizer=ToyTokenizer(49408),
        device=device)
    det_ = provider.box_provider
    tall = np.random.default_rng(26).integers(0, 256, (1216, 832, 3),
                                              dtype=np.uint8)
    t0 = time.perf_counter()
    rec = validate_detector.validate_image(det_, tall, DETECTOR_CLASSES,
                                           DETECTOR_SWEEP)
    seconds = time.perf_counter() - t0
    if rec["size"] != [1216, 832] or \
            set(rec["per_class"]) != set(DETECTOR_CLASSES) or \
            set(rec["sim_thresh_sweep"]) != {str(t) for t in DETECTOR_SWEEP} \
            or rec["n_proposals"] != len(rec["proposal_scores"]) or \
            det_.sim_thresh != 0.18 or det_._assigned:
        raise AssertionError(f"bench (d): validate_image record {rec}, "
                             f"sim_thresh {det_.sim_thresh}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = validate_detector.main(["--sam_checkpoint",
                                     os.path.join(tempfile.gettempdir(),
                                                  "no-such-xl1.pt")])
    if rc != 0 or not out.getvalue().startswith("SKIP"):
        raise AssertionError(f"bench (d): main without files: rc {rc}, "
                             f"{out.getvalue()!r}")
    log(f"bench (d): validate_image {seconds:.2f} s: {rec['n_proposals']} "
        f"proposals, per class {rec['per_class']}, sweep "
        f"{rec['sim_thresh_sweep']}; main without files: "
        f"{out.getvalue().strip()!r}, rc {rc}")
    return {"record": rec, "seconds": seconds, "skip_rc": rc}


def bench_phase(device, cfg, params, loras) -> dict:
    """Phase 16 on phase 5's live weights."""
    t0 = time.perf_counter()
    h, w = BENCH_BUCKET
    out = {"latency": bench_run(
        "(a)", device, cfg, params, BENCH_SHAPES,
        (2, HEIGHT // 8, WIDTH // 8, 4), OMG_BENCH_MODE="latency",
        OMG_BENCH_DRIFT="crop", OMG_BENCH_H=HEIGHT, OMG_BENCH_W=WIDTH)[0]}
    crop = out["latency"]["extra"]["crop_drift"]
    if not crop or crop["measured"] != "live" or \
            not math.isfinite(crop["pixel_psnr_db"]):
        raise AssertionError(f"bench (a): crop drift {crop}")
    out["bucket"] = bench_run(
        "(b)", device, cfg, params, BENCH_BUCKET_SHAPES,
        (2, h // 8, w // 8, 4),
        OMG_BENCH_MODE="latency", OMG_BENCH_DRIFT="none", OMG_BENCH_H=h,
        OMG_BENCH_W=w)[0]
    out["bucket_forward_err"] = model_phase(device, cfg, params, loras, h, w,
                                            name="bench (b)")
    out["throughput"] = bench_run(
        "(c)", device, cfg, params, BENCH_PAIR_SHAPES,
        (BENCH_R, 2, HEIGHT // 8, WIDTH // 8, 4),
        OMG_BENCH_MODE="throughput", OMG_BENCH_REQUESTS=BENCH_R,
        OMG_BENCH_CHUNK=BENCH_R, OMG_BENCH_H=HEIGHT, OMG_BENCH_W=WIDTH)[0]
    if out["throughput"]["extra"]["requests"] != BENCH_R:
        raise AssertionError(f"bench (c): {out['throughput']['extra']}")
    gc.collect()
    torch.cuda.empty_cache()
    out["detector"] = detector_validation(device)
    gc.collect()
    torch.cuda.empty_cache()
    out["crop_throughput"], lat = bench_run(
        "(e)", device, cfg, params, BENCH_CROP_SHAPES,
        (BENCH_R, 2, HEIGHT // 8, WIDTH // 8, 4),
        OMG_BENCH_MODE="throughput", OMG_BENCH_CROP="strips",
        OMG_BENCH_REQUESTS=BENCH_R, OMG_BENCH_CHUNK=BENCH_R,
        OMG_BENCH_H=HEIGHT, OMG_BENCH_W=WIDTH)
    ex = out["crop_throughput"]["extra"]
    if (ex["concept_crop"], ex["requests"]) != ("strips", BENCH_R):
        raise AssertionError(f"bench (e): {ex}")
    out["crop_throughput"]["vs_serial"] = crop_against_serial(
        device, cfg, params, lat)
    del lat
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = power_line()
    log(f"bench: phase 16 took {out['phase_s']:.1f} s")
    return out


def _profile_forward(name: str, forward) -> None:
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[1] * 1e3
    # host time inside the wrapper, per K1 launch (a run of its own)
    launch, host = fa._launch, [0.0, 0]

    def timed_launch(*args, **kwargs):
        t0 = time.perf_counter()
        out = launch(*args, **kwargs)
        host[0] += time.perf_counter() - t0
        host[1] += 1
        return out

    fa._launch = timed_launch
    try:
        forward()
        torch.cuda.synchronize()
    finally:
        fa._launch = launch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = "K1 flash_fwd_kernel" if "flash_fwd_kernel" in e.name \
                else e.name[:60]
            kernels[key] = kernels.get(key, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        log(f"profile {name}: wall {wall_ms:.1f} ms; the profiler saw no "
            "device time (not measured)")
        return
    k1_ms = kernels.get("K1 flash_fwd_kernel", 0.0) / 1e3
    log(f"profile {name}: wall {wall_ms:.1f} ms, kernels {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%), K1 {k1_ms:.2f} ms "
        f"({100 * k1_ms / busy_ms:.1f}% of kernel time), host "
        f"{host[0] / max(host[1], 1) * 1e6:.1f} us per K1 launch over "
        f"{host[1]} launches")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:8.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  {key}")


def profile_phase(device) -> None:
    with torch.inference_mode():
        cfg, params, loras = weights(device)
        t = int(schedulers.make_schedule("euler", STEPS).timesteps[0])
        s1 = unet_inputs(device, cfg, 2, seed=2)
        _profile_forward("stage 1 (2 lanes)", lambda: params.unet(
            s1[0], t, s1[1], text_embeds=s1[2], time_ids=s1[3]))
        s2 = unet_inputs(device, cfg, 7, seed=1)
        lane_lora = lora_lib.stack_loras(
            [None] * 3 + [loras[0]] * 2 + [loras[1]] * 2)
        ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                                   self_replace_steps=0.4, width=WIDTH // 32,
                                   height=HEIGHT // 32, device=device)
        t2 = int(schedulers.make_schedule("euler", STEPS).timesteps[P2P_STEP])
        _profile_forward("stage 2 (7 lanes)", lambda: params.unet(
            s2[0], t2, s2[1], text_embeds=s2[2], time_ids=s2[3],
            lora=lane_lora, control=ctl.at_step(P2P_STEP, src_lane=0,
                                                dst_lane=2)))
        cn = controlnet.init_params(torch.Generator(device).manual_seed(30),
                                    config.sdxl_controlnet())
        c3 = cn_inputs(device, cfg, 3, seed=5)
        _profile_forward("ControlNet (3 lanes)", lambda: cn(
            c3[0], t2, c3[1], c3[2], text_embeds=c3[3], time_ids=c3[4]))
        del cn
        # the mask stage's two encoders at 1024² (phase 7's models)
        x = torch.randn(1, 1024, 1024, 3, device=device,
                        generator=torch.Generator(device).manual_seed(27))
        for name, cfg, seed in (("SAM ViT-H encoder", vit_sam.vit_h_config(),
                                 20),
                                ("EfficientViT-SAM-XL1 encoder",
                                 efficientvit.xl1_config(), 21)):
            sam = sam_provider.init_sam(
                torch.Generator(device).manual_seed(seed), cfg, device)
            _profile_forward(name, lambda: sam.image_encoder(x))
            del sam


# --------------------------------------------------------------- phase 6

def _lora_checksum(loras) -> torch.Tensor:
    return torch.stack([leaf[r].double().sum() for tree in loras
                        for _, leaf in sorted(tree.items())
                        for r in ("down", "up", "scale")])


def spatial_forward(mesh, cfg, params) -> dict:
    """One stage-1 UNet forward at b=2, H split over the model axis: 70 K1b
    launches; rank 0 holds it against the unsharded forward (K1)."""
    sample, ehs, pooled, tids = unet_inputs(mesh.device, cfg, 2, seed=2)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[0])
    seq = mesh.model_group
    rows = sample.shape[1] // seq.size
    fa.SEQ_LAUNCHES = 0
    eps = params.unet(sample[:, seq.index * rows:(seq.index + 1) * rows], t,
                      ehs, text_embeds=pooled, time_ids=tids, seq_group=seq)
    torch.cuda.synchronize()
    launches = fa.SEQ_LAUNCHES
    if launches != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"K1b launches per H-split forward: {launches}, "
                             f"want {LAUNCHES_PER_FORWARD}")
    eps = comm.all_gather(eps, 1, seq)
    out = {"launches": launches}
    if mesh.rank == 0:
        out["err"] = compare_eps(
            "mesh: H-split stage-1 forward vs unsharded", eps,
            params.unet(sample, t, ehs, text_embeds=pooled, time_ids=tids))
    return out


def lane_forward(mesh, cfg, params, loras) -> dict:
    """One stage-2 UNet forward on the 4+2K = 8 lanes split over all ranks
    (P2P inside its self-replace window, stacked LoRA lanes): 70 K1
    launches per rank; rank 0 holds it against the unsharded forward."""
    sample, ehs, pooled, tids = unet_inputs(mesh.device, cfg, 8, seed=3)
    lane_lora = lora_lib.stack_loras(
        [None] * 4 + [loras[0]] * 2 + [loras[1]] * 2)
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, device=mesh.device)
    step = P2P_STEP
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[step])
    lanes = mesh_lib.Split(8, mesh.flat)
    lo, hi = lanes.lo, lanes.hi
    fa.LAUNCHES = 0
    eps = params.unet(sample[lo:hi], t, ehs[lo:hi], text_embeds=pooled[lo:hi],
                      time_ids=tids[lo:hi],
                      lora=lora_lib.lane_slice(lane_lora, lo, hi),
                      control=ctl.at_step(step, lanes=lanes))
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    if launches != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"K1 launches per lane-split forward: "
                             f"{launches}, want {LAUNCHES_PER_FORWARD}")
    eps = comm.all_gather(eps, 0, mesh.flat, sizes=lanes.sizes)
    out = {"launches": launches}
    if mesh.rank == 0:
        out["err"] = compare_eps(
            "mesh: lane-split 8-lane stage-2 forward vs unsharded", eps,
            params.unet(sample, t, ehs, text_embeds=pooled, time_ids=tids,
                        lora=lane_lora, control=ctl.at_step(step)))
    return out


def mesh_generate(mesh, cfg, params, loras) -> dict:
    """``OMG(mesh=...).generate`` as phase 5 runs it, counts zeroed just
    before and read just after."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS, mesh=mesh)
    latents: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
    t0 = time.perf_counter()
    with record_latents(latents):
        res = generate(engine, loras)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    seq_launches, launches = fa.SEQ_LAUNCHES, fa.LAUNCHES
    check_result(res, latents)
    if (seq_launches, launches) != (MESH_SEQ_LAUNCHES, MESH_LAUNCHES):
        raise AssertionError(
            f"rank {mesh.rank}: K1b/K1 launches in generate {seq_launches}/"
            f"{launches}, want {MESH_SEQ_LAUNCHES}/{MESH_LAUNCHES}")
    return {"stage1": res.stage1, "stage2": res.stage2,
            "timings": res.timings, "total": total,
            "peak": torch.cuda.max_memory_allocated(mesh.device),
            "seq_launches": seq_launches, "launches": launches}


def mesh_deepcache(mesh, cfg, params, loras) -> dict:
    """Phase 12 (g): ``OMG(mesh=..., cache_interval=2).generate`` at 6 steps:
    K1b on stage 1's full steps only, K1 on stage 2's."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=MESH_DC_STEPS, mesh=mesh,
                         cache_interval=MESH_DC_INTERVAL)
    n1, n2 = deepcache_forwards(MESH_DC_STEPS, MESH_DC_INTERVAL)
    want = (n1 * LAUNCHES_PER_FORWARD, n2 * LAUNCHES_PER_FORWARD)
    torch.cuda.synchronize()
    fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
    t0 = time.perf_counter()
    res = generate(engine, loras, num_steps=MESH_DC_STEPS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = (fa.SEQ_LAUNCHES, fa.LAUNCHES)
    if got != want or res.stage2 is None or not all(
            img.shape == (2, HEIGHT, WIDTH, 3)
            for img in (res.stage1, res.stage2)):
        raise AssertionError(f"rank {mesh.rank}: mesh DeepCache K1b/K1 "
                             f"launches {got}, want {want}")
    return {"stage1": res.stage1, "stage2": res.stage2,
            "timings": res.timings, "total": total,
            "seq_launches": got[0], "launches": got[1]}


# -------------------------------------------------------------- phase 13

def mesh_cn_forward(mesh, cfg, cn) -> dict:
    """(a) One ControlNet forward at b = 2 split by rows over the model
    axis: 34 K1b launches; rank 0 holds the residuals, rows gathered,
    against the unsharded forward (K1)."""
    sample, ehs, cond, pooled, tids = cn_inputs(mesh.device, cfg, 2, seed=5)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[P2P_STEP])
    seq = mesh.model_group

    def rows(x):
        n = x.shape[1] // seq.size
        return x[:, seq.index * n:(seq.index + 1) * n]
    fa.SEQ_LAUNCHES = 0
    down, mid = cn(rows(sample), t, ehs, rows(cond),
                   text_embeds=pooled, time_ids=tids, seq_group=seq)
    torch.cuda.synchronize()
    launches = fa.SEQ_LAUNCHES
    if launches != CN_LAUNCHES:
        raise AssertionError(f"K1b launches per H-split ControlNet forward: "
                             f"{launches}, want {CN_LAUNCHES}")
    got = [comm.all_gather(r, 2, seq) for r in down + [mid]]
    out = {"launches": launches}
    if mesh.rank == 0:
        d_ref, m_ref = cn(sample, t, ehs, cond, text_embeds=pooled,
                          time_ids=tids)
        out["rel_err"] = max(_rel_err(f"mesh: ControlNet residual {j}", g, w)
                             for j, (g, w) in enumerate(zip(got,
                                                            d_ref + [m_ref])))
        log(f"mesh (13a): H-split ControlNet forward at b=2: {launches} K1b "
            f"launches; residuals vs unsharded max |diff| / max |res| "
            f"{out['rel_err']:.3e} (bound {MODEL_REL_BOUND})")
    return out


@contextlib.contextmanager
def four_lane_stage2():
    """One device on the mesh's stage-2 program: stage 1 records no
    trajectory, so stage 2 runs the 4+2K lanes (not the 3+2K ones) and a
    mesh run and its one-device reference differ only by the split."""
    stage1 = multiconcept.sample_stage1_cached

    def no_trajectory(*args, **kwargs):
        return stage1(*args, **dict(kwargs, record_trajectory=False))
    multiconcept.sample_stage1_cached = no_trajectory
    try:
        yield
    finally:
        multiconcept.sample_stage1_cached = stage1


@contextlib.contextmanager
def given_masks(masks):
    """``OMG.generate`` takes ``masks`` in place of its provider's; yields
    the list its provider's own masks are appended to."""
    predict = omg_lib.OMG._predict_masks
    seen: list = []

    def fixed(self, *args, **kwargs):
        seen.extend(predict(self, *args, **kwargs))
        return list(masks)
    omg_lib.OMG._predict_masks = fixed
    try:
        yield seen
    finally:
        omg_lib.OMG._predict_masks = predict


def mesh_conditioned_run(mesh, cfg, params, loras, name: str,
                         expect: tuple, **kw) -> dict:
    """(b), (c): ``OMG(mesh=...).generate`` at MESH_COND_STEPS, counts
    zeroed just before and read just after (K1b, K1 on this rank); then,
    on rank 0, the unsharded engine's same call on the same 4+2K stage-2
    program, its latents within MODEL_REL_BOUND of the mesh run's."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         cn_cfg=config.sdxl_controlnet(),
                         num_steps=MESH_COND_STEPS, mesh=mesh)
    latents: dict = {}
    torch.cuda.synchronize()
    fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
    t0 = time.perf_counter()
    with record_latents(latents):
        res = generate(engine, loras, num_steps=MESH_COND_STEPS, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = (fa.SEQ_LAUNCHES, fa.LAUNCHES)
    check_result(res, latents)
    want = (expect[0], expect[1][mesh.rank])
    if got != want:
        raise AssertionError(f"rank {mesh.rank}: {name} K1b/K1 launches "
                             f"{got}, want {want}")
    out = {"stage1": res.stage1, "stage2": res.stage2,
           "timings": res.timings, "total": total, "seq_launches": got[0],
           "launches": got[1]}
    if mesh.rank == 0:
        single = dataclasses.replace(engine, mesh=None)
        ref: dict = {}
        with four_lane_stage2(), record_latents(ref):
            generate(single, loras, num_steps=MESH_COND_STEPS, **kw)
        for stage in ("stage1", "stage2"):
            out[f"{stage}_rel_err"] = _rel_err(
                f"mesh {name} {stage} vs unsharded", latents[stage],
                ref[stage])
    return out


def mesh_tp_forward(mesh, cfg, params, loras) -> dict:
    """(d) One UNet forward at b = 4 (P2P in its window, LoRA on lanes 2
    and 3) with its attention split over the model axis: 70 K1 launches
    at TP_SHAPES on each rank, the all-reduces' calls, bytes and seconds
    per forward; rank 0 holds its eps within MODEL_REL_BOUND of the
    unsharded forward's, and, where bf16 rounding cannot hide a fault,
    the same forward in fp32 (plain attention, TF32 off) within
    TP_FP32_REL."""
    sample, ehs, pooled, tids = unet_inputs(mesh.device, cfg, 4, seed=6)
    lane_lora = lora_lib.stack_loras([None, None, loras[0], loras[1]])
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, device=mesh.device)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[P2P_STEP])

    def split(unet):
        return sharding.shard_params(copy.deepcopy(unet),
                                     sharding.unet_tp_sharding(unet, mesh))

    def forward(unet, dtype=None):
        f = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
        return unet(f(sample), t, f(ehs), text_embeds=f(pooled),
                    time_ids=tids, lora=lane_lora,
                    control=ctl.at_step(P2P_STEP))

    tally = {"calls": 0, "bytes": 0, "s": 0.0}
    reduce = comm._all_reduce

    def timed_reduce(x, group, op):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = reduce(x, group, op)
        torch.cuda.synchronize()
        tally["s"] += time.perf_counter() - t0
        tally["calls"] += 1
        tally["bytes"] += x.numel() * x.element_size()
        return y

    tp = split(params.unet)
    shapes: dict = {}
    torch.cuda.synchronize()
    fa.LAUNCHES = 0
    comm._all_reduce = timed_reduce
    try:
        with launch_shapes(shapes):
            eps = forward(tp)
        torch.cuda.synchronize()
    finally:
        comm._all_reduce = reduce
    if shapes != TP_SHAPES or fa.LAUNCHES != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"rank {mesh.rank}: TP forward K1 launches "
                             f"{shapes}, want {TP_SHAPES}")
    if not torch.isfinite(eps).all():
        raise AssertionError("TP forward: eps not finite")
    t0 = time.perf_counter()
    forward(tp)
    torch.cuda.synchronize()
    out = {"launches_by_shape": shapes, "all_reduce": tally,
           "forward_s": time.perf_counter() - t0}
    del tp
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        out["bf16_rel_err"] = _rel_err("mesh (13d): TP forward vs "
                                       "unsharded", eps, forward(params.unet))
    # fp32: the same forward, plain attention
    f32 = unet_lib.UNet2DConditionModel(
        dataclasses.replace(cfg.unet, dtype=torch.float32), mesh.device)
    f32.load_state_dict(params.unet.state_dict())
    with bench.plain_attention():
        tp = split(f32)
        eps = forward(tp, torch.float32)
        del tp
        gc.collect()
        if mesh.rank == 0:
            ref = forward(f32, torch.float32)
            out["fp32_rel_err"] = ((eps - ref).abs().max()
                                   / ref.abs().max()).item()
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        log(f"mesh (13d): TP forward at b=4: K1 by shape {shapes}; "
            f"{tally['calls']} all-reduces, {tally['bytes'] / 2**20:.1f} MiB"
            f", {tally['s']:.3f} s (gloo, host-staged) in the counted "
            f"forward; {out['forward_s']:.3f} s for a forward untimed; eps "
            f"vs unsharded max |diff| / max |eps| {out['bf16_rel_err']:.3e} "
            f"in bf16 (bound {MODEL_REL_BOUND}), {out['fp32_rel_err']:.3e} "
            f"in fp32 (bound {TP_FP32_REL})")
        if out["fp32_rel_err"] > TP_FP32_REL:
            raise AssertionError(f"TP forward in fp32 disagrees: "
                                 f"{out['fp32_rel_err']:.3e}")
    return out


def mesh_cli(mesh, cfg, params, loras) -> dict:
    """(f) ``cli.inference_lora.main([..., "--mesh", "2"])`` inside this
    world (make_latency_mesh(2): (data, model) = (2, 1)) on the checkpoint
    files phase 9 writes, written again here by rank 0 from the live
    weights; then rank 0's single-device CLI run on the same 4+2K
    stage-2 program and the mesh run's masks, its latents within
    MODEL_REL_BOUND of the mesh run's. Counts zeroed just before and read
    just after the mesh run."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, ".phase13-cli")
    rec: dict = {}
    if mesh.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        t0 = time.perf_counter()
        write_sdxl_dir(os.path.join(tmp, "sdxl"), params, {})
        for i, tree in enumerate(loras):
            write_kohya(os.path.join(tmp, f"char{i}.safetensors"), tree)
        write_xl1(os.path.join(tmp, "xl1.pt"), mesh.device)
        rec["write_s"] = time.perf_counter() - t0
    comm.all_reduce_sum(torch.zeros(1), mesh.flat)        # files written
    argv = ["--pretrained_sdxl_model", os.path.join(tmp, "sdxl"),
            "--lora_path", "|".join(os.path.join(tmp, f"char{i}.safetensors")
                                    for i in range(len(loras))),
            "--prompt", CLI_PROMPT, "--negative_prompt", "ugly",
            "--prompt_rewrite",
            "[photo of the man]-*-[ugly]|[photo of the woman]-*-[ugly]",
            "--efficientViT_checkpoint", os.path.join(tmp, "xl1.pt"),
            "--seed", str(SEED), "--num_steps", str(MESH_COND_STEPS),
            "--height", str(HEIGHT), "--width", str(WIDTH),
            "--device", mesh.device.type]
    try:
        latents: dict = {}
        torch.cuda.synchronize()
        fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
        t0 = time.perf_counter()
        with record_latents(latents):
            res = cli_lora.main(argv + ["--save_dir",
                                        os.path.join(tmp, "mesh"),
                                        "--mesh", "2"])
        torch.cuda.synchronize()
        rec.update(wall_s=time.perf_counter() - t0, timings=res.timings,
                   seq_launches=fa.SEQ_LAUNCHES, launches=fa.LAUNCHES)
        image = res.stage2
        if (rec["seq_launches"], rec["launches"]) != (0, MESH_CLI_LAUNCHES):
            raise AssertionError(
                f"rank {mesh.rank}: CLI --mesh 2 K1b/K1 launches "
                f"{rec['seq_launches']}/{rec['launches']}, want "
                f"0/{MESH_CLI_LAUNCHES}")
        check_result(res, latents)
        rec["image_sum"] = int(image.astype(np.int64).sum())
        masks = res.masks
        del res
        gc.collect()
        torch.cuda.empty_cache()
        if mesh.rank == 0:
            ref: dict = {}
            t0 = time.perf_counter()
            with four_lane_stage2(), record_latents(ref), \
                    given_masks(masks) as seen:
                single = cli_lora.main(argv + ["--save_dir",
                                               os.path.join(tmp, "one")])
            # SAM's masks of two stage-1 images a few levels apart may
            # differ: stage 2 is compared on the mesh run's masks
            rec["own_mask_pixels_differing"] = [
                None if m is None or o is None else
                int((np.asarray(m) != np.asarray(o)).sum())
                for m, o in zip(masks, seen)]
            rec["single_wall_s"] = time.perf_counter() - t0
            for stage in ("stage1", "stage2"):
                rec[f"{stage}_rel_err"] = _rel_err(
                    f"CLI --mesh 2 {stage} vs one device", latents[stage],
                    ref[stage])
            png = image_io.read_png(os.path.join(tmp, "mesh",
                                                 f"seed_{SEED}",
                                                 "stage-2.png"))
            if not np.array_equal(png, image[1]):
                raise AssertionError("CLI --mesh 2: rank 0's stage-2.png is "
                                     "not its result")
            rec["image_max_diff"] = int(np.abs(
                image.astype(int) - single.stage2.astype(int)).max())
            del single
    finally:
        comm.all_reduce_sum(torch.zeros(1), mesh.flat)    # runs done
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def mesh_conditioned(mesh, cfg, params, loras) -> dict:
    """Phase 13 on phase 6's ranks and weights: (a) the H-split ControlNet
    forward, (b) config #3 and (c) config #4 on the mesh, (d) the TP
    forward, (f) the CLI's --mesh 2; (e) runs in the parent."""
    device = mesh.device
    t0 = time.perf_counter()
    cn = controlnet.init_params(torch.Generator(device).manual_seed(30),
                                config.sdxl_controlnet())
    mesh_lib.replicated(mesh, cn)
    out = {"cn_forward": mesh_cn_forward(mesh, cfg, cn)}
    cond = np.random.default_rng(35).integers(0, 256, (HEIGHT, WIDTH, 3),
                                              dtype=np.uint8)
    out["config3"] = mesh_conditioned_run(
        mesh, cfg, params, loras, "config #3", MESH_CN_LAUNCHES,
        controlnet_params=cn, spatial_condition=cond, controlnet_scale=1.0)
    del cn
    gc.collect()
    torch.cuda.empty_cache()
    iid = omg_lib.InstantIDModels(
        resampler_cfg=config.instantid_resampler(),
        resampler_params=resampler.init_params(
            torch.Generator(device).manual_seed(31),
            config.instantid_resampler()),
        ip_adapter_layers=unet_lib.init_ip_layers(
            torch.Generator(device).manual_seed(32), cfg.unet),
        identitynet_params=controlnet.init_params(
            torch.Generator(device).manual_seed(33), config.sdxl_controlnet()),
        identitynet_cfg=config.sdxl_controlnet(), ip_scale=0.8,
        identitynet_scale=0.8)
    rng = np.random.default_rng(36)
    faces = [rng.standard_normal(512).astype(np.float32) for _ in range(2)]
    kps = instantid.draw_kps(HEIGHT, WIDTH, [face_kps(300, 380),
                                             face_kps(724, 380)])
    out["config4"] = mesh_conditioned_run(
        mesh, cfg, params, [], "config #4", MESH_IID_LAUNCHES, instantid=iid,
        face_embeddings=faces, face_kps_image=kps, guidance_scale=3.0)
    del iid
    gc.collect()
    torch.cuda.empty_cache()
    out["tp"] = mesh_tp_forward(mesh, cfg, params, loras)
    out["cli"] = mesh_cli(mesh, cfg, params, loras)
    out["phase_s"] = time.perf_counter() - t0
    return out


def mesh_rank(rank: int, device) -> dict:
    """One rank of phase 6 (``launch.spawn`` runs it in its own process)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.build()
    mesh = mesh_lib.make_mesh(MESH_RANKS, data=1, model=MESH_RANKS,
                              device=device)
    with torch.inference_mode():
        cfg, params, loras = weights(device)
        mesh_lib.replicated(mesh, *params)
        sums = comm.all_gather(_lora_checksum(loras)[None], 0, mesh.flat)
        if not all(torch.equal(sums[0], row) for row in sums):
            raise AssertionError("the concept LoRAs differ between ranks")
        out = {"spatial": spatial_forward(mesh, cfg, params),
               "lanes": lane_forward(mesh, cfg, params, loras)}
        out.update(mesh_generate(mesh, cfg, params, loras))
        out["deepcache"] = mesh_deepcache(mesh, cfg, params, loras)
        out["conditioned"] = mesh_conditioned(mesh, cfg, params, loras)
    return out


def mesh_phase(single) -> dict:
    t0 = time.perf_counter()
    ranks = launch.spawn(mesh_rank, MESH_RANKS, backend="gloo",
                         devices=["cuda:0"] * MESH_RANKS,
                         timeout=MESH_TIMEOUT_S)
    log(f"mesh: {MESH_RANKS} ranks on cuda:0, backend gloo (collectives "
        f"staged through host memory); {time.perf_counter() - t0:.1f} s "
        "wall for the phase, rank start-up and weights included")
    for r, out in enumerate(ranks):
        tm = out["timings"]
        log(f"mesh rank {r}: stage1 {tm['stage1']:.3f} s, masks "
            f"{tm['masks']:.3f} s, stage2 {tm['stage2']:.3f} s, decode "
            f"{tm['decode']:.3f} s, encode {tm['encode']:.3f} s, total "
            f"{out['total']:.3f} s; peak memory {out['peak'] / 2**30:.2f} "
            f"GiB; K1b launches {out['seq_launches']}, K1 launches "
            f"{out['launches']}")
        for name in ("stage1", "stage2"):
            if not np.array_equal(out[name], ranks[0][name]):
                raise AssertionError(f"mesh: rank {r}'s {name} images differ "
                                     "from rank 0's")
    for name in ("stage1", "stage2"):
        diff = np.abs(ranks[0][name].astype(int)
                      - getattr(single, name).astype(int))
        log(f"mesh: {name} images vs phase 5: max |diff| {diff.max()}, mean "
            f"{diff.mean():.3f} (uint8; the 4+2K program and the split "
            "reductions round differently)")
    dcs = [out["deepcache"] for out in ranks]
    for r, dc in enumerate(dcs):
        tm = dc["timings"]
        log(f"approximate (g): mesh rank {r}, DeepCache interval "
            f"{MESH_DC_INTERVAL} at {MESH_DC_STEPS} steps: stage1 "
            f"{tm['stage1']:.3f} s, stage2 {tm['stage2']:.3f} s, total "
            f"{dc['total']:.3f} s; K1b launches {dc['seq_launches']}, K1 "
            f"launches {dc['launches']}")
        for name in ("stage1", "stage2"):
            if not np.array_equal(dc[name], dcs[0][name]):
                raise AssertionError(f"mesh DeepCache: rank {r}'s {name} "
                                     "images differ from rank 0's")
    return {"seq_launches": [out["seq_launches"] for out in ranks],
            "launches": [out["launches"] for out in ranks],
            "deepcache": [{k: dc[k] for k in ("timings", "total",
                                              "seq_launches", "launches")}
                          for dc in dcs],
            "conditioned": conditioned_record(
                [out["conditioned"] for out in ranks])}


def conditioned_record(ranks: list) -> dict:
    """Phase 13's checks across the ranks (identical images, the CLI's
    too) and its record, images dropped."""
    rec = {"cn_forward": ranks[0]["cn_forward"],
           "phase_s": [r["phase_s"] for r in ranks]}
    for name in ("config3", "config4"):
        runs = [r[name] for r in ranks]
        for r, run in enumerate(runs):
            tm = run["timings"]
            log(f"mesh (13 {name}): rank {r}: stage1 {tm['stage1']:.3f} s, "
                f"stage2 {tm['stage2']:.3f} s, decode {tm['decode']:.3f} s, "
                f"total {run['total']:.3f} s; K1b {run['seq_launches']}, K1 "
                f"{run['launches']}")
            for stage in ("stage1", "stage2"):
                if not np.array_equal(run[stage], runs[0][stage]):
                    raise AssertionError(f"mesh {name}: rank {r}'s {stage} "
                                         "images differ from rank 0's")
        log(f"mesh (13 {name}): both ranks' images identical; latents vs "
            f"unsharded max |diff| / max |ref| {runs[0]['stage1_rel_err']:.3e}"
            f" (stage 1), {runs[0]['stage2_rel_err']:.3e} (stage 2), bound "
            f"{MODEL_REL_BOUND}")
        rec[name] = [{k: v for k, v in run.items()
                      if k not in ("stage1", "stage2")} for run in runs]
    rec["tp"] = [r["tp"] for r in ranks]
    cli = [r["cli"] for r in ranks]
    if len({c["image_sum"] for c in cli}) != 1:
        raise AssertionError("CLI --mesh 2: the ranks' images differ")
    log(f"mesh (13f): CLI --mesh 2: {cli[0]['wall_s']:.2f} s from main's "
        f"start (loading included; the files written in "
        f"{cli[0]['write_s']:.2f} s), {cli[0]['launches']} K1 launches a "
        f"rank; one device {cli[0]['single_wall_s']:.2f} s; latents vs one "
        f"device {cli[0]['stage1_rel_err']:.3e} / "
        f"{cli[0]['stage2_rel_err']:.3e} (stage 2 on the mesh run's masks; "
        f"the one-device run's own differ in "
        f"{cli[0]['own_mask_pixels_differing']} pixels); stage-2 image max "
        f"|diff| {cli[0]['image_max_diff']}")
    rec["cli"] = cli
    return rec


def main() -> int:
    device = device_phase()
    log("== build")
    build_phase()
    if "--profile" in sys.argv[1:]:
        log("== profile")
        profile_phase(device)
        return 0
    log("== kernel vs plain")
    kstats, by_shape = kernel_phase(device)
    torch.cuda.empty_cache()     # the plain version's scores at B = 28
    log("== K1b vs plain")
    sstats = seq_kernel_phase(device)
    (launches, single, masks, cond, ckpt, serve, pre, approx, api, tools,
     bench_rec) = single_card_phases(device)
    cond["k1_by_shape"] = {key: by_shape[key] for key in (
        "1,10,4096,64", "3,10,4096,64", "4,10,4096,64", "1,20,1024,64",
        "3,20,1024,64", "4,20,1024,64")}
    serve["k1_by_shape"] = {key: by_shape[key] for key in (
        "8,10,4096,64", "8,20,1024,64", "28,10,4096,64", "28,20,1024,64",
        "6,10,4096,64", "6,20,1024,64", "14,10,4096,64", "14,20,1024,64")}
    approx["k1_by_shape"] = {"4,10,2048,64": by_shape["4,10,2048,64"]}
    bench_rec["k1_by_shape"] = {key: by_shape[key] for key in (
        *BENCH_BUCKET_SHAPES, "2,10,4032,64", "7,10,4032,64", "2,20,1008,64",
        "7,20,1008,64", "2,10,3840,64", "7,10,3840,64", "2,20,960,64",
        "7,20,960,64", "8,10,2048,64", "12,10,4096,64", "12,20,1024,64",
        "16,10,2048,64")}
    gc.collect()
    torch.cuda.empty_cache()
    log("== mesh")
    mstats = mesh_phase(single)
    approx["mesh_deepcache"] = mstats["deepcache"]
    log("== mesh, conditioned (e): dry run")
    t0 = time.perf_counter()
    mcond = dict(mstats["conditioned"],
                 dryrun=dryrun.dryrun_multichip(MESH_RANKS),
                 dryrun_s=time.perf_counter() - t0,
                 k1_by_shape={key: by_shape[key] for key in TP_SHAPES})
    source = "omg_tpu_torch/ops/csrc/flash_attention.cu"
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "bound_share")
    record = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": source,
        "replaces": "omg_tpu/ops/flash_attention.py:249",
        "launches": launches,
        **{key: kstats[key] for key in timed},
        "timed_at": "q/k/v [%d,%d,%d,%d] bf16" % TIMED_SHAPE,
        "text_to_image_launches": api["text_to_image"]["launches"],
        "serve_mesh_launches_by_rank": api["serve_mesh"]["launches_by_rank"],
        "masks_path_launches": masks["launches"],
        "conditioned_path_launches": {
            name: cond[name]["launches"]
            for name in ("config3", "config4", "ddim", "dpmpp_2m", "lcm")},
        "mesh_launches_by_rank": mstats["launches"],
        "mesh_conditioned_launches_by_rank": {
            "config3": [r["launches"] for r in mcond["config3"]],
            "config4": [r["launches"] for r in mcond["config4"]],
            "tp_forward": [r["launches_by_shape"] for r in mcond["tp"]],
            "cli_mesh": [r["launches"] for r in mcond["cli"]]},
        "reference_step_launches": {
            name: cond["reference_step"][name]["launches"]
            for name in ("sample_stage", "two_stage_latents")},
        "cli_path_launches": {
            name: ckpt[name]["launches"]
            for name in ("inference_lora", "inference_instantid")},
        "serving_path_launches": {
            name: serve[name]["launches"]
            for name in ("throughput", "config5", "guess_mode", "http")},
        "preprocessors_path_launches": pre["http"]["launches"],
        "serving_tools_path_launches": {
            "serve_bench": tools["serve_bench"]["launches"],
            "serve_bench_by_part": {
                part: rec["launches"]
                for part, rec in tools["serve_bench"]["k1"].items()},
            "soak": tools["soak"]["launches"],
            "self_check": tools["self_check"]["launches"]},
        "bench_path_launches": {
            name: {"run": bench_rec[name]["launches"],
                   "timed_call": bench_rec[name]["extra"]["k1_launches"]}
            for name in ("latency", "bucket", "throughput",
                         "crop_throughput")},
        "approximate_path_launches": {
            "deepcache_uniform": approx["deepcache"]["uniform"]["launches"],
            "deepcache_front": approx["deepcache"]["front"]["launches"],
            "deepcache_config3": approx["deepcache_config3"]["launches"],
            "concept_crop": approx["crop"]["launches"],
            "w8a8": approx["w8a8"]["generate"]["launches"],
            "served_front": approx["serving"]["launches"],
            "mesh_deepcache_by_rank": [
                dc["launches"] for dc in mstats["deepcache"]]}}, {
        "name": "flash_attention_fwd_seq_local",
        "route": "cuda",
        "source": source,
        "replaces": "omg_tpu/ops/flash_attention.py:108-126 via :249",
        "launches": mstats["seq_launches"][0],
        "launches_by_rank": mstats["seq_launches"],
        "serve_mesh_launches_by_rank":
            api["serve_mesh"]["seq_launches_by_rank"],
        "mesh_conditioned_launches_by_rank": {
            "controlnet_forward": mcond["cn_forward"]["launches"],
            "config3": [r["seq_launches"] for r in mcond["config3"]],
            "config4": [r["seq_launches"] for r in mcond["config4"]]},
        "approximate_path_launches": {"mesh_deepcache_by_rank": [
            dc["seq_launches"] for dc in mstats["deepcache"]]},
        **{key: sstats[key] for key in timed},
        "timed_at": "q [%d,%d,%d,64] against k/v of %d, bf16"
                    % SEQ_TIMED_SHAPE}]}
    log("card:", power_line())
    log(json.dumps({"masks": masks}))
    log(json.dumps({"conditioned": cond}))
    log(json.dumps({"checkpoint": ckpt}))
    log(json.dumps({"serving": serve}))
    log(json.dumps({"preprocessors": pre}))
    log(json.dumps({"approximate": approx}))
    log(json.dumps({"mesh_conditioned": mcond}))
    log(json.dumps({"api_surface": api}))
    log(json.dumps({"serving_tools": tools}))
    log(json.dumps({"bench": bench_rec}))
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
