"""Fidelity harness of the port: the engine beside the reference's
diffusers pipeline (port of ``tools/fidelity_harness.py``).

Target: LPIPS < 0.05 between the reference's two-stage OMG generation and
the port's at the same configuration (BASELINE.md:24). Both pipelines
start from the same initial noise, the reference's own draw:

  * ``initial_latents``: a CPU ``torch.Generator`` seeded with the seed,
    ``randn`` of [B, 4, h, w] (diffusers' ``prepare_latents``), in the
    port's NHWC layout for ``generate(initial_noise=...)``;
  * ``run_ours``: the port's ``OMG`` engine from the checkpoint files
    (``loader.load_sdxl``, the LoRA files, the mask provider), from that
    noise, with the given masks;
  * ``run_reference``: the reference's ``inference_lora.py`` flow
    (``build_model_sd``, the LoRAs as adapters, ``prepare_text``,
    ``sample_image`` for stage 1 and, given masks, stage 2) where the
    ``diffusers`` package and the reference's checkout import;
  * ``psnr``, ``ssim`` (global statistics) and ``lpips_distance`` (None
    without the ``lpips`` package).

``main`` compares stage 2 with stage 2 when ``--masks`` went to both
pipelines, else stage 1 with stage 1, and writes the report (``--out``):
``config``, ``compared``, ``psnr``, ``ssim``, ``lpips``, ``lpips_target``
and ``pass`` (LPIPS under the target, when ``lpips`` is installed). With
no ``diffusers`` or no checkout it still runs the engine, and the report
says the reference was skipped; with no checkpoint directory it prints
SKIP. ``--self_check`` runs the compare-and-report path against itself
with random weights: two ``generate`` calls from the same noise must
agree bit for bit; a concept-crop run (where the width splits into
strips) and a DeepCache interval-2 run report their drift.

    python -m omg_tpu_torch.tools.fidelity_harness \
        --pretrained_sdxl_model ./stable-diffusion-xl-base-1.0 \
        --reference_repo /path/to/kongzhecn-OMG \
        --lora_path "chris.safetensors|taylor.safetensors" \
        --efficientViT_checkpoint xl1.pt --masks "a.npy|b.npy" \
        --prompt "..." --prompt_rewrite "[..]-*-[..]|[..]-*-[..]" \
        [--device cpu] [--out report.json]
    python -m omg_tpu_torch.tools.fidelity_harness --self_check \
        [--device cpu] [--out report.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

from omg_tpu_torch import loader, lora as lora_lib, segment
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import multiconcept, omg as omg_lib
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.tools import serve_bench


def initial_latents(seed: int, batch: int, height: int,
                    width: int) -> np.ndarray:
    """The reference's initial noise (diffusers' ``prepare_latents`` with a
    CPU generator seeded ``seed``): unit normal [batch, 4, height / 8,
    width / 8], returned NHWC as float32 numpy."""
    g = torch.Generator("cpu").manual_seed(seed)
    noise = torch.randn((batch, 4, height // 8, width // 8), generator=g)
    return noise.permute(0, 2, 3, 1).contiguous().numpy()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM from global statistics (no dependency; a coarse companion to
    LPIPS, not a replacement)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def lpips_distance(a: np.ndarray, b: np.ndarray):
    """LPIPS (AlexNet) between two uint8 [H, W, 3] images, or None without
    the ``lpips`` package."""
    if importlib.util.find_spec("lpips") is None:
        return None
    import lpips
    loss = lpips.LPIPS(net="alex")

    def prep(x):
        t = torch.from_numpy(x.astype(np.float32) / 127.5 - 1.0)
        return t.permute(2, 0, 1)[None]

    with torch.no_grad():
        return float(loss(prep(a), prep(b)))


LPIPS_TARGET = 0.05


def run_ours(args, noise_nhwc: np.ndarray, masks=None, device="cuda"):
    """The port's engine from ``args``' checkpoint files on ``device``:
    the SDXL directory (bf16), the mask provider (built even when
    ``masks`` are given, so a bad checkpoint fails here as in the JAX
    harness), the ``|``-separated LoRA files, then ``generate`` from
    ``noise_nhwc``. Returns the ``GenerationResult``."""
    device = layers.target_device(device, "fidelity_harness")
    cfg, params, tok1, tok2 = loader.load_sdxl(args.pretrained_sdxl_model,
                                               device=device)
    provider = segment.build_mask_provider(
        args.segment_type, sam_checkpoint=args.efficientViT_checkpoint,
        clip_checkpoint=args.clip_checkpoint, tokenizer=tok1, device=device)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok1,
                         tokenizer_2=tok2, mask_provider=provider,
                         num_steps=args.steps, quantize=args.quantize,
                         concept_crop=args.concept_crop,
                         cache_interval=args.cache_interval)
    loras = [lora_lib.load_lora(p, device=device) if p else None
             for p in args.lora_path.split("|")]
    with torch.inference_mode():
        return engine.generate(
            args.prompt, negative_prompt=args.negative_prompt,
            prompt_rewrite=args.prompt_rewrite, concept_loras=loras,
            seed=args.seed, height=args.height, width=args.width,
            guidance_scale=args.guidance_scale, masks=masks,
            initial_noise=noise_nhwc)


def run_reference(args, masks=None, device="cuda"):
    """The reference's two-stage flow (inference_lora.py:262-297) from
    ``args.reference_repo``, or None (with a SKIP line) when ``diffusers``
    or the checkout does not import. Stage 1, and with ``masks`` (per
    concept [H, W] {0, 1} arrays) the region-fused stage 2; without masks
    only stage 1 is comparable. Returns {"stage1", "stage2"}, each the
    pipeline's two images (stage2 None without masks)."""
    try:
        import diffusers  # noqa: F401
    except ImportError as e:
        print(f"SKIP reference run: {e}")
        return None
    if not args.reference_repo:
        print("SKIP reference run: no --reference_repo (the directory "
              "holding inference_lora.py)")
        return None
    sys.path.insert(0, args.reference_repo)
    try:
        import inference_lora  # noqa: F401
    except ImportError as e:
        print(f"SKIP reference run (repo not importable): {e}")
        return None
    from inference_lora import build_model_sd, prepare_text, sample_image
    device = str(layers.target_device(device, "fidelity_harness"))
    pipe, controller, pipe_concepts = build_model_sd(
        args.pretrained_sdxl_model, "", device, prompts=[args.prompt] * 2)
    # the LoRAs as inference_lora.py:162-170 loads them
    lora_list = []
    for i, path in enumerate(p for p in args.lora_path.split("|") if p):
        pipe_concepts.load_lora_weights(path, adapter_name=f"c{i}")
        lora_list.append(f"c{i}")
    input_prompt = prepare_text(args.prompt, args.prompt_rewrite)

    def gen():
        # a CPU generator whatever the pipeline's device: diffusers then
        # draws on the CPU and moves the noise, which is initial_latents;
        # a CUDA generator would start the reference from other noise
        return torch.Generator("cpu").manual_seed(args.seed)

    common = dict(
        input_prompt=input_prompt, concept_models=pipe_concepts,
        input_neg_prompt=[args.negative_prompt] * len(input_prompt),
        controller=controller, lora_list=lora_list,
        height=args.height, width=args.width,
        guidance_scale=args.guidance_scale,
        num_inference_steps=args.steps, spatial_condition=None)
    stage1 = sample_image(pipe, generator=gen(), stage=1, **common)
    if masks is None:
        return {"stage1": stage1, "stage2": None}
    controller.reset()
    region_masks = [torch.from_numpy(np.asarray(m, np.float32))
                    for m in masks]
    stage2 = sample_image(pipe, generator=gen(), stage=2,
                          region_masks=region_masks, **common)
    return {"stage1": stage1, "stage2": stage2}


SELF_CHECK_STEPS = 4


def _mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).mean())


def run_self_check(out_path: str = "", device="cuda", size: str = "tiny",
                   weights=None) -> dict:
    """The harness against itself at ``size`` ("tiny": 32x32; "sdxl":
    1024x1024) with random weights (``weights``: (cfg, params) already on
    a device), SELF_CHECK_STEPS Euler steps, the left/right strip masks
    and ``initial_latents(14, ...)``: the report of two identical runs
    (``self_exact_equal`` must be true), a crop-strip run where the width
    splits, and a DeepCache interval-2 run, each through psnr, ssim and
    lpips_distance; written to ``out_path`` when given."""
    cfg, side, _ = serve_bench.geometry(size)
    if weights is None:
        params = serve_bench.random_weights(
            cfg, layers.target_device(device, "fidelity_harness"))
    else:
        cfg, params = weights

    def build(**kw):
        tok = ToyTokenizer()
        return omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                           tokenizer_2=tok,
                           mask_provider=serve_bench.strip_provider({"n": 0}),
                           num_steps=SELF_CHECK_STEPS, **kw)

    kwargs = dict(
        negative_prompt="ugly",
        prompt_rewrite="[the chris man]-*-[ugly]|[the taylor woman]-*-[ugly]",
        seed=14, height=side, width=side,
        initial_noise=initial_latents(14, 1, side, side))
    prompt = "photo of the man and woman"
    with torch.inference_mode():
        a = build().generate(prompt, **kwargs)
        b = build().generate(prompt, **kwargs)
    report = {"mode": "self_check", "steps": SELF_CHECK_STEPS,
              "height": side, "width": side,
              "stage2_latent_mae": _mae(a.stage2, b.stage2),
              "psnr": psnr(a.image, b.image), "ssim": ssim(a.image, b.image),
              # None without the lpips package, and reported as such
              "lpips": lpips_distance(a.image, b.image),
              "self_exact_equal": bool(np.array_equal(a.image, b.image))}

    if multiconcept.crop_strips_ok(cfg, side // 8, 2):
        with torch.inference_mode():
            c = build(concept_crop=True).generate(prompt, **kwargs)
        report.update(crop_psnr=psnr(a.image, c.image),
                      crop_ssim=ssim(a.image, c.image),
                      crop_stage2_latent_mae=_mae(a.stage2, c.stage2))
    else:
        report["crop"] = "skipped (this geometry has no UNet-safe strips)"
    # DeepCache drift: interval 2 over 4 steps, 2 shallow steps a stage
    with torch.inference_mode():
        d = build(cache_interval=2).generate(prompt, **kwargs)
    report.update(deepcache_psnr=psnr(a.image, d.image),
                  deepcache_ssim=ssim(a.image, d.image),
                  deepcache_stage2_latent_mae=_mae(a.stage2, d.stage2))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser("omg_tpu_torch.tools.fidelity_harness",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--pretrained_sdxl_model", default="")
    p.add_argument("--reference_repo", default="",
                   help="a checkout of the reference (its inference_lora.py)")
    p.add_argument("--lora_path", default="")
    p.add_argument("--efficientViT_checkpoint", default="")
    p.add_argument("--clip_checkpoint", default="")
    p.add_argument("--segment_type", default="sam")
    p.add_argument("--prompt", default="")
    p.add_argument("--negative_prompt", default="noisy, blurry, ugly")
    p.add_argument("--prompt_rewrite", default="")
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--concept_crop", action="store_true",
                   help="measure the approximate cropped-concept mode's "
                        "LPIPS against the reference")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="measure the approximate int8 mode's LPIPS "
                        "against the reference")
    p.add_argument("--cache_interval", type=int, default=0,
                   help="measure the approximate DeepCache mode's LPIPS "
                        "against the reference")
    p.add_argument("--out", default="fidelity_report.json")
    p.add_argument("--masks", default="",
                   help="'|'-separated .npy per-concept binary masks [H, W] "
                        "(an empty entry is None), given to both pipelines: "
                        "the stage-2 comparison then does not depend on "
                        "the two detectors")
    p.add_argument("--self_check", action="store_true",
                   help="run the harness against itself with tiny random "
                        "weights (no checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.self_check:
        report = run_self_check(args.out, args.device)
        return 0 if report["self_exact_equal"] else 1
    if not args.pretrained_sdxl_model or not args.prompt:
        raise SystemExit("--pretrained_sdxl_model and --prompt are required "
                         "(or use --self_check)")
    if not os.path.isdir(args.pretrained_sdxl_model):
        print(f"SKIP: no checkpoint at {args.pretrained_sdxl_model} (the "
              "compare needs the SDXL base directory; --self_check runs "
              "without one)")
        return 0
    masks = None
    if args.masks:
        masks = [np.load(p) if p else None for p in args.masks.split("|")]
    noise = initial_latents(args.seed, 1, args.height, args.width)
    ours = run_ours(args, noise, masks=masks, device=args.device)
    ref = run_reference(args, masks=masks, device=args.device)
    report = {"config": dict(vars(args))}
    if ref is not None:
        # stage 2 with stage 2 only when the masks went to both pipelines
        # (copy B each time); the reference's stage 1 against the
        # engine's stage 2 would measure the fusion, not the port
        if masks is not None and ref["stage2"] is not None:
            a, b = np.asarray(ref["stage2"][1]), ours.image
            report["compared"] = "stage2"
        else:
            a, b = np.asarray(ref["stage1"][1]), np.asarray(ours.stage1[1])
            report["compared"] = ("stage1 (pass --masks for the stage-2 "
                                  "comparison)")
        lp = lpips_distance(a, b)
        report.update(psnr=psnr(a, b), ssim=ssim(a, b), lpips=lp,
                      lpips_target=LPIPS_TARGET)
        if lp is not None:
            report["pass"] = lp < LPIPS_TARGET
    else:
        report["reference"] = "skipped (diffusers/repo unavailable)"
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
