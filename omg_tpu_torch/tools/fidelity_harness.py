"""Fidelity harness of the port: its self-check and its metrics (port of
``tools/fidelity_harness.py``).

The JAX harness compares its engine with the reference's diffusers
pipeline from the same torch-drawn initial noise, on real checkpoints
(target: LPIPS < 0.05 between the stage-2 images, BASELINE.md:24). That
compare needs the checkpoints, diffusers and the reference's checkout,
none of which this repository holds, so the port has its weight-free
parts:

  * ``initial_latents``: the reference's initial noise (a CPU
    ``torch.Generator`` seeded with the seed, ``randn`` of [B, 4, h, w])
    in the port's NHWC layout, for ``generate(initial_noise=...)``;
  * ``psnr``, ``ssim`` (global statistics) and ``lpips_distance`` (None
    without the ``lpips`` package);
  * ``run_self_check``: the harness's compare-and-report path against
    itself, with random weights: two ``generate`` calls from the same
    noise must agree bit for bit; a concept-crop run (where the width
    splits into strips) and a DeepCache interval-2 run report their
    drift through the same metrics.

``main`` without ``--self_check`` exits 0 with a SKIP message naming what
is missing (the checkpoint, diffusers or the reference's checkout); with
all three present it refuses, since the side-by-side compare is not part
of the port yet.

    python -m omg_tpu_torch.tools.fidelity_harness --self_check \
        [--device cpu] [--out report.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import numpy as np
import torch

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
    p.add_argument("--prompt", default="")
    p.add_argument("--out", default="fidelity_report.json")
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
    if importlib.util.find_spec("diffusers") is None:
        print("SKIP: the reference pipeline needs the diffusers package")
        return 0
    if not args.reference_repo or not os.path.isfile(
            os.path.join(args.reference_repo, "inference_lora.py")):
        print(f"SKIP: no reference checkout at {args.reference_repo!r} "
              "(--reference_repo: the directory holding inference_lora.py)")
        return 0
    raise SystemExit("the side-by-side compare against the reference "
                     "pipeline is not part of the port yet (ROADMAP.md); "
                     "tools/fidelity_harness.py runs it for the JAX package")


if __name__ == "__main__":
    raise SystemExit(main())
