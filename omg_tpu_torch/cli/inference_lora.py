"""OMG + LoRA command-line entry point (port of
``omg_tpu/cli/inference_lora.py``).

The JAX CLI's flags and defaults (the reference's ``inference_lora.py``:
model paths, the prompt / prompt_rewrite DSL, '|'-separated LoRA files,
an optional style LoRA, the segment type, the seed), plus ``--device``
(the card unless ``cpu`` is asked for), and its outputs:
``<save_dir>/seed_<seed>/stage-1.png``, ``stage-2.png`` when stage 2 ran,
and ``image---<suffix>---<hash>.txt`` holding the four config lines, the
hash being the first 8 hex digits of their sha256.

``--cache_interval N`` (> 1) and ``--cache_schedule`` turn on DeepCache,
the approximate mode (a full UNet forward every N-th step, a shallow one
from the cached feature otherwise).

``--mesh N`` is the multi-device latency mode, as in JAX:
``make_latency_mesh(N)``, (data, model) = (2, N/2) when N is even, and
``OMG(mesh=...)``; ``--spatial_condition`` and the DeepCache flags
compose with it. The port runs one process per rank: the CLI starts N
ranks (``parallel/launch.spawn``), each loads the same files (the engine
checks that every rank holds the same weights) and runs ``generate``;
rank 0 alone writes the images and prints. With ``--device cuda`` rank r
takes ``cuda:{r % device_count}``, over ``nccl`` when every rank has a
card of its own and over ``gloo`` when ranks share one; ``--device cpu``
runs ``gloo`` CPU ranks. Called inside a world that is already running,
the CLI is one of its ranks instead, and a world of fewer than N ranks
is a ``SystemExit`` with ``make_latency_mesh``'s message, before any
weight loads.

Usage:
    python -m omg_tpu_torch.cli.inference_lora \
        --pretrained_sdxl_model /path/to/stable-diffusion-xl-base-1.0 \
        --lora_path a.safetensors|b.safetensors \
        --prompt "..." --prompt_rewrite "[...]-*-[...]|[...]-*-[...]"
"""

from __future__ import annotations

import argparse
import hashlib
import os

DINO_DEFAULT = "./checkpoint/GroundingDINO"


def parse_args(argv=None):
    parser = argparse.ArgumentParser("omg_tpu_torch OMG+LoRA", add_help=True)
    parser.add_argument("--pretrained_sdxl_model",
                        default="./checkpoint/stable-diffusion-xl-base-1.0")
    parser.add_argument("--controlnet_checkpoint", default="")
    parser.add_argument("--spatial_condition", default="", type=str,
                        help="path to a pose/canny/depth condition PNG")
    parser.add_argument("--efficientViT_checkpoint",
                        default="./checkpoint/sam/xl1.pt", type=str)
    parser.add_argument("--dino_checkpoint",
                        default=DINO_DEFAULT, type=str)
    parser.add_argument("--sam_checkpoint",
                        default="./checkpoint/sam/sam_vit_h_4b8939.pth")
    parser.add_argument("--save_dir", default="results/lora", type=str)
    parser.add_argument("--prompt", default="Close-up photo of the cool man"
                        " and beautiful woman at the beach, 4k.", type=str)
    parser.add_argument("--negative_prompt",
                        default="noisy, blurry, soft, deformed, ugly")
    parser.add_argument("--prompt_rewrite", default="", type=str)
    parser.add_argument("--lora_path", default="", type=str,
                        help="'|'-separated character LoRA files")
    parser.add_argument("--style_lora", default="", type=str)
    parser.add_argument("--segment_type", default="sam",
                        help="mask provider kind (omg_tpu_torch.segment)")
    parser.add_argument("--seed", default=14, type=int)
    parser.add_argument("--suffix", default="", type=str)
    parser.add_argument("--num_steps", default=50, type=int)
    parser.add_argument("--height", default=1024, type=int)
    parser.add_argument("--width", default=1024, type=int)
    parser.add_argument("--guidance_scale", default=7.5, type=float)
    parser.add_argument("--mesh", default=0, type=int, metavar="N",
                        help="multi-device latency mode over N ranks "
                             "(stage 1 split over CFG lanes x latent H, "
                             "stage 2 over the lanes); 0 = one device")
    parser.add_argument("--cache_interval", default=0, type=int,
                        metavar="N",
                        help="approximate mode: DeepCache, a full UNet "
                             "forward every N-th step and a shallow one "
                             "from the cache otherwise (0 = exact)")
    parser.add_argument("--cache_schedule", default="uniform",
                        choices=["uniform", "front"],
                        help="DeepCache full-step placement: 'front' packs "
                             "the same number of full steps towards step 0")
    parser.add_argument("--device", default="cuda",
                        help="device of the models: cuda (default) or cpu")
    return parser.parse_args(argv)


def load_condition(path: str, height: int, width: int):
    """A condition image (PNG or baseline JPEG) as RGB uint8 [height,
    width, 3], resized as the JAX CLI resizes it (PIL's default
    bicubic)."""
    from omg_tpu_torch.utils import image
    return image.resize(image.read_rgb(path), height, width)


def save_outputs(args, model_path: str, result) -> str:
    """stage-1.png, stage-2.png (when stage 2 ran) and the config file,
    named as the JAX CLI names them; returns the run's directory."""
    from omg_tpu_torch.utils import image
    configs = [
        f"pretrained_model: {model_path}\n",
        f"context_prompt: {args.prompt}\n",
        f"neg_context_prompt: {args.negative_prompt}\n",
        f"prompt_rewrite: {args.prompt_rewrite}\n",
    ]
    hash_code = hashlib.sha256("".join(configs).encode()).hexdigest()[:8]
    out = os.path.join(args.save_dir, f"seed_{args.seed}")
    os.makedirs(out, exist_ok=True)
    print(f"save to: {out}")
    image.write_png(os.path.join(out, "stage-1.png"), result.stage1[1])
    if result.stage2 is not None:
        image.write_png(os.path.join(out, "stage-2.png"), result.stage2[1])
    with open(os.path.join(out, f"image---{args.suffix}---{hash_code}.txt"),
              "w") as fw:
        fw.writelines(configs)
    return out


def main(argv=None):
    """Run the CLI on ``argv`` (the command line when None); returns the
    ``GenerationResult`` (rank 0's under ``--mesh``)."""
    args = parse_args(argv)
    if (args.segment_type.lower() != "groundingdino"
            and args.dino_checkpoint != DINO_DEFAULT):
        # a flag the run would silently ignore fails before the weights load
        raise SystemExit(
            f"--dino_checkpoint was set but --segment_type is "
            f"{args.segment_type!r}: GroundingDINO weights have no consumer "
            f"in this framework (detection is the in-framework SAM-proposals"
            f" x CLIP ranker). Pass --segment_type GroundingDINO to select "
            f"the reference's DINO pairing (SAM-ViT-H via --sam_checkpoint),"
            f" or drop the flag.")
    if not args.mesh:
        return run(args)
    import torch.distributed as dist
    if dist.is_initialized():
        return run(args, latency_mesh(args, args.device))
    return spawn_mesh(args)


def latency_mesh(args, device):
    """``make_latency_mesh(--mesh)`` over the running world; too few
    ranks is a ``SystemExit`` carrying its message."""
    from omg_tpu_torch.parallel import mesh as mesh_lib
    try:
        return mesh_lib.make_latency_mesh(args.mesh, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from e


def spawn_mesh(args):
    """Start ``--mesh`` ranks on ``--device`` and return rank 0's
    result."""
    import torch

    from omg_tpu_torch.parallel import launch
    n = args.mesh
    if args.device == "cpu":
        devices, backend = ["cpu"] * n, "gloo"
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("inference_lora: no CUDA device for the ranks; "
                               "pass --device cpu for CPU ranks")
        devices = [f"cuda:{r % count}" for r in range(n)]
        # NCCL refuses two ranks on one card
        backend = "nccl" if count >= n else "gloo"
    return launch.spawn(_mesh_rank, n, backend=backend, devices=devices,
                        args=(vars(args),), timeout=MESH_TIMEOUT_S)[0]


# A mesh run's limit, the whole run and any one collective (loading a
# checkpoint on every rank included).
MESH_TIMEOUT_S = 3600.0


def _mesh_rank(rank: int, device, args: dict):
    """One rank of ``--mesh`` (``launch.spawn`` runs it in its own
    process)."""
    args = argparse.Namespace(**args)
    return run(args, latency_mesh(args, device))


def run(args, mesh=None):
    """Load the models on ``--device`` (the mesh rank's device under
    ``mesh``), build the engine and generate; rank 0 writes the
    outputs."""
    # imported here, so --help needs neither torch nor a card
    from omg_tpu_torch import loader
    from omg_tpu_torch import lora as lora_lib
    from omg_tpu_torch.nn import layers
    from omg_tpu_torch.pipelines import omg as omg_lib
    from omg_tpu_torch.segment import build_mask_provider

    lead = mesh is None or mesh.rank == 0
    device = layers.target_device(
        mesh.device if mesh is not None else args.device, "inference_lora")
    cfg, params, tok1, tok2 = loader.load_sdxl(args.pretrained_sdxl_model,
                                               device=device)
    cn_cfg = controlnet = spatial = None
    if args.controlnet_checkpoint and args.spatial_condition:
        cn_cfg, controlnet = loader.load_controlnet(
            args.controlnet_checkpoint, device=device)
        spatial = load_condition(args.spatial_condition, args.height,
                                 args.width)

    if args.segment_type.lower() == "groundingdino":
        # the reference's pairing: GroundingDINO boxes, SAM-ViT-H masks;
        # detection runs in-framework, so the DINO weights are not read
        if lead:
            print("note: --segment_type GroundingDINO pairs --sam_checkpoint "
                  "(SAM-ViT-H); --dino_checkpoint weights are not read - "
                  "detection runs in-framework (segment/detector.py)")
        sam_ckpt = args.sam_checkpoint
    else:
        sam_ckpt = args.efficientViT_checkpoint
    provider = build_mask_provider(args.segment_type, sam_checkpoint=sam_ckpt,
                                   device=device)

    concept_loras = [lora_lib.load_lora(p, device=device)
                     for p in args.lora_path.split("|") if p]
    # a typo'd style path fails, not an unstyled image
    style = (lora_lib.load_lora(args.style_lora, device=device)
             if args.style_lora else None)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok1,
                         tokenizer_2=tok2, mask_provider=provider,
                         cn_cfg=cn_cfg, num_steps=args.num_steps, mesh=mesh,
                         cache_interval=args.cache_interval,
                         cache_schedule=args.cache_schedule)
    result = engine.generate(
        args.prompt, negative_prompt=args.negative_prompt,
        prompt_rewrite=args.prompt_rewrite,
        concept_loras=concept_loras, style_lora=style,
        seed=args.seed, height=args.height, width=args.width,
        guidance_scale=args.guidance_scale,
        spatial_condition=spatial, controlnet_params=controlnet)
    if lead:
        save_outputs(args, args.pretrained_sdxl_model, result)
    return result


if __name__ == "__main__":
    main()
