"""Real-checkpoint OMG generation with the PyTorch/CUDA port (the
reference's ``inference_lora.py`` workflow through the Python API).

The counterpart of ``examples/full_pipeline.py``, with its flags, loaded
by ``omg_tpu_torch``'s own readers (no diffusers, transformers or
safetensors package). It needs the checkpoints (see kongzhecn/OMG's
README):
  stable-diffusion-xl-base-1.0/   (HF diffusers layout)
  sam/xl1.pt                      (EfficientViT-SAM; or sam_vit_h_*.pth)
  two character LoRA .safetensors and optionally a style LoRA
  a CLIP checkpoint               (optional: the open-vocabulary detector;
                                   without it both concepts take
                                   whole-image boxes)

    python examples/torch_full_pipeline.py --sdxl <dir> --sam xl1.pt \
        --lora chris.safetensors --lora taylor.safetensors [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sdxl", required=True)
    p.add_argument("--sam", required=True)
    p.add_argument("--lora", action="append", default=[])
    p.add_argument("--style_lora", default="")
    p.add_argument("--clip", default="",
                   help="CLIP checkpoint for the open-vocabulary detector")
    p.add_argument("--prompt", default="Close-up photo of the cool man "
                   "and beautiful woman as they discover a mysterious "
                   "island, smiling, 35mm photograph, 4k")
    p.add_argument("--prompt_rewrite", default="")
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--scheduler", default="euler",
                   help="'lcm' + --steps 8 for the few-step mode (needs "
                        "an LCM-LoRA merged checkpoint)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--concept_crop", action="store_true",
                   help="approximate: stage 2's concept lanes on strips")
    p.add_argument("--out", default="omg_out.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from omg_tpu_torch import loader, lora
    from omg_tpu_torch.nn import layers
    from omg_tpu_torch.pipelines import omg
    from omg_tpu_torch.segment import build_mask_provider
    from omg_tpu_torch.utils import image

    device = layers.target_device(args.device, "full_pipeline")
    cfg, params, tok1, tok2 = loader.load_sdxl(args.sdxl, device=device)
    provider = build_mask_provider(
        "sam", sam_checkpoint=args.sam, clip_checkpoint=args.clip,
        tokenizer=tok1, device=device)
    engine = omg.OMG(cfg=cfg, params=params, tokenizer=tok1,
                     tokenizer_2=tok2, mask_provider=provider,
                     scheduler=args.scheduler, num_steps=args.steps,
                     concept_crop=args.concept_crop)

    rewrite = args.prompt_rewrite or "|".join(
        "[photo of a person]-*-[noisy, blurry]" for _ in args.lora)
    result = engine.generate(
        args.prompt, prompt_rewrite=rewrite,
        concept_loras=[lora.load_lora(p, device=device) for p in args.lora],
        style_lora=(lora.load_lora(args.style_lora, device=device)
                    if args.style_lora else None),
        seed=args.seed, height=args.height, width=args.width)
    image.write_png(args.out, result.image)
    print("wrote", args.out)
    return result


if __name__ == "__main__":
    main()
