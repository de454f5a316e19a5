"""OMG + InstantID command-line entry point (port of
``omg_tpu/cli/inference_instantid.py``).

The JAX CLI's flags (the reference's ``inference_instantid.py``): the SDXL
base, the IdentityNet directory, the InstantID face adapter
(``ip-adapter.bin``), the 3-field ``prompt_rewrite`` with a reference
face image per region, and the IdentityNet / adapter / ControlNet
strengths (0.8 each), plus ``--device``; the outputs of
``cli/inference_lora.py``.

Face analysis is insightface's ONNX stack in the reference, which the
port does not run: each reference image needs its sidecar files
``<image>.arcface.npy`` (the 512-d embedding) and ``<image>.kps.npy``
([5, 2] keypoints, zeros when absent). Without face analysis of the
stage-1 image, stage 2 runs without the IdentityNet condition, with a
warning, as the JAX CLI degrades.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from omg_tpu_torch.cli.inference_lora import (check_not_ported,
                                              load_condition, save_outputs)


def parse_args(argv=None):
    p = argparse.ArgumentParser("omg_tpu_torch OMG+InstantID", add_help=True)
    p.add_argument("--pretrained_model",
                   default="./checkpoint/YamerMIX_v8")
    p.add_argument("--controlnet_path",
                   default="./checkpoint/InstantID/ControlNetModel",
                   help="IdentityNet checkpoint dir")
    p.add_argument("--face_adapter_path",
                   default="./checkpoint/InstantID/ip-adapter.bin")
    p.add_argument("--controlnet_checkpoint", default="",
                   help="optional spatial controlnet (pose/canny/depth)")
    p.add_argument("--spatial_condition", default="", type=str)
    p.add_argument("--efficientViT_checkpoint",
                   default="./checkpoint/sam/xl1.pt")
    p.add_argument("--save_dir", default="results/instantID")
    p.add_argument("--prompt", default="Close-up photo of the cool man and"
                   " beautiful woman in surprised expressions, 4k.")
    p.add_argument("--negative_prompt",
                   default="noisy, blurry, soft, deformed, ugly")
    p.add_argument("--prompt_rewrite", default="", type=str)
    p.add_argument("--segment_type", default="sam")
    p.add_argument("--identitynet_strength_ratio", default=0.8, type=float)
    p.add_argument("--adapter_strength_ratio", default=0.8, type=float)
    p.add_argument("--controlnet_ratio", default=0.8, type=float)
    p.add_argument("--guidance_scale", default=3.0, type=float)
    p.add_argument("--seed", default=53, type=int)
    p.add_argument("--suffix", default="", type=str)
    p.add_argument("--num_steps", default=50, type=int)
    p.add_argument("--height", default=1024, type=int)
    p.add_argument("--width", default=1024, type=int)
    p.add_argument("--cache_interval", default=0, type=int, metavar="N",
                   help="DeepCache; not ported (0 = exact)")
    p.add_argument("--cache_schedule", default="uniform",
                   choices=["uniform", "front"],
                   help="DeepCache full-step placement; not ported")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


def get_face_info(image_path: str):
    """-> (kps [5, 2], embedding [512]) of the largest face: face analysis
    (``instantid.analyze_face``), or on its failure the image's
    ``.arcface.npy`` / ``.kps.npy`` sidecars; without them an error that
    says what to precompute."""
    from omg_tpu_torch import instantid as iid_lib
    from omg_tpu_torch.utils import image
    npy_emb = image_path + ".arcface.npy"
    npy_kps = image_path + ".kps.npy"
    try:
        return iid_lib.analyze_face(image.read_rgb(image_path))
    except (RuntimeError, ValueError, OSError) as e:
        if os.path.exists(npy_emb):
            kps = (np.load(npy_kps) if os.path.exists(npy_kps)
                   else np.zeros((5, 2), np.float32))
            return kps, np.load(npy_emb)
        raise RuntimeError(
            f"face analysis failed for {image_path} ({e}) and no sidecar "
            f"{npy_emb}; precompute the ArcFace embedding (512-d .npy) "
            "for each reference image") from e


def main(argv=None):
    """Run the CLI on ``argv`` (the command line when None); returns the
    ``GenerationResult``."""
    args = parse_args(argv)
    check_not_ported(args)
    from omg_tpu_torch import convert, instantid, loader
    from omg_tpu_torch.nn import layers
    from omg_tpu_torch.pipelines import omg as omg_lib
    from omg_tpu_torch.rewrite import parse_rewrite
    from omg_tpu_torch.segment import build_mask_provider

    device = layers.target_device(args.device, "inference_instantid")
    cfg, params, tok1, tok2 = loader.load_sdxl(args.pretrained_model,
                                               device=device)
    idnet_cfg, idnet = loader.load_controlnet(args.controlnet_path,
                                              device=device)
    # the resampler's geometry from the adapter's own shapes
    adapter_sd = convert.load_state_dict(args.face_adapter_path)
    rs_cfg = convert.infer_resampler_cfg(adapter_sd, dtype=cfg.unet.dtype)
    adapter = convert.convert_ip_adapter(adapter_sd, rs_cfg,
                                         dtype=cfg.unet.dtype, device=device)
    iid = omg_lib.InstantIDModels(
        resampler_cfg=rs_cfg, resampler_params=adapter["image_proj"],
        ip_adapter_layers=adapter["ip_adapter"], identitynet_params=idnet,
        identitynet_cfg=idnet_cfg, ip_scale=args.adapter_strength_ratio,
        identitynet_scale=args.identitynet_strength_ratio)
    provider = build_mask_provider(
        args.segment_type, sam_checkpoint=args.efficientViT_checkpoint,
        device=device)

    # a reference photo's keypoints are in its own frame, not the canvas's:
    # only the embedding is used here (see kps_provider)
    face_embeds = [get_face_info(r.ref_image)[1] if r.ref_image else None
                   for r in parse_rewrite(args.prompt_rewrite)]

    # the IdentityNet's condition: the faces found on the stage-1 image,
    # drawn at canvas coordinates (the engine calls this between stages)
    def kps_provider(stage1_img):
        try:
            return instantid.stage1_kps_provider(stage1_img)
        except RuntimeError as e:
            print(f"warning: stage-1 face analysis failed ({e}); "
                  "running stage 2 without the IdentityNet condition")
            return None

    cn_kwargs = {}
    if args.controlnet_checkpoint and args.spatial_condition:
        _, spatial_cn = loader.load_controlnet(args.controlnet_checkpoint,
                                               device=device)
        cn_kwargs = dict(spatial_condition=load_condition(
            args.spatial_condition, args.height, args.width),
            controlnet_params=spatial_cn,
            controlnet_scale=args.controlnet_ratio)

    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok1,
                         tokenizer_2=tok2, mask_provider=provider,
                         cn_cfg=idnet_cfg, num_steps=args.num_steps)
    result = engine.generate(
        args.prompt, negative_prompt=args.negative_prompt,
        prompt_rewrite=args.prompt_rewrite,
        seed=args.seed, height=args.height, width=args.width,
        guidance_scale=args.guidance_scale,
        instantid=iid, face_embeddings=face_embeds,
        face_kps_provider=kps_provider, **cn_kwargs)
    save_outputs(args, args.pretrained_model, result)
    return result


if __name__ == "__main__":
    main()
