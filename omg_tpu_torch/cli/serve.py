"""Serving entry point (port of ``omg_tpu/cli/serve.py``).

    python -m omg_tpu_torch.cli.serve --pretrained_sdxl_model <dir> \
        --registry registry.json --port 7861

The JAX CLI's flags, plus ``--device`` (the card unless ``cpu`` is asked
for). Loads SDXL and the SAM mask provider from files, a registry, the
InstantID stack (``--face_adapter_path``, ``--identitynet_path``), one
ControlNet per condition kind, all of one geometry, and the condition
preprocessors that turn a photo into a pose or depth map
(``--pose_detector_checkpoint``: OpenPose's ``body_pose_model.pth``;
``--dpt_checkpoint``: a transformers DPT directory); ``--warmup`` runs
``serving.warmup.default_serving_warmup`` before serving.

The approximate modes: ``--quantize int8`` (W8A8 on the UNet's
transformer linears), ``--concept_crop`` (stage 2's concept lanes on
strips) and DeepCache (``--cache_interval``, ``--cache_schedule``; also
per request). ``--mesh`` is not ported to the server yet and raises
``NotImplementedError`` before any weight loads (ROADMAP §1 item 10: rank
0 serves and hands each job to the follower ranks).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser("omg_tpu_torch serve")
    p.add_argument("--pretrained_sdxl_model",
                   default="./checkpoint/stable-diffusion-xl-base-1.0")
    p.add_argument("--efficientViT_checkpoint",
                   default="./checkpoint/sam/xl1.pt")
    p.add_argument("--segment_type", default="sam")
    p.add_argument("--registry", default="", help="registry JSON path")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; use 0.0.0.0 to expose externally")
    p.add_argument("--port", default=7861, type=int)
    p.add_argument("--num_steps", default=50, type=int)
    p.add_argument("--face_adapter_path", default="",
                   help="InstantID ip-adapter.bin (enables identity serving)")
    p.add_argument("--identitynet_path", default="",
                   help="InstantID IdentityNet ControlNet dir")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving program once before serving")
    p.add_argument("--openpose_checkpoint", default="",
                   help="ControlNet-openpose-sdxl dir (enables kind=pose)")
    p.add_argument("--canny_checkpoint", default="",
                   help="ControlNet-canny-sdxl dir (enables kind=canny)")
    p.add_argument("--depth_checkpoint", default="",
                   help="ControlNet-depth-sdxl dir (enables kind=depth)")
    p.add_argument("--pose_detector_checkpoint", default="",
                   help="OpenPose body_pose_model.pth (photo -> pose map)")
    p.add_argument("--dpt_checkpoint", default="",
                   help="transformers DPT directory (photo -> depth map)")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="approximate mode: int8 W8A8 transformer linears")
    p.add_argument("--scheduler", default="euler",
                   choices=["euler", "ddim", "dpmpp_2m", "lcm"],
                   help="lcm + --num_steps 8 is the few-step serving mode "
                        "(needs an LCM-LoRA'd checkpoint)")
    p.add_argument("--concept_crop", action="store_true",
                   help="approximate mode: stage-2 concept lanes on "
                        "vertical strips (exact per request when "
                        "per-concept ControlNets are on)")
    p.add_argument("--cache_interval", default=0, type=int, metavar="N",
                   help="approximate mode: DeepCache every N-th step "
                        "(0 = exact); exclusive with --concept_crop")
    p.add_argument("--cache_schedule", default="uniform",
                   choices=["uniform", "front"],
                   help="DeepCache full-step placement; also a per-request "
                        "job field")
    p.add_argument("--mesh", default=0, type=int, metavar="N",
                   help="multi-device latency mode; not ported to the "
                        "server (0 = one device)")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


def check_not_ported(args) -> None:
    """Raise for the options the port does not have yet, before loading."""
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: a server over a mesh is not ported yet "
            "(ROADMAP §1 item 10: rank 0 serves and hands each job to the "
            "follower ranks)")


def build_server(args):
    """The ``OMGServer`` of the parsed ``args``, models loaded and the
    warmup run when asked for; does not serve."""
    check_not_ported(args)
    # imported after parsing, so --help needs neither torch nor a card
    from omg_tpu_torch import convert, loader
    from omg_tpu_torch.nn import layers
    from omg_tpu_torch.pipelines import omg as omg_lib
    from omg_tpu_torch.segment import build_mask_provider
    from omg_tpu_torch.serving.registry import Registry, default_registry
    from omg_tpu_torch.serving.server import OMGServer

    device = layers.target_device(args.device, "serve")
    cfg, params, tok1, tok2 = loader.load_sdxl(args.pretrained_sdxl_model,
                                               device=device)
    provider = build_mask_provider(
        args.segment_type, sam_checkpoint=args.efficientViT_checkpoint,
        device=device)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok1,
                         tokenizer_2=tok2, mask_provider=provider,
                         num_steps=args.num_steps, scheduler=args.scheduler,
                         quantize=args.quantize,
                         concept_crop=args.concept_crop,
                         cache_interval=args.cache_interval,
                         cache_schedule=args.cache_schedule)
    registry = (Registry.from_json(args.registry) if args.registry
                else default_registry())

    iid = None
    if args.face_adapter_path:
        adapter_sd = convert.load_state_dict(args.face_adapter_path)
        rs_cfg = convert.infer_resampler_cfg(adapter_sd, dtype=cfg.unet.dtype)
        adapter = convert.convert_ip_adapter(adapter_sd, rs_cfg,
                                             dtype=cfg.unet.dtype,
                                             device=device)
        idnet_cfg = idnet = None
        if args.identitynet_path:
            idnet_cfg, idnet = loader.load_controlnet(args.identitynet_path,
                                                      device=device)
            engine.cn_cfg = idnet_cfg
        iid = omg_lib.InstantIDModels(
            resampler_cfg=rs_cfg, resampler_params=adapter["image_proj"],
            ip_adapter_layers=adapter["ip_adapter"],
            identitynet_params=idnet, identitynet_cfg=idnet_cfg)

    controlnets = {}
    for kind, path in (("pose", args.openpose_checkpoint),
                       ("canny", args.canny_checkpoint),
                       ("depth", args.depth_checkpoint)):
        if path:
            cn_cfg, cn = loader.load_controlnet(path, device=device)
            # the engine checks every ControlNet against one cn_cfg
            if engine.cn_cfg is not None and engine.cn_cfg != cn_cfg:
                raise ValueError(
                    f"ControlNet {kind!r} at {path} has a different "
                    f"geometry than the previously loaded ControlNets/"
                    f"IdentityNet; all loaded ControlNets must share one "
                    f"config (got {cn_cfg} vs {engine.cn_cfg})")
            engine.cn_cfg = cn_cfg
            controlnets[kind] = cn

    pose_provider = depth_provider = None
    if args.pose_detector_checkpoint:
        from omg_tpu_torch.models import openpose
        pose_provider = openpose.load_body_model(
            args.pose_detector_checkpoint, device=device)
    if args.dpt_checkpoint:
        from omg_tpu_torch.models import dpt
        depth_provider = dpt.load_depth_model(args.dpt_checkpoint,
                                              device=device)

    server = OMGServer(engine, registry, instantid=iid,
                       controlnets=controlnets, pose_provider=pose_provider,
                       depth_provider=depth_provider)
    if args.warmup:
        from omg_tpu_torch.serving.warmup import default_serving_warmup
        sample = next(iter(server.loras.values()), None)
        default_serving_warmup(
            cfg, unet_params=engine.params.unet, steps=args.num_steps,
            scheduler=args.scheduler,
            sample_lora=(sample.get("unet", sample)
                         if isinstance(sample, dict) else None),
            sample_ip_adapter=(iid.ip_adapter_layers
                               if iid is not None else None),
            vae_params=engine.params.vae,
            cache_interval=args.cache_interval,
            cache_schedule=args.cache_schedule, max_batch=server.max_batch)
    return server


def main(argv=None):
    args = parse_args(argv)
    build_server(args).serve(args.host, args.port)


if __name__ == "__main__":
    main()
