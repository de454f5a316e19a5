"""Serving entry point (port of ``omg_tpu/cli/serve.py``).

    python -m omg_tpu_torch.cli.serve --pretrained_sdxl_model <dir> \
        --registry registry.json --port 7861

The JAX CLI's flags, plus ``--device`` (the card unless ``cpu`` is asked
for). Loads SDXL and the SAM mask provider from files, a registry, the
InstantID stack (``--face_adapter_path``, ``--identitynet_path``) and one
ControlNet per condition kind, all of one geometry; ``--warmup`` runs
``serving.warmup.default_serving_warmup`` before serving.

Options the port does not have yet raise ``NotImplementedError`` before
any weight loads: ``--mesh`` (ROADMAP §1 item 8), ``--quantize``,
``--concept_crop`` and ``--cache_interval`` > 1 or ``--cache_schedule
front`` (item 6, approximate modes), ``--pose_detector_checkpoint`` and
``--dpt_checkpoint`` (item 4, the condition preprocessors).
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
                   help="OpenPose body model (photo -> pose); not ported")
    p.add_argument("--dpt_checkpoint", default="",
                   help="DPT depth model (photo -> depth); not ported")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8 W8A8 transformer GEMMs; not ported")
    p.add_argument("--scheduler", default="euler",
                   choices=["euler", "ddim", "dpmpp_2m", "lcm"],
                   help="lcm + --num_steps 8 is the few-step serving mode "
                        "(needs an LCM-LoRA'd checkpoint)")
    p.add_argument("--concept_crop", action="store_true",
                   help="stage-2 concept lanes on strips; not ported")
    p.add_argument("--cache_interval", default=0, type=int, metavar="N",
                   help="DeepCache; not ported (0 = exact)")
    p.add_argument("--cache_schedule", default="uniform",
                   choices=["uniform", "front"],
                   help="DeepCache full-step placement; not ported")
    p.add_argument("--mesh", default=0, type=int, metavar="N",
                   help="multi-device latency mode; not ported to the CLI "
                        "(0 = one device)")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


def check_not_ported(args) -> None:
    """Raise for the options the port does not have yet, before loading."""
    from omg_tpu_torch.cli.inference_lora import check_not_ported as common
    common(args)
    if args.quantize or args.concept_crop:
        raise NotImplementedError(
            "--quantize / --concept_crop: the approximate modes are not "
            "ported yet (ROADMAP §1 item 6)")
    if args.pose_detector_checkpoint or args.dpt_checkpoint:
        raise NotImplementedError(
            "--pose_detector_checkpoint / --dpt_checkpoint: the OpenPose "
            "and DPT condition preprocessors are not ported yet (ROADMAP "
            "§1 item 4); send pose and depth maps precomputed")


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
                         num_steps=args.num_steps, scheduler=args.scheduler)
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

    server = OMGServer(engine, registry, instantid=iid,
                       controlnets=controlnets)
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
            vae_params=engine.params.vae, max_batch=server.max_batch)
    return server


def main(argv=None):
    args = parse_args(argv)
    build_server(args).serve(args.host, args.port)


if __name__ == "__main__":
    main()
