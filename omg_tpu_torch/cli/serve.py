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
per request).

``--mesh N`` serves over the multi-device latency mode: N rank processes
(``launch.spawn``: NCCL when the host has N cards, gloo when ranks share
one or run on the CPU), each loading every model and building the same
server over ``OMG(mesh=make_latency_mesh(N))``. Rank 0 binds HTTP and
hands each job group it runs to the others (``serving/mesh.py``), which
run it in step. SIGTERM or SIGINT stops every rank. Run inside a world
already started (``torch.distributed`` initialized), this process is
one rank of it, and a world of fewer than N ranks is ``SystemExit``.
"""

from __future__ import annotations

import argparse

# too few ranks for --mesh is a SystemExit carrying make_latency_mesh's
# message, as in the LoRA CLI
from omg_tpu_torch.cli.inference_lora import latency_mesh


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
                   help="multi-device latency mode over N ranks: stage 1 "
                        "split over (CFG lanes x latent rows), stage 2 "
                        "over lanes; rank 0 serves (0 = one device)")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


# A mesh server's limit for any one collective (loading every model on
# each rank included); the run itself has none.
MESH_TIMEOUT_S = 3600.0


def build_server(args, mesh=None):
    """The ``OMGServer`` of the parsed ``args``, models loaded and the
    warmup run when asked for; does not serve. ``mesh``: this rank's
    latency mesh (the models load on its device, and the server gets the
    rank's job handover)."""
    # imported after parsing, so --help needs neither torch nor a card
    from omg_tpu_torch import convert, loader
    from omg_tpu_torch.nn import layers
    from omg_tpu_torch.pipelines import omg as omg_lib
    from omg_tpu_torch.segment import build_mask_provider
    from omg_tpu_torch.serving.registry import Registry, default_registry
    from omg_tpu_torch.serving.server import OMGServer

    device = layers.target_device(
        mesh.device if mesh is not None else args.device, "serve")
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
                         cache_schedule=args.cache_schedule, mesh=mesh)
    registry = (Registry.from_json(args.registry) if args.registry
                else default_registry())

    iid = None
    if args.face_adapter_path:
        adapter_sd = convert.load_state_dict(args.face_adapter_path)
        rs_cfg = convert.infer_resampler_cfg(adapter_sd, dtype=cfg.unet.dtype)
        adapter = convert.convert_ip_adapter(adapter_sd, rs_cfg,
                                             unet_cfg=cfg.unet,
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

    handover = None
    if mesh is not None:
        from omg_tpu_torch.serving.mesh import Handover
        handover = Handover(mesh.rank, mesh.size)
    server = OMGServer(engine, registry, instantid=iid,
                       controlnets=controlnets, pose_provider=pose_provider,
                       depth_provider=depth_provider, handover=handover)
    if args.warmup:
        from omg_tpu_torch.serving.warmup import default_serving_warmup
        if mesh is not None and mesh.rank == 0:
            print("warmup note: the warmup runs the one-device programs on "
                  "every rank; the mesh layout's first request at each "
                  "(resolution, concept count) is its first run", flush=True)
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
    if not args.mesh:
        build_server(args).serve(args.host, args.port)
        return
    import torch.distributed as dist
    if dist.is_initialized():
        return serve_rank(args, latency_mesh(args, args.device))
    return spawn_mesh(args)


def spawn_mesh(args) -> None:
    """Start ``--mesh`` ranks on ``--device`` and serve until stopped:
    SIGTERM or SIGINT of this process stops every rank."""
    import signal

    from omg_tpu_torch.parallel import launch

    def interrupt(*_):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, interrupt)
    devices, backend = launch.mesh_devices(args.mesh, args.device, "serve")
    try:
        launch.spawn(_mesh_rank, args.mesh, backend=backend, devices=devices,
                     args=(vars(args),), timeout=MESH_TIMEOUT_S,
                     limit_run=False)
    except KeyboardInterrupt:
        pass        # spawn stopped the ranks on its way out


def _mesh_rank(rank: int, device, args: dict) -> None:
    """One rank of ``--mesh`` (``launch.spawn`` runs it in its own
    process)."""
    args = argparse.Namespace(**args)
    serve_rank(args, latency_mesh(args, device))


def serve_rank(args, mesh) -> None:
    """This rank's server over ``mesh``: rank 0 serves, the others
    follow."""
    from omg_tpu_torch.serving import mesh as mesh_serving
    mesh_serving.serve(build_server(args, mesh), args.host, args.port)



if __name__ == "__main__":
    main()
