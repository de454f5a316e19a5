"""Rank entry points of the port's multi-device tests.

``launch.spawn`` runs these in fresh processes, so this module imports no
jax (and nothing that does): the ranks stay light. Every input arrives as
numpy arrays or plain containers; every result goes back as numpy.
"""

import numpy as np
import torch

from omg_tpu_torch import from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import unet, vae
from omg_tpu_torch.nn import attention
from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.parallel import comm, mesh as mesh_lib
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def rows_of(x: torch.Tensor, group: comm.Group, dim: int) -> torch.Tensor:
    """This rank's equal block of ``x`` along ``dim``."""
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n)


def left_right_masks(image, cls):
    """'man' owns the left half of the image, anyone else the right."""
    m = np.zeros(image.shape[:2], np.float32)
    half = image.shape[1] // 2
    if cls == "man":
        m[:, :half] = 1.0
    else:
        m[:, half:] = 1.0
    return m


def tiny_unet(tree) -> unet.UNet2DConditionModel:
    return from_jax.load_into(
        unet.UNet2DConditionModel(sdxl.tiny_config().unet), tree)


def tiny_vae(tree) -> vae.AutoencoderKL:
    return from_jax.load_into(vae.AutoencoderKL(sdxl.tiny_config().vae),
                              tree, skip=("encoder", "quant_conv"))


# --------------------------------------------------------------------------
# comm, mesh, layers, attention
# --------------------------------------------------------------------------

def comm_inputs(rank: int) -> torch.Tensor:
    """The rank's piece of every collective check: exact in fp64."""
    return torch.arange(24, dtype=torch.float64).reshape(2, 3, 4) + 1000 * rank


def _comm_checks(rank: int, n: int) -> dict:
    m = mesh_lib.make_mesh(n)
    x = comm_inputs(rank)
    uneven = mesh_lib.Split(2 * n - 1, m.flat)
    src = n - 1
    block = torch.arange(4 * n * 6, dtype=torch.float64).reshape(
        1, 2, 4 * n, 3)[..., 4 * rank:4 * rank + 4, :]
    out = {
        "gather": comm.all_gather(x, 1, m.flat),
        "uneven": comm.all_gather(
            torch.full((uneven.sizes[rank], 2), float(rank)), 0, m.flat,
            sizes=uneven.sizes),
        "sum": comm.all_reduce_sum(x, m.flat),
        "bcast": comm.broadcast_rows(x if rank == src else torch.zeros_like(x),
                                     src, m.flat),
        "halo1": torch.cat(comm.halo_rows(block, m.flat, 1), dim=-2),
        "halo2": torch.cat(comm.halo_rows(block, m.flat, 2), dim=-2),
    }
    out = {k: v.numpy() for k, v in out.items()}
    grids = []
    for data in sorted({1, 2, n} & {d for d in range(1, n + 1) if n % d == 0}):
        g = mesh_lib.make_mesh(n, data=data)
        grids.append((g.shape, g.coords, g.data_group.ranks,
                      g.model_group.ranks, g.flat.ranks))
    out["grids"] = grids
    latency = mesh_lib.make_latency_mesh(n)
    out["latency"] = (latency.data, latency.model)
    try:
        mesh_lib.make_latency_mesh(n + 1)
    except ValueError as e:
        out["latency_error"] = str(e)
    return out


def _layer_checks(case: dict, group: comm.Group) -> dict:
    x = t(case["x"])                                  # [B, C, H, W] NCHW
    out = {}
    for stride in (1, 2):
        conv = layers.Conv2d(x.shape[1], 16, 3, stride=stride)
        with torch.no_grad():
            conv.weight.copy_(t(case["conv_w"]))
            conv.bias.copy_(t(case["conv_b"]))
        out[f"conv{stride}"] = conv(rows_of(x, group, 2), group).numpy()
    gn = layers.GroupNorm(x.shape[1], 4)
    with torch.no_grad():
        gn.weight.copy_(t(case["gn_w"]))
        gn.bias.copy_(t(case["gn_b"]))
    out["group_norm"] = gn(rows_of(x, group, 2), group).numpy()
    model = tiny_unet(case["unet"])
    sample, ehs, pooled, tids = (t(a) for a in case["unet_inputs"])
    with torch.no_grad():
        out["unet"] = model(rows_of(sample, group, 1), 981, ehs,
                            text_embeds=pooled, time_ids=tids,
                            seq_group=group).numpy()
    return out


def _attention_checks(case: dict, data: int, model: int) -> dict:
    m = mesh_lib.make_mesh(data * model, data=data)
    lanes = mesh_lib.data_sharded(m, case["q"].shape[0])
    q, k, v = (rows_of(t(a)[lanes.lo:lanes.hi], m.model_group, 2)
               for a in (case["q"], case["k"], case["v"]))
    plain = attention.SEQ_PLAIN_CALLS
    return {"coords": m.coords,
            "wrapper": fa.flash_attention_seq_sharded(
                q, k, v, group=m.model_group).numpy(),
            "sdpa": attention.seq_sharded_sdpa(q, k, v, m.model_group).numpy(),
            "plain_calls": attention.SEQ_PLAIN_CALLS - plain}


def ops_rank(rank: int, device, case: dict) -> dict:
    """comm and mesh checks over the whole world; the spatial layers and
    the UNet forward split over all ranks (mesh (1, n)); seq-sharded
    attention on the grids named in ``case``."""
    _, n = comm.world()
    out = {"comm": _comm_checks(rank, n)}
    if "layers" in case:
        out["layers"] = _layer_checks(case["layers"],
                                      mesh_lib.make_mesh(n, data=1).model_group)
    for data, model in case.get("attention_grids", ()):
        out[f"attention{data}x{model}"] = _attention_checks(
            case["attention"], data, model)
    return out


# --------------------------------------------------------------------------
# pipelines
# --------------------------------------------------------------------------

def base_inputs(arrays, hw, guidance=7.5) -> mc.BaseInputs:
    ep, en, pp, pn = (t(a) for a in arrays)
    tids = sdxl.add_time_ids(hw, (0, 0), hw)
    return mc.make_base_inputs(ep, pp, en, pn, tids, guidance)


def concept_inputs(arrays, hw) -> mc.ConceptInputs:
    ep, en, pp, pn = (t(a) for a in arrays)
    return mc.make_concept_inputs(ep, pp, en, pn,
                                  sdxl.add_time_ids(hw, (0, 0), hw))


def stage2_resumed(case: dict, lane_sharding=None) -> np.ndarray:
    """``sample_stage2_resumed`` on the 4+2K program from a cache with no
    trajectory, over ``lane_sharding`` when given."""
    cfg = sdxl.tiny_config()
    hw = (case["hw"],) * 2
    steps = case["steps"]
    boundary = case["fusion_start"] + 1
    cache = mc.StageCache(latents=t(case["cache_latents"]),
                          sched_state=schedulers.SchedulerState(boundary),
                          a_traj=None, a_final=t(case["cache_final"]))
    ctl = p2p.P2PControl.build(["a", "a"], steps,
                               self_replace_steps=case["self_replace"],
                               width=2, height=2)
    K = case["n_concepts"]
    with torch.no_grad():
        return mc.sample_stage2_resumed(
            cfg, schedulers.make_schedule("euler", steps),
            tiny_unet(case["unet"]), cache,
            base_inputs=base_inputs(case["base"], hw), controller=ctl,
            concept_inputs=[concept_inputs(case["concept"], hw)] * K,
            concept_loras=[None] * K, masks=t(case["masks"]),
            fusion_start=case["fusion_start"],
            lane_sharding=lane_sharding,
            cache_interval=case.get("cache_interval", 0)).numpy()


def pipeline_rank(rank: int, device, case: dict) -> dict:
    """Spatial stage-1 ranges, the H-split decode and the lane-split 4+2K
    stage 2, each as ``case`` asks."""
    _, n = comm.world()
    cfg = sdxl.tiny_config()
    out = {}
    for key, run in case.get("stage1", {}).items():
        m = mesh_lib.make_mesh(n, data=run["data"])
        hw = (run["hw"],) * 2
        spatial = mc.Spatial(m, seq=run["seq"])
        plain = attention.SEQ_PLAIN_CALLS
        with torch.no_grad():
            got, _ = mc._denoise_cfg_range(
                cfg, schedulers.make_schedule("euler", run["steps"]),
                tiny_unet(run["unet"]), t(run["lat0"]), schedulers.init_state(),
                base_inputs(run["base"], hw), i0=0, i1=run["steps"],
                spatial=spatial, cache_interval=run.get("cache_interval", 0))
        out[key] = {"latents": got.numpy(),
                    "seq_calls": attention.SEQ_PLAIN_CALLS - plain}
    if "decode" in case:
        flat = mesh_lib.make_mesh(n).flat
        with torch.no_grad():
            out["decode"] = sdxl.decode_latents(
                cfg, tiny_vae(case["decode"]["vae"]),
                t(case["decode"]["latents"]), spatial=flat).numpy()
    for key, run in case.get("stage2", {}).items():
        out[key] = stage2_resumed(run, mesh_lib.make_mesh(n).flat)
    return out


def omg_rank(rank: int, device, case: dict) -> dict:
    """``OMG(mesh=make_mesh(n, data=case['data'])).generate`` on the tiny
    config, with the port's ToyTokenizer and the left/right masks."""
    _, n = comm.world()
    m = mesh_lib.make_mesh(n, data=case["data"])
    params = from_jax.sdxl_from_jax(sdxl.SDXLParams(*case["params"]),
                                    sdxl.tiny_config(), device=device)
    tok = ToyTokenizer()
    engine = omg.OMG(cfg=sdxl.tiny_config(), params=params, tokenizer=tok,
                     tokenizer_2=tok, mask_provider=left_right_masks,
                     num_steps=case["steps"], mesh=m)
    kw = dict(case["kw"])
    loras = [from_jax.lora_from_jax(c, device=device)
             for c in kw.pop("concept_loras")]
    style = from_jax.lora_from_jax(kw.pop("style_lora"), device=device)
    plain = attention.SEQ_PLAIN_CALLS
    with torch.no_grad():
        res = engine.generate(case["prompt"], concept_loras=loras,
                              style_lora=style, **kw)
    out = {"stage1": res.stage1, "stage2": res.stage2, "masks": res.masks,
           "seq_calls": attention.SEQ_PLAIN_CALLS - plain}
    if case.get("cache_interval"):
        # DeepCache on the mesh: an engine with the interval
        engine = omg.OMG(cfg=sdxl.tiny_config(), params=params,
                         tokenizer=tok, tokenizer_2=tok,
                         mask_provider=left_right_masks,
                         num_steps=case["steps"], mesh=m,
                         cache_interval=case["cache_interval"])
        with torch.no_grad():
            res = engine.generate(case["prompt"], concept_loras=loras,
                                  style_lora=style, **kw)
        out["deepcache"] = {"stage1": res.stage1, "stage2": res.stage2}
    return out


# --------------------------------------------------------------------------
# conditioned paths under the mesh layouts
# --------------------------------------------------------------------------

def _tiny_cn(tree):
    from omg_tpu_torch import config
    return from_jax.controlnet_from_jax(tree, config.tiny_controlnet(),
                                        device="cpu")


def _instantid(case) -> omg.InstantIDModels:
    from omg_tpu_torch import config
    return omg.InstantIDModels(
        resampler_cfg=config.tiny_resampler(),
        resampler_params=from_jax.resampler_from_jax(
            case["resampler"], config.tiny_resampler(), device="cpu"),
        ip_adapter_layers=from_jax.ip_layers_from_jax(
            case["ip"], config.tiny_unet(), device="cpu"),
        identitynet_params=_tiny_cn(case["identitynet"]),
        identitynet_cfg=config.tiny_controlnet())


def _cn_forward_checks(case: dict, group: comm.Group) -> dict:
    """One ControlNet forward H-split over ``group`` (every rank's rows of
    the residuals), and the embedder refusing an odd local row count."""
    cn = _tiny_cn(case["cn"])
    sample, ehs, pooled, tids, cond = (t(a) for a in case["inputs"])
    with torch.no_grad():
        down, mid = cn(rows_of(sample, group, 1), 981, ehs,
                       rows_of(cond, group, 1), text_embeds=pooled,
                       time_ids=tids, conditioning_scale=0.7,
                       seq_group=group)
        out = {"down": [r.numpy() for r in down], "mid": mid.numpy()}
        odd = torch.zeros((1, 3, 6 * group.size, 8))
        try:
            cn.controlnet_cond_embedding(rows_of(odd, group, 2), group)
        except ValueError as e:
            out["odd_error"] = str(e)
    return out


def conditioned_rank(rank: int, device, case: dict) -> dict:
    """The conditioned mesh paths ``case`` asks for: an H-split ControlNet
    forward, spatial stage-1 ranges with a base ControlNet, lane-split
    4+2K stage-2 runs with the base ControlNet, the IdentityNet and the IP
    tokens, and ``OMG(mesh=...).generate`` with a ControlNet and with
    InstantID."""
    _, n = comm.world()
    cfg = sdxl.tiny_config()
    out = {}
    if "cn_forward" in case:
        out["cn_forward"] = _cn_forward_checks(
            case["cn_forward"], mesh_lib.make_mesh(n, data=1).model_group)
    model = tiny_unet(case["unet"]) if "unet" in case else None
    for key, run in case.get("stage1", {}).items():
        m = mesh_lib.make_mesh(n, data=run["data"])
        hw = (run["hw"],) * 2
        cns = [mc.ControlNetInputs(_tiny_cn(case["cn"]), t(run["cond"]), 0.9,
                                   **run["cn_kw"])]
        plain = attention.SEQ_PLAIN_CALLS
        with torch.no_grad():
            got, _ = mc._denoise_cfg_range(
                cfg, schedulers.make_schedule("euler", run["steps"]), model,
                t(run["lat0"]), schedulers.init_state(),
                base_inputs(case["base"], hw), i0=0, i1=run["steps"],
                spatial=mc.Spatial(m, seq=run["seq"]), base_controlnets=cns)
        out[key] = {"latents": got.numpy(),
                    "seq_calls": attention.SEQ_PLAIN_CALLS - plain}
    for key, run in case.get("stage2", {}).items():
        out[key] = conditioned_stage2(case, run, mesh_lib.make_mesh(n).flat)
    if "generate" in case:
        out["generate"] = _conditioned_generate(case["generate"], n)
    return out


def conditioned_stage2(case: dict, run: dict, lane_sharding=None):
    """``sample_stage2_resumed`` on the 4+2K program (no trajectory) with
    ``run``'s base ControlNet, IdentityNet and IP tokens, over
    ``lane_sharding`` when given -> (latents, the ControlNet forwards run
    on this rank)."""
    cfg = sdxl.tiny_config()
    hw = (run["hw"],) * 2
    steps, fs = run["steps"], run["fusion_start"]
    cache = mc.StageCache(latents=t(run["cache_latents"]),
                          sched_state=schedulers.SchedulerState(fs + 1),
                          a_traj=None, a_final=t(run["cache_latents"]))
    ctl = p2p.P2PControl.build(["a", "a"], steps, self_replace_steps=0.4,
                               width=2, height=2)
    tokens = [t(x) for x in run["ip_tokens"]]
    concepts = [concept_inputs(case["base"], hw)._replace(ip_context=tok)
                for tok in tokens]
    base_cns, concept_cns, ip = [], [], ()
    if run.get("base_cn"):
        base_cns = [mc.ControlNetInputs(_tiny_cn(case["cn"]), t(run["cond"]),
                                        0.9, **run["base_cn"])]
    if run.get("identitynet"):
        idn = _tiny_cn(case["identitynet"])
        concept_cns = [mc.ControlNetInputs(idn, t(run["kps"]), 0.8,
                                           encoder_hidden_states=tok)
                       for tok in tokens]
        from omg_tpu_torch import config
        ip = [from_jax.ip_layers_from_jax(case["ip"], config.tiny_unet(),
                                          device="cpu")] * len(tokens)
    forwards = []
    for m in {c.params for c in base_cns + concept_cns}:
        m.register_forward_hook(lambda mod, a, o: forwards.append(
            a[0].shape[0]))
    with torch.no_grad():
        got = mc.sample_stage2_resumed(
            cfg, schedulers.make_schedule("euler", steps),
            tiny_unet(case["unet"]), cache,
            base_inputs=base_inputs(case["base"], hw), controller=ctl,
            concept_inputs=concepts, concept_loras=[None] * len(tokens),
            masks=t(run["masks"]), fusion_start=fs,
            concept_ip_adapters=ip, ip_scale=0.8, base_controlnets=base_cns,
            concept_controlnets=concept_cns, lane_sharding=lane_sharding)
    return {"latents": got.numpy(), "cn_lanes": forwards}


def _conditioned_generate(case: dict, n: int) -> dict:
    """``OMG(mesh=make_mesh(n, data=2)).generate`` with a spatial
    ControlNet, then with InstantID (keypoints from a provider that sees
    the stage-1 image)."""
    from omg_tpu_torch import config
    m = mesh_lib.make_mesh(n, data=case["data"])
    params = from_jax.sdxl_from_jax(sdxl.SDXLParams(*case["params"]),
                                    sdxl.tiny_config(), device="cpu")
    tok = ToyTokenizer()
    engine = omg.OMG(cfg=sdxl.tiny_config(), params=params, tokenizer=tok,
                     tokenizer_2=tok, mask_provider=left_right_masks,
                     cn_cfg=config.tiny_controlnet(), num_steps=case["steps"],
                     mesh=m)
    out = {}
    seen = []

    def provider(image):
        seen.append(np.array(image))
        return case["kps_image"]
    with torch.no_grad():
        res = engine.generate(case["prompt"],
                              controlnet_params=_tiny_cn(case["cn"]),
                              **case["kw"], **case["cn_kw"])
        out["controlnet"] = (res.stage1, res.stage2)
        res = engine.generate(case["prompt"], instantid=_instantid(case),
                              face_kps_provider=provider, **case["kw"],
                              **case["iid_kw"])
        out["instantid"] = (res.stage1, res.stage2)
    out["kps_seen"] = seen
    return out


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

def tp_unet_config(kind: str):
    """"tiny": the tiny UNet (8 heads at its attention level); "mixed": two
    attention levels of 4 and 6 heads, so a 4-way model axis splits one
    along heads and not the other."""
    import dataclasses
    cfg = sdxl.tiny_config().unet
    if kind == "mixed":
        cfg = dataclasses.replace(cfg, block_out_channels=(32, 48),
                                  transformer_layers_per_block=(1, 1))
    return cfg


def tp_rank(rank: int, device, case: dict) -> dict:
    """For each grid of ``case``: one UNet forward (4 lanes, P2P inside
    its window, LoRA, IP tokens) with the attention split over the model
    axis, the same after W8A8, and one split int8 ``to_q`` and ``to_out``
    alone; every output whole on every rank."""
    import copy
    from omg_tpu_torch.ops import quant
    from omg_tpu_torch.parallel import sharding
    _, n = comm.world()
    out = {}
    for key, run in case.items():
        m = mesh_lib.make_mesh(n, data=run["data"])
        ucfg = tp_unet_config(run["unet"])
        model = unet.init_params(torch.Generator().manual_seed(3), ucfg)
        ip = unet.init_ip_layers(torch.Generator().manual_seed(4), ucfg)
        lora = from_jax.lora_from_jax(run["lora"], device="cpu")
        sample, ehs, pooled, tids, ip_ctx = (t(a) for a in run["inputs"])
        ctl = p2p.P2PControl.build(["a", "a"], 4, self_replace_steps=0.5,
                                   width=4, height=4)
        res = {}
        for name, unet_m in (("plain", model),
                             ("w8a8", quant.quantize_unet(model))):
            split = sharding.shard_params(
                copy.deepcopy(unet_m), sharding.unet_tp_sharding(unet_m, m))
            with torch.no_grad():
                res[name] = split(
                    sample, 961, ehs, text_embeds=pooled, time_ids=tids,
                    lora=lora, control=ctl.at_step(1), ip_adapter=ip,
                    ip_context=ip_ctx, ip_scale=0.7).numpy()
            if name == "w8a8":
                blk = split.mid_block.attentions[0].transformer_blocks[0]
                x = t(run["linear_x"])
                with torch.no_grad():
                    res["q_linear"] = blk.attn1.to_q(x).numpy()
                    cols = blk.attn1.to_out[0].tp.split
                    res["out_linear"] = blk.attn1.to_out[0](
                        x[..., cols.lo:cols.hi]).numpy()
                res["q_rows"] = blk.attn1.to_q.weight_q.shape[0]
        out[key] = res
    return out
