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
