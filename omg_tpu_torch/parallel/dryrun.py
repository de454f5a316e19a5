"""A dry run of the sharded programs on n ranks at the tiny geometry (the
port's counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m omg_tpu_torch.parallel.dryrun [N] [--device cpu]

starts N ``gloo`` ranks (on the card by default, every rank on
``cuda:{rank % device_count}``; ``--device cpu`` for CPU ranks) over a
(data, model) grid, model = 2 when N is even, and runs the scenarios that
``parallel/sharding.py`` serves, each held against the unsharded program:

  1. one ``multiconcept_step`` (P2P, two concepts with LoRA, fusion on)
     under DP x TP: one request per data row (``request_sharding``), the
     UNet's attention split over the model axis (``unet_tp_sharding``,
     ``shard_params``);
  5. the full two-stage program (``two_stage_latents``) with N requests,
     one per rank, gathered in rank order;
  7. scenario 5 under LCM at 4 steps: every request re-noises from its
     own seed, so the requests' latents differ.

It prints one ``dryrun_multichip OK: ...`` line per scenario after that
scenario's checks, and raises on a failed one. The JAX dry run's other
scenarios (the lane-split stage 2, the sequence-sharded kernel, the
spatial stage 1, the engine's mesh mode with and without DeepCache and
the lane-only bucket) are the mesh programs that
``tests/port/test_torch_parallel_{ops,stage1,stage2,omg}.py`` hold.
"""

from __future__ import annotations

import argparse
import copy

import torch

from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import layers
from omg_tpu_torch.parallel import comm, launch, mesh as mesh_lib
from omg_tpu_torch.parallel import sharding
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import sdxl

H = W = 32          # latent 4x4, as the JAX dry run
STEPS = 8
STEP = 4
LCM_STEPS = 4
# fp32 (TF32 off on a card): the split sums the attention's partial
# products in another order
ATOL = 2e-4


def _inputs(device) -> dict:
    """Every rank's copy of the tiny weights and inputs, drawn from fixed
    seeds (the rank checks the weights are replicated)."""
    cfg = sdxl.tiny_config()
    gen = torch.Generator(device).manual_seed(0)
    unet = unet_lib.init_params(gen, cfg.unet, device)
    g = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)
    d = cfg.unet.cross_attention_dim
    p = cfg.text_encoder_2.projection_dim
    ep, en, pp, pn = randn(1, 77, d), randn(1, 77, d), randn(1, p), \
        randn(1, p)
    tids = sdxl.add_time_ids((H, W), (0, 0), (H, W), device=device)
    dim = cfg.unet.block_out_channels[-1]
    key = "mid_block.attentions.0.transformer_blocks.0.attn2.to_q"
    lora = {key: {"down": randn(dim, 4, scale=0.2), "up": randn(4, dim,
                                                               scale=0.2),
                  "scale": torch.tensor(1.0, device=device)}}
    m = torch.zeros((2, H // 8, W // 8), device=device)
    m[0, :, :W // 16], m[1, :, W // 16:] = 1.0, 1.0
    return dict(
        cfg=cfg, unet=unet, masks=m, loras=(lora, lora),
        base=mc.make_base_inputs(ep, pp, en, pn, tids, 7.5),
        concepts=(mc.make_concept_inputs(ep, pp, en, pn, tids),) * 2,
        noise=[randn(1, H // 8, W // 8, 4) for _ in range(8)])


def _step(x, inp, unet) -> torch.Tensor:
    """Scenario 1's step on one request's latents [2, h, w, 4]."""
    sched = schedulers.make_schedule("euler", STEPS)
    ctl = p2p.P2PControl.build(["x", "x"], STEPS, self_replace_steps=0.4,
                               width=2, height=2, device=x.device)
    out, _ = mc.multiconcept_step(
        inp["cfg"], sched, unet, x, schedulers.init_state(), STEP,
        inp["base"], ctl, inp["concepts"], inp["loras"], inp["masks"], True,
        fusion_start=1)
    return out


def _two_stage(inp, kind: str, steps: int, r: int) -> torch.Tensor:
    """Request r of scenarios 5 and 7: both stages from its own noise and
    seed -> [2, 2, h, w, 4] (stage 1, stage 2)."""
    sched = schedulers.make_schedule(kind, steps)
    ctl = p2p.P2PControl.build(["x", "x"], steps, self_replace_steps=0.4,
                               width=2, height=2,
                               device=inp["noise"][0].device)
    lat0 = schedulers.scale_initial_noise(sched, inp["noise"][r])
    s1, s2 = mc.two_stage_latents(
        inp["cfg"], sched, inp["unet"], lat0, inp["base"], ctl,
        inp["concepts"], (None, None), inp["masks"], fusion_start=1,
        noise_seed=7 + r)
    return torch.stack([s1, s2])


def _rank(rank: int, device, n: int) -> dict:
    # the checks are fp32 ones: no TF32 in a card's matmuls and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = 2 if n % 2 == 0 else 1
    mesh = mesh_lib.make_mesh(n, model=model, device=device)
    out = {}
    with torch.inference_mode():
        inp = _inputs(device)
        mesh_lib.replicated(mesh, inp["unet"])
        # scenario 1: DP over requests x TP over attention heads
        reqs = sharding.request_sharding(mesh, mesh.data)
        lat_r = [mc.duplicate_latents(inp["noise"][r])
                 for r in range(mesh.data)]
        tp = sharding.shard_params(
            copy.deepcopy(inp["unet"]),
            sharding.unet_tp_sharding(inp["unet"], mesh))
        mine = torch.stack([_step(lat_r[r], inp, tp)
                            for r in range(reqs.lo, reqs.hi)])
        got = comm.all_gather(mine, 0, mesh.data_group, sizes=reqs.sizes)
        want = torch.stack([_step(x, inp, inp["unet"]) for x in lat_r])
        q = tp.mid_block.attentions[0].transformer_blocks[0].attn1.to_q
        out["tp"] = dict(
            shape=tuple(got.shape), data=mesh.data, model=mesh.model,
            err=float((got - want).abs().max()),
            finite=bool(torch.isfinite(got).all()),
            q_rows=(q.weight.shape[0], inp["unet"].mid_block.attentions[0]
                    .transformer_blocks[0].attn1.to_q.weight.shape[0]),
            split=isinstance(q.tp, layers.TPSplit))
        # scenarios 5 and 7: one request per rank over the flat axis
        for name, kind, steps in (("dp", "euler", 2 * LCM_STEPS),
                                  ("dp_lcm", "lcm", LCM_STEPS)):
            mine = _two_stage(inp, kind, steps, rank)[None]
            got = comm.all_gather(mine, 0, mesh.flat)
            rec = dict(shape=tuple(got.shape),
                       finite=bool(torch.isfinite(got).all()),
                       distinct=not torch.allclose(got[0, 1], got[1, 1]))
            if rank == 0:
                want = torch.stack([_two_stage(inp, kind, steps, r)
                                    for r in range(n)])
                rec["err"] = float((got - want).abs().max())
            out[name] = rec
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n: int, device: str = "cuda") -> list:
    """Run the dry run on ``n`` gloo ranks on ``device``; print and return
    each scenario's line."""
    if device == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                               "device='cpu' for CPU ranks")
        devices = [f"cuda:{r % count}" for r in range(n)]
    else:
        devices = [device] * n
    ranks = launch.spawn(_rank, n, backend="gloo", devices=devices,
                         args=(n,), timeout=600)
    lines = []
    tp = ranks[0]["tp"]
    for r, res in enumerate(ranks):
        t = res["tp"]
        _check(t["finite"] and t["err"] < ATOL,
               f"rank {r}: DP x TP step err {t['err']:.3e}")
        _check(t["split"] and t["q_rows"][0] * tp["model"] == t["q_rows"][1]
               or tp["model"] == 1, f"rank {r}: to_q not split {t['q_rows']}")
    lines.append(f"dryrun_multichip OK: mesh {tp['data']}x{tp['model']} "
                 f"(data x model), step out {tp['shape']}, TP to_q rows "
                 f"{tp['q_rows'][0]} of {tp['q_rows'][1]} per rank, max err "
                 f"vs unsharded {max(r['tp']['err'] for r in ranks):.2e}")
    for name, what in (("dp", "throughput DP - full two-stage program"),
                       ("dp_lcm", "throughput DP x LCM - few-step "
                                  "stochastic sampling")):
        rec = ranks[0][name]
        _check(all(r[name]["finite"] for r in ranks)
               and rec["shape"][0] == n and rec["err"] < ATOL,
               f"{name}: err {rec['err']:.3e}, shape {rec['shape']}")
        if name == "dp_lcm":
            _check(rec["distinct"], "LCM requests gave equal latents")
        lines.append(f"dryrun_multichip OK: {what}, {n} requests "
                     f"one-per-rank, out {rec['shape']}, max err vs "
                     f"serial {rec['err']:.2e}")
    for line in lines:
        print(line)
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser("omg_tpu_torch.parallel.dryrun")
    p.add_argument("n", nargs="?", default=2, type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
