"""ControlNet and InstantID under the mesh layouts, on four CPU ranks
(``gloo``), (data, model) = (2, 2): one ControlNet forward H-split, the
spatial stage 1 with a base ControlNet (H split and lane-only, guess mode
under the data split), the lane-split 4+2K stage 2 with the base
ControlNet, the IdentityNet and the IP tokens, and ``OMG(mesh=...)
.generate`` with a ControlNet and with InstantID against JAX's unsharded
``generate``. The reference has no mesh test of these paths, so the
unsharded programs are the reference: latents within 2e-4
(tests/test_parallel.py's bound), uint8 images within one level."""

import jax
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import instantid as jiid
from omg_tpu.models import controlnet as jcn
from omg_tpu.models import resampler as jrs
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.parallel import launch
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, normal, numpy_params,
                                tiny_sdxl_numpy, to_jax)

ATOL = 2e-4
PROMPT = "photo of the man and the woman at the beach"
REWRITE = "[photo of the man]-*-[ugly]|[photo of the woman]-*-[blurry]"
GEN_HW = 64
GEN_STEPS = 4


def _kps_image(hw):
    kps = [np.float32([[6, 8], [12, 8], [9, 11], [7, 14], [11, 14]]) * hw / 32,
           np.float32([[20, 8], [26, 8], [23, 11], [21, 14], [25, 14]])
           * hw / 32]
    return jiid.draw_kps(hw, hw, kps)


@pytest.fixture(scope="module")
def case():
    """Every input of the rank workers (numpy), and the ranks' results
    from one spawn."""
    rng = np.random.default_rng(60)
    ucfg = jconfig.tiny_unet()
    d, dim = ucfg.cross_attention_dim, ucfg.block_out_channels[-1]
    tree = tiny_sdxl_numpy(seed=61)
    cn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 62)
    idn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 63)
    rs_tree = numpy_params(jrs.init_params, jconfig.tiny_resampler(), 64)
    n_ip = junet.num_cross_attention_layers(ucfg)
    ip_tree = [{k: {"weight": normal(rng, d, dim, scale=d ** -0.5)}
                for k in ("to_k_ip", "to_v_ip")} for _ in range(n_ip)]
    base = [normal(rng, 1, 77, d), normal(rng, 1, 77, d),
            normal(rng, 1, 16), normal(rng, 1, 16)]
    stage1 = {}
    for key, hw, seq, cn_kw in (
            ("s22", 64, True, {}),
            ("s22guess", 64, True, {"guess_mode": True}),
            ("lanes22guess", 48, False,
             {"guess_mode": True, "guidance_start": 0.5})):
        stage1[key] = dict(hw=hw, data=2, seq=seq, steps=2, cn_kw=cn_kw,
                           lat0=normal(rng, 1, hw // 8, hw // 8, 4),
                           cond=rng.random((1, hw, hw, 3), np.float32))
    masks = np.zeros((2, 4, 4), np.float32)
    masks[0, :, :2], masks[1, :, 2:] = 1.0, 1.0
    common2 = dict(hw=32, steps=4, fusion_start=1, masks=masks,
                   cache_latents=normal(rng, 1, 4, 4, 4),
                   ip_tokens=[normal(rng, 2, 4, d), normal(rng, 2, 4, d)],
                   cond=rng.random((1, 32, 32, 3), np.float32),
                   kps=rng.random((1, 32, 32, 3), np.float32))
    stage2 = {"guess_iid": dict(common2, base_cn={"guess_mode": True},
                                identitynet=True),
              "cn": dict(common2, base_cn={"guidance_end": 0.75},
                         identitynet=False)}
    cn_in = [normal(rng, 2, GEN_HW // 8, GEN_HW // 8, 4),
             normal(rng, 2, 77, d), normal(rng, 2, 16),
             np.tile(np.float32([64, 64, 0, 0, 64, 64]), (2, 1)),
             rng.random((2, GEN_HW, GEN_HW, 3), np.float32)]
    gen = dict(
        data=2, steps=GEN_STEPS, prompt=PROMPT, params=tuple(tree),
        cn=cn_tree, identitynet=idn_tree, resampler=rs_tree, ip=ip_tree,
        kps_image=_kps_image(GEN_HW),
        kw=dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=14,
                height=GEN_HW, width=GEN_HW,
                initial_noise=normal(rng, 1, GEN_HW // 8, GEN_HW // 8, 4)),
        cn_kw=dict(spatial_condition=rng.integers(
            0, 256, (GEN_HW, GEN_HW, 3), dtype=np.uint8),
            controlnet_scale=0.9, controlnet_guess_mode=True),
        iid_kw=dict(face_embeddings=[normal(rng, 16), normal(rng, 16)],
                    guidance_scale=3.0))
    out = dict(unet=tree.unet, cn=cn_tree, identitynet=idn_tree, ip=ip_tree,
               base=base, stage1=stage1, stage2=stage2, generate=gen,
               cn_forward={"cn": cn_tree, "inputs": cn_in})
    out["ranks"] = launch.spawn(workers.conditioned_rank, 4, backend="gloo",
                                args=(out,), timeout=300)
    return out


def test_controlnet_forward_split_by_rows(case):
    """The H-split forward's residuals, rows gathered in rank order, equal
    the unsharded forward's; a stride-2 conv over an odd local row count
    raises."""
    cn = workers._tiny_cn(case["cn"])
    sample, ehs, pooled, tids, cond = map(workers.t,
                                          case["cn_forward"]["inputs"])
    with torch.no_grad():
        down, mid = cn(sample, 981, ehs, cond, text_embeds=pooled,
                       time_ids=tids, conditioning_scale=0.7)
    # (data, model) = (1, 4): every rank holds a quarter of the rows
    got = [r["cn_forward"] for r in case["ranks"]]
    for j, want in enumerate(down):
        np.testing.assert_allclose(
            np.concatenate([g["down"][j] for g in got], axis=2),
            want.numpy(), atol=ATOL, err_msg=f"down {j}")
    np.testing.assert_allclose(np.concatenate([g["mid"] for g in got], 2),
                               mid.numpy(), atol=ATOL)
    assert all("even count" in g["odd_error"] for g in got)


@pytest.mark.parametrize("key", ["s22", "s22guess", "lanes22guess"])
def test_spatial_stage1_with_controlnet(case, key):
    """Every rank ends with the unsharded range's latents; the split
    layouts ran their self-attention sequence-sharded (the ControlNet's
    too: more such calls with it than without), the lane-only one did
    not. In guess mode the rank pair holding the unconditional lane runs
    no ControlNet."""
    run = case["stage1"][key]
    hw = (run["hw"],) * 2
    cns = [mc.ControlNetInputs(workers._tiny_cn(case["cn"]),
                               workers.t(run["cond"]), 0.9, **run["cn_kw"])]
    with torch.no_grad():
        want, _ = mc._denoise_cfg_range(
            sdxl.tiny_config(), schedulers.make_schedule("euler",
                                                         run["steps"]),
            workers.tiny_unet(case["unet"]), workers.t(run["lat0"]),
            schedulers.init_state(), workers.base_inputs(case["base"], hw),
            i0=0, i1=run["steps"], base_controlnets=cns)
    calls = []
    for r, res in enumerate(case["ranks"]):
        np.testing.assert_allclose(res[key]["latents"], want.numpy(),
                                   atol=ATOL, err_msg=f"rank {r}")
        calls.append(res[key]["seq_calls"])
    if not run["seq"]:
        assert calls == [0] * 4
        return
    # the UNet's 4 self-attentions (tiny geometry: level 1 down, mid and
    # two up) a step on every rank; the ControlNet's 2 where it runs
    unet_only, cn = 4 * run["steps"], 2 * run["steps"]
    if run["cn_kw"].get("guess_mode"):
        assert calls == [unet_only] * 2 + [unet_only + cn] * 2
    else:
        assert calls == [unet_only + cn] * 4


def _jax_stage2(case, run):
    """JAX's unsharded 4+2K program on ``run``'s inputs."""
    import jax.numpy as jnp
    from omg_tpu.control import p2p as jp2p
    from omg_tpu.diffusion import schedulers as jsched
    hw = (run["hw"],) * 2
    ep, en, pp, pn = map(jnp.asarray, case["base"])
    tids = jsdxl.add_time_ids(hw, (0, 0), hw)
    base = jmc.make_base_inputs(ep, pp, en, pn, tids, 7.5)
    toks = [jnp.asarray(x) for x in run["ip_tokens"]]
    concepts = [jmc.make_concept_inputs(ep, pp, en, pn, tids, ip_context=x)
                for x in toks]
    cn = to_jax(case["cn"])
    base_cns = [jmc.ControlNetInputs(cn, jnp.asarray(run["cond"]),
                                     jnp.float32(0.9), **run["base_cn"])]
    concept_cns, ip = [], ()
    if run["identitynet"]:
        idn = to_jax(case["identitynet"])
        concept_cns = [jmc.ControlNetInputs(idn, jnp.asarray(run["kps"]),
                                            jnp.float32(0.8),
                                            encoder_hidden_states=x)
                       for x in toks]
        ip = [to_jax(case["ip"])] * 2
    sched = jsched.make_schedule("euler", run["steps"])
    lat = jnp.asarray(run["cache_latents"])
    cache = jmc.StageCache(
        latents=lat, sched_state=jsched.init_state(sched, lat.shape)._replace(
            step_count=jnp.int32(run["fusion_start"] + 1)),
        a_traj=None, a_final=lat)
    return np.asarray(jmc.sample_stage2_resumed(
        jsdxl.tiny_config(), sched, to_jax(case["unet"]), cache,
        base_inputs=base,
        controller=jp2p.P2PControl.build(["a", "a"], run["steps"],
                                         self_replace_steps=0.4, width=2,
                                         height=2),
        concept_inputs=concepts, concept_loras=[None, None],
        masks=jnp.asarray(run["masks"]), fusion_start=run["fusion_start"],
        concept_ip_adapters=ip, ip_scale=0.8,
        base_controlnets=base_cns, concept_controlnets=concept_cns,
        cn_cfg=jconfig.tiny_controlnet()))


@pytest.mark.parametrize("key", ["guess_iid", "cn"])
def test_lane_split_stage2_with_controlnets(case, key):
    """8 lanes over 4 ranks, 2 each: the unsharded port's and JAX's 4+2K
    program on every rank. Each rank runs only the ControlNet forwards its
    lanes need: in guess mode rank 0 (both unconditional base lanes) runs
    none, rank 1 the base ControlNet on its 2 conditional lanes, ranks 2
    and 3 the IdentityNet on their concept pair."""
    run = case["stage2"][key]
    want = workers.conditioned_stage2(case, run)
    np.testing.assert_allclose(want["latents"], _jax_stage2(case, run),
                               atol=5e-4)
    steps = run["steps"] - run["fusion_start"] - 1
    for r, res in enumerate(case["ranks"]):
        np.testing.assert_allclose(res[key]["latents"], want["latents"],
                                   atol=ATOL, err_msg=f"rank {r}")
    lanes = [res[key]["cn_lanes"] for res in case["ranks"]]
    if key == "guess_iid":
        assert lanes == [[], [2] * steps, [2] * steps, [2] * steps]
        assert want["cn_lanes"] == [2, 4] * steps
    else:
        # the window drops the base ControlNet on the last step (3/4 <
        # 4/4); the concept ranks run none
        assert lanes == [[2], [2], [], []]


def _jax_generate(case, kind):
    gen = case["generate"]
    tok = ToyTokenizer()
    eng = jomg.OMG(cfg=jsdxl.tiny_config(),
                   params=to_jax(jsdxl.SDXLParams(*gen["params"])),
                   tokenizer=tok, tokenizer_2=tok,
                   mask_provider=left_right_masks, num_steps=gen["steps"],
                   cn_cfg=jconfig.tiny_controlnet())
    if kind == "controlnet":
        return eng.generate(PROMPT, controlnet_params=to_jax(gen["cn"]),
                            **gen["kw"], **gen["cn_kw"])
    rs = jax.tree.map(lambda x: x, gen["resampler"])
    for attn, _ in rs["layers"]:
        # the JAX resampler's q/k scale is the reference's defect: this
        # rescale makes both compute upstream's function
        attn["to_q"] = {"weight": attn["to_q"]["weight"] * 8 ** 0.5}
    iid = jomg.InstantIDModels(
        resampler_cfg=jconfig.tiny_resampler(), resampler_params=to_jax(rs),
        ip_adapter_layers=to_jax(gen["ip"]),
        identitynet_params=to_jax(gen["identitynet"]),
        identitynet_cfg=jconfig.tiny_controlnet())
    return eng.generate(PROMPT, instantid=iid,
                        face_kps_provider=lambda img: gen["kps_image"],
                        **gen["kw"], **gen["iid_kw"])


@pytest.mark.parametrize("kind", ["controlnet", "instantid"])
def test_mesh_generate_matches_jax(case, kind):
    """``OMG(mesh=(2, 2)).generate`` with a spatial ControlNet (guess
    mode) and with InstantID on every rank: identical images, within one
    uint8 level of JAX's unsharded engine; the keypoint provider saw the
    whole stage-1 image on every rank."""
    want = _jax_generate(case, kind)
    ranks = [res["generate"] for res in case["ranks"]]
    for r, res in enumerate(ranks):
        for name, got in zip(("stage1", "stage2"), res[kind]):
            w = getattr(want, name)
            assert w is not None and got.shape == w.shape, (name, r)
            assert np.abs(got.astype(int) - w.astype(int)).max() <= 1, \
                (kind, name, r)
            np.testing.assert_array_equal(got, ranks[0][kind][
                ("stage1", "stage2").index(name)])
        (seen,) = res["kps_seen"]
        np.testing.assert_array_equal(seen, res["instantid"][0][1])
