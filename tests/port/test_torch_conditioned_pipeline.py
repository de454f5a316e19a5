"""The conditioned paths of ``OMG.generate`` against the JAX engine at the
tiny config: a spatial ControlNet (default window, partial window, guess
mode; BASELINE config #3), InstantID with an IdentityNet (config #4),
DDIM, DPM++2M and LCM (JAX's draws injected), the 4+2K program against
the 3+2K one, and the mesh layout refusing the conditioned paths. uint8
images within 1, latents within 5e-4 (tests/test_golden.py's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import instantid as jiid
from omg_tpu.control import p2p as jp2p
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import controlnet as jcn
from omg_tpu.models import resampler as jrs
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import controlnet
from omg_tpu_torch.parallel import mesh as mesh_lib
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, normal, numpy_params, t,
                                tiny_sdxl, to_jax)

LATENT_ATOL = 5e-4
H = W = 32
PROMPT = "photo of the man and the woman at the beach"
REWRITE = "[photo of the man]-*-[ugly]|[photo of the woman]-*-[blurry]"


@pytest.fixture(scope="module")
def setup():
    jp, tp = tiny_sdxl(seed=12)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=4)
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp,
                    cn_cfg=jconfig.tiny_controlnet(), **kw)
    teng = omg.OMG(cfg=sdxl.tiny_config(), params=tp,
                   cn_cfg=config.tiny_controlnet(), **kw)
    cn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 20)
    rng = np.random.default_rng(21)
    return dict(
        jeng=jeng, teng=teng, jcn=to_jax(cn_tree),
        tcn=from_jax.controlnet_from_jax(cn_tree, config.tiny_controlnet(),
                                         device="cpu"),
        cond=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        noise=normal(rng, 1, H // 8, W // 8, 4))


def _recording(monkeypatch, mod, store, key):
    s1, s2 = mod.sample_stage1_cached, mod.sample_stage2_resumed

    def stage1(*args, **kwargs):
        lat, cache = s1(*args, **kwargs)
        store[key + "1"] = np.asarray(lat)
        return lat, cache

    def stage2(*args, **kwargs):
        out = s2(*args, **kwargs)
        store[key + "2"] = np.asarray(out)
        return out

    monkeypatch.setattr(mod, "sample_stage1_cached", stage1)
    monkeypatch.setattr(mod, "sample_stage2_resumed", stage2)


def run_both(setup, monkeypatch, jkw=None, tkw=None, **kw):
    """``generate`` on both engines with the same initial noise; checks
    images within 1 and latents within LATENT_ATOL; returns the port's
    result."""
    lat: dict = {}
    _recording(monkeypatch, jmc, lat, "j")
    _recording(monkeypatch, multiconcept, lat, "t")
    common = dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=14,
                  height=H, width=W, initial_noise=setup["noise"], **kw)
    want = setup["jeng"].generate(PROMPT, **common, **(jkw or {}))
    got = setup["teng"].generate(PROMPT, **common, **(tkw or {}))
    assert got.stage2 is not None and want.stage2 is not None
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.uint8 and g.shape == w.shape == (2, H, W, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
    for s in "12":
        np.testing.assert_allclose(lat["t" + s], lat["j" + s],
                                   atol=LATENT_ATOL, err_msg=f"stage {s}")
    return got, lat


def _cn_kwargs(setup, **over):
    base = dict(spatial_condition=setup["cond"], controlnet_scale=0.9)
    base.update(over)
    return (dict(controlnet_params=setup["jcn"], **base),
            dict(controlnet_params=setup["tcn"], **base))


@pytest.mark.parametrize("case", ["default", "window", "guess"])
def test_spatial_controlnet(setup, monkeypatch, case):
    over = {"default": {},
            "window": dict(control_guidance_start=0.25,
                           control_guidance_end=0.75),
            "guess": dict(controlnet_guess_mode=True)}[case]
    jkw, tkw = _cn_kwargs(setup, **over)
    got, lat = run_both(setup, monkeypatch, jkw, tkw)
    plain = setup["teng"].generate(
        PROMPT, negative_prompt="ugly", prompt_rewrite=REWRITE, seed=14,
        height=H, width=W, initial_noise=setup["noise"])
    # the ControlNet moved the image
    assert np.abs(got.stage2.astype(int) - plain.stage2.astype(int)).max() > 1


def _instantid_pair(setup):
    """The same identity stack for both engines: resampler (the JAX tree's
    to_q rescaled so the two compute one function), IP layers for every
    attn2, and an IdentityNet with non-zero heads."""
    rs_tree = numpy_params(jrs.init_params, jconfig.tiny_resampler(), 30)
    jrs_tree = jax.tree.map(lambda x: x, rs_tree)
    for attn, _ in jrs_tree["layers"]:
        attn["to_q"] = {"weight": attn["to_q"]["weight"] * 8 ** 0.5}
    rng = np.random.default_rng(31)
    n = junet.num_cross_attention_layers(jconfig.tiny_unet())
    ip_tree = [{k: {"weight": normal(rng, 48, 64, scale=48 ** -0.5)}
                for k in ("to_k_ip", "to_v_ip")} for _ in range(n)]
    idn = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 32)
    jid = jomg.InstantIDModels(
        resampler_cfg=jconfig.tiny_resampler(), resampler_params=to_jax(
            jrs_tree), ip_adapter_layers=to_jax(ip_tree),
        identitynet_params=to_jax(idn),
        identitynet_cfg=jconfig.tiny_controlnet())
    tid = omg.InstantIDModels(
        resampler_cfg=config.tiny_resampler(),
        resampler_params=from_jax.resampler_from_jax(
            rs_tree, config.tiny_resampler(), device="cpu"),
        ip_adapter_layers=from_jax.ip_layers_from_jax(
            ip_tree, config.tiny_unet(), device="cpu"),
        identitynet_params=from_jax.controlnet_from_jax(
            idn, config.tiny_controlnet(), device="cpu"),
        identitynet_cfg=config.tiny_controlnet())
    faces = [normal(rng, 16), normal(rng, 16)]
    kps = [np.float32([[6, 8], [12, 8], [9, 11], [7, 14], [11, 14]]),
           np.float32([[20, 8], [26, 8], [23, 11], [21, 14], [25, 14]])]
    return jid, tid, faces, jiid.draw_kps(H, W, kps)


@pytest.mark.parametrize("kps_from", ["image", "provider"])
def test_instantid_with_identitynet(setup, monkeypatch, kps_from):
    jid, tid, faces, kimg = _instantid_pair(setup)
    seen = []

    def provider(image):
        seen.append(image.shape)
        return kimg
    kw = ({"face_kps_image": kimg} if kps_from == "image"
          else {"face_kps_provider": provider})
    got, _ = run_both(setup, monkeypatch, dict(instantid=jid),
                      dict(instantid=tid), face_embeddings=faces,
                      guidance_scale=3.0, **kw)
    assert seen == ([] if kps_from == "image" else [(H, W, 3)] * 2)
    plain = setup["teng"].generate(
        PROMPT, negative_prompt="ugly", prompt_rewrite=REWRITE, seed=14,
        height=H, width=W, initial_noise=setup["noise"], guidance_scale=3.0)
    assert np.abs(got.stage2.astype(int) - plain.stage2.astype(int)).max() > 1


@pytest.mark.parametrize("kind", ["ddim", "dpmpp_2m"])
def test_schedulers(setup, monkeypatch, kind):
    run_both(setup, monkeypatch, scheduler=kind)


def test_lcm_with_jax_draws(setup, monkeypatch):
    """LCM at 4 steps: the port's per-step re-noise replaced by JAX's own
    fold_in(fold_in(PRNGKey(seed), 777), i) draws."""
    key = jax.random.fold_in(jax.random.PRNGKey(14), 777)
    drawn = []

    def jax_noise(seed, i, shape, device):
        assert seed == 14
        drawn.append(i)
        return t(jax.random.normal(jax.random.fold_in(key, i), shape,
                                   jnp.float32))
    monkeypatch.setattr(schedulers, "step_noise", jax_noise)
    run_both(setup, monkeypatch, scheduler="lcm")
    # steps 0-2 re-noise in stage 1; stage 2 redraws from its boundary
    assert drawn == [0, 1, 2, 2]


def test_lcm_is_reproducible_and_copies_stay_equal(setup):
    kw = dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=5,
              height=H, width=W, scheduler="lcm")
    a = setup["teng"].generate(PROMPT, **kw)
    b = setup["teng"].generate(PROMPT, **kw)
    np.testing.assert_array_equal(a.stage2, b.stage2)
    np.testing.assert_array_equal(a.stage1[0], a.stage1[1])


def _stage_inputs(setup, pkg):
    """Base and concept inputs of one package from fixed random
    embeddings."""
    rng = np.random.default_rng(40)
    ep, en = normal(rng, 1, 77, 48), normal(rng, 1, 77, 48)
    pp, pn = normal(rng, 1, 16), normal(rng, 1, 16)
    if pkg == "jax":
        a = [jnp.asarray(x) for x in (ep, pp, en, pn)]
        tids = jsdxl.add_time_ids((H, W), (0, 0), (H, W))
        return (jmc.make_base_inputs(*a, tids, 7.5),
                [jmc.make_concept_inputs(*a, tids)] * 2)
    a = [t(x) for x in (ep, pp, en, pn)]
    tids = sdxl.add_time_ids((H, W), (0, 0), (H, W))
    return (multiconcept.make_base_inputs(*a, tids, 7.5),
            [multiconcept.make_concept_inputs(*a, tids)] * 2)


def test_four_lane_program_against_the_trajectory_program(setup):
    """Stage 2 by the 4+2K program (no trajectory: both copies and the
    doubled DPM++2M state carried from the boundary) and by the 3+2K one,
    with a spatial ControlNet in guess mode, each against JAX's."""
    steps, fs = 5, 1
    m = np.zeros((2, 4, 4), np.float32)
    m[0, :, :2], m[1, :, 2:] = 1.0, 1.0
    cond = setup["cond"][None].astype(np.float32) / 255.0
    jbase, jconcepts = _stage_inputs(setup, "jax")
    tbase, tconcepts = _stage_inputs(setup, "torch")
    jcn_in = jmc.ControlNetInputs(setup["jcn"], jnp.asarray(cond),
                                  jnp.float32(0.9), guess_mode=True)
    tcn_in = multiconcept.ControlNetInputs(setup["tcn"], t(cond), 0.9,
                                           guess_mode=True)
    jsch = jsched.make_schedule("dpmpp_2m", steps)
    tsch = schedulers.make_schedule("dpmpp_2m", steps)
    jcfg, tcfg = jsdxl.tiny_config(), sdxl.tiny_config()
    unet_j, unet_t = setup["jeng"].params.unet, setup["teng"].params.unet
    jlat1, jcache = jmc.sample_stage1_cached(
        jcfg, jsch, unet_j, key=jax.random.PRNGKey(3), height=H, width=W,
        base_inputs=jbase, fusion_start=fs, base_controlnets=[jcn_in],
        cn_cfg=jconfig.tiny_controlnet(), initial_noise=setup["noise"])
    lat1, cache = multiconcept.sample_stage1_cached(
        tcfg, tsch, unet_t, generator=None, height=H, width=W,
        base_inputs=tbase, fusion_start=fs, base_controlnets=[tcn_in],
        initial_noise=setup["noise"], noise_seed=3)
    np.testing.assert_allclose(lat1.numpy(), np.asarray(jlat1),
                               atol=LATENT_ATOL)
    assert cache.sched_state.prev_model_output is not None
    ctl_kw = dict(self_replace_steps=0.4, width=1, height=1)
    outs = {}
    for prog in ("3+2K", "4+2K"):
        jc = jcache if prog == "3+2K" else jcache._replace(a_traj=None)
        tc = cache if prog == "3+2K" else cache._replace(a_traj=None)
        want = jmc.sample_stage2_resumed(
            jcfg, jsch, unet_j, jc, base_inputs=jbase,
            controller=jp2p.P2PControl.build(["a", "a"], steps, **ctl_kw),
            concept_inputs=jconcepts, concept_loras=[None, None],
            masks=jnp.asarray(m), fusion_start=fs,
            base_controlnets=[jcn_in], cn_cfg=jconfig.tiny_controlnet())
        got = multiconcept.sample_stage2_resumed(
            tcfg, tsch, unet_t, tc, base_inputs=tbase,
            controller=p2p.P2PControl.build(["a", "a"], steps, **ctl_kw),
            concept_inputs=tconcepts, concept_loras=[None, None],
            masks=t(m), fusion_start=fs, base_controlnets=[tcn_in])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LATENT_ATOL, err_msg=prog)
        outs[prog] = got
    np.testing.assert_allclose(outs["4+2K"].numpy(), outs["3+2K"].numpy(),
                               atol=LATENT_ATOL)


def test_mesh_refuses_controlnet_and_instantid(setup):
    """A mesh engine raises before any collective runs (the reference has
    no test of these paths under a mesh)."""
    mesh = mesh_lib.Mesh(1, 2, 0, torch.device("cpu"), None, None, None)
    teng = setup["teng"]
    eng = omg.OMG(cfg=teng.cfg, params=teng.params, tokenizer=teng.tokenizer,
                  tokenizer_2=teng.tokenizer_2, mesh=mesh)
    with pytest.raises(NotImplementedError, match="parallel/"):
        eng.generate(PROMPT, height=H, width=W,
                     controlnet_params=setup["tcn"],
                     spatial_condition=setup["cond"])
    with pytest.raises(NotImplementedError, match="parallel/"):
        eng.generate(PROMPT, height=H, width=W,
                     instantid=omg.InstantIDModels(None, None, []))


def test_controlnet_init_params_follow_the_generator():
    model = controlnet.init_params(torch.Generator().manual_seed(0),
                                   config.tiny_controlnet())
    heads = [m.weight for m in model.controlnet_down_blocks] + \
        [model.controlnet_mid_block.weight,
         model.controlnet_cond_embedding.conv_out.weight]
    assert all(float(w.abs().max()) > 0 for w in heads)
    assert len(model.controlnet_down_blocks) == 4
