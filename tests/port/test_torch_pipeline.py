"""The slice as a whole: the port's two-stage sampler on the golden
inputs (tests/test_golden.py) and ``OMG.generate`` against the JAX
engine at the tiny config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.control import p2p as jp2p
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import unet
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, mid_block_lora, normal,
                                np_tree, t, tiny_sdxl, to_jax)

FIXTURE = os.path.join(os.path.dirname(__file__), os.pardir,
                       "golden_two_stage.npz")
GOLDEN_ATOL = 5e-4      # the fixture's own tolerance (test_golden.py)


def _golden_inputs():
    """tests/test_golden.py's inputs; the stage-1 noise is drawn from its
    PRNGKey(7) here and handed to the port as ``initial_noise``."""
    H = W = 32
    cfg = jsdxl.tiny_config()
    params = jax.jit(junet.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg.unet)
    d, pdim = cfg.unet.cross_attention_dim, cfg.text_encoder_2.projection_dim
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    enc = [jax.random.normal(ks[0], (1, 77, d)),
           jax.random.normal(ks[1], (1, 77, d)),
           jax.random.normal(ks[2], (1, pdim)),
           jax.random.normal(ks[3], (1, pdim))]
    lk = jax.random.split(jax.random.PRNGKey(42), 2)
    lora = {"mid_block": {"attentions": [{"transformer_blocks": [{
        "attn2": {"to_q": {
            "down": jax.random.normal(lk[0], (64, 2)) * 0.2,
            "up": jax.random.normal(lk[1], (2, 64)) * 0.2,
            "scale": jnp.asarray(1.0)}}}]}]}}
    m = np.zeros((2, 4, 4), np.float32)
    m[0, :, :2] = 1.0
    m[1, :, 2:] = 1.0
    return H, W, cfg, params, enc, lora, m


def test_two_stage_matches_golden_and_jax():
    H, W, jcfg, jparams, enc, jlora_tree, m = _golden_inputs()
    jep, jen, jpp, jpn = enc
    tids = jsdxl.add_time_ids((H, W), (0, 0), (H, W))
    base = jmc.make_base_inputs(jep, jpp, jen, jpn, tids, 7.5)
    concept = jmc.make_concept_inputs(jep, jpp, jen, jpn, tids)
    ctl = jp2p.P2PControl.build(["a", "a"], 5, self_replace_steps=0.4,
                                width=2, height=2)
    jlat1, jcache = jmc.sample_stage1_cached(
        jcfg, jsched.make_schedule("euler", 5), jparams,
        key=jax.random.PRNGKey(7), height=H, width=W, base_inputs=base,
        fusion_start=1)
    jlat2 = jmc.sample_stage2_resumed(
        jcfg, jsched.make_schedule("euler", 5), jparams, jcache,
        base_inputs=base, controller=ctl, concept_inputs=[concept, concept],
        concept_loras=[jlora_tree, None], masks=jnp.asarray(m),
        fusion_start=1)

    cfg = sdxl.tiny_config()
    model = from_jax.load_into(unet.UNet2DConditionModel(cfg.unet),
                               np_tree(jparams))
    ep, en, pp, pn = (t(a) for a in enc)
    ttids = sdxl.add_time_ids((H, W), (0, 0), (H, W))
    tbase = multiconcept.make_base_inputs(ep, pp, en, pn, ttids, 7.5)
    tconcept = multiconcept.make_concept_inputs(ep, pp, en, pn, ttids)
    sched = schedulers.make_schedule("euler", 5)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (1, H // 8, W // 8, 4)))
    lat1, cache = multiconcept.sample_stage1_cached(
        cfg, sched, model, generator=None, height=H, width=W,
        base_inputs=tbase, fusion_start=1, initial_noise=noise)
    lat2 = multiconcept.sample_stage2_resumed(
        cfg, sched, model, cache, base_inputs=tbase,
        controller=p2p.P2PControl.build(["a", "a"], 5,
                                        self_replace_steps=0.4, width=2,
                                        height=2),
        concept_inputs=[tconcept, tconcept],
        concept_loras=[from_jax.lora_from_jax(np_tree(jlora_tree),
                                              device="cpu"), None],
        masks=t(m), fusion_start=1)

    ref = np.load(FIXTURE)
    for got, live, name in ((lat1, jlat1, "stage1"), (lat2, jlat2, "stage2")):
        np.testing.assert_allclose(got.numpy(), ref[name], atol=GOLDEN_ATOL,
                                   err_msg=f"{name} vs fixture")
        np.testing.assert_allclose(got.numpy(), np.asarray(live),
                                   atol=GOLDEN_ATOL, err_msg=f"{name} vs JAX")


@pytest.fixture(scope="module")
def engines():
    jp, tp = tiny_sdxl(seed=10)
    # one instance of the port's tokenizer (duck-typed) for both engines:
    # its ids do not depend on the process's hash seed
    tok = ToyTokenizer()
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp, tokenizer=tok,
                    tokenizer_2=tok, mask_provider=left_right_masks,
                    num_steps=4)
    teng = omg.OMG(cfg=sdxl.tiny_config(), params=tp, tokenizer=tok,
                   tokenizer_2=tok, mask_provider=left_right_masks,
                   num_steps=4)
    return jeng, teng


def test_generate_matches_jax(engines):
    """Two concepts with LoRA (one also on text encoder 1) and a style
    LoRA, left/right masks, 4 Euler steps, the same initial noise."""
    jeng, teng = engines
    rng = np.random.default_rng(11)
    dim = jsdxl.tiny_config().unet.block_out_channels[-1]
    ctx = jsdxl.tiny_config().unet.cross_attention_dim
    te = {"text_model": {"encoder": {"layers": {0: {"self_attn": {
        "q_proj": {"down": normal(rng, 32, 2, scale=0.3),
                   "up": normal(rng, 2, 32, scale=0.3),
                   "scale": np.float32(1.0)}}}}}}}
    concepts = [{"unet": mid_block_lora(rng, dim, ctx),
                 "text_encoder": te},
                mid_block_lora(rng, dim, ctx, rank=2)]
    style = mid_block_lora(rng, dim, ctx, rank=3)
    kw = dict(negative_prompt="ugly", seed=14, height=32, width=32,
              prompt_rewrite="[photo of the man]-*-[ugly]|"
                             "[photo of the woman]-*-[blurry]",
              initial_noise=normal(rng, 1, 4, 4, 4))
    prompt = "photo of the man and the woman at the beach"
    want = jeng.generate(prompt, concept_loras=[to_jax(c) for c in concepts],
                         style_lora=to_jax(style), **kw)
    got = teng.generate(prompt,
                        concept_loras=[from_jax.lora_from_jax(c, device="cpu")
                                       for c in concepts],
                        style_lora=from_jax.lora_from_jax(
                            style, device="cpu"), **kw)
    assert got.stage2 is not None and want.stage2 is not None
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.uint8 and g.shape == w.shape == (2, 32, 32, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
    assert len(got.masks) == 2
    for g, w in zip(got.masks, want.masks):
        np.testing.assert_array_equal(g, w)
    assert set(got.timings) == {"encode", "stage1", "decode", "masks",
                                "stage2"}


def test_seeded_noise_is_reproducible(engines):
    _, teng = engines
    kw = dict(seed=3, height=32, width=32, num_steps=4,
              prompt_rewrite="[the man]-*-[x]")
    a = teng.generate("the man", **kw)
    b = teng.generate("the man", **kw)
    np.testing.assert_array_equal(a.image, b.image)


class _ShortProvider:
    def masks_for(self, image, classes):
        return [np.ones(image.shape[:2], np.float32)]


def test_predict_masks_rejects_short_provider(engines):
    """A provider answering fewer classes than were gated raises (the JAX
    engine's zip dropped the extra classes silently)."""
    _, teng = engines
    eng = omg.OMG(cfg=teng.cfg, params=teng.params,
                  tokenizer=teng.tokenizer, tokenizer_2=teng.tokenizer_2,
                  mask_provider=_ShortProvider())
    image = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="1 masks for 2 classes"):
        eng._predict_masks(image, "the man and the woman", 2,
                           ("man", "woman"))


@pytest.mark.parametrize("kwargs,match", [
    ({"controlnet_params": "mesh", "spatial_condition": "mesh"}, "parallel/"),
    ({"instantid": "mesh"}, "parallel/"),
    ({"cache_interval": 3}, "DeepCache"),
    ({"cache_schedule": "front"}, "DeepCache"),
])
def test_unported_options_raise(engines, kwargs, match, monkeypatch):
    """Options once refused here now run. ControlNet and InstantID under a
    mesh layout: a one-rank grid (groups of one rank run no collective)
    takes the mesh programs and gives the one-device engine's images.
    DeepCache: a request's interval takes shallow steps, and a schedule
    without an interval on an engine without one is the exact program (as
    in JAX)."""
    from omg_tpu_torch import config
    from omg_tpu_torch.models import controlnet, resampler
    from omg_tpu_torch.parallel import comm
    from omg_tpu_torch.parallel import mesh as mesh_lib
    _, teng = engines
    if match == "DeepCache":
        shallow = []
        apply_shallow = unet.UNet2DConditionModel.apply_shallow
        monkeypatch.setattr(unet.UNet2DConditionModel, "apply_shallow",
                            lambda *a, **k: shallow.append(1) or
                            apply_shallow(*a, **k))
        kw = dict(height=32, width=32, seed=3, prompt_rewrite="[the man]-*-[x]")
        res = teng.generate("the man", **kw, **kwargs)
        assert res.stage2 is not None
        if "cache_interval" in kwargs:
            # 4 steps, fusion after step 1: ranges [0, 2), [2, 4) and
            # [2, 4), each a full forward on its first step only
            assert len(shallow) == 3
        else:
            assert not shallow
            np.testing.assert_array_equal(
                res.image, teng.generate("the man", **kw).image)
        return
    one = comm.Group((0,), 0)
    eng = omg.OMG(cfg=teng.cfg, params=teng.params, tokenizer=teng.tokenizer,
                  tokenizer_2=teng.tokenizer_2,
                  mask_provider=teng.mask_provider, num_steps=teng.num_steps,
                  mesh=mesh_lib.Mesh(1, 1, 0, teng.device, one, one, one))
    g = torch.Generator().manual_seed(5)
    cn = controlnet.init_params(g, config.tiny_controlnet(), device="cpu")
    if "instantid" in kwargs:
        kwargs = dict(
            instantid=omg.InstantIDModels(
                config.tiny_resampler(),
                resampler.init_params(g, config.tiny_resampler(),
                                      device="cpu"),
                unet.init_ip_layers(g, config.tiny_unet(), device="cpu"),
                identitynet_params=cn,
                identitynet_cfg=config.tiny_controlnet()),
            face_embeddings=[np.ones(16, np.float32)],
            face_kps_image=np.full((32, 32, 3), 200, np.uint8))
    else:
        kwargs = dict(controlnet_params=cn,
                      spatial_condition=np.full((32, 32, 3), 90, np.uint8))
    kw = dict(height=32, width=32, seed=3, prompt_rewrite="[the man]-*-[x]",
              **kwargs)
    got, want = eng.generate("the man", **kw), teng.generate("the man", **kw)
    assert got.stage2 is not None
    for name in ("stage1", "stage2"):
        assert np.abs(getattr(got, name).astype(int)
                      - getattr(want, name).astype(int)).max() <= 1, name
