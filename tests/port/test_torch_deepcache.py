"""DeepCache in the port against the JAX package, at the tiny config:
the schedules; ``forward(return_cache=True)`` and ``apply_shallow``
(2e-4), including a geometry whose level 0 has attention, with LoRA on
it, the IP layers and P2P; the same-step invariant (exact); every
denoise range with a stale cache through ``sample_stage1_cached`` /
``sample_stage2_resumed`` (the 3+2K and the 4+2K programs) and
``two_stage_latents``, with an int interval and a "front" tuple (5e-4 on
latents); ``generate`` with a per-request interval and a ControlNet, and
``generate_batch`` with a per-request interval or "front" schedule
(uint8 within 1/255 of JAX's, the ControlNet run on full steps only);
and the JAX guards' messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.control import p2p as jp2p
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import controlnet as jcn
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import controlnet, unet
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from test_torch_batch import jax_noise  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, lora_leaf, mid_block_lora,
                                normal, np_tree, numpy_params, t, tiny_sdxl,
                                to_jax)

MODULE_RTOL = 2e-4
LATENT_ATOL = 5e-4
H = W = 32
PROMPT = "photo of the man and the woman at the beach"
REWRITE = "[photo of the man]-*-[ugly]|[photo of the woman]-*-[blurry]"


def _close(got, want, rel=MODULE_RTOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("kind", ["uniform", "front"])
@pytest.mark.parametrize("fusion_start", [None, 0, 5, 15, 60])
def test_schedules_match_jax(kind, fusion_start):
    for steps in (1, 2, 4, 10, 25, 50):
        for interval in (2, 3, 4, 7):
            assert multiconcept.deepcache_schedule(
                steps, interval, kind=kind, fusion_start=fusion_start) == \
                jmc.deepcache_schedule(steps, interval, kind=kind,
                                       fusion_start=fusion_start)
    assert multiconcept.DEEPCACHE_SCHEDULES == jmc.DEEPCACHE_SCHEDULES
    for spec in (0, 1, 2, 5, True, False, (True, False), ()):
        assert multiconcept.dc_on(spec) == jmc._dc_on(spec), spec
    for bad in ((4, 1, kind), (4, 2, "center")):
        with pytest.raises(ValueError) as want:
            jmc.deepcache_schedule(bad[0], bad[1], kind=bad[2])
        with pytest.raises(ValueError, match=str(want.value)):
            multiconcept.deepcache_schedule(bad[0], bad[1], kind=bad[2])


def _attentive_level0(ucfg):
    """The tiny geometry with a transformer on level 0 too."""
    return dataclasses.replace(ucfg, transformer_layers_per_block=(1, 1))


def _lora_tree(rng, ucfg):
    """LoRA on level 0's transformer (when it has one), the mid block and
    the last up block's second transformer (JAX layout)."""
    c0, c1 = ucfg.block_out_channels
    ctx = ucfg.cross_attention_dim
    tree = mid_block_lora(rng, c1, ctx, rank=2)

    def blk(dim):
        return {"transformer_blocks": {0: {
            "attn1": {"to_q": lora_leaf(rng, dim, dim, 2),
                      "to_out": lora_leaf(rng, dim, dim, 2)},
            "attn2": {"to_k": lora_leaf(rng, ctx, dim, 2)},
            "ff": {"net_2": lora_leaf(rng, dim * 4, dim, 2)}}},
            "proj_out": lora_leaf(rng, dim, dim, 2)}
    if ucfg.transformer_layers_per_block[0]:
        tree["down_blocks"] = {0: {"attentions": {0: blk(c0)}}}
        tree["up_blocks"] = {1: {"attentions": {1: blk(c0)}}}
    return tree


def _ip_tree(rng, ucfg):
    """One IP projection pair per attn2, the width of its block."""
    chs, depths = ucfg.block_out_channels, ucfg.transformer_layers_per_block
    lpb, ctx = ucfg.layers_per_block, ucfg.cross_attention_dim
    widths = ([ch for ch, d in zip(chs, depths) for _ in range(lpb * d)]
              + [chs[-1]] * depths[-1]
              + [ch for ch, d in zip(chs[::-1], depths[::-1])
                 for _ in range((lpb + 1) * d)])
    return [{"to_k_ip": {"weight": normal(rng, ctx, w, scale=ctx ** -0.5)},
             "to_v_ip": {"weight": normal(rng, ctx, w, scale=ctx ** -0.5)}}
            for w in widths]


def _unet_pair(ucfg, seed):
    tree = numpy_params(junet.init_params, ucfg, seed)
    tcfg = dataclasses.replace(ucfg, dtype=torch.float32)
    return to_jax(tree), from_jax.load_into(unet.UNet2DConditionModel(tcfg),
                                            tree)


def _inputs(rng, ucfg, b):
    return dict(x=normal(rng, b, 4, 4, 4), ehs=normal(rng, b, 77, 48),
                text=normal(rng, b, 16),
                tids=np.tile(np.float32([[32, 32, 0, 0, 32, 32]]), (b, 1)),
                toks=normal(rng, b, 3, ucfg.cross_attention_dim))


@pytest.mark.parametrize("level0", ["tiny", "attentive"])
def test_cache_and_shallow_match_jax(level0):
    """``forward(return_cache=True)`` against ``apply(return_cache=True)``
    (eps and cache), then ``apply_shallow`` from that cache at another
    (sample, t): a stale cache, as a shallow step sees it. Four lanes
    [cond_A, uncond_B, cond_B, concept] with per-lane LoRA on the last,
    the IP branch and P2P inside its self-replace window."""
    ucfg = jconfig.tiny_unet()
    if level0 == "attentive":
        ucfg = _attentive_level0(ucfg)
    jparams, model = _unet_pair(ucfg, seed=3)
    rng = np.random.default_rng(4)
    tree = _lora_tree(rng, ucfg)
    jlane = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jax.tree.map(jnp.zeros_like, to_jax(tree))] * 3 + [to_jax(tree)])
    tlane = from_jax.lora_from_jax(np_tree(jlane), device="cpu")
    ip_tree = _ip_tree(rng, ucfg)
    tcfg = dataclasses.replace(ucfg, dtype=torch.float32)
    ips = from_jax.ip_layers_from_jax(ip_tree, tcfg, device="cpu")
    ctl_kw = dict(self_replace_steps=0.4, width=1, height=1)
    jctl = jp2p.P2PControl.build(["a b", "a b"], 10, **ctl_kw).at_step(
        jnp.asarray(1), src_lane=0, dst_lane=2)
    ctl = p2p.P2PControl.build(["a b", "a b"], 10, **ctl_kw).at_step(
        1, src_lane=0, dst_lane=2)
    a, b = _inputs(rng, ucfg, 4), _inputs(rng, ucfg, 4)

    def jrun(fn, inp, ts, **kw):
        # one compiled program runs faster than the ops one by one
        return jax.jit(lambda p, lane, ips, x, e, te, ti, tok, **k: fn(
            p, ucfg, x, jnp.float32(ts), e, text_embeds=te, time_ids=ti,
            lora=lane, control=jctl, ip_adapter=ips, ip_context=tok,
            ip_scale=0.7, **k), static_argnames=("return_cache",))(
            jparams, jlane, to_jax(ip_tree), *(jnp.asarray(inp[k]) for k in (
                "x", "ehs", "text", "tids", "toks")), **kw)

    def trun(fn, inp, ts, **kw):
        return fn(t(inp["x"]), ts, t(inp["ehs"]), text_embeds=t(inp["text"]),
                  time_ids=t(inp["tids"]), lora=tlane, control=ctl,
                  ip_adapter=ips, ip_context=t(inp["toks"]), ip_scale=0.7,
                  **kw)
    jeps, jcache = jrun(junet.apply, a, 701, return_cache=True)
    eps, cache = trun(model, a, 701, return_cache=True)
    assert tuple(cache.shape) == unet.cache_shape(tcfg, 4, 4, 4)
    assert tuple(jcache.shape) == junet.cache_shape(ucfg, 4, 4, 4)
    _close(eps.numpy(), jeps)
    _close(cache.permute(0, 2, 3, 1).numpy(), jcache)
    jshallow = jrun(junet.apply_shallow, b, 641, cache=jcache)
    shallow = trun(model.apply_shallow, b, 641,
                   cache=t(jcache).permute(0, 3, 1, 2))
    _close(shallow.numpy(), jshallow)
    assert float(np.abs(np.asarray(jshallow) - np.asarray(jeps)).max()) > 0


def test_same_step_shallow_equals_full():
    """Fed the cache of a full forward at the same (sample, t), the
    shallow forward gives that forward's eps exactly; at SDXL's geometry
    (no attention on level 0) it runs no attention."""
    ucfg = _attentive_level0(jconfig.tiny_unet())
    _, model = _unet_pair(ucfg, seed=5)
    rng = np.random.default_rng(6)
    inp = _inputs(rng, ucfg, 3)
    lane = from_jax.lora_from_jax(np_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs), *[to_jax(_lora_tree(rng, ucfg))] * 3)),
        device="cpu")
    kw = dict(text_embeds=t(inp["text"]), time_ids=t(inp["tids"]), lora=lane)
    eps, cache = model(t(inp["x"]), 501, t(inp["ehs"]), return_cache=True,
                       **kw)
    again = model.apply_shallow(t(inp["x"]), 501, t(inp["ehs"]), cache=cache,
                                **kw)
    torch.testing.assert_close(again, eps, rtol=0, atol=0)
    # SDXL's geometry has no attention on level 0, nor has the tiny one:
    # there a shallow step applies no LoRA, IP or P2P edit at all
    assert config.UNetConfig().transformer_layers_per_block[0] == 0
    tiny = jconfig.tiny_unet()
    _, plain_model = _unet_pair(tiny, seed=7)
    inp = _inputs(rng, tiny, 3)
    kw = dict(text_embeds=t(inp["text"]), time_ids=t(inp["tids"]))
    _, cache = plain_model(t(inp["x"]), 501, t(inp["ehs"]),
                           return_cache=True, **kw)
    lane = from_jax.lora_from_jax(np_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs), *[to_jax(_lora_tree(rng, tiny))] * 3)),
        device="cpu")
    tcfg = dataclasses.replace(tiny, dtype=torch.float32)
    ctl = p2p.P2PControl.build(["a b", "a b"], 10, self_replace_steps=0.4,
                               width=1, height=1).at_step(
        1, src_lane=0, dst_lane=2)
    bare = plain_model.apply_shallow(t(inp["x"]), 501, t(inp["ehs"]),
                                     cache=cache, **kw)
    edited = plain_model.apply_shallow(
        t(inp["x"]), 501, t(inp["ehs"]), cache=cache, lora=lane,
        control=ctl, ip_adapter=from_jax.ip_layers_from_jax(
            _ip_tree(rng, tiny), tcfg, device="cpu"),
        ip_context=t(inp["toks"]), **kw)
    torch.testing.assert_close(edited, bare, rtol=0, atol=0)


def _golden_like(ucfg_seed=0):
    """test_torch_pipeline.py's golden inputs (tests/test_golden.py) with
    seeded numpy weights: the tiny UNet, random text conditioning, one
    LoRA'd concept and one plain, left/right masks, PRNGKey(7) stage-1
    noise."""
    jcfg = jsdxl.tiny_config()
    jparams = to_jax(numpy_params(junet.init_params, jcfg.unet, ucfg_seed))
    d, pdim = jcfg.unet.cross_attention_dim, jcfg.text_encoder_2.projection_dim
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    enc = [jax.random.normal(ks[0], (1, 77, d)),
           jax.random.normal(ks[1], (1, 77, d)),
           jax.random.normal(ks[2], (1, pdim)),
           jax.random.normal(ks[3], (1, pdim))]
    rng = np.random.default_rng(42)
    lora = mid_block_lora(rng, 64, d, rank=2)
    m = np.zeros((2, 4, 4), np.float32)
    m[0, :, :2] = 1.0
    m[1, :, 2:] = 1.0
    model = from_jax.load_into(unet.UNet2DConditionModel(
        sdxl.tiny_config().unet), np_tree(jparams))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 4, 4, 4)))
    return jcfg, jparams, model, enc, lora, m, noise


@pytest.fixture(scope="module")
def golden():
    jcfg, jparams, model, enc, lora, m, noise = _golden_like()
    jep, jen, jpp, jpn = enc
    jtids = jsdxl.add_time_ids((H, W), (0, 0), (H, W))
    ep, en, pp, pn = (t(a) for a in enc)
    tids = sdxl.add_time_ids((H, W), (0, 0), (H, W))
    ctl_kw = dict(self_replace_steps=0.4, width=1, height=1)
    return dict(
        jcfg=jcfg, jparams=jparams, model=model, masks=m, noise=noise,
        jbase=jmc.make_base_inputs(jep, jpp, jen, jpn, jtids, 7.5),
        jconcept=jmc.make_concept_inputs(jep, jpp, jen, jpn, jtids),
        base=multiconcept.make_base_inputs(ep, pp, en, pn, tids, 7.5),
        concept=multiconcept.make_concept_inputs(ep, pp, en, pn, tids),
        jlora=to_jax(lora), lora=from_jax.lora_from_jax(lora, device="cpu"),
        jctl=jp2p.P2PControl.build(["a", "a"], 6, **ctl_kw),
        ctl=p2p.P2PControl.build(["a", "a"], 6, **ctl_kw))


SPECS = {"int2": 2, "int3": 3,
         "front": jmc.deepcache_schedule(6, 2, kind="front", fusion_start=1)}


@pytest.mark.parametrize("spec", list(SPECS))
def test_stages_with_deepcache_match_jax(golden, spec):
    """Stage 1's two ranges and stage 2's 3+2K program with DeepCache, and
    the 4+2K program (no recorded trajectory), against JAX at 5e-4."""
    g = golden
    interval = SPECS[spec]
    jsch, sch = jsched.make_schedule("euler", 6), \
        schedulers.make_schedule("euler", 6)
    jlat1, jcache = jmc.sample_stage1_cached(
        g["jcfg"], jsch, g["jparams"], key=jax.random.PRNGKey(7), height=H,
        width=W, base_inputs=g["jbase"], fusion_start=1,
        cache_interval=interval)
    lat1, cache = multiconcept.sample_stage1_cached(
        sdxl.tiny_config(), sch, g["model"], generator=None, height=H,
        width=W, base_inputs=g["base"], fusion_start=1,
        initial_noise=g["noise"], cache_interval=interval)
    np.testing.assert_allclose(lat1.numpy(), np.asarray(jlat1),
                               atol=LATENT_ATOL)
    kw = dict(fusion_start=1, cache_interval=interval)
    jlat2 = jmc.sample_stage2_resumed(
        g["jcfg"], jsch, g["jparams"], jcache, base_inputs=g["jbase"],
        controller=g["jctl"], concept_inputs=[g["jconcept"]] * 2,
        concept_loras=[g["jlora"], None], masks=jnp.asarray(g["masks"]),
        **kw)
    lat2 = multiconcept.sample_stage2_resumed(
        sdxl.tiny_config(), sch, g["model"], cache, base_inputs=g["base"],
        controller=g["ctl"], concept_inputs=[g["concept"]] * 2,
        concept_loras=[g["lora"], None], masks=t(g["masks"]), **kw)
    np.testing.assert_allclose(lat2.numpy(), np.asarray(jlat2),
                               atol=LATENT_ATOL)
    if spec != "int2":
        return
    # the 4+2K program: the cache without the trajectory
    jlat4 = jmc.sample_stage2_resumed(
        g["jcfg"], jsch, g["jparams"], jcache._replace(a_traj=None),
        base_inputs=g["jbase"], controller=g["jctl"],
        concept_inputs=[g["jconcept"]] * 2,
        concept_loras=[g["jlora"], None], masks=jnp.asarray(g["masks"]),
        **kw)
    lat4 = multiconcept.sample_stage2_resumed(
        sdxl.tiny_config(), sch, g["model"], cache._replace(a_traj=None),
        base_inputs=g["base"], controller=g["ctl"],
        concept_inputs=[g["concept"]] * 2, concept_loras=[g["lora"], None],
        masks=t(g["masks"]), **kw)
    np.testing.assert_allclose(lat4.numpy(), np.asarray(jlat4),
                               atol=LATENT_ATOL)
    assert float(np.abs(np.asarray(jlat4) - np.asarray(jlat2)).max()) > 0


def test_two_stage_latents_with_deepcache_match_jax(golden):
    g = golden
    jsch, sch = jsched.make_schedule("euler", 6), \
        schedulers.make_schedule("euler", 6)
    jlat0 = jsched.scale_initial_noise(jsch, jnp.asarray(g["noise"]))
    want = jmc.two_stage_latents(
        g["jcfg"], jsch, g["jparams"], jlat0, g["jbase"], g["jctl"],
        [g["jconcept"]] * 2, [g["jlora"], None], jnp.asarray(g["masks"]),
        fusion_start=1, cache_interval=3)
    got = multiconcept.two_stage_latents(
        sdxl.tiny_config(), sch, g["model"],
        schedulers.scale_initial_noise(sch, t(g["noise"])), g["base"],
        g["ctl"], [g["concept"]] * 2, [g["lora"], None], t(g["masks"]),
        fusion_start=1, cache_interval=3)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   atol=LATENT_ATOL)


@pytest.fixture(scope="module")
def engines():
    jp, tp = tiny_sdxl(seed=20)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=6)
    cn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 21)
    rng = np.random.default_rng(22)
    loras = [mid_block_lora(rng, 64, 48, rank=2) for _ in range(2)]
    return dict(
        jeng=jomg.OMG(cfg=jsdxl.tiny_config(), params=jp,
                      cn_cfg=jconfig.tiny_controlnet(), **kw),
        teng=omg.OMG(cfg=sdxl.tiny_config(), params=tp,
                     cn_cfg=config.tiny_controlnet(), **kw),
        jcn=to_jax(cn_tree),
        tcn=from_jax.controlnet_from_jax(cn_tree, config.tiny_controlnet(),
                                         device="cpu"),
        jloras=[to_jax(x) for x in loras],
        tloras=[from_jax.lora_from_jax(x, device="cpu") for x in loras],
        cond=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        noise=normal(rng, 1, 4, 4, 4))


def _uint8_close(got, want):
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g is not None and g.dtype == np.uint8 and g.shape == w.shape
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name


@pytest.mark.parametrize("request_kw", [
    {"cache_interval": 2},
    {"cache_interval": 3, "cache_schedule": "front"}],
    ids=["interval", "front"])
def test_generate_per_request_interval_matches_jax(engines, request_kw,
                                                   monkeypatch):
    """A request's DeepCache on engines without one, with a spatial
    ControlNet: images within 1/255 of JAX's; the ControlNet runs on the
    full steps only."""
    e = engines
    calls = []
    forward = controlnet.ControlNetModel.forward
    monkeypatch.setattr(controlnet.ControlNetModel, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(
                            self, *a, **k))
    kw = dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=5,
              height=H, width=W, initial_noise=e["noise"],
              spatial_condition=e["cond"], **request_kw)
    want = e["jeng"].generate(PROMPT, concept_loras=e["jloras"],
                              controlnet_params=e["jcn"], **kw)
    got = e["teng"].generate(PROMPT, concept_loras=e["tloras"],
                             controlnet_params=e["tcn"], **kw)
    _uint8_close(got, want)
    spec = e["teng"]._resolve_cache_spec(request_kw["cache_interval"],
                                         request_kw.get("cache_schedule"),
                                         6, 2)
    assert spec == e["jeng"]._resolve_cache_spec(
        request_kw["cache_interval"], request_kw.get("cache_schedule"), 6, 2)
    # full steps per range [0, 3), [3, 6) in stage 1 and [3, 6) in stage 2
    full = [multiconcept._DeepCache(spec, i0).full(i)
            for i0, i1 in ((0, 3), (3, 6), (3, 6)) for i in range(i0, i1)]
    assert 0 < len(calls) == sum(full) < 9


@pytest.mark.parametrize("request_kw", [
    {"cache_interval": 2},
    {"cache_interval": 3, "cache_schedule": "front"}],
    ids=["interval", "front"])
def test_generate_batch_per_request_interval(engines, monkeypatch, jax_noise,
                                             request_kw):
    """Two requests sharing a per-request DeepCache spec batch into one
    program (``sample_stage1_batch``'s 2R lanes, ``sample_stage2_batch``'s
    R(3+2K)) whose images are within 1/255 of JAX's ``generate_batch``
    (both start from JAX's ``PRNGKey(seed)`` draw) and of each request's
    serial ``generate``; requests with different specs are refused as JAX
    refuses them."""
    e = engines
    teng = e["teng"]

    def reqs(loras):
        return [dict(prompt=PROMPT, negative_prompt="bad",
                     prompt_rewrite=REWRITE, concept_loras=loras, seed=s,
                     height=H, width=W, guidance_scale=g, **request_kw)
                for s, g in ((3, 7.5), (9, 5.0))]
    shallow = []
    apply_shallow = unet.UNet2DConditionModel.apply_shallow
    monkeypatch.setattr(unet.UNet2DConditionModel, "apply_shallow",
                        lambda self, x, *a, **k: shallow.append(x.shape[0])
                        or apply_shallow(self, x, *a, **k))
    want = e["jeng"].generate_batch(reqs(e["jloras"]))
    batch = teng.generate_batch(reqs(e["tloras"]))
    assert len(batch) == len(want) == 2
    for got, w in zip(batch, want):
        _uint8_close(got, w)
    # both specs leave steps 1 and 4 shallow in stage 1's [0, 3) and
    # [3, 6) at 2R = 4 lanes, and step 4 in stage 2's [3, 6) at
    # R(3 + 2K) = 14 lanes
    spec = teng._resolve_cache_spec(request_kw["cache_interval"],
                                    request_kw.get("cache_schedule"), 6, 2)
    assert [i for i0, i1 in ((0, 3), (3, 6), (3, 6)) for i in range(i0, i1)
            if not multiconcept._DeepCache(spec, i0).full(i)] == [1, 4, 4]
    assert shallow == [4, 4, 14]
    for r, res in zip(reqs(e["tloras"]), batch):
        _uint8_close(res, teng.generate(r.pop("prompt"), **r))
    first, second = reqs(e["tloras"])
    with pytest.raises(ValueError, match="bucket them"):
        teng.generate_batch([first, dict(second, cache_interval=0)])
    with pytest.raises(ValueError, match="bucket them"):
        teng.generate_batch([first, dict(
            second, cache_schedule="uniform" if "cache_schedule" in
            request_kw else "front")])


def test_guards_match_jax(engines, golden):
    """Where JAX refuses a DeepCache or crop combination, the port refuses
    it with the same message."""
    e, g = engines, golden
    tp, tok = e["teng"].params, e["teng"].tokenizer

    def same(jfn, tfn):
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError) as got:
            tfn()
        assert str(got.value) == str(want.value)

    jp = e["jeng"].params
    for kw in (dict(cache_schedule="center"), dict(quantize="fp8"),
               dict(cache_interval=2, concept_crop=True)):
        same(lambda: jomg.OMG(cfg=jsdxl.tiny_config(), params=jp,
                              tokenizer=tok, tokenizer_2=tok, **kw),
             lambda: omg.OMG(cfg=sdxl.tiny_config(), params=tp,
                             tokenizer=tok, tokenizer_2=tok, **kw))
    same(lambda: jomg.OMG(cfg=jsdxl.tiny_config(), params=jp, tokenizer=tok,
                          tokenizer_2=tok, concept_crop=True,
                          mesh=object()),
         lambda: omg.OMG(cfg=sdxl.tiny_config(), params=tp, tokenizer=tok,
                         tokenizer_2=tok, concept_crop=True, mesh=object()))
    jcrop = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp, tokenizer=tok,
                     tokenizer_2=tok, concept_crop=True)
    tcrop = omg.OMG(cfg=sdxl.tiny_config(), params=tp, tokenizer=tok,
                    tokenizer_2=tok, concept_crop=True)
    same(lambda: jcrop.generate("a", height=H, width=W, cache_interval=2),
         lambda: tcrop.generate("a", height=H, width=W, cache_interval=2))
    same(lambda: e["jeng"]._resolve_cache_spec((True, False), None, 6, 2),
         lambda: e["teng"]._resolve_cache_spec((True, False), None, 6, 2))
    jcache = jmc.StageCache(jnp.zeros((1, 4, 4, 4)), jsched.SchedulerState(
        jnp.zeros((1, 4, 4, 4)), jnp.int32(0), jax.random.PRNGKey(0)),
        a_traj=jnp.zeros((4, 1, 4, 4, 4)), a_final=jnp.zeros((1, 4, 4, 4)))
    cache = multiconcept.StageCache(
        torch.zeros(1, 4, 4, 4), schedulers.init_state(None),
        a_traj=torch.zeros(4, 1, 4, 4, 4), a_final=torch.zeros(1, 4, 4, 4))
    jsch, sch = jsched.make_schedule("euler", 6), \
        schedulers.make_schedule("euler", 6)
    for kw in (dict(concept_crop=True, cache_interval=2, k=2),
               dict(cache_interval=2, k=0),
               dict(concept_crop=True, a_traj=None, k=2)):
        k = kw.pop("k")
        jc, tc = jcache, cache
        if "a_traj" in kw:
            kw.pop("a_traj")
            jc, tc = jc._replace(a_traj=None), tc._replace(a_traj=None)
        same(lambda: jmc.sample_stage2_resumed(
            g["jcfg"], jsch, g["jparams"], jc, base_inputs=g["jbase"],
            controller=None, concept_inputs=[g["jconcept"]] * k,
            concept_loras=[None] * k, masks=jnp.zeros((k, 4, 4)),
            fusion_start=1, **kw),
            lambda: multiconcept.sample_stage2_resumed(
                sdxl.tiny_config(), sch, g["model"], tc,
                base_inputs=g["base"], controller=None,
                concept_inputs=[g["concept"]] * k, concept_loras=[None] * k,
                masks=torch.zeros(k, 4, 4), fusion_start=1, **kw))
    same(lambda: jmc.two_stage_latents(
        g["jcfg"], jsch, g["jparams"], jnp.zeros((1, 4, 4, 4)), g["jbase"],
        None, [], [], jnp.zeros((0, 4, 4)), concept_crop=True,
        cache_interval=2),
        lambda: multiconcept.two_stage_latents(
            sdxl.tiny_config(), sch, g["model"], torch.zeros(1, 4, 4, 4),
            g["base"], None, [], [], torch.zeros(0, 4, 4),
            concept_crop=True, cache_interval=2))
    same(lambda: jmc._denoise_mc_range(
        g["jcfg"], jsch, g["jparams"], jnp.zeros((2, 4, 4, 4)),
        jcache.sched_state, g["jbase"], None, (), (), jnp.zeros((0, 4, 4)),
        i0=2, cache_interval=2),
        lambda: multiconcept._denoise_mc_range(
            sdxl.tiny_config(), sch, g["model"], torch.zeros(2, 4, 4, 4),
            schedulers.init_state(None), g["base"], None, (), (),
            torch.zeros(0, 4, 4), i0=2, cache_interval=2))
