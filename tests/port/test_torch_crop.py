"""The concept-crop strips (``concept_crop``) in the port against the
JAX package, at the tiny config: the strip geometry and the masks
clipped to it (exact), stage 2 on the strips after stage 1, alone and
with a base-row spatial ControlNet, and ``two_stage_latents`` with crop
(5e-4 on latents); ``OMG(concept_crop=True).generate`` (uint8 within
1/255) and the requests that run the exact program instead; the refusal
of per-concept ControlNets with JAX's message."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import controlnet as jcn
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from test_torch_deepcache import H, PROMPT, REWRITE, W, golden  # noqa: F401
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, mid_block_lora, normal,
                                numpy_params, t, tiny_sdxl, to_jax)

LATENT_ATOL = 5e-4


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_strip_geometry_matches_jax(k):
    jcfg, tcfg = jsdxl.tiny_config(), sdxl.tiny_config()
    rng = np.random.default_rng(k)
    for w in range(1, 25):
        assert multiconcept.crop_strips_ok(tcfg, w, k) == \
            jmc.crop_strips_ok(jcfg, w, k), (w, k)
        masks = rng.random((k, 3, w)).astype(np.float32)
        if not jmc.crop_strips_ok(jcfg, w, k):
            with pytest.raises(ValueError) as want:
                jmc.check_crop_strips(jcfg, jnp.asarray(masks), k)
            with pytest.raises(ValueError, match=str(want.value)):
                multiconcept.check_crop_strips(tcfg, t(masks), k)
            continue
        np.testing.assert_array_equal(
            multiconcept.check_crop_strips(tcfg, t(masks), k).numpy(),
            np.asarray(jmc.check_crop_strips(jcfg, jnp.asarray(masks), k)))
    assert not multiconcept.crop_strips_ok(tcfg, 8, 0)


@pytest.fixture(scope="module")
def tiny_cn():
    tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 12)
    cond = np.random.default_rng(13).random((1, H, W, 3)).astype(np.float32)
    return (jmc.ControlNetInputs(to_jax(tree), jnp.asarray(cond),
                                 jnp.float32(0.8)),
            multiconcept.ControlNetInputs(
                from_jax.controlnet_from_jax(
                    tree, config.tiny_controlnet(), device="cpu"),
                t(cond), 0.8))


@pytest.mark.parametrize("base_cn", [False, True],
                         ids=["plain", "base_controlnet"])
def test_cropped_stage2_matches_jax(golden, tiny_cn, base_cn):  # noqa: F811
    """Stage 1, then stage 2 with the concept lanes on strips (base rows
    full-frame, exact P2P, the base ControlNet on rows 0 and 2)."""
    g = golden
    jsch, sch = jsched.make_schedule("euler", 6), \
        schedulers.make_schedule("euler", 6)
    jcns, tcns = ([tiny_cn[0]], [tiny_cn[1]]) if base_cn else ([], [])
    jcn_kw = {"cn_cfg": jconfig.tiny_controlnet()} if base_cn else {}
    _, jcache = jmc.sample_stage1_cached(
        g["jcfg"], jsch, g["jparams"], key=jax.random.PRNGKey(7), height=H,
        width=W, base_inputs=g["jbase"], fusion_start=1,
        base_controlnets=jcns, **jcn_kw)
    _, cache = multiconcept.sample_stage1_cached(
        sdxl.tiny_config(), sch, g["model"], generator=None, height=H,
        width=W, base_inputs=g["base"], fusion_start=1,
        initial_noise=g["noise"], base_controlnets=tcns)
    want = jmc.sample_stage2_resumed(
        g["jcfg"], jsch, g["jparams"], jcache, base_inputs=g["jbase"],
        controller=g["jctl"], concept_inputs=[g["jconcept"]] * 2,
        concept_loras=[g["jlora"], None], masks=jnp.asarray(g["masks"]),
        fusion_start=1, concept_crop=True, base_controlnets=jcns, **jcn_kw)
    kw = dict(base_inputs=g["base"], controller=g["ctl"],
              concept_inputs=[g["concept"]] * 2,
              concept_loras=[g["lora"], None], masks=t(g["masks"]),
              fusion_start=1, base_controlnets=tcns)
    got = multiconcept.sample_stage2_resumed(
        sdxl.tiny_config(), sch, g["model"], cache, concept_crop=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LATENT_ATOL)
    exact = multiconcept.sample_stage2_resumed(
        sdxl.tiny_config(), sch, g["model"], cache, **kw)
    # copy A is stage 1's in both; copy B's concept lanes saw only strips
    torch.testing.assert_close(got[0], exact[0], rtol=0, atol=0)
    assert float((got[1] - exact[1]).abs().max()) > 1e-4


def test_two_stage_latents_with_crop_matches_jax(golden):  # noqa: F811
    g = golden
    jsch, sch = jsched.make_schedule("euler", 6), \
        schedulers.make_schedule("euler", 6)
    want = jmc.two_stage_latents(
        g["jcfg"], jsch, g["jparams"],
        jsched.scale_initial_noise(jsch, jnp.asarray(g["noise"])),
        g["jbase"], g["jctl"], [g["jconcept"]] * 2, [g["jlora"], None],
        jnp.asarray(g["masks"]), fusion_start=1, concept_crop=True)
    got = multiconcept.two_stage_latents(
        sdxl.tiny_config(), sch, g["model"],
        schedulers.scale_initial_noise(sch, t(g["noise"])), g["base"],
        g["ctl"], [g["concept"]] * 2, [g["lora"], None], t(g["masks"]),
        fusion_start=1, concept_crop=True)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   atol=LATENT_ATOL)


def test_crop_refuses_per_concept_controlnets(golden, tiny_cn):  # noqa: F811
    g = golden
    cache = multiconcept.StageCache(
        torch.zeros(1, 4, 4, 4), schedulers.init_state(None),
        a_traj=torch.zeros(4, 1, 4, 4, 4), a_final=torch.zeros(1, 4, 4, 4))
    jcache = jmc.StageCache(
        jnp.zeros((1, 4, 4, 4)), jsched.init_state(
            jsched.make_schedule("euler", 6), (1, 4, 4, 4)),
        a_traj=jnp.zeros((4, 1, 4, 4, 4)), a_final=jnp.zeros((1, 4, 4, 4)))
    with pytest.raises(ValueError) as want:
        jmc.sample_stage2_resumed(
            g["jcfg"], jsched.make_schedule("euler", 6), g["jparams"],
            jcache, base_inputs=g["jbase"], controller=None,
            concept_inputs=[g["jconcept"]] * 2, concept_loras=[None] * 2,
            masks=jnp.zeros((2, 4, 4)), fusion_start=1,
            concept_controlnets=[tiny_cn[0], None], concept_crop=True)
    with pytest.raises(ValueError) as got:
        multiconcept.sample_stage2_resumed(
            sdxl.tiny_config(), schedulers.make_schedule("euler", 6),
            g["model"], cache, base_inputs=g["base"], controller=None,
            concept_inputs=[g["concept"]] * 2, concept_loras=[None] * 2,
            masks=torch.zeros(2, 4, 4), fusion_start=1,
            concept_controlnets=[tiny_cn[1], None], concept_crop=True)
    assert str(got.value) == str(want.value)


def test_generate_with_concept_crop_matches_jax(monkeypatch):
    """A crop engine's ``generate`` within 1/255 of JAX's; a canvas whose
    latent width does not split into UNet-compatible strips, and
    ``generate_batch``, run the exact stage-2 program."""
    jp, tp = tiny_sdxl(seed=30)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=5, concept_crop=True)
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp, **kw)
    teng = omg.OMG(cfg=sdxl.tiny_config(), params=tp, **kw)
    rng = np.random.default_rng(31)
    loras = [mid_block_lora(rng, 64, 48, rank=2) for _ in range(2)]
    gen = dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=4,
               height=H, width=W, initial_noise=normal(rng, 1, 4, 4, 4))
    ran = []
    cropped = multiconcept._denoise_mc_range_traj_cropped
    monkeypatch.setattr(multiconcept, "_denoise_mc_range_traj_cropped",
                        lambda *a, **k: ran.append(1) or cropped(*a, **k))
    want = jeng.generate(PROMPT, concept_loras=[to_jax(x) for x in loras],
                         **gen)
    got = teng.generate(PROMPT, concept_loras=[
        from_jax.lora_from_jax(x, device="cpu") for x in loras], **gen)
    assert ran == [1]
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and np.abs(
            g.astype(int) - w.astype(int)).max() <= 1, name
    odd = teng.generate(PROMPT, prompt_rewrite=REWRITE, seed=4, height=H,
                        width=48)         # latent width 6: 3-wide strips
    assert odd.stage2 is not None and ran == [1]
    reqs = [dict(prompt=PROMPT, prompt_rewrite=REWRITE, seed=s, height=H,
                 width=W) for s in (1, 2)]
    assert all(r.stage2 is not None for r in teng.generate_batch(reqs))
    assert ran == [1]
