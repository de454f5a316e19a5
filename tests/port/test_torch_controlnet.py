"""The port's ControlNet (``models/controlnet.py``), its lane plumbing in
``pipelines/multiconcept.py`` and the UNet's residual inputs against the
JAX package at the tiny config, fp32. Every ControlNet here has seeded
non-zero zero-conv heads (a zero-initialized one is an exact no-op), and
the tests assert that its residuals are non-zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.models import controlnet as jcn
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.pipelines import multiconcept

from torch_port_helpers import normal, numpy_params, t, to_jax

REL = 2e-4          # of max |residual|, per module, fp32
HW, PIX = 4, 32     # latent and pixel side


def tiny_cn(seed=0):
    """(JAX tree, port module) of one tiny ControlNet, every leaf seeded
    (the heads included)."""
    tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), seed)
    return to_jax(tree), from_jax.controlnet_from_jax(
        tree, config.tiny_controlnet(), device="cpu")


def inputs(b, seed=1):
    rng = np.random.default_rng(seed)
    u = jconfig.tiny_unet()
    return dict(sample=normal(rng, b, HW, HW, 4),
                ehs=normal(rng, b, 77, u.cross_attention_dim),
                cond=rng.uniform(0, 1, (b, PIX, PIX, 3)).astype(np.float32),
                text=normal(rng, b, 16),
                tids=np.tile(np.float32([[32, 32, 0, 0, 32, 32]]), (b, 1)))


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def assert_residuals(got, want, name=""):
    """Port residuals (NCHW tensors) against JAX's (NHWC) within REL of
    max |want|; every one non-zero."""
    (gd, gm), (wd, wm) = got, want
    assert len(gd) == len(wd)
    for j, (g, w) in enumerate(list(zip(gd, wd)) + [(gm, wm)]):
        w = nchw(w)
        scale = np.abs(w).max()
        assert scale > 0, f"{name} residual {j} is zero"
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * scale,
                                   err_msg=f"{name} residual {j}")


@pytest.mark.parametrize("mode", ["plain", "guess", "per_lane"])
def test_controlnet_matches_jax(mode):
    jp, model = tiny_cn()
    x = inputs(3)
    scale = (np.float32([0.5, 1.0, 1.5])[:, None, None, None]
             if mode == "per_lane" else 0.7)
    guess = mode == "guess"
    want = jcn.apply(jp, jconfig.tiny_controlnet(), jnp.asarray(x["sample"]),
                     jnp.float32(501), jnp.asarray(x["ehs"]),
                     jnp.asarray(x["cond"]), text_embeds=jnp.asarray(x["text"]),
                     time_ids=jnp.asarray(x["tids"]),
                     conditioning_scale=jnp.asarray(scale), guess_mode=guess)
    got = model(t(x["sample"]), 501, t(x["ehs"]), t(x["cond"]),
                text_embeds=t(x["text"]), time_ids=t(x["tids"]),
                conditioning_scale=(t(scale) if mode == "per_lane"
                                    else scale), guess_mode=guess)
    assert_residuals(got, want, mode)


@pytest.mark.parametrize("window", [(0.0, 1.0), (0.2, 0.7), (0.5, 0.5),
                                    (0.0, 0.3), (0.34, 1.0)])
def test_cn_keep_windows(window):
    cn = multiconcept.ControlNetInputs(None, None, guidance_start=window[0],
                                       guidance_end=window[1])
    jcn_in = jmc.ControlNetInputs(None, None, 1.0, None, jnp.float32(window[0]),
                                  jnp.float32(window[1]))
    for steps in (4, 25, 50):
        got = [multiconcept._cn_keep(cn, i, steps) for i in range(steps)]
        want = [float(jmc._cn_keep(jcn_in, jnp.int32(i), steps))
                for i in range(steps)]
        assert got == want, (steps, got, want)


def _pair(jp, model, cond, scale=0.8, ehs=None, guess=False, start=0.0,
          end=1.0):
    """The same ControlNetInputs for both packages."""
    return (jmc.ControlNetInputs(
                jp, jnp.asarray(cond), jnp.float32(scale),
                None if ehs is None else jnp.asarray(ehs),
                jnp.float32(start), jnp.float32(end), guess_mode=guess),
            multiconcept.ControlNetInputs(
                model, t(cond), scale, None if ehs is None else t(ehs),
                start, end, guess_mode=guess))


@pytest.mark.parametrize("guess", [False, True])
def test_controlnet_residuals_with_cond_rows(guess):
    """Two ControlNets summed on the 3-row stage-2 base layout (rows 0
    and 2 conditional), one with its own context, at a step inside both
    windows."""
    (jp1, m1), (jp2, m2) = tiny_cn(0), tiny_cn(1)
    x = inputs(3, seed=2)
    rng = np.random.default_rng(3)
    c1 = rng.uniform(0, 1, (1, PIX, PIX, 3)).astype(np.float32)
    c2 = rng.uniform(0, 1, (1, PIX, PIX, 3)).astype(np.float32)
    # guess mode takes a CFG-stacked context's cond half; otherwise the
    # context broadcasts over the rows
    ehs2 = normal(rng, 2 if guess else 1, 5, 48)
    a1, b1 = _pair(jp1, m1, c1, 0.8, guess=guess, start=0.1, end=0.9)
    a2, b2 = _pair(jp2, m2, c2, 0.5, ehs=ehs2, guess=guess)
    want = jmc._controlnet_residuals(
        (a1, a2), jconfig.tiny_controlnet(), jnp.asarray(x["sample"]),
        jnp.int32(401), jnp.asarray(x["ehs"]), jnp.asarray(x["text"]),
        jnp.asarray(x["tids"]), step_i=jnp.int32(2), num_steps=10,
        cond_rows=(0, 2))
    got = multiconcept._controlnet_residuals(
        (b1, b2), t(x["sample"]), 401, t(x["ehs"]), t(x["text"]),
        t(x["tids"]), step_i=2, num_steps=10, cond_rows=(0, 2))
    assert_residuals(got, want, f"guess={guess}")
    if guess:
        assert float(got[1][1].abs().max()) == 0.0   # uncond row: zeros
    # outside the first ControlNet's window only the second one counts
    want = jmc._controlnet_residuals(
        (a1, a2), jconfig.tiny_controlnet(), jnp.asarray(x["sample"]),
        jnp.int32(401), jnp.asarray(x["ehs"]), jnp.asarray(x["text"]),
        jnp.asarray(x["tids"]), step_i=jnp.int32(9), num_steps=10,
        cond_rows=(0, 2))
    got = multiconcept._controlnet_residuals(
        (b1, b2), t(x["sample"]), 401, t(x["ehs"]), t(x["text"]),
        t(x["tids"]), step_i=9, num_steps=10, cond_rows=(0, 2))
    assert_residuals(got, want, "window")


@pytest.mark.parametrize("guess", [False, True])
def test_concept_cn_residuals_with_a_concept_without(guess):
    """K = 3 concepts, the middle one without an IdentityNet (zero-scale
    lanes), the others with their own scales and CFG-stacked tokens."""
    jp, model = tiny_cn(4)
    K = 3
    x = inputs(2 * K, seed=5)
    rng = np.random.default_rng(6)
    kimg = rng.uniform(0, 1, (1, PIX, PIX, 3)).astype(np.float32)
    toks = [normal(rng, 2, 4, 48) for _ in range(K)]
    pairs = [_pair(jp, model, kimg, s, ehs=e, guess=guess)
             for s, e in ((0.8, toks[0]), (0.6, toks[2]))]
    jcns = (pairs[0][0], None, pairs[1][0])
    tcns = (pairs[0][1], None, pairs[1][1])
    jci = [jmc.ConceptInputs(jnp.asarray(x["ehs"][:2]), None, None)] * K
    tci = [multiconcept.ConceptInputs(t(x["ehs"][:2]), None, None)] * K
    want = jmc._concept_cn_residuals(
        jcns, jci, jnp.asarray(x["sample"]), jnp.int32(301),
        jnp.asarray(x["text"]), jnp.asarray(x["tids"]),
        jconfig.tiny_controlnet(), step_i=jnp.int32(1), num_steps=4)
    got = multiconcept._concept_cn_residuals(
        tcns, tci, t(x["sample"]), 301, t(x["text"]), t(x["tids"]),
        step_i=1, num_steps=4)
    assert_residuals(got, want, f"guess={guess}")
    for r in got[0] + [got[1]]:
        assert float(r[2:4].abs().max()) == 0.0        # concept 1's lanes
    assert multiconcept._concept_cn_residuals(
        (None, None), tci[:2], t(x["sample"][:4]), 301, t(x["text"][:4]),
        t(x["tids"][:4])) == (None, None)


def test_validate_concept_controlnets():
    _, m1 = tiny_cn(0)
    _, m2 = tiny_cn(1)
    cond = torch.zeros(1, PIX, PIX, 3)
    a = multiconcept.ControlNetInputs(m1, cond, 0.8)
    multiconcept.validate_concept_controlnets([a, None, a._replace(scale=0.5)])
    with pytest.raises(ValueError, match="share one model"):
        multiconcept.validate_concept_controlnets(
            [a, multiconcept.ControlNetInputs(m2, cond, 0.8)])


def test_unet_with_residuals():
    """The UNet adds the residuals to its skips and after the mid block."""
    from omg_tpu_torch.pipelines import sdxl
    from torch_port_helpers import tiny_sdxl
    jparams, tparams = tiny_sdxl(seed=3)
    jp, model = tiny_cn(2)
    x = inputs(2, seed=7)
    jdown, jmid = jcn.apply(
        jp, jconfig.tiny_controlnet(), jnp.asarray(x["sample"]),
        jnp.float32(301), jnp.asarray(x["ehs"]), jnp.asarray(x["cond"]),
        text_embeds=jnp.asarray(x["text"]), time_ids=jnp.asarray(x["tids"]))
    want = junet.apply(jparams.unet, jconfig.tiny_unet(),
                       jnp.asarray(x["sample"]), jnp.float32(301),
                       jnp.asarray(x["ehs"]), text_embeds=jnp.asarray(
                           x["text"]), time_ids=jnp.asarray(x["tids"]),
                       down_block_residuals=jdown, mid_block_residual=jmid)
    down, mid = model(t(x["sample"]), 301, t(x["ehs"]), t(x["cond"]),
                      text_embeds=t(x["text"]), time_ids=t(x["tids"]))
    got = tparams.unet(t(x["sample"]), 301, t(x["ehs"]),
                       text_embeds=t(x["text"]), time_ids=t(x["tids"]),
                       down_block_residuals=down, mid_block_residual=mid)
    plain = tparams.unet(t(x["sample"]), 301, t(x["ehs"]),
                         text_embeds=t(x["text"]), time_ids=t(x["tids"]))
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=REL * scale)
    assert float((got - plain).abs().max()) > 1e-3 * scale
    assert sdxl.tiny_config().unet == config.tiny_controlnet().unet
