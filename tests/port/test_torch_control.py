"""Euler schedule, P2P controller construction, region fusion and the
LoRA algebra of the port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import lora as jlora
from omg_tpu.control import p2p as jp2p
from omg_tpu.control import regions as jregions
from omg_tpu.diffusion import sampling as jsampling
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.text.tokenizer import ToyTokenizer
from omg_tpu_torch import from_jax
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import p2p, regions
from omg_tpu_torch.diffusion import sampling, schedulers

from torch_port_helpers import lora_leaf, normal, t, to_jax


@pytest.mark.parametrize("steps", [1, 4, 5, 7, 30, 50])
def test_euler_schedule_constants(steps):
    want = jsched.make_schedule("euler", steps)
    got = schedulers.make_schedule("euler", steps)
    np.testing.assert_array_equal(got.timesteps.numpy(),
                                  np.asarray(want.timesteps))
    for name in ("sigmas", "init_noise_sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.num_steps == steps


@pytest.mark.parametrize("i", [0, 17, 49])
def test_euler_step_scale_and_cfg(i):
    rng = np.random.default_rng(i)
    x, eps = normal(rng, 2, 4, 4, 4), normal(rng, 4, 4, 4, 4)
    js = jsched.make_schedule("euler", 50)
    ts = schedulers.make_schedule("euler", 50)
    np.testing.assert_allclose(
        schedulers.scale_model_input(ts, t(x), i).numpy(),
        np.asarray(jsched.scale_model_input(js, jnp.asarray(x), i)),
        rtol=1e-6)
    guided = sampling.cfg_combine(t(eps), 7.5)
    jguided = jsampling.cfg_combine(jnp.asarray(eps), jnp.float32(7.5))
    np.testing.assert_allclose(guided.numpy(), np.asarray(jguided),
                               rtol=1e-6, atol=1e-6)
    nxt, st = schedulers.step(ts, schedulers.init_state(), guided, i, t(x))
    jnxt, _ = jsched.step(js, jsched.init_state(js, x.shape), jguided, i,
                          jnp.asarray(x))
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jnxt), rtol=1e-6,
                               atol=1e-6)
    assert st.step_count == 1
    noise = schedulers.scale_initial_noise(ts, t(x))
    np.testing.assert_allclose(
        noise.numpy(), np.asarray(jsched.scale_initial_noise(
            js, jnp.asarray(x))), rtol=1e-6)


def test_other_schedulers_are_not_ported():
    """All four of the JAX package's kinds are ported; any other raises
    and names them (test_torch_schedulers.py holds the four to JAX)."""
    with pytest.raises(ValueError, match="ddim"):
        schedulers.make_schedule("heun", 10)
    assert schedulers.KINDS == tuple(jsched._KINDS)


@pytest.mark.parametrize("prompts,cross", [
    (["a man and a woman", "a man and a woman"], 1.0),
    (["a man and a woman", "a cat and a woman"], 0.6),
    (["a man and a woman", "a cat and a woman"],
     {"default_": 1.0, "cat": (0.2, 0.5)}),
])
def test_p2p_build(prompts, cross):
    tok = ToyTokenizer()
    kw = dict(cross_replace_steps=cross, self_replace_steps=0.4, width=32,
              height=32, tokenizer=tok)
    want = jp2p.P2PControl.build(prompts, 50, **kw)
    got = p2p.P2PControl.build(prompts, 50, **kw)
    np.testing.assert_array_equal(got.mapper.numpy(), np.asarray(want.mapper))
    np.testing.assert_array_equal(got.cross_alpha.numpy(),
                                  np.asarray(want.cross_alpha))
    assert (got.self_start, got.self_end, got.self_seq_limit) == (
        want.self_start, want.self_end, want.self_seq_limit)
    for step in (0, 19, 20):
        for nq in (1024, 4096):
            ws = got.at_step(step, src_lane=0, dst_lane=2)
            jws = want.at_step(jnp.asarray(step), src_lane=0, dst_lane=2)
            assert ws.wants(is_cross=False, num_queries=nq) == \
                jws.wants(is_cross=False, num_queries=nq)


@pytest.mark.parametrize("active", [False, True])
def test_fuse_region_edit(active):
    rng = np.random.default_rng(5)
    edit, preds = normal(rng, 2, 6, 8, 4), normal(rng, 3, 2, 6, 8, 4)
    masks = np.zeros((3, 6, 8), np.float32)
    masks[0, :, :4] = 1
    masks[1, 2:, 3:] = 1     # overlaps concept 0: contributions sum
    want = jregions.fuse_region_edit(jnp.asarray(edit), jnp.asarray(preds),
                                     jnp.asarray(masks),
                                     active=jnp.asarray(active))
    got = regions.fuse_region_edit(t(edit), t(preds), t(masks),
                                   active=active)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_make_concept_mask_stack():
    rng = np.random.default_rng(6)
    pixel = (rng.random((64, 48)) > 0.5).astype(np.float32)
    latent = (rng.random((8, 6)) > 0.5).astype(np.float32)
    masks = [pixel, None, latent]
    want = jregions.make_concept_mask_stack(masks, (8, 6), 4)
    got = regions.make_concept_mask_stack(masks, (8, 6), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_lora(seed, paths, rank):
    rng = np.random.default_rng(seed)
    tree = {}
    for a, b in paths:
        tree.setdefault(a, {})[b] = lora_leaf(rng, 6, 5, rank, scale=0.5)
    return tree


def _as_flat(jax_tree):
    return from_jax.lora_from_jax(jax.tree.map(np.asarray, jax_tree),
                                  device="cpu")


def _assert_flat_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        for role in ("down", "up", "scale"):
            np.testing.assert_allclose(got[k][role].numpy(),
                                       want[k][role].numpy(), atol=1e-6,
                                       err_msg=f"{k}.{role}")


def test_stack_loras():
    a = _jax_lora(0, [("attn1", "to_q"), ("attn1", "to_out")], 2)
    b = _jax_lora(1, [("attn1", "to_q"), ("attn2", "to_k")], 3)
    trees = [None, a, b]
    want = jlora.stack_loras([None if x is None else to_jax(x)
                              for x in trees], repeat=2)
    got = lora_lib.stack_loras([from_jax.lora_from_jax(x, device="cpu")
                                for x in trees],
                               repeat=2)
    _assert_flat_equal(got, _as_flat(want))
    assert got["attn1.to_q"]["down"].shape == (6, 6, 3)
    assert lora_lib.stack_loras([None, None]) is None


def test_merge_and_scale_loras():
    a = _jax_lora(2, [("attn1", "to_q"), ("attn1", "to_v")], 2)
    b = _jax_lora(3, [("attn1", "to_q"), ("ff", "net_2")], 4)
    want = jlora.scale_lora(jlora.merge_loras([to_jax(a), to_jax(b)],
                                              [0.7, 0.5]), 0.8)
    got = lora_lib.scale_lora(lora_lib.merge_loras(
        [from_jax.lora_from_jax(a, device="cpu"),
         from_jax.lora_from_jax(b, device="cpu")], [0.7, 0.5]),
        0.8)
    _assert_flat_equal(got, _as_flat(want))
    assert "ff.net.2" in got
    assert lora_lib.merge_loras([None, None], [1.0, 1.0]) is None
