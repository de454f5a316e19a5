"""Layers and attention of the port against the JAX package (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.control import p2p as jp2p
from omg_tpu.nn import attention as jattention
from omg_tpu.nn import layers as jlayers
from omg_tpu_torch import from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.nn import attention, layers

from torch_port_helpers import lora_leaf, normal, np_tree, t, to_jax

ATOL = 2e-4


def _linear(p, lora_key=""):
    lin = layers.Linear(*np.asarray(p["weight"]).shape, bias="bias" in p)
    from_jax.load_into(lin, p)
    lin.lora_key = lora_key
    return lin


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_with_lora(per_lane, bias):
    rng = np.random.default_rng(0)
    p = {"weight": normal(rng, 12, 20)}
    if bias:
        p["bias"] = normal(rng, 20)
    x = normal(rng, 3, 5, 12)
    if per_lane:
        leaf = {"down": normal(rng, 3, 12, 4), "up": normal(rng, 3, 4, 20),
                "scale": np.asarray([0.5, 0.0, 2.0], np.float32)}
    else:
        leaf = lora_leaf(rng, 12, 20, scale=0.7)
    want = np.asarray(jlayers.linear(to_jax(p), jnp.asarray(x),
                                     to_jax(leaf)))
    lin = _linear(p, "lin")
    got = lin(t(x), {"lin": from_jax.lora_from_jax({"lin": leaf},
                                                   device="cpu")["lin"]})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # no leaf for this layer: the plain product
    np.testing.assert_allclose(
        lin(t(x), {"other": {}}).numpy(),
        np.asarray(jlayers.linear(to_jax(p), jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("which", ["group", "layer"])
def test_norms_fp32_stats(which):
    rng = np.random.default_rng(1)
    p = {"weight": normal(rng, 16), "bias": normal(rng, 16)}
    x = normal(rng, 2, 6, 5, 16, scale=3.0) + 4.0
    if which == "group":
        want = jlayers.group_norm(to_jax(p), jnp.asarray(x), num_groups=4)
        mod = from_jax.load_into(layers.GroupNorm(16, 4), p)
        got = mod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        want = jlayers.layer_norm(to_jax(p), jnp.asarray(x))
        got = from_jax.load_into(layers.LayerNorm(16), p)(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_geglu_and_activations():
    rng = np.random.default_rng(2)
    p = {"weight": normal(rng, 8, 32), "bias": normal(rng, 32)}
    x = normal(rng, 2, 3, 8)
    want = jlayers.geglu(to_jax(p), jnp.asarray(x))
    np.testing.assert_allclose(layers.geglu(_linear(p), t(x)).numpy(),
                               np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(layers.quick_gelu(t(x)).numpy(),
                               np.asarray(jlayers.quick_gelu(x)), atol=ATOL)


@pytest.mark.parametrize("dim", [8, 9, 256, 320])
def test_timestep_embedding(dim):
    ts = np.asarray([0.0, 1.0, 981.0, 1024.0], np.float32)
    want = jlayers.timestep_embedding(jnp.asarray(ts), dim)
    np.testing.assert_allclose(
        layers.timestep_embedding(t(ts), dim).numpy(), np.asarray(want),
        atol=ATOL)


@pytest.mark.parametrize("src,dst", [((64, 64), (8, 8)), ((24, 40), (7, 9)),
                                     ((5, 6), (12, 13))])
def test_nearest_resize(src, dst):
    x = np.random.default_rng(3).standard_normal(src).astype(np.float32)
    want = np.asarray(jlayers.nearest_resize(jnp.asarray(x), dst))
    np.testing.assert_array_equal(layers.nearest_resize(t(x), dst).numpy(),
                                  want)
    x4 = np.broadcast_to(x[None, :, :, None], (2,) + src + (3,))
    np.testing.assert_array_equal(
        layers.nearest_resize(t(x4), dst).numpy(),
        np.asarray(jlayers.nearest_resize(jnp.asarray(x4), dst)))


def _mha_pair(seed, cross):
    rng = np.random.default_rng(seed)
    ctx_dim = 12 if cross else None
    jp = np_tree(jattention.init_mha(jax.random.PRNGKey(seed), 32,
                                     context_dim=ctx_dim, num_heads=4,
                                     head_dim=8))
    mod = from_jax.load_into(attention.Attention(
        32, context_dim=ctx_dim, num_heads=4, head_dim=8), jp)
    layers.set_lora_keys(mod)
    kin = ctx_dim or 32
    lora = {"to_q": lora_leaf(rng, 32, 32), "to_k": lora_leaf(rng, kin, 32),
            "to_v": lora_leaf(rng, kin, 32),
            "to_out": lora_leaf(rng, 32, 32)}
    return rng, jp, mod, lora


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("with_lora", [False, True])
def test_mha_with_lora(cross, with_lora):
    rng, jp, mod, lora = _mha_pair(4, cross)
    x = normal(rng, 2, 10, 32)
    ctx = normal(rng, 2, 7, 12) if cross else None
    jl = to_jax(lora) if with_lora else None
    want = jattention.mha(to_jax(jp), jnp.asarray(x), num_heads=4,
                          context=None if ctx is None else jnp.asarray(ctx),
                          lora=jl)
    got = mod(t(x), None if ctx is None else t(ctx),
              lora=(from_jax.lora_from_jax(lora, device="cpu")
                    if with_lora else None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("step", [0, 1, 3])
def test_mha_with_p2p(cross, step):
    """Lanes [unc_A, unc_B, cond_A, cond_B]; the self-replace window is
    steps [0, 2) of 5, so step 3 is outside it."""
    rng, jp, mod, _ = _mha_pair(5, cross)
    x = normal(rng, 4, 9, 32)
    ctx = normal(rng, 4, 77, 12) if cross else None
    kw = dict(cross_replace_steps=0.5, self_replace_steps=0.4, width=3,
              height=3)
    jctl = jp2p.P2PControl.build(["a b", "a b"], 5, **kw).at_step(
        jnp.asarray(step))
    ctl = p2p.P2PControl.build(["a b", "a b"], 5, **kw).at_step(step)
    want = jattention.mha(to_jax(jp), jnp.asarray(x), num_heads=4,
                          context=None if ctx is None else jnp.asarray(ctx),
                          p2p=jctl)
    got = mod(t(x), None if ctx is None else t(ctx), p2p=ctl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the edit touched the cond-B lane only
    plain = mod(t(x), None if ctx is None else t(ctx))
    torch.testing.assert_close(got[:3], plain[:3], rtol=0, atol=0)
