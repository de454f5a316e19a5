"""Tiny UNet, VAE decoder and both CLIP encoders of the port against the
JAX package, with the same weights (from_jax) and numpy inputs (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import lora as jlora
from omg_tpu.control import p2p as jp2p
from omg_tpu.models import clip as jclip
from omg_tpu.models import unet as junet
from omg_tpu.models import vae as jvae
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import p2p
from omg_tpu_torch.models import unet
from omg_tpu_torch.pipelines import sdxl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (lora_leaf, mid_block_lora, normal, np_tree,
                                t, tiny_sdxl, to_jax)

ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    return tiny_sdxl()


def _unet_inputs(rng, b, cfg):
    s = cfg.sample_size
    tids = np.tile(np.asarray([[s * 8, s * 8, 0, 0, s * 8, s * 8]],
                              np.float32), (b, 1))
    return (normal(rng, b, s, s, 4), normal(rng, b, 77,
                                            cfg.cross_attention_dim),
            normal(rng, b, 16), tids)


def test_unet_plain(models):
    jp, tp = models
    cfg = jsdxl.tiny_config().unet
    sample, ehs, pooled, tids = _unet_inputs(np.random.default_rng(0), 2, cfg)
    want = junet.apply(jp.unet, cfg, jnp.asarray(sample), jnp.asarray(981),
                       jnp.asarray(ehs), text_embeds=jnp.asarray(pooled),
                       time_ids=jnp.asarray(tids))
    got = tp.unet(t(sample), 981, t(ehs), text_embeds=t(pooled),
                  time_ids=t(tids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("step", [1, 4])
def test_unet_seven_lanes_lora_p2p(models, step):
    """The stage-2 layout [cond_A, uncond_B, cond_B, c1 x2, c2 x2] with
    lane-stacked LoRA and P2P (src 0, dst 2), inside (step 1) and outside
    (step 4) the self-replace window. At the 16x16 tiny latent the level-1
    self-attention has 64 tokens, under the 8x8 = 64 limit."""
    jp, tp = models
    cfg = jsdxl.tiny_config().unet
    rng = np.random.default_rng(1)
    sample, ehs, pooled, tids = _unet_inputs(rng, 7, cfg)
    dim, ctx = cfg.block_out_channels[-1], cfg.cross_attention_dim
    concepts = [mid_block_lora(rng, dim, ctx), mid_block_lora(rng, dim, ctx,
                                                              rank=2)]
    lanes = [None] * 3 + [c for c in concepts for _ in range(2)]
    jlane = jlora.stack_loras([None if c is None else to_jax(c)
                               for c in lanes])
    lane = lora_lib.stack_loras([from_jax.lora_from_jax(c, device="cpu")
                                 for c in lanes])
    kw = dict(self_replace_steps=0.4, width=8, height=8)
    jctl = jp2p.P2PControl.build(["a", "a"], 5, **kw).at_step(
        jnp.asarray(step), src_lane=0, dst_lane=2)
    ctl = p2p.P2PControl.build(["a", "a"], 5, **kw).at_step(
        step, src_lane=0, dst_lane=2)
    want = junet.apply(jp.unet, cfg, jnp.asarray(sample), jnp.asarray(501),
                       jnp.asarray(ehs), text_embeds=jnp.asarray(pooled),
                       time_ids=jnp.asarray(tids), lora=jlane, control=jctl)
    got = tp.unet(t(sample), 501, t(ehs), text_embeds=t(pooled),
                  time_ids=t(tids), lora=lane, control=ctl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vae_decode(models):
    jp, tp = models
    lat = normal(np.random.default_rng(2), 2, 4, 5, 4)
    want = jvae.decode(jp.vae, jsdxl.tiny_config().vae, jnp.asarray(lat))
    got = tp.vae.decode(t(lat))
    assert got.shape == (2, 32, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _ids(seed, eos_at):
    ids = np.random.default_rng(seed).integers(2, 998, (2, 77))
    ids[:, 0] = 1
    for row, n in enumerate(eos_at):
        ids[row, n:] = 999
    return ids


@pytest.mark.parametrize("which", ["text_encoder", "text_encoder_2"])
@pytest.mark.parametrize("with_lora", [False, True])
def test_clip_encoders(models, which, with_lora):
    jp, tp = models
    cfg = getattr(jsdxl.tiny_config(), which)
    ids = _ids(3, (5, 40))
    jl = pl = None
    if with_lora:
        rng = np.random.default_rng(4)
        d = cfg.hidden_size
        tree = {"text_model": {"encoder": {"layers": [{
            "self_attn": {"q_proj": lora_leaf(rng, d, d),
                          "out_proj": lora_leaf(rng, d, d)},
            "mlp": {"fc1": lora_leaf(rng, d, cfg.intermediate_size)}}]}}}
        jl, pl = to_jax(tree), from_jax.lora_from_jax(tree, device="cpu")
    want = jclip.apply(getattr(jp, which), cfg, jnp.asarray(ids, jnp.int32),
                       jl)
    got = getattr(tp, which)(torch.from_numpy(ids), pl)
    for name in ("last_hidden_state", "penultimate", "pooled", "projected"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       err_msg=name)


def test_encode_tokens(models):
    jp, tp = models
    ids1, ids2 = _ids(5, (3, 77)), _ids(6, (9, 20))
    want = jsdxl.encode_tokens(jsdxl.tiny_config(), jp,
                               jnp.asarray(ids1, jnp.int32),
                               jnp.asarray(ids2, jnp.int32))
    got = sdxl.encode_tokens(sdxl.tiny_config(), tp, torch.from_numpy(ids1),
                             torch.from_numpy(ids2))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_init_params_scheme():
    """Random init draws from the generator: same seed, same weights;
    JAX's scheme (unit norms, zero biases, N(0, 1/fan_in) kernels)."""
    cfg = sdxl.tiny_config().unet
    a = unet.init_params(torch.Generator().manual_seed(3), cfg)
    b = unet.init_params(torch.Generator().manual_seed(3), cfg)
    for (name, x), y in zip(a.state_dict().items(),
                            b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert torch.all(a.conv_norm_out.weight == 1)
    assert torch.all(a.conv_in.bias == 0)
    w = a.mid_block.attentions[0].transformer_blocks[0].ff.net[2].weight
    assert abs(w.std().item() * w.shape[1] ** 0.5 - 1.0) < 0.1
    assert unet.num_cross_attention_layers(cfg) == \
        junet.num_cross_attention_layers(jsdxl.tiny_config().unet)


def test_init_params_follows_generator_device():
    """With no device named, the weights land on the generator's device
    and are the draws an explicit device gives."""
    cfg = sdxl.tiny_config().unet
    a = unet.init_params(torch.Generator().manual_seed(3), cfg)
    b = unet.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    assert {p.device for p in a.parameters()} == {torch.device("cpu")}
    for (name, x), y in zip(a.state_dict().items(),
                            b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


def test_sdxl_from_jax_on_cpu(models):
    """device="cpu" gives the modules that loading each one on the CPU
    gives, and every tensor lies on the CPU."""
    jp, tp = models
    cfg = sdxl.tiny_config()
    want = from_jax.load_into(unet.UNet2DConditionModel(cfg.unet),
                              np_tree(jp.unet))
    for (name, x), y in zip(tp.unet.state_dict().items(),
                            want.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    for m in tp:
        assert {p.device for p in m.parameters()} == {torch.device("cpu")}
    lora = from_jax.lora_from_jax({"lin": lora_leaf(np.random.default_rng(0),
                                                    4, 4)}, device="cpu")
    assert lora["lin"]["down"].device == torch.device("cpu")


def test_from_jax_without_device_needs_cuda(models, monkeypatch):
    """The default is the card: with no CUDA device a call that names no
    device raises rather than landing on the CPU."""
    jp, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax.sdxl_from_jax(np_tree(jp), sdxl.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax.lora_from_jax({"lin": lora_leaf(np.random.default_rng(0),
                                                 4, 4)})


def test_from_jax_rejects_mismatched_tree(models):
    jp, _ = models
    tree = np_tree(jp.unet)
    tree = dict(tree, conv_in={"weight": tree["conv_in"]["weight"]})
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_into(unet.UNet2DConditionModel(
            sdxl.tiny_config().unet), tree)
