"""InstantID in the port against the JAX package: the resampler (through
the to_q rescale that makes the reference's q/k scaling equal the
upstream one), the scale defect itself, ``encode_face_tokens``, the IP
branch of ``Attention`` and of the UNet, ``draw_kps`` byte for byte, and
the keypoint boxes. Tiny configs, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import instantid as jiid
from omg_tpu.control import p2p as jp2p
from omg_tpu.models import resampler as jrs
from omg_tpu.models import unet as junet
from omg_tpu.nn import attention as jattention
from omg_tpu_torch import config, from_jax
from omg_tpu_torch import instantid as iid
from omg_tpu_torch.control import p2p
from omg_tpu_torch.models import resampler, unet
from omg_tpu_torch.nn import attention

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal, np_tree, numpy_params, t, tiny_sdxl, \
    to_jax

REL = 2e-4


def _close(got, want, rel=REL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=err_msg)


def jax_scaled(tree, cfg):
    """The JAX resampler tree whose function is the port's on ``tree``:
    to_q times dim_head ** 0.5 (q enters only the logits, where JAX's
    dim_head ** -1 then equals upstream's dim_head ** -0.5)."""
    out = jax.tree.map(lambda x: x, tree)
    for attn, _ in out["layers"]:
        attn["to_q"] = {"weight": attn["to_q"]["weight"] * cfg.dim_head ** 0.5}
    return to_jax(out)


@pytest.fixture(scope="module")
def rs_pair():
    tree = numpy_params(jrs.init_params, jconfig.tiny_resampler(), 3)
    return tree, from_jax.resampler_from_jax(tree, config.tiny_resampler(),
                                             device="cpu")


def test_resampler_matches_jax_through_the_to_q_rescale(rs_pair):
    tree, model = rs_pair
    emb = normal(np.random.default_rng(0), 2, 3, 16)
    want = jrs.apply(jax_scaled(tree, jconfig.tiny_resampler()),
                     jconfig.tiny_resampler(), jnp.asarray(emb))
    got = model(t(emb))
    assert got.shape == (2, 4, 48)
    _close(got.detach().numpy(), want)
    assert set(model.state_dict()) >= {"layers.0.0.to_out.weight",
                                        "layers.0.1.0.weight",
                                        "layers.0.1.1.weight",
                                        "layers.0.1.3.weight", "latents"}


def test_resampler_scale_defect_of_the_reference(rs_pair):
    """With identical weights the reference (q and k each times
    dim_head ** -0.5) and the port (each times dim_head ** -0.25, the
    upstream PerceiverAttention) give different tokens; the port's logits
    are those of the usual 1/sqrt(dim_head) attention."""
    tree, model = rs_pair
    emb = normal(np.random.default_rng(1), 1, 1, 16)
    ref = np.asarray(jrs.apply(to_jax(tree), jconfig.tiny_resampler(),
                               jnp.asarray(emb)))
    got = model(t(emb)).detach().numpy()
    assert np.abs(got - ref).max() > 1e-2 * np.abs(ref).max()
    # one attention, by hand, at 1/sqrt(dim_head)
    attn = model.layers[0][0]
    x = model.proj_in(t(emb))
    lat = model.latents.detach()
    xn, ln = attn.norm1(x), attn.norm2(lat)
    q = attn.to_q(ln).reshape(1, 4, 4, 8).transpose(1, 2)
    k, v = attn.to_kv(torch.cat([xn, ln], 1)).chunk(2, -1)
    k, v = (z.reshape(1, -1, 4, 8).transpose(1, 2) for z in (k, v))
    w = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5, -1)
    want = attn.to_out((w @ v).transpose(1, 2).reshape(1, 4, 32))
    torch.testing.assert_close(attn(x, lat), want, rtol=1e-5, atol=1e-6)


def test_encode_face_tokens(rs_pair):
    tree, model = rs_pair
    emb = normal(np.random.default_rng(2), 16)
    want = jiid.encode_face_tokens(jax_scaled(tree, jconfig.tiny_resampler()),
                                   jconfig.tiny_resampler(), jnp.asarray(emb))
    got = iid.encode_face_tokens(model, emb).detach()
    assert got.shape == (2, 4, 48)
    _close(got.numpy(), want)
    # row 0 is the resampler on a zeros embedding, not zero tokens
    _close(got[0].numpy(), model(torch.zeros(1, 1, 16))[0].detach().numpy())
    assert float(got[0].abs().max()) > 0


def _ip_tree(rng, n, ctx_dim, inner):
    return [{"to_k_ip": {"weight": normal(rng, ctx_dim, inner,
                                          scale=ctx_dim ** -0.5)},
             "to_v_ip": {"weight": normal(rng, ctx_dim, inner,
                                          scale=ctx_dim ** -0.5)}}
            for _ in range(n)]


@pytest.mark.parametrize("step", [0, 3])
def test_attention_ip_branch_after_the_p2p_edit(step):
    """A cross-attention with the IP branch and the P2P cross-lane edit:
    the IP term is added after the edit, on every lane."""
    rng = np.random.default_rng(step)
    jp = np_tree(jattention.init_mha(jax.random.PRNGKey(1), 32,
                                     context_dim=12, num_heads=4,
                                     head_dim=8))
    mod = from_jax.load_into(attention.Attention(
        32, context_dim=12, num_heads=4, head_dim=8), jp)
    ip_tree = _ip_tree(rng, 1, 12, 32)
    ip = from_jax.ip_layers_from_jax(ip_tree, config.tiny_unet(),
                                     device="cpu")[0]
    x, ctx, toks = normal(rng, 4, 9, 32), normal(rng, 4, 77, 12), \
        normal(rng, 4, 5, 12)
    kw = dict(cross_replace_steps=0.5, self_replace_steps=0.4, width=3,
              height=3)
    jctl = jp2p.P2PControl.build(["a b", "a b"], 5, **kw).at_step(
        jnp.asarray(step))
    ctl = p2p.P2PControl.build(["a b", "a b"], 5, **kw).at_step(step)
    want = jattention.mha(to_jax(jp), jnp.asarray(x), num_heads=4,
                          context=jnp.asarray(ctx), ip=to_jax(ip_tree[0]),
                          ip_context=jnp.asarray(toks), ip_scale=0.7,
                          p2p=jctl)
    got = mod(t(x), t(ctx), p2p=ctl, ip=ip, ip_context=t(toks), ip_scale=0.7)
    _close(got.detach().numpy(), want, rel=1e-5)
    # zero tokens: an exact no-op (to_v_ip has no bias)
    plain = mod(t(x), t(ctx), p2p=ctl)
    zero = mod(t(x), t(ctx), p2p=ctl, ip=ip,
               ip_context=torch.zeros(4, 5, 12), ip_scale=0.7)
    torch.testing.assert_close(zero, plain, rtol=0, atol=0)


def test_unet_ip_branch():
    """The UNet hands its IP layers to the attn2s in traversal order;
    lanes with zero tokens equal the forward without the branch."""
    jparams, tparams = tiny_sdxl(seed=4)
    ucfg = jconfig.tiny_unet()
    n = junet.num_cross_attention_layers(ucfg)
    assert n == unet.num_cross_attention_layers(config.tiny_unet()) == 4
    rng = np.random.default_rng(5)
    ip_tree = _ip_tree(rng, n, 48, 64)
    ips = from_jax.ip_layers_from_jax(ip_tree, config.tiny_unet(),
                                      device="cpu")
    x, ehs = normal(rng, 3, 4, 4, 4), normal(rng, 3, 77, 48)
    text, tids = normal(rng, 3, 16), np.tile(
        np.float32([[32, 32, 0, 0, 32, 32]]), (3, 1))
    toks = normal(rng, 3, 4, 48)
    toks[0] = 0.0
    want = junet.apply(jparams.unet, ucfg, jnp.asarray(x), jnp.float32(601),
                       jnp.asarray(ehs), text_embeds=jnp.asarray(text),
                       time_ids=jnp.asarray(tids),
                       ip_adapter=to_jax(ip_tree), ip_context=jnp.asarray(toks),
                       ip_scale=0.8)
    got = tparams.unet(t(x), 601, t(ehs), text_embeds=t(text),
                       time_ids=t(tids), ip_adapter=ips,
                       ip_context=t(toks), ip_scale=0.8)
    _close(got.numpy(), want)
    plain = tparams.unet(t(x), 601, t(ehs), text_embeds=t(text),
                         time_ids=t(tids))
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    assert float((got[1:] - plain[1:]).abs().max()) > 1e-3
    # one random IPKV per attn2, the widths of its block
    layers_ = unet.init_ip_layers(torch.Generator().manual_seed(0),
                                  config.tiny_unet())
    assert [m.to_k_ip.weight.shape for m in layers_] == \
        [torch.Size([64, 48])] * n


def _faces(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(30, 90, (2, 2))
    offs = np.float32([[-12, -8], [12, -8], [0, 2], [-9, 12], [9, 12]])
    return [(c + offs + rng.uniform(-2, 2, (5, 2))).astype(np.float32)
            for c in centers]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_kps_byte_equal(seed):
    faces = _faces(seed)
    got = iid.draw_kps(96, 128, faces)
    want = jiid.draw_kps(96, 128, faces)
    assert got.dtype == np.uint8 and got.shape == (96, 128, 3)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    cond = iid.kps_image_to_cond(got, device="cpu")
    np.testing.assert_array_equal(cond.numpy(),
                                  np.asarray(jiid.kps_image_to_cond(want)))


def test_face_region_box_and_the_kps_box_provider():
    faces = _faces(3) + [None]
    image = np.zeros((96, 128, 3), np.uint8)
    for kps in faces[:2]:
        np.testing.assert_array_equal(
            iid.face_region_box(kps, (96, 128)),
            jiid.face_region_box(kps, (96, 128)))
    got, want = iid.make_kps_box_provider(faces), \
        jiid.make_kps_box_provider(faces)
    for _ in range(5):
        g, w = got(image, "man"), want(image, "man")
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    assert iid.make_kps_box_provider([])(image, "man") is None


@pytest.mark.parametrize("fn", ["analyze_faces", "analyze_face",
                                "stage1_kps_provider"])
def test_face_analysis_raises_with_the_reference_message(fn):
    with pytest.raises(RuntimeError, match="insightface is not installed"):
        getattr(iid, fn)(np.zeros((8, 8, 3), np.uint8))


def test_init_params_draws_latents(rs_pair):
    model = resampler.init_params(torch.Generator().manual_seed(0),
                                  config.tiny_resampler())
    assert model.latents.device.type == "cpu"
    std = float(model.latents.std())
    assert 0.5 / 32 ** 0.5 < std < 2 / 32 ** 0.5
