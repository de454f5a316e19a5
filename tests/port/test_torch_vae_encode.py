"""The port's VAE encoder half against ``omg_tpu/models/vae.py:encode``
on the CPU (fp32, the same weights through ``from_jax``), the forms of
``tests/test_vae.py`` (shapes, determinism, the posterior sample, the
scaling factor), the loaders that now keep ``encoder.*``, and the seeded
draws that the encoder must not move."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import loader as jloader
from omg_tpu.models import vae as jvae
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax, loader
from omg_tpu_torch.models import clip, unet, vae
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import sdxl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (np_tree, numpy_params, t,
                                write_tiny_checkpoint)

ATOL = 2e-4


@pytest.fixture(scope="module")
def tiny():
    tree = numpy_params(jvae.init_params, jsdxl.tiny_config().vae, seed=12)
    return (jax.tree.map(jnp.asarray, tree),
            from_jax.load_into(vae.AutoencoderKL(sdxl.tiny_config().vae),
                               tree))


def _images(seed, *shape):
    return (np.random.default_rng(seed).uniform(-1, 1, shape)
            .astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 40, 3),
                                   (1, 64, 24, 3)])
def test_encode_matches_jax(tiny, shape):
    """The mean (deterministic mode) within 2e-4; the downsamplers'
    right/bottom pad shows on non-square inputs."""
    jp, model = tiny
    img = _images(1, *shape)
    want = np.asarray(jvae.encode(jp, jsdxl.tiny_config().vae,
                                  jnp.asarray(img)))
    got = model.encode(t(img))
    f = 2 ** (len(model.cfg.block_out_channels) - 1)
    assert got.shape == (shape[0], shape[1] // f, shape[2] // f, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_posterior_sample_matches_jax(tiny):
    """The sample with JAX's ``normal(key, ...)`` as eps within 2e-4; a
    generator's draw is seeded: the same seed the same latents, another
    seed others, and both differ from the mean."""
    jp, model = tiny
    img = _images(2, 2, 32, 32, 3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jvae.encode(jp, jsdxl.tiny_config().vae,
                                  jnp.asarray(img), key=key))
    eps = jax.random.normal(key, want.shape, jnp.float32)
    got = model.encode(t(img), noise=t(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    s1 = model.encode(t(img), torch.Generator().manual_seed(2))
    s1b = model.encode(t(img), torch.Generator().manual_seed(2))
    s2 = model.encode(t(img), torch.Generator().manual_seed(3))
    assert torch.equal(s1, s1b) and not torch.allclose(s1, s2)
    assert not torch.allclose(s1, model.encode(t(img)))


def test_encode_decode_round_trip(tiny):
    """``tests/test_vae.py``'s forms: decode(encode(x)) has x's shape and
    is finite, the mode is deterministic, and the scaling factor is live
    (decode(lat) != decode(2 lat)); the round trip equals JAX's."""
    jp, model = tiny
    img = (np.random.default_rng(3).standard_normal((2, 32, 32, 3)) * 0.5
           ).astype(np.float32)
    lat = model.encode(t(img))
    assert torch.equal(lat, model.encode(t(img)))
    out = model.decode(lat)
    assert out.shape == img.shape and torch.isfinite(out).all()
    assert not torch.allclose(out, model.decode(lat * 2.0))
    jcfg = jsdxl.tiny_config().vae
    want = jvae.decode(jp, jcfg, jvae.encode(jp, jcfg, jnp.asarray(img)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_load_sdxl_keeps_the_encoder(tmp_path):
    """``loader.load_sdxl`` from a checkout whose VAE file has ``encoder.*``
    and ``quant_conv.*``: the encoder half bit-equal to ``from_jax`` of
    the JAX loader's tree, and it encodes."""
    root = write_tiny_checkpoint(tmp_path, seed=5)
    _, params, _, _ = loader.load_sdxl(root, dtype=torch.float32,
                                       device="cpu")
    _, jparams, _, _ = jloader.load_sdxl(root, dtype=jnp.float32, pack=False)
    want = from_jax.load_into(vae.AutoencoderKL(params.vae.cfg),
                              np_tree(jparams.vae)).state_dict()
    got = params.vae.state_dict()
    enc = [k for k in want if k.startswith(("encoder.", "quant_conv."))]
    assert enc and set(got) == set(want)
    for k in enc:
        assert torch.equal(got[k], want[k]), k
    assert params.vae.encode(t(_images(4, 1, 32, 32, 3))).shape == \
        (1, 4, 4, 4)


def test_seeded_draws_of_the_other_weights_unchanged():
    """``sdxl.init_params`` draws the encoder last: every other weight is
    what the draw order before the encoder (UNet, VAE decoder, both text
    encoders from one generator) gives; ``vae.init_params`` alone draws
    the decoder first, then the encoder."""
    cfg = sdxl.tiny_config()
    got = sdxl.init_params(torch.Generator().manual_seed(11), cfg, "cpu")
    g = torch.Generator().manual_seed(11)
    before = [unet.init_params(g, cfg.unet, "cpu"),
              layers.init_params(vae.AutoencoderKL(cfg.vae, "cpu",
                                                   encoder=False), g),
              clip.init_params(g, cfg.text_encoder, "cpu"),
              clip.init_params(g, cfg.text_encoder_2, "cpu")]
    for new, old in zip(got, before):
        sd = new.state_dict()
        for k, v in old.state_dict().items():
            assert torch.equal(sd[k], v), k
    alone = vae.init_params(torch.Generator().manual_seed(11), cfg.vae)
    g = torch.Generator().manual_seed(11)
    dec = layers.init_params(vae.AutoencoderKL(cfg.vae, encoder=False), g)
    sd = alone.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in dec.state_dict().items())
    w = alone.encoder.conv_in.weight
    assert w.abs().sum() > 0 and abs(w.std().item() * 27 ** 0.5 - 1) < 0.3
