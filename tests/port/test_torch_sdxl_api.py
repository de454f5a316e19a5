"""The plain SDXL API of the port against the JAX package on the CPU:
``sampling.denoise_loop`` (every scheduler kind), ``sdxl.make_inputs``,
``denoise``, ``text_to_image`` (BASELINE config #1), the bf16 decode,
the CLIP presets and ``regions.masks_to_latent``, with the same weights
(``from_jax``) and numpy-seeded inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.control import regions as jregions
from omg_tpu.diffusion import sampling as jsampling
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config
from omg_tpu_torch.control import regions
from omg_tpu_torch.diffusion import sampling, schedulers
from omg_tpu_torch.pipelines import sdxl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal, t, tiny_sdxl

MODULE_TOL = 2e-4       # one module in fp32
PIPELINE_TOL = 5e-4     # the golden two-stage tolerance, on the image
# bf16 decode: the port computes in bf16, the JAX decode in fp32 on
# bf16-rounded weights and latents, so each of the decoder's ~20 layers
# may round apart by 2^-8 relative. Bound: 8 uint8 levels at any pixel,
# one level on average.
BF16_MAX, BF16_MEAN = 2.0 ** -5, 2.0 ** -8


@pytest.fixture(scope="module")
def models():
    return tiny_sdxl(seed=7)


def _toy_model(xp):
    def model_fn(x, t_, i):
        return 0.1 * x * (1.0 + t_ / 1000.0) + 0.01 * (i + 1)
    return model_fn


@pytest.mark.parametrize("kind", schedulers.KINDS)
def test_denoise_loop_matches_jax(kind, monkeypatch):
    """The loop of one toy ``model_fn`` (timestep and step index used) for
    every kind, within 1e-6 of max |want|; LCM with JAX's draws (the
    state's default PRNGKey(0), ``fold_in`` per step) injected."""
    steps = 6
    x = normal(np.random.default_rng(1), 2, 4, 4, 4)
    js = jsched.make_schedule(kind, steps)
    want = jsampling.denoise_loop(js, _toy_model(jnp), jnp.asarray(x))

    def jax_draw(seed, i, shape, device):
        assert seed == 0
        return t(jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(0), i), shape, jnp.float32)).to(device)
    monkeypatch.setattr(schedulers, "step_noise", jax_draw)
    got = sampling.denoise_loop(schedulers.make_schedule(kind, steps),
                                _toy_model(torch), t(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1.0))


def _conditioning(rng, b=1):
    cfg = jsdxl.tiny_config()
    d = cfg.text_encoder.hidden_size + cfg.text_encoder_2.hidden_size
    p = cfg.text_encoder_2.projection_dim
    return (normal(rng, b, 77, d), normal(rng, b, p), normal(rng, b, 77, d),
            normal(rng, b, p),
            np.asarray([[64, 64, 0, 0, 64, 64]], np.float32))


def test_make_inputs_exactly():
    args = _conditioning(np.random.default_rng(2), b=2)
    want = jsdxl.make_inputs(*map(jnp.asarray, args), 5.5)
    got = sdxl.make_inputs(*map(t, args), 5.5)
    assert isinstance(got, sdxl.DenoiseInputs)
    for name in sdxl.DenoiseInputs._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_denoise_matches_jax(models):
    jp, tp = models
    rng = np.random.default_rng(3)
    args = _conditioning(rng)
    lat = normal(rng, 1, 8, 8, 4)
    want = jsdxl.denoise(jsdxl.tiny_config(), jsched.make_schedule("euler", 3),
                         jp.unet, jnp.asarray(lat),
                         jsdxl.make_inputs(*map(jnp.asarray, args), 7.5))
    got = sdxl.denoise(sdxl.tiny_config(), schedulers.make_schedule("euler", 3),
                       tp.unet, t(lat), sdxl.make_inputs(*map(t, args), 7.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_TOL)


def test_text_to_image_matches_jax(models, monkeypatch):
    """Config #1 end to end at 64x64, 3 Euler steps: the port's seeded
    draw replaced by JAX's ``PRNGKey`` draw, so both start from the same
    noise; the image within 5e-4."""
    jp, tp = models
    cfg = jsdxl.tiny_config()
    rng = np.random.default_rng(4)
    ids = {name: rng.integers(0, cfg.text_encoder.vocab_size, (1, 77))
           .astype(np.int32) for name in ("ids1_pos", "ids2_pos",
                                           "ids1_neg", "ids2_neg")}
    key = jax.random.PRNGKey(9)
    want = jsdxl.text_to_image(cfg, jp, key=key, height=64, width=64,
                               steps=3, guidance_scale=6.0,
                               **{k: jnp.asarray(v) for k, v in ids.items()})

    def prepare(generator, batch, height, width, sched, dtype=torch.float32,
                device=None):
        assert generator.initial_seed() == 9
        noise = jax.random.normal(key, (batch, height // 8, width // 8, 4))
        return schedulers.scale_initial_noise(sched, t(noise)).to(
            device=device, dtype=dtype)
    monkeypatch.setattr(sdxl, "prepare_latents", prepare)
    got = sdxl.text_to_image(sdxl.tiny_config(), tp,
                             generator=torch.Generator().manual_seed(9),
                             height=64, width=64, steps=3,
                             guidance_scale=6.0,
                             **{k: torch.from_numpy(v.astype(np.int64))
                                for k, v in ids.items()})
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PIPELINE_TOL)


def test_decode_latents_bf16(models):
    """bf16 against JAX's bf16 decode within the bound stated above (and
    against the port's own fp32 decode); the cast copy is made once and
    kept outside the module's state; the fp32 default is the VAE's own
    decode bit for bit."""
    jp, tp = models
    lat = normal(np.random.default_rng(5), 2, 8, 8, 4)
    want = np.asarray(jsdxl.decode_latents(jsdxl.tiny_config(), jp.vae,
                                           jnp.asarray(lat),
                                           dtype=jnp.bfloat16))
    keys = set(tp.vae.state_dict())
    got = sdxl.decode_latents(sdxl.tiny_config(), tp.vae, t(lat),
                              dtype=torch.bfloat16)
    fp32 = sdxl.decode_latents(sdxl.tiny_config(), tp.vae, t(lat))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 3)
    for ref in (want, fp32.numpy()):
        diff = np.abs(got.numpy() - ref)
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, \
            (diff.max(), diff.mean())
    assert not torch.equal(got, fp32)
    copy = tp.vae.decoder_copy(torch.bfloat16)
    assert copy is tp.vae.decoder_copy(torch.bfloat16)
    assert {p.dtype for p in copy.parameters()} == {torch.bfloat16}
    assert not hasattr(copy, "encoder") and set(tp.vae.state_dict()) == keys
    assert tp.vae.decoder_copy(torch.float32) is tp.vae
    own = torch.clamp(tp.vae.decode(t(lat)).float() / 2 + 0.5, 0.0, 1.0)
    assert torch.equal(fp32, own)


def _fields(cfg):
    return {f.name: (str(getattr(cfg, f.name)).split(".")[-1].rstrip("'>")
                     if f.name == "dtype" else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", ["clip_vit_l14_text", "clip_vit_l14_vision",
                                  "tiny_clip_vision"])
def test_clip_presets_match_jax(name):
    got, want = getattr(config, name)(), getattr(jconfig, name)()
    assert _fields(got) == _fields(want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("hw,latent_hw", [((64, 48), (8, 6)),
                                          ((37, 53), (5, 7)),
                                          ((16, 16), (24, 40))])
def test_masks_to_latent_exactly(hw, latent_hw):
    masks = (np.random.default_rng(6).random((3,) + hw) > 0.5
             ).astype(np.float32)
    want = jregions.masks_to_latent(jnp.asarray(masks), latent_hw)
    got = regions.masks_to_latent(torch.from_numpy(masks), latent_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
