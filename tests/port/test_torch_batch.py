"""Request batching: the port's ``OMG.generate_batch`` against the JAX
engine's and against its own serial ``generate``, at the tiny config.
The port draws its initial latents from a CPU generator seeded with the
request's seed; here that draw is replaced by JAX's ``PRNGKey(seed)``
draw, so both engines start from the same noise. Latents within 5e-4
(tests/test_golden.py's bound), uint8 images within 1."""

import jax
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import lora as jlora
from omg_tpu.models import controlnet as jcn
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config, from_jax
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from test_torch_conditioned_pipeline import _instantid_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, mid_block_lora,
                                numpy_params, t, tiny_sdxl, to_jax)

LATENT_ATOL = 5e-4
H = W = 32
REWRITE = "[the man]-*-[b]|[the woman]-*-[b]"


@pytest.fixture(scope="module")
def setup():
    jp, tp = tiny_sdxl(seed=50)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=4)
    rng = np.random.default_rng(51)
    dim = jsdxl.tiny_config().unet.block_out_channels[-1]
    ctx = jsdxl.tiny_config().unet.cross_attention_dim
    loras = [mid_block_lora(rng, dim, ctx, rank=2) for _ in range(2)]
    cn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 52)
    return dict(
        jeng=jomg.OMG(cfg=jsdxl.tiny_config(), params=jp,
                      cn_cfg=jconfig.tiny_controlnet(), **kw),
        teng=omg.OMG(cfg=sdxl.tiny_config(), params=tp,
                     cn_cfg=config.tiny_controlnet(), **kw),
        jloras=[{"unet": to_jax(x)} for x in loras],
        tloras=[{"unet": from_jax.lora_from_jax(x, device="cpu")}
                for x in loras],
        jcn=to_jax(cn_tree),
        tcn=from_jax.controlnet_from_jax(cn_tree, config.tiny_controlnet(),
                                         device="cpu"),
        cond=rng.integers(0, 256, (H, W, 3), dtype=np.uint8))


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's seeded draw replaced by JAX's PRNGKey(seed) draw."""
    def prepare(generator, batch, height, width, sched, dtype=torch.float32,
                device=None):
        noise = jax.random.normal(jax.random.PRNGKey(generator.initial_seed()),
                                  (batch, height // 8, width // 8, 4))
        return schedulers.scale_initial_noise(sched, t(noise)).to(
            device=device, dtype=dtype)
    monkeypatch.setattr(sdxl, "prepare_latents", prepare)


def _record(monkeypatch, mod, store, key, names):
    for i, name in enumerate(names):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _i=i, **k):
            out = _fn(*a, **k)
            store.setdefault(f"{key}{_i + 1}", []).append(
                np.asarray(out[0] if isinstance(out, tuple) else out))
            return out
        monkeypatch.setattr(mod, name, wrapped)


BATCH = ("sample_stage1_batch", "sample_stage2_batch")
SERIAL = ("sample_stage1_cached", "sample_stage2_resumed")


def _requests(setup, pkg, *, seeds=(3, 9), ks=(2, 2)):
    """tests/test_omg_pipeline.py's pair: different prompts, seeds,
    guidance scales and adapters (``ks``: each request's concept count)."""
    loras = setup["jloras" if pkg == "jax" else "tloras"]
    rewrites = {1: "[the man]-*-[b]", 2: REWRITE}
    return [
        dict(prompt="the man and the woman", negative_prompt="bad",
             prompt_rewrite=rewrites[ks[0]],
             concept_loras=[loras[0], None][:ks[0]], seed=seeds[0],
             height=H, width=W, guidance_scale=7.5),
        dict(prompt="the man and the woman at night", negative_prompt="ugly",
             prompt_rewrite=rewrites[ks[1]],
             concept_loras=[loras[1], None][:ks[1]], seed=seeds[1],
             height=H, width=W, guidance_scale=5.0)]


def _compare(got, want, lat, a="t", b="j"):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.stage2 is None) == (w.stage2 is None)
        for name in ("stage1", "stage2"):
            gi, wi = getattr(g, name), getattr(w, name)
            if gi is not None:
                assert gi.dtype == np.uint8 and gi.shape == (2, H, W, 3)
                assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1
    for s in "12":
        x, y = (np.concatenate([v.reshape((-1,) + v.shape[-3:])
                                for v in lat[k + s]]) for k in (a, b))
        np.testing.assert_allclose(x, y, atol=LATENT_ATOL,
                                   err_msg=f"stage {s}")


@pytest.mark.parametrize("ks", [(2, 2), (1, 2)], ids=["same_k", "mixed_k"])
def test_generate_batch_matches_jax(setup, monkeypatch, jax_noise, ks):
    lat: dict = {}
    _record(monkeypatch, jmc, lat, "j", BATCH)
    _record(monkeypatch, multiconcept, lat, "t", BATCH)
    want = setup["jeng"].generate_batch(_requests(setup, "jax", ks=ks))
    got = setup["teng"].generate_batch(_requests(setup, "torch", ks=ks))
    assert all(g.stage2 is not None for g in got)
    _compare(got, want, lat)
    assert set(got[0].timings) == {"encode", "stage1", "decode", "masks",
                                   "stage2"}


@pytest.mark.parametrize("kind", ["dpmpp_2m", "lcm"])
def test_batched_equals_serial(setup, monkeypatch, kind):
    """The port's batch against its own ``generate`` per request: each
    request keeps its scheduler state (DPM++2M's previous x0, LCM's
    re-noise seed)."""
    lat: dict = {}
    _record(monkeypatch, multiconcept, lat, "b", BATCH)
    _record(monkeypatch, multiconcept, lat, "s", SERIAL)
    reqs = _requests(setup, "torch", ks=(1, 2))
    for r in reqs:
        r["scheduler"] = kind
    got = setup["teng"].generate_batch([dict(r) for r in reqs])
    want = [setup["teng"].generate(r.pop("prompt"), **r) for r in reqs]
    _compare(got, want, lat, "b", "s")


def test_config5_batch_matches_jax(setup, monkeypatch, jax_noise):
    """BASELINE config #5 (InstantID, a spatial ControlNet and a style
    LoRA) batched with a ControlNet-only request with a guidance window
    (tests/test_omg_pipeline.py:489-555 has InstantID and the ControlNet
    on separate requests): the zero-token IP and zero-scale IdentityNet
    rows of the second request are no-ops."""
    jid, tid, faces, kimg = _instantid_pair(None)
    style = mid_block_lora(np.random.default_rng(54), 64, 48, rank=3)
    lat: dict = {}
    _record(monkeypatch, jmc, lat, "j", BATCH)
    _record(monkeypatch, multiconcept, lat, "t", BATCH)

    def reqs(pkg):
        cn = setup["jcn" if pkg == "jax" else "tcn"]
        return [
            dict(prompt="the man and the woman", negative_prompt="bad",
                 prompt_rewrite=REWRITE, seed=3, height=H, width=W,
                 guidance_scale=3.0,
                 instantid=jid if pkg == "jax" else tid,
                 face_embeddings=faces, face_kps_image=kimg,
                 spatial_condition=setup["cond"][::-1].copy(),
                 controlnet_params=cn, controlnet_scale=0.6,
                 style_lora=(to_jax(style) if pkg == "jax" else
                             from_jax.lora_from_jax(style, device="cpu"))),
            dict(prompt="the man and the woman at night",
                 negative_prompt="ugly", prompt_rewrite=REWRITE, seed=9,
                 height=H, width=W, guidance_scale=7.5,
                 spatial_condition=setup["cond"], controlnet_params=cn,
                 controlnet_scale=0.8, control_guidance_start=0.1,
                 control_guidance_end=0.9)]
    want = setup["jeng"].generate_batch(reqs("jax"))
    got = setup["teng"].generate_batch(reqs("torch"))
    _compare(got, want, lat)


def test_serial_fallbacks_and_bucket_errors(setup, monkeypatch):
    teng = setup["teng"]

    def refuse(*a, **k):
        raise AssertionError("ran the batched program")
    monkeypatch.setattr(multiconcept, "sample_stage1_batch", refuse)
    base = _requests(setup, "torch")
    masks = [np.ones((H, W), np.float32), None]
    other_cn = from_jax.controlnet_from_jax(
        numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 53),
        config.tiny_controlnet(), device="cpu")
    for over in ({"masks": masks}, {"controlnet_guess_mode": True},
                 {"initial_noise": np.zeros((1, 4, 4, 4), np.float32)}):
        out = teng.generate_batch([dict(base[0], **over), base[1]])
        assert len(out) == 2 and out[0].stage2 is not None
    one = teng.generate_batch([base[0]])
    r = dict(base[0])
    np.testing.assert_array_equal(one[0].image,
                                  teng.generate(r.pop("prompt"), **r).image)
    cns = [dict(b, spatial_condition=setup["cond"], controlnet_params=c)
           for b, c in zip(base, (setup["tcn"], other_cn))]
    assert len(teng.generate_batch(cns)) == 2
    monkeypatch.undo()
    with pytest.raises(ValueError, match="bucket them"):
        teng.generate_batch([base[0], dict(base[1], scheduler="ddim")])
    with pytest.raises(ValueError, match="bucket them"):
        teng.generate_batch([base[0], dict(base[1], num_steps=3)])
    with pytest.raises(NotImplementedError, match="approximate modes"):
        teng.generate_batch([base[0], dict(base[1], cache_interval=2)])


def test_requests_take_generate_defaults(setup):
    """A batched request reads every field it leaves out from
    ``generate``'s own defaults, and an unknown field fails as it would
    in ``generate``."""
    import inspect
    teng = setup["teng"]
    params = inspect.signature(teng.generate).parameters
    args = teng._request_args({"prompt": "a", "seed": 3})
    assert list(args) == list(params)
    assert args["seed"] == 3 and args["prompt"] == "a"
    assert all(args[k] == p.default for k, p in params.items()
               if k not in ("prompt", "seed"))
    with pytest.raises(TypeError):
        teng._request_args({"prompt": "a", "guidance": 5.0})


def test_empty_suffix_returns_stage1_twice(setup):
    """fusion_start + 1 >= steps: stage 2 is copy A of stage 1, twice."""
    cache = multiconcept.StageCache(torch.zeros(1, 4, 4, 4), None,
                                    a_final=torch.ones(1, 4, 4, 4))
    out = multiconcept.sample_stage2_batch(
        sdxl.tiny_config(), schedulers.make_schedule("euler", 4), None,
        [cache, cache], [None, None], None, [[], []], [[], []],
        torch.zeros(2, 0, 4, 4), fusion_start=3)
    assert out.shape == (2, 2, 4, 4, 4) and bool((out == 1).all())


def test_align_loras_matches_jax():
    """Different ranks, a path only one adapter has, and None."""
    rng = np.random.default_rng(60)
    a = mid_block_lora(rng, 64, 48, rank=2)
    b = mid_block_lora(rng, 64, 48, rank=4)
    del b["mid_block"]["attentions"][0]["transformer_blocks"][0]["ff"]
    trees = [a, None, b]
    want = jlora.align_loras([to_jax(x) if x else None for x in trees])
    got = lora_lib.align_loras([from_jax.lora_from_jax(x, device="cpu")
                                if x else None for x in trees])
    for g, w in zip(got, want):
        w = from_jax.lora_from_jax(jax.tree.map(np.asarray, w), device="cpu")
        assert sorted(g) == sorted(w)
        for key in g:
            for role in ("down", "up", "scale"):
                np.testing.assert_array_equal(g[key][role].numpy(),
                                              w[key][role].numpy())
    assert all(float(leaf["scale"]) == 0 for leaf in got[1].values())
    assert lora_lib.align_loras([None, None]) == [None, None]
