"""The condition preprocessors of the port (``models/openpose.py``,
``models/dpt.py``) against the JAX modules on the CPU: the OpenPose
network at width 0.125 and the tiny DPT within 2e-4 abs / 2e-3 rel, the
estimators on the same maps, the checkpoint converters and loaders on
files the tests write, and ``prepare_condition`` with both providers."""

import json

import jax
import numpy as np
import pytest
import torch

from omg_tpu import convert as jconvert
from omg_tpu.models import dpt as jdpt
from omg_tpu.models import openpose as jop
from omg_tpu.serving import conditions as jcond
from omg_tpu_torch import convert, from_jax
from omg_tpu_torch.models import dpt, openpose
from omg_tpu_torch.serving import conditions

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import numpy_params, t, to_jax

ATOL, RTOL = 2e-4, 2e-3
WIDTH = 0.125


@pytest.fixture(scope="module")
def body():
    tree = numpy_params(lambda k, _: jop.init_params(k, width_mult=WIDTH),
                        None, seed=3)
    return tree, from_jax.openpose_from_jax(tree, width_mult=WIDTH,
                                            device="cpu")


@pytest.fixture(scope="module")
def tiny_dpt():
    cfg_j, cfg_t = jdpt.tiny_config(), dpt.tiny_config()
    tree = numpy_params(jdpt.init_params, cfg_j, seed=4)
    return tree, cfg_j, cfg_t, from_jax.dpt_from_jax(tree, cfg_t,
                                                     device="cpu")


def test_openpose_network_matches_jax(body):
    tree, model = body
    x = np.random.default_rng(2).standard_normal((1, 48, 64, 3)).astype(
        np.float32) * 0.1
    paf_j, heat_j = jop.apply(to_jax(tree), jax.numpy.asarray(x))
    with torch.no_grad():
        paf_t, heat_t = model(t(x.transpose(0, 3, 1, 2)))
    assert paf_t.shape == (1, jop.PAF_CH, 6, 8)
    assert heat_t.shape == (1, jop.HEAT_CH, 6, 8)
    for got, want in ((paf_t, paf_j), (heat_t, heat_j)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=RTOL)


def _checkpoint_sd(model, prefixed: bool) -> dict:
    """``model``'s weights as a ``body_pose_model.pth`` state dict, raw
    or with controlnet_aux's segment prefixes (model0 for the trunk,
    model1_1 / model{n}_2 ... for the branches)."""
    out = {}
    for k, v in model.state_dict().items():
        if prefixed:
            layer = k.split(".")[0]
            if layer.startswith("Mconv"):
                seg = f"model{layer.split('stage')[1][0]}_{layer[-1]}"
            elif layer.startswith("conv5"):
                seg = f"model1_{layer[-1]}"
            else:
                seg = "model0"
            k = f"{seg}.{k}"
        out[k] = v.clone()
    return out


@pytest.mark.parametrize("prefixed", [False, True], ids=["raw", "model0"])
def test_openpose_convert_and_load_match_jax(body, tmp_path, prefixed):
    tree, model = body
    sd = _checkpoint_sd(model, prefixed)
    if prefixed:
        assert "model0.conv1_1.weight" in sd
        assert "model6_2.Mconv7_stage6_L2.bias" in sd
    want = jop.convert_state_dict({k: v.numpy() for k, v in sd.items()})
    got = openpose.convert_state_dict(sd)
    assert sorted(got) == sorted(f"{n}.{p}" for n in want for p in want[n])
    path = tmp_path / "body_pose_model.pth"
    torch.save(sd, path)
    est = openpose.load_body_model(str(path), device="cpu")
    loaded = est.model.state_dict()
    for name, leaf in want.items():
        np.testing.assert_array_equal(
            loaded[f"{name}.weight"].numpy(),
            np.asarray(leaf["weight"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(loaded[f"{name}.bias"].numpy(),
                                      np.asarray(leaf["bias"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            openpose.load_body_model(str(path))


# --------------------------------------------------------------- estimator

# The maps the fake networks return: two people painted on the network's
# 48 x 64 grid (tests/test_preprocessors.py's layout), which the
# estimators upsample 8x and resize to a 96 x 128 photo. Grid cell g lands
# on photo coordinate 2g + 0.5, half way between two pixels, so a blob
# centred on a cell peaks on an exact tie that a 1e-7 difference between
# two float resizes (cv2's, torch's) decides either way; the centres sit
# off the cells.
GRID = (48, 64)
PHOTO = (96, 128)
BOXSIZE = 768            # 0.5 * 768 / 96 = 4: the photo scales to 384 x 512


def _grid_maps():
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from test_preprocessors import _synthetic_person
    heat = np.zeros(GRID + (jop.HEAT_CH,), np.float32)
    paf = np.zeros(GRID + (jop.PAF_CH,), np.float32)
    _synthetic_person(heat, paf, (18, 12.29), 0.37)
    _synthetic_person(heat, paf, (46, 12.29), 0.37)
    return heat, paf


def _estimators(model, tree, heat, paf):
    """The JAX and port estimators with their networks replaced by the
    same maps."""
    jest = jop.BodyEstimator(to_jax(tree), boxsize=BOXSIZE)
    jest._apply = lambda params, x: (jax.numpy.asarray(paf[None]),
                                     jax.numpy.asarray(heat[None]))
    test = openpose.BodyEstimator(model, boxsize=BOXSIZE)
    test.model = lambda x: (t(paf.transpose(2, 0, 1)[None]),
                            t(heat.transpose(2, 0, 1)[None]))
    return jest, test


def _assert_same_people(got, want):
    (cand_g, sub_g), (cand_w, sub_w) = got, want
    assert cand_g.shape == cand_w.shape and sub_g.shape == sub_w.shape
    np.testing.assert_array_equal(cand_g[:, [0, 1, 3]], cand_w[:, [0, 1, 3]])
    np.testing.assert_allclose(cand_g[:, 2], cand_w[:, 2], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(sub_g[:, :18], sub_w[:, :18])
    np.testing.assert_array_equal(sub_g[:, 19], sub_w[:, 19])
    np.testing.assert_allclose(sub_g[:, 18], sub_w[:, 18], rtol=1e-5)


def test_body_estimator_matches_jax_on_the_same_maps(body):
    tree, model = body
    heat, paf = _grid_maps()
    jest, test = _estimators(model, tree, heat, paf)
    photo = np.random.default_rng(5).integers(0, 256, PHOTO + (3,),
                                              dtype=np.uint8)
    want = jest.estimate(photo)
    got = test.estimate(photo)
    _assert_same_people(got, want)
    assert len(want[1]) == 2                  # the two painted people
    np.testing.assert_array_equal(test(photo), jest(photo))


def test_body_estimator_runs_the_network(body):
    """The real (random, tiny) network through both estimators: the
    stride-8 maps and the upsampled ones agree within the tolerances."""
    tree, model = body
    photo = np.random.default_rng(6).integers(0, 256, (80, 60, 3),
                                              dtype=np.uint8)
    jest = jop.BodyEstimator(to_jax(tree), boxsize=64)
    seen = {}
    japply = jest._apply

    def spy(params, x):
        seen["x"] = np.asarray(x)
        return japply(params, x)
    jest._apply = spy
    jest.estimate(photo)
    test = openpose.BodyEstimator(model, boxsize=64)
    heat_t, paf_t = test.maps(photo)
    assert heat_t.shape == (80, 60, jop.HEAT_CH)
    # both networks on JAX's input (cv2 with IPP may resize the photo a
    # level apart from cv2's own code, which the port follows)
    out = test.model(t(seen["x"].transpose(0, 3, 1, 2)))
    paf_j, heat_j = japply(to_jax(tree), jax.numpy.asarray(seen["x"]))
    np.testing.assert_allclose(out[0].detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(paf_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out[1].detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(heat_j), atol=ATOL, rtol=RTOL)
    canvas = test(photo)
    assert canvas.shape == photo.shape and canvas.dtype == np.uint8


# --------------------------------------------------------------------- DPT

@pytest.mark.parametrize("size", [64, 96], ids=["native", "resized"])
def test_dpt_matches_jax(tiny_dpt, size):
    tree, cfg_j, cfg_t, model = tiny_dpt
    x = np.random.default_rng(size).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jdpt.apply(to_jax(tree), cfg_j, jax.numpy.asarray(x)))
    with torch.no_grad():
        got = model(t(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (1, size, size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dpt_attention_stays_plain(tiny_dpt, monkeypatch):
    """K1 takes bf16: with its shape gate admitting every attention (as it
    would at 1025 tokens on the card), DPT still runs the plain form."""
    from omg_tpu_torch.ops import flash_attention as fa
    _, _, _, model = tiny_dpt
    monkeypatch.setattr(fa, "use_flash", lambda *a, **k: True)

    def refuse(*a, **k):
        raise AssertionError("DPT reached the flash kernel")
    monkeypatch.setattr(fa, "flash_attention", refuse)
    with torch.no_grad():
        assert model(torch.zeros(1, 3, 96, 96)).shape == (1, 96, 96)


def test_depth_estimator_matches_jax(tiny_dpt):
    tree, cfg_j, cfg_t, model = tiny_dpt
    img = np.random.default_rng(0).integers(0, 255, (120, 90, 3), np.uint8)
    want = jdpt.DepthEstimator(to_jax(tree), cfg_j)(img, out_size=(64, 48))
    got = dpt.DepthEstimator(model, cfg_t)(img, out_size=(64, 48))
    assert got.shape == want.shape == (64, 48, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.max() == 255 and got.min() == 0


def _hf_tiny_dpt_dir(root):
    """A transformers DPTForDepthEstimation checkpoint directory at the
    tiny config: config.json and model.safetensors."""
    from transformers import DPTConfig, DPTForDepthEstimation
    hf_cfg = DPTConfig(hidden_size=32, num_hidden_layers=4,
                       num_attention_heads=2, intermediate_size=64,
                       image_size=64, patch_size=16,
                       neck_hidden_sizes=[16, 16, 32, 32],
                       fusion_hidden_size=16,
                       backbone_out_indices=[0, 1, 2, 3])
    torch.manual_seed(0)
    hf = DPTForDepthEstimation(hf_cfg).eval()
    root.mkdir()
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    convert.save_safetensors(str(root / "model.safetensors"), sd)
    (root / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    return hf, sd


def test_convert_dpt_and_load_match_jax(tmp_path):
    hf, sd = _hf_tiny_dpt_dir(tmp_path / "dpt")
    est = dpt.load_depth_model(str(tmp_path / "dpt"), device="cpu")
    assert est.cfg == dpt.tiny_config()
    want = from_jax.dpt_from_jax(
        jax.tree.map(np.asarray, jconvert.convert_dpt(
            {k: v.numpy() for k, v in sd.items()}, jdpt.tiny_config())),
        dpt.tiny_config(), device="cpu").state_dict()
    got = est.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # and the forward agrees with transformers' own
    x = np.random.default_rng(1).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            est.model(t(x)).numpy(),
            hf(torch.from_numpy(x)).predicted_depth.numpy(),
            atol=ATOL, rtol=RTOL)
    # strict on keys and shapes
    with pytest.raises(KeyError, match="missing"):
        convert.convert_dpt({k: v for k, v in sd.items()
                             if not k.startswith("head.")},
                            dpt.tiny_config(), device="cpu")
    bad = dict(sd)
    bad["neck.convs.0.weight"] = torch.zeros(16, 16, 1, 1)
    with pytest.raises(ValueError, match="neck.convs.0.weight"):
        convert.convert_dpt(bad, dpt.tiny_config(), device="cpu")


# ---------------------------------------------------------------- pipeline

def test_prepare_condition_with_providers_matches_jax(body, tiny_dpt):
    """Photo -> pose map and photo -> depth map through
    ``prepare_condition`` with each package's providers (the pose
    estimators on the same painted maps)."""
    tree, model = body
    heat, paf = _grid_maps()
    jest, test = _estimators(model, tree, heat, paf)
    dtree, cfg_j, cfg_t, dmodel = tiny_dpt
    jdepth = jdpt.DepthEstimator(to_jax(dtree), cfg_j)
    tdepth = dpt.DepthEstimator(dmodel, cfg_t)
    photo = np.random.default_rng(7).integers(0, 256, (150, 200, 3),
                                              dtype=np.uint8)
    want = jcond.prepare_condition(photo, "Human pose", *PHOTO,
                                   pose_provider=jest, depth_provider=jdepth)
    got = conditions.prepare_condition(photo, "Human pose", *PHOTO,
                                       pose_provider=test,
                                       depth_provider=tdepth)
    assert got.shape == PHOTO + (3,) and (got > 0).any()
    np.testing.assert_array_equal(got, want)
    want = jcond.prepare_condition(photo, "depth", 64, 96,
                                   pose_provider=jest, depth_provider=jdepth)
    got = conditions.prepare_condition(photo, "depth", 64, 96,
                                       pose_provider=test,
                                       depth_provider=tdepth)
    assert got.shape == (64, 96, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
