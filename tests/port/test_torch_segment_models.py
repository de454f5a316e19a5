"""The port's segmentation models against the JAX package at tiny
geometry, fp32 on the CPU: both SAM image encoders (atol 1e-4), the
prompt encoder and mask decoder (atol 1e-4), the CLIP vision tower; the
geometry read off a state; and the layouts ``from_jax`` gives SAM's
tables and kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.models import clip_vision as jcv
from omg_tpu.segment import efficientvit as jevit
from omg_tpu.segment import sam_decoder as jdec
from omg_tpu.segment import vit_sam as jvit
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.models import clip_vision as cv
from omg_tpu_torch.segment import efficientvit as evit
from omg_tpu_torch.segment import sam_decoder as dec
from omg_tpu_torch.segment import sam_provider
from omg_tpu_torch.segment import vit_sam

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal, numpy_params, sam_numpy, t, to_jax

ATOL = 1e-4

# the L-series miniature of tests/test_segment.py (5 stages, mb/att, a
# stage4/3/2 neck with expand 1)
L_MINI = dict(width_list=(8, 8, 16, 16, 32), depth_list=(1, 1, 1, 1, 1),
              expand_list=(1, 2, 2, 2, 2), qkv_dim=8,
              neck_in_channels=(32, 16, 16), neck_width=16, neck_depth=1,
              neck_out_dim=16, neck_feature_hw=8, image_size=64)
# ViT with two windowed blocks around a global one, windows padded 5 -> 6
VIT_MINI = dict(image_size=80, patch_size=16, dim=24, depth=3, num_heads=3,
                window_size=3, global_attn_indexes=(1,), out_chans=8)

ENCODERS = {
    "evit_tiny": (jevit, jevit.tiny_config(), evit.tiny_config()),
    "evit_l_series": (jevit, dataclasses.replace(jevit.l0_config(), **L_MINI),
                      dataclasses.replace(evit.l0_config(), **L_MINI)),
    "vit_tiny": (jvit, jvit.tiny_config(), vit_sam.tiny_config()),
    "vit_windows": (jvit, jvit.VitSamConfig(**VIT_MINI),
                    vit_sam.VitSamConfig(**VIT_MINI)),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_image_encoder_matches_jax(name):
    jmod, jcfg, cfg = ENCODERS[name]
    tree = sam_numpy(jmod.init_params, jcfg, seed=5)
    x = normal(np.random.default_rng(6), 1, cfg.image_size, cfg.image_size, 3)
    want = np.asarray(jmod.encoder_apply(to_jax(tree["image_encoder"]), jcfg,
                                         jnp.asarray(x)))
    sam = from_jax.sam_from_jax(tree, cfg=cfg, device="cpu")
    assert sam.image_encoder.cfg == cfg
    got = sam.image_encoder(t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_init_params_builds_both_families():
    g = torch.Generator().manual_seed(0)
    for cfg in (evit.tiny_config(), vit_sam.tiny_config()):
        sam = sam_provider.init_sam(g, cfg, "cpu")
        out = sam.image_encoder(torch.randn(1, cfg.image_size,
                                            cfg.image_size, 3))
        assert torch.isfinite(out).all()
        assert out.abs().max() > 0


@pytest.fixture(scope="module")
def decoder_pair():
    tree = sam_numpy(jevit.init_params, jevit.tiny_config(), seed=7)
    sam = from_jax.sam_from_jax(tree, cfg=evit.tiny_config(), device="cpu")
    return to_jax(tree), sam


def test_encode_boxes_matches_jax(decoder_pair):
    jt, sam = decoder_pair
    boxes = np.array([[4.0, 6.0, 50.0, 40.0], [0, 0, 64, 64]], np.float32)
    want = jdec.encode_boxes(jt["prompt_encoder"], jnp.asarray(boxes), 64.0)
    got = dec.encode_boxes(sam.prompt_encoder, t(boxes), 64.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode_points_matches_jax(decoder_pair):
    jt, sam = decoder_pair
    pts = np.array([[[10.0, 20.0], [30.0, 5.0], [1.0, 60.0]],
                    [[63.0, 0.0], [7.5, 7.5], [40.0, 41.0]]], np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.float32)
    want = jdec.encode_points(jt["prompt_encoder"], jnp.asarray(pts),
                              jnp.asarray(labels), 64.0)
    got = dec.encode_points(sam.prompt_encoder, t(pts), t(labels), 64.0)
    assert got.shape == (2, 4, 256)                 # + SAM's padding point
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the -1 slots are not_a_point_embed exactly (PE dropped)
    for row in (got[0, 2], got[0, 3], got[1, 3]):
        np.testing.assert_array_equal(
            row.numpy(), sam.prompt_encoder.not_a_point_embed.weight[0])


def test_decode_masks_matches_jax(decoder_pair):
    jt, sam = decoder_pair
    rng = np.random.default_rng(8)
    emb = normal(rng, 2, 16, 16, 256)
    boxes = np.array([[4.0, 4.0, 30.0, 30.0], [10, 0, 64, 50]], np.float32)
    pj, pt = jt["prompt_encoder"], sam.prompt_encoder
    want_m, want_iou = jdec.decode_masks(
        jt["mask_decoder"], pj, jnp.asarray(emb),
        jdec.encode_boxes(pj, jnp.asarray(boxes), 64.0),
        jdec.no_mask_dense(pj, 2, 16))
    got_m, got_iou = dec.decode_masks(
        sam.mask_decoder, pt, t(emb), dec.encode_boxes(pt, t(boxes), 64.0),
        dec.no_mask_dense(pt, 2, 16))
    assert got_m.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=ATOL)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou),
                               atol=ATOL)


def test_conv_transpose_kernel_layout():
    """JAX's [k, k, out, in] transposed-conv kernel comes out of from_jax
    as torch's ConvTranspose2d weight [in, out, k, k], and the port's
    upscaling conv then equals torch's module."""
    ct = torch.nn.ConvTranspose2d(6, 4, kernel_size=2, stride=2)
    w = ct.weight.detach().numpy()
    jax_tree = {"weight": w.transpose(2, 3, 1, 0), "bias": ct.bias.detach()
                .numpy()}
    port = from_jax.load_into(dec.ConvTranspose2x(6, 4), jax_tree)
    np.testing.assert_array_equal(port.weight.numpy(), w)
    x = torch.randn(1, 6, 5, 5)
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), ct(x).numpy(), atol=1e-6)
    want = jdec._conv_transpose_2x(to_jax(jax_tree),
                                   jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(port(x).permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)


# one global block over a 4x4 grid whose rel-pos tables are square:
# [2*4-1, 14/2]
SQUARE = dict(image_size=64, patch_size=16, dim=14, depth=1, num_heads=2,
              window_size=0, global_attn_indexes=(0,), out_chans=256)


def test_from_jax_keeps_tables_and_grids():
    """pos_embed, the rel-pos tables (square here, where a transpose would
    not raise), the Fourier matrix and the prompt/token tables arrive as
    JAX stores them."""
    tree = sam_numpy(jvit.init_params, jvit.VitSamConfig(**SQUARE), seed=9)
    sam = from_jax.sam_from_jax(tree, device="cpu")
    enc, pe, md = tree["image_encoder"], tree["prompt_encoder"], \
        tree["mask_decoder"]
    assert enc["blocks"][0]["attn"]["rel_pos_h"].shape == (7, 7)
    same = {
        "image_encoder.pos_embed": enc["pos_embed"],
        "image_encoder.blocks.0.attn.rel_pos_h":
            enc["blocks"][0]["attn"]["rel_pos_h"],
        "image_encoder.blocks.0.attn.rel_pos_w":
            enc["blocks"][0]["attn"]["rel_pos_w"],
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
            pe["pe_layer"]["positional_encoding_gaussian_matrix"],
        "prompt_encoder.not_a_point_embed.weight":
            pe["not_a_point_embed"]["weight"],
        "prompt_encoder.no_mask_embed.weight": pe["no_mask_embed"]["weight"],
        "mask_decoder.iou_token.weight": md["iou_token"]["weight"],
        "mask_decoder.mask_tokens.weight": md["mask_tokens"]["weight"],
    }
    same.update({f"prompt_encoder.point_embeddings.{i}.weight":
                 pe["point_embeddings"][i]["weight"] for i in range(4)})
    state = sam.state_dict()
    for key, arr in same.items():
        np.testing.assert_array_equal(state[key].numpy(), arr, err_msg=key)
    # the config read off the state matches the one the tree was made for
    assert sam.image_encoder.cfg == vit_sam.VitSamConfig(**SQUARE)


def test_from_jax_defaults_to_the_card(monkeypatch):
    tree = sam_numpy(jevit.init_params, jevit.tiny_config(), seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax.sam_from_jax(tree, cfg=evit.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax.clip_vision_from_jax({}, config.clip_vit_b32_vision())


@pytest.mark.parametrize("make", ["vit_b_config", "vit_l_config",
                                  "vit_h_config"])
def test_vit_config_from_structure_only_state(make):
    cfg = getattr(vit_sam, make)()
    with torch.device("meta"):
        enc = vit_sam.ImageEncoderViT(cfg)
    assert vit_sam.config_from_params(enc.state_dict()) == cfg
    assert sam_provider.encoder_config(enc.state_dict()) == cfg


def test_evit_zoo_inferred_from_structure():
    sigs = set()
    for name, make in evit.ZOO.items():
        cfg = make()
        sigs.add(evit._signature(cfg))
        with torch.device("meta"):
            state = evit.EfficientViTSamImageEncoder(cfg).state_dict()
        assert evit.infer_config(state) == cfg, name
        assert sam_provider.encoder_config(state) == cfg
    assert len(sigs) == len(evit.ZOO)
    assert evit.infer_config({"backbone.stages.0.op_list.0.x": None}) is None
    assert sam_provider.encoder_config({}) == evit.xl1_config()


VISION = dict(image_size=32, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4,
              projection_dim=16)


@pytest.fixture(scope="module")
def vision_pair():
    jcfg = jconfig.CLIPVisionConfig(**VISION)
    tree = numpy_params(jcv.init_params, jcfg, seed=11)
    return (jcfg, to_jax(tree), from_jax.clip_vision_from_jax(
        tree, config.CLIPVisionConfig(**VISION), device="cpu"))


def test_clip_vision_matches_jax(vision_pair):
    jcfg, jt, model = vision_pair
    crops = (np.random.default_rng(12).random((3, 32, 32, 3)) * 255).astype(
        np.uint8)
    pix_j = jcv.preprocess(crops, 32)
    pix = cv.preprocess(crops, 32)
    np.testing.assert_allclose(pix.numpy(), np.asarray(pix_j), atol=1e-6)
    want = jcv.apply(jt, jcfg, pix_j)
    got = model(pix)
    for name in ("last_hidden_state", "pooled", "projected"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)


def test_clip_vision_preprocess_resizes_like_jax():
    crops = (np.random.default_rng(13).random((2, 48, 48, 3)) * 255).astype(
        np.uint8)
    np.testing.assert_allclose(cv.preprocess(crops, 32).numpy(),
                               np.asarray(jcv.preprocess(crops, 32)),
                               atol=1e-4)


def test_clip_vision_rejects_a_wrong_grid(vision_pair):
    _, _, model = vision_pair
    with pytest.raises(ValueError, match="does not match the position table"):
        model(torch.zeros(1, 40, 40, 3))
