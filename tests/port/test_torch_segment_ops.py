"""The EfficientViT blocks, LiteMLA and the resizes of the port's
``segment/evit_ops.py`` against ``omg_tpu/segment/evit_ops.py`` (fp32,
CPU, atol 1e-5), and the PIL-style uint8 resize against PIL."""

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from omg_tpu.segment import efficientvit as jevit
from omg_tpu.segment import evit_ops as jops
from omg_tpu_torch import from_jax
from omg_tpu_torch.segment import evit_ops as ops

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (normal, numpy_params, positive_variances,
                                t, to_jax)

F32 = jnp.float32
ATOL = 1e-5


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


# (name, JAX init(key), JAX apply(p, x), port module, input channels)
OPS = [
    ("conv_layer",
     lambda k: jevit._init_conv_layer(k, 8, 12, 3, norm=True, bias=True,
                                      dtype=F32),
     lambda p, x: jops.conv_layer(p, x, kernel=3, stride=2,
                                  act_func="hswish"),
     lambda: ops.ConvLayer(8, 12, 3, stride=2, bias=True, act_func="hswish"),
     8),
    ("res_block",
     lambda k: {"conv1": jevit._init_conv_layer(k, 8, 8, 3, dtype=F32),
                "conv2": jevit._init_conv_layer(k, 8, 8, 3, dtype=F32)},
     lambda p, x: jops.res_block(p, x),
     lambda: ops.ResBlock(8), 8),
    ("fused_mbconv",
     lambda k: jevit._init_fmb(k, 8, 16, 4, fewer_norm=True, dtype=F32),
     lambda p, x: jops.fused_mbconv(p, x, stride=2),
     lambda: ops.FusedMBConv(8, 16, 4, stride=2, fewer_norm=True), 8),
    ("mbconv",
     lambda k: jevit._init_mb(k, 8, 8, 2, fewer_norm=False, dtype=F32),
     lambda p, x: jops.mbconv(p, x),
     lambda: ops.MBConv(8, 8, 2), 8),
    ("mbconv_down_fewer_norm",
     lambda k: jevit._init_mb(k, 8, 16, 8, fewer_norm=True, dtype=F32),
     lambda p, x: jops.mbconv(p, x, stride=2),
     lambda: ops.MBConv(8, 16, 8, stride=2, fewer_norm=True), 8),
    ("lite_mla",
     lambda k: jevit._init_litemla(k, 16, 8, (5,), F32),
     lambda p, x: jops.lite_mla(p, x, dim=8, scales=(5,)),
     lambda: ops.LiteMLA(16, dim=8, scales=(5,)), 16),
    ("evit_block",
     lambda k: {"context_module": {"main": jevit._init_litemla(
                    k, 16, 8, (3,), F32)},
                "local_module": {"main": jevit._init_mb(
                    k, 16, 16, 2, fewer_norm=True, dtype=F32)}},
     lambda p, x: jops.evit_block(p, x, dim=8, scales=(3,)),
     lambda: ops.EfficientViTBlock(16, dim=8, scales=(3,), expand=2), 16),
    ("layer_norm_2d",
     lambda k: {"weight": jnp.ones((8,)), "bias": jnp.zeros((8,))},
     lambda p, x: jops.layer_norm_2d(p, x),
     lambda: ops.LayerNorm2d(8), 8),
]


@pytest.mark.parametrize("name,init,apply,module,cin", OPS,
                         ids=[o[0] for o in OPS])
def test_op_matches_jax(name, init, apply, module, cin):
    tree = positive_variances(numpy_params(lambda k, _: init(k), None, 3))
    x = normal(np.random.default_rng(4), 2, 9, 11, cin)
    want = np.asarray(apply(to_jax(tree), jnp.asarray(x)))
    got = from_jax.load_into(module(), tree)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)


def test_lite_mla_denominator_is_fp32():
    """Near-zero denominators stay finite: the 1e-15 epsilon is fp32."""
    m = ops.LiteMLA(16, dim=8, scales=(3,))
    with torch.no_grad():
        for p in m.parameters():
            p.zero_()
        m.proj.norm.weight.fill_(1.0)
        m.proj.norm.running_var.fill_(1.0)
    out = m(torch.randn(1, 16, 5, 5))
    assert torch.isfinite(out).all() and out.abs().max() == 0


@pytest.mark.parametrize("name", ["relu", "gelu", "hswish"])
def test_act_matches_jax(name):
    x = normal(np.random.default_rng(0), 64, scale=4.0)
    np.testing.assert_allclose(ops.act(name, t(x)).numpy(),
                               np.asarray(jops.act(name, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


RESIZES = [
    ("bicubic_resize", (16, 16), (64, 64)),
    ("bicubic_resize", (32, 32), (64, 64)),
    ("bicubic_resize", (64, 64), (64, 64)),
    ("bicubic_resize", (24, 40), (10, 16)),
    ("bilinear_resize", (16, 16), (64, 64)),
    ("bilinear_resize", (64, 64), (24, 24)),
    ("bilinear_resize", (20, 36), (48, 30)),
    ("bilinear_resize_ac", (16, 16), (64, 64)),
    ("bilinear_resize_ac", (64, 64), (24, 24)),
    ("bilinear_resize_ac", (20, 36), (48, 30)),
]


@pytest.mark.parametrize("fn,size_in,size_out", RESIZES)
def test_resize_matches_jax_matrices(fn, size_in, size_out):
    x = normal(np.random.default_rng(1), 2, *size_in, 3)
    want = getattr(jops, fn)(jnp.asarray(x), size_out)
    got = getattr(ops, fn)(_nchw(x), size_out)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("size_in,size_out", [
    ((64, 64), (40, 40)), ((30, 20), (64, 43)), ((80, 56), (64, 45)),
    ((48, 64), (48, 64)), ((37, 90), (26, 64))])
def test_resize_uint8_within_one_level_of_pil(size_in, size_out):
    img = (np.random.default_rng(2).random(size_in + (3,)) * 255).astype(
        np.uint8)
    want = np.asarray(PIL.Image.fromarray(img).resize(
        size_out[::-1], PIL.Image.BILINEAR)).astype(int)
    got = ops.resize_uint8(img, size_out).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, np.round(got))
    assert np.abs(got - want).max() <= 1
