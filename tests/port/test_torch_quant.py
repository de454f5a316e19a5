"""Int8 W8A8 (``ops/quant.py``, ``nn/layers.QuantLinear``, the fused QKV
layouts of ``nn/attention.py``) in the port against the JAX package:
int8 weights and scales bit-equal to ``quantize_linear``'s; the exact
int32 product; ``int8_matmul``, the quantized ``Linear`` with LoRA and
bias, and the mixed and fused QKV layouts within 1e-6 relative; the
quantization scope (``quantize_unet``, the JAX ``quantize_unet_params``);
the quantized UNet and ``OMG(quantize="int8").generate`` against JAX's
quantized engine.

Bound of the whole-model comparisons. The two packages' float paths
differ by rounding (about 1e-6 relative at the tiny config), and an
activation that differs by an ulp can move ``round(x / sx)`` across a
half-integer: one int8 step. Such a flip moves that token's output of
the linear by ``sx * |w_q| * w_scale <= max|x| * max|w_j| / 127``, at most
1/127 of the product's own scale, and the layers after it carry that
forward. So the quantized eps may differ by 2/127 of max |eps| (a flip
or two, the second through the residual stream) and their cosine by
1e-4, which is 50 times tighter than JAX's own quantized-vs-bf16
criterion (cosine > 0.995, tests/test_quant.py); images by 2/127 of the
uint8 range, 4 levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.models import unet as junet
from omg_tpu.nn import attention as jattention
from omg_tpu.nn import layers as jlayers
from omg_tpu.ops import quant as jquant
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax
from omg_tpu_torch.models import unet
from omg_tpu_torch.nn import attention, layers
from omg_tpu_torch.ops import quant
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, lora_leaf, mid_block_lora,
                                normal, np_tree, numpy_params, t, tiny_sdxl,
                                to_jax)

REL = 1e-6
FLIP_REL = 2 / 127          # one or two int8 rounding flips (docstring)
FLIP_COS = 1e-4
IMAGE_LEVELS = 4            # 2/127 of 255


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", [(64, 96), (48, 64), (1, 16), (320, 8)])
def test_quantize_weight_bit_equal_to_jax(shape):
    """[in, out] JAX weights against the port's [out, in]; a zero column
    takes the 1e-12 floor."""
    rng = np.random.default_rng(sum(shape))
    w = normal(rng, *shape, scale=0.05)
    w[:, 0] = 0.0
    want = jquant.quantize_linear({"weight": jnp.asarray(w)})
    wq, ws = quant.quantize_weight(t(w.T))
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(want["weight_q"]).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(want["w_scale"]))
    assert ws[0] == np.float32(1e-12)


def test_int_mm_is_exact():
    rng = np.random.default_rng(0)
    for m, k, n in ((3, 5, 7), (40, 64, 24), (17, 2048, 8)):
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (k, n), dtype=np.int8)
        got = quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(5,), (2, 40), (3, 17, 9)],
                         ids=["tokens", "batch", "3d"])
def test_int8_matmul_matches_jax(dtype, lead):
    """Against the JAX function compiled (XLA folds the division by 127
    into a product with its reciprocal; the port does the same, so the
    result is met exactly) and, in fp32, run op by op (an exact division:
    scales one fp32 ulp apart, which a bf16 output can round to one bf16
    ulp, so bf16 is held to the compiled program only)."""
    rng = np.random.default_rng(len(lead))
    w = normal(rng, 64, 40, scale=0.1)
    x = normal(rng, *lead, 64, scale=3.0)
    x[..., 0, :] = 0.0                                  # an all-zero token
    jp = jquant.quantize_linear({"weight": jnp.asarray(w)})
    wq, ws = quant.quantize_weight(t(w.T))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = quant.int8_matmul(t(x).to(getattr(torch, dtype)), wq, ws)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    fns = ((jquant.int8_matmul,) if dtype == "float32" else ()) + (
        jax.jit(jquant.int8_matmul),)
    for fn in fns:
        want = np.asarray(fn(jx, jp["weight_q"], jp["w_scale"]), np.float32)
        assert _rel(got, want) <= REL
    np.testing.assert_array_equal(got, want)


def test_quantized_linear_matches_jax():
    """A quantized Linear with bias, with a shared LoRA leaf and with a
    per-lane one: the LoRA delta and the bias on top in the compute
    dtype."""
    rng = np.random.default_rng(2)
    p = {"weight": jnp.asarray(normal(rng, 32, 24)),
         "bias": jnp.asarray(normal(rng, 24))}
    mod = from_jax.load_into(layers.Linear(32, 24), np_tree(p))
    layers.QuantLinear.quantize_(mod)
    assert isinstance(mod, layers.QuantLinear) and mod.weight is None
    jq = jquant.quantize_linear(p)
    x = normal(rng, 3, 7, 32)
    shared = lora_leaf(rng, 32, 24, rank=4, scale=0.7)
    lanes = {"down": normal(rng, 3, 32, 2), "up": normal(rng, 3, 2, 24),
             "scale": np.float32([0.0, 0.5, 1.0])}
    for leaf in (None, shared, lanes):
        tleaf = None if leaf is None else {k: t(v) for k, v in leaf.items()}
        got = mod(t(x), None if leaf is None else {mod.lora_key: tleaf})
        want = jlayers.linear(jq, jnp.asarray(x),
                              None if leaf is None else to_jax(leaf))
        assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("quantized", [("to_q",), ("to_k",),
                                       ("to_q", "to_k", "to_v"),
                                       ("to_k", "to_v")])
def test_qkv_layouts_match_jax(quantized):
    """Self- and cross-attention with some of to_q/to_k/to_v int8: a mixed
    group takes the per-projection path, a uniform one the fused product
    (JAX ``mha``'s rule), each with LoRA on every projection."""
    rng = np.random.default_rng(len(quantized))
    jp = np_tree(jattention.init_mha(jax.random.PRNGKey(3), 32,
                                     context_dim=32, num_heads=4,
                                     head_dim=8))
    mod = from_jax.load_into(attention.Attention(
        32, context_dim=32, num_heads=4, head_dim=8), jp)
    jq = dict(jp)
    for name in quantized:
        jq[name] = jquant.quantize_linear(to_jax(jp[name]))
        layers.QuantLinear.quantize_(getattr(mod, name))
    layers.set_lora_keys(mod)
    lora = {n: lora_leaf(rng, 32, 32, rank=2, scale=0.5)
            for n in ("to_q", "to_k", "to_v", "to_out")}
    tlora = {("to_out.0" if n == "to_out" else n): {k: t(v) for k, v in
                                                    leaf.items()}
             for n, leaf in lora.items()}
    x, ctx = normal(rng, 2, 9, 32), normal(rng, 2, 5, 32)
    for context in (None, ctx):
        want = jattention.mha(
            to_jax(jq), jnp.asarray(x), num_heads=4,
            context=None if context is None else jnp.asarray(context),
            lora=to_jax(lora))
        got = mod(t(x), None if context is None else t(context), lora=tlora)
        assert _rel(got.detach().numpy(), want) <= 10 * REL


def _tiny_unet_pair(seed=0):
    jcfg = jsdxl.tiny_config().unet
    tree = numpy_params(junet.init_params, jcfg, seed)
    return jcfg, to_jax(tree), from_jax.load_into(
        unet.UNet2DConditionModel(sdxl.tiny_config().unet), tree)


def _quantized_paths(tree, prefix=()):
    if isinstance(tree, dict):
        if "weight_q" in tree:
            yield ".".join(map(str, prefix))
            return
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return
    for k, v in items:
        yield from _quantized_paths(v, prefix + (k,))


@pytest.mark.parametrize("min_dim", [16, 49])
def test_quantize_unet_scope_matches_jax(min_dim):
    """The same linears are quantized (the transformer blocks, proj_in and
    proj_out with both dimensions >= min_dim); the source model keeps its
    float weights and shares every other tensor with the copy."""
    jcfg, jparams, model = _tiny_unet_pair()
    qm = quant.quantize_unet(model, min_dim=min_dim)
    want = {p.replace("to_out", "to_out.0").replace(
        "net_0_proj", "net.0.proj").replace("net_2", "net.2")
        for p in _quantized_paths(jquant.quantize_unet_params(
            jparams, min_dim=min_dim))}
    got = {n for n, m in qm.named_modules()
           if isinstance(m, layers.QuantLinear)}
    assert got == want and len(got) > 0
    assert not any(isinstance(m, layers.QuantLinear)
                   for m in model.modules())
    assert qm.conv_in.weight is model.conv_in.weight
    assert qm.time_embedding.linear_1.weight is \
        model.time_embedding.linear_1.weight
    jq = jquant.quantize_unet_params(jparams, min_dim=min_dim)
    blk = jq["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    np.testing.assert_array_equal(
        qm.down_blocks[1].attentions[0].transformer_blocks[0].attn1.to_q
        .weight_q.numpy(), np.asarray(blk["attn1"]["to_q"]["weight_q"]).T)


def _cos_gap(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return 1.0 - float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def unets():
    """The tiny float UNet pair, the quantized pair, and JAX's apply
    compiled once for every test."""
    jcfg, jparams, model = _tiny_unet_pair()
    apply = jax.jit(lambda p, *a: junet.apply(
        p, jcfg, a[0], jnp.int32(500), a[1], text_embeds=a[2],
        time_ids=a[3]))
    return (jparams, jquant.quantize_unet_params(jparams),
            quant.quantize_unet(model), apply)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quantized_unet_matches_jax(unets, seed):
    """The quantized UNet against JAX's compiled one at the bound of the
    docstring; both differ from the float UNet by far more."""
    jparams, jq, qm, f = unets
    rng = np.random.default_rng(seed)
    x, e = normal(rng, 2, 8, 8, 4), normal(rng, 2, 77, 48)
    te, tids = normal(rng, 2, 16), np.ones((2, 6), np.float32)
    want = np.asarray(f(jq, x, e, te, tids))
    got = qm(t(x), 500, t(e), text_embeds=t(te), time_ids=t(tids)).numpy()
    assert _rel(got, want) <= FLIP_REL and _cos_gap(got, want) <= FLIP_COS
    fp = np.asarray(f(jparams, x, e, te, tids))
    assert _cos_gap(want, fp) > 10 * _cos_gap(got, want)
    assert _cos_gap(want, fp) < 1 - 0.995


def test_generate_int8_matches_jax():
    """``OMG(quantize="int8")`` against the JAX engine's: both stages'
    images within the docstring's 4 levels; the caller's float UNet is
    left as it was."""
    jp, tp = tiny_sdxl(seed=40)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=4, quantize="int8")
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp, **kw)
    teng = omg.OMG(cfg=sdxl.tiny_config(), params=tp, **kw)
    assert teng.params.unet is not tp.unet and not any(
        isinstance(m, layers.QuantLinear) for m in tp.unet.modules())
    rng = np.random.default_rng(41)
    loras = [mid_block_lora(rng, 64, 48, rank=2) for _ in range(2)]
    gen = dict(negative_prompt="ugly", seed=6, height=32, width=32,
               prompt_rewrite="[photo of the man]-*-[ugly]|"
                              "[photo of the woman]-*-[blurry]",
               initial_noise=normal(rng, 1, 4, 4, 4))
    prompt = "photo of the man and the woman at the beach"
    want = jeng.generate(prompt, concept_loras=[to_jax(x) for x in loras],
                         **gen)
    got = teng.generate(prompt, concept_loras=[
        from_jax.lora_from_jax(x, device="cpu") for x in loras], **gen)
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape == (2, 32, 32, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= IMAGE_LEVELS
    with pytest.raises(ValueError, match="unknown quantize mode 'fp8'"):
        omg.OMG(cfg=sdxl.tiny_config(), params=tp, tokenizer=tok,
                tokenizer_2=tok, quantize="fp8")
