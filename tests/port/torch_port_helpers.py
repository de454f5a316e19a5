"""Shared helpers of the port's parity tests: JAX trees to numpy, numpy
inputs, the left/right stand-in mask provider and random LoRA trees."""

import jax
import numpy as np
import torch

from omg_tpu.models import clip as jclip
from omg_tpu.models import unet as junet
from omg_tpu.models import vae as jvae


def np_tree(tree):
    """JAX pytree -> the same tree with numpy leaves (from_jax's input)."""
    return jax.tree.map(np.asarray, tree)


def t(a) -> torch.Tensor:
    """numpy/JAX array -> fp32 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, np.float32))


def normal(rng: np.random.Generator, *shape, scale: float = 1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def left_right_masks(image, cls):
    """'man' owns the left half of the image, anyone else the right."""
    m = np.zeros(image.shape[:2], np.float32)
    half = image.shape[1] // 2
    if cls == "man":
        m[:, :half] = 1.0
    else:
        m[:, half:] = 1.0
    return m


def lora_leaf(rng, d_in, d_out, rank=4, scale=1.0):
    return {"down": normal(rng, d_in, rank, scale=0.1),
            "up": normal(rng, rank, d_out, scale=0.1),
            "scale": np.float32(scale)}


def mid_block_lora(rng, dim, ctx_dim, rank=4):
    """JAX-layout LoRA tree on every projection of the first mid-block
    transformer block and its feed-forward (numpy leaves; block indices
    are int dict keys, as the JAX LoRA loader writes them)."""
    attn1 = {k: lora_leaf(rng, dim, dim, rank)
             for k in ("to_q", "to_k", "to_v", "to_out")}
    attn2 = {"to_q": lora_leaf(rng, dim, dim, rank),
             "to_k": lora_leaf(rng, ctx_dim, dim, rank),
             "to_v": lora_leaf(rng, ctx_dim, dim, rank),
             "to_out": lora_leaf(rng, dim, dim, rank)}
    ff = {"net_0_proj": lora_leaf(rng, dim, dim * 8, rank),
          "net_2": lora_leaf(rng, dim * 4, dim, rank)}
    return {"mid_block": {"attentions": {0: {
        "proj_in": lora_leaf(rng, dim, dim, rank),
        "transformer_blocks": {0: {"attn1": attn1, "attn2": attn2,
                                   "ff": ff}}}}}}


def to_jax(tree):
    return jax.tree.map(jax.numpy.asarray, tree)


def numpy_params(init, cfg, seed=0):
    """A parameter tree with ``init(key, cfg)``'s structure and shapes
    (traced, not run) and random numpy leaves: N(0, 1/fan_in) kernels,
    N(0, 0.02²) embeddings, and biases and norm scales perturbed off
    0 and 1 so that every parameter shows in the outputs."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, cfg),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        names = [str(getattr(p, "key", "")) for p in path]
        if len(names) > 1 and "embedding" in names[-2]:
            return normal(rng, *s.shape, scale=0.02)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return normal(rng, *s.shape, scale=fan_in ** -0.5)
        base = 1.0 if names[-1] == "weight" else 0.0
        return base + normal(rng, *s.shape, scale=0.1)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def positive_variances(tree):
    """BatchNorm running variances of a numpy_params tree made positive."""
    def fix(path, x):
        last = str(getattr(path[-1], "key", ""))
        return np.abs(x) + 0.5 if last == "running_var" else x
    return jax.tree_util.tree_map_with_path(fix, tree)


def sam_numpy(enc_init, enc_cfg, seed=0):
    """A JAX SAM tree {"image_encoder", "prompt_encoder", "mask_decoder"}
    with numpy_params leaves; ``enc_init(key, cfg)`` picks the family."""
    from omg_tpu.segment import sam_decoder as jdec
    return {"image_encoder": positive_variances(
                numpy_params(enc_init, enc_cfg, seed)),
            "prompt_encoder": numpy_params(
                lambda k, _: jdec.init_prompt_encoder(k), None, seed + 1),
            "mask_decoder": numpy_params(
                lambda k, _: jdec.init_mask_decoder(k), None, seed + 2)}


def tiny_sdxl_numpy(seed=0):
    """The four tiny SDXL parameter trees with numpy leaves, as a JAX
    ``SDXLParams``."""
    from omg_tpu.pipelines import sdxl as jsdxl
    return jsdxl.SDXLParams(*(
        numpy_params(mod.init_params, c, seed + i) for i, (mod, c) in
        enumerate(zip((junet, jvae, jclip, jclip), jsdxl.tiny_config()))))


def tiny_sdxl(seed=0):
    """(JAX tiny SDXLParams, port SDXLParams) holding the same random
    weights."""
    from omg_tpu_torch import from_jax
    from omg_tpu_torch.pipelines import sdxl
    tree = tiny_sdxl_numpy(seed)
    return to_jax(tree), from_jax.sdxl_from_jax(tree, sdxl.tiny_config(),
                                                device="cpu")
