"""Shared helpers of the port's parity tests: JAX trees to numpy, numpy
inputs, the left/right stand-in mask provider and random LoRA trees."""

import jax
import numpy as np
import pytest
import torch

from omg_tpu.models import clip as jclip
from omg_tpu.models import unet as junet
from omg_tpu.models import vae as jvae


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A port test module runs torch on one intra-op thread (autouse in
    every module that imports it). The test workers share the host's
    cores, and a pool of one thread per core in each worker oversubscribes
    them: the tiny models' ops then wait on each other's threads (on an
    8-core host with every core busy, three tiny ``generate`` calls took
    36 s on eight threads and 0.25 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


TOKENIZER_CORPUS = (
    "close-up photo of the cool man and the beautiful woman at the beach, "
    "4k. a man and a woman in surprised expressions; the man's hat, the "
    "woman's dress, they'll smile. portrait of a young girl with red hair "
    "in a garden, cinematic lighting, highly detailed, 8k uhd, dslr, soft "
    "light, high quality, film grain. noisy, blurry, soft, deformed, ugly. "
    "a cat and a dog playing on the grass under the blue sky in summer")


def learn_merges(corpus: str, n: int) -> list:
    """Byte-level BPE merges learned from ``corpus``: the most frequent
    adjacent pair of symbols (ties: the smallest pair) merged ``n``
    times, CLIP's way of marking the last symbol of a word with
    ``</w>``."""
    from collections import Counter

    from omg_tpu_torch.text import tokenizer as tk
    enc = tk.bytes_to_unicode()
    words = Counter()
    for tok in tk.pre_tokenize(tk.basic_clean(corpus)):
        chars = [enc[b] for b in tok.encode("utf-8")]
        words[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        new = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += c
        words = new
    return merges


def write_clip_tokenizer(folder, merges, *, pad="<|endoftext|>"):
    """A CLIP tokenizer folder as SDXL ships it: vocab.json (the 256 byte
    symbols, the same with ``</w>``, one symbol per merge, then BOS and
    EOS last), merges.txt, special_tokens_map.json and
    tokenizer_config.json (``pad`` "!" for ``tokenizer_2``, an added
    special token at id 0)."""
    import json
    import os

    from omg_tpu_torch.text import tokenizer as tk
    os.makedirs(folder, exist_ok=True)
    syms = list(tk.bytes_to_unicode().values())
    syms += [s + "</w>" for s in syms]
    syms += ["".join(m) for m in merges]
    syms += ["<|startoftext|>", "<|endoftext|>"]
    vocab = {s: i for i, s in enumerate(dict.fromkeys(syms))}
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges)
                + "\n")

    def added(content):
        return {"content": content, "lstrip": False, "normalized": True,
                "rstrip": False, "single_word": False}

    specials = {"bos_token": added("<|startoftext|>"),
                "eos_token": added("<|endoftext|>"), "pad_token": pad,
                "unk_token": added("<|endoftext|>")}
    with open(os.path.join(folder, "special_tokens_map.json"), "w") as f:
        json.dump(specials, f)
    config = dict({k: v["content"] if isinstance(v, dict) else v
                   for k, v in specials.items()},
                  do_lower_case=True, errors="replace",
                  model_max_length=77, tokenizer_class="CLIPTokenizer",
                  clean_up_tokenization_spaces=True)
    if pad != "<|endoftext|>":
        config["added_tokens_decoder"] = {
            str(vocab[c]): dict(added(c), special=True)
            for c in (pad, "<|startoftext|>", "<|endoftext|>")}
    with open(os.path.join(folder, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return vocab


def write_safetensors(path, sd, np_dtype=np.float32):
    """A flat numpy state dict -> a safetensors file written by the
    ``safetensors`` package, float arrays cast to ``np_dtype``."""
    from safetensors import numpy as stnp
    stnp.save_file({k: np.array(v.astype(np_dtype) if v.dtype.kind == "f"
                                else v, order="C")
                    for k, v in map(lambda kv: (kv[0], np.asarray(kv[1])),
                                    sd.items())}, str(path))


def _json(path, obj):
    import json
    with open(path, "w") as f:
        json.dump(obj, f)


def unet_config_json(ucfg, **extra):
    """The diffusers config.json fields of a UNet geometry, with the
    block types that say which levels carry transformers."""
    return dict({
        "sample_size": ucfg.sample_size,
        "block_out_channels": list(ucfg.block_out_channels),
        "down_block_types": ["CrossAttnDownBlock2D" if d else "DownBlock2D"
                             for d in ucfg.transformer_layers_per_block],
        "layers_per_block": ucfg.layers_per_block,
        "transformer_layers_per_block":
            list(ucfg.transformer_layers_per_block),
        "attention_head_dim": ucfg.attention_head_dim,
        "cross_attention_dim": ucfg.cross_attention_dim,
        "addition_time_embed_dim": ucfg.addition_time_embed_dim,
        "projection_class_embeddings_input_dim":
            ucfg.projection_class_embeddings_input_dim,
        "norm_num_groups": ucfg.norm_num_groups}, **extra)


def write_tiny_checkpoint(root, *, seed=0, np_dtype=np.float32):
    """A tiny SDXL checkout in the HF layout under ``root``: unet/, vae/
    (the encoder half included, as real files have it), text_encoder/
    and text_encoder_2/ (with transformers' ``position_ids`` buffer)
    safetensors in ``np_dtype`` with their config.json, and tokenizer/
    and tokenizer_2/ (pad "!") with merges learned from a corpus. The
    weights are ``numpy_params`` of the JAX tiny configs, written through
    the JAX package's own inverse of its converter."""
    import os

    from tests.test_convert import _emit_torch_sd
    root = str(root)
    trees = tiny_sdxl_numpy(seed)
    jc = jsdxl_tiny()
    for name, tree, fname in (
            ("unet", trees.unet, "diffusion_pytorch_model.safetensors"),
            ("vae", trees.vae, "diffusion_pytorch_model.safetensors"),
            ("text_encoder", trees.text_encoder, "model.safetensors"),
            ("text_encoder_2", trees.text_encoder_2, "model.safetensors")):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        sd = _emit_torch_sd(tree)
        if name.startswith("text_encoder"):
            sd["text_model.embeddings.position_ids"] = \
                np.arange(77, dtype=np.int64)[None]
        write_safetensors(os.path.join(root, name, fname), sd, np_dtype)
    _json(os.path.join(root, "unet", "config.json"),
          unet_config_json(jc.unet))
    v = jc.vae
    _json(os.path.join(root, "vae", "config.json"), {
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block,
        "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor})
    for name, t_cfg, arch in (
            ("text_encoder", jc.text_encoder, "CLIPTextModel"),
            ("text_encoder_2", jc.text_encoder_2,
             "CLIPTextModelWithProjection")):
        _json(os.path.join(root, name, "config.json"), {
            "architectures": [arch], "vocab_size": t_cfg.vocab_size,
            "hidden_size": t_cfg.hidden_size,
            "intermediate_size": t_cfg.intermediate_size,
            "num_hidden_layers": t_cfg.num_layers,
            "num_attention_heads": t_cfg.num_heads,
            "hidden_act": t_cfg.hidden_act,
            "projection_dim": t_cfg.projection_dim or 8})
    merges = learn_merges(TOKENIZER_CORPUS, 486)
    write_clip_tokenizer(os.path.join(root, "tokenizer"), merges)
    write_clip_tokenizer(os.path.join(root, "tokenizer_2"), merges, pad="!")
    return root


def kohya_lora_sd(rng, ucfg, te_hidden, rank=4, alpha=None):
    """A kohya-ss LoRA state dict (numpy) on the first mid-block
    transformer block's projections and feed-forward of a UNet of
    ``ucfg``, and on text encoder 1's first q_proj (width ``te_hidden``);
    ``alpha`` per module (None: rank)."""
    dim, ctx = ucfg.block_out_channels[-1], ucfg.cross_attention_dim
    blk = "lora_unet_mid_block_attentions_0_transformer_blocks_0_"
    shapes = {blk + "attn1_to_q": (dim, dim), blk + "attn1_to_out_0":
              (dim, dim), blk + "attn2_to_k": (ctx, dim),
              blk + "attn2_to_v": (ctx, dim), blk + "ff_net_2": (4 * dim, dim),
              "lora_te1_text_model_encoder_layers_0_self_attn_q_proj":
              (te_hidden, te_hidden)}
    sd = {}
    for key, (d_in, d_out) in shapes.items():
        sd[key + ".lora_down.weight"] = normal(rng, rank, d_in, scale=0.3)
        sd[key + ".lora_up.weight"] = normal(rng, d_out, rank, scale=0.3)
        sd[key + ".alpha"] = np.float32(rank if alpha is None else alpha)
    return sd


def jsdxl_tiny():
    from omg_tpu.pipelines import sdxl as jsdxl
    return jsdxl.tiny_config()


def tiny_sdxl(seed=0):
    """(JAX tiny SDXLParams, port SDXLParams) holding the same random
    weights."""
    from omg_tpu_torch import from_jax
    from omg_tpu_torch.pipelines import sdxl
    tree = tiny_sdxl_numpy(seed)
    return to_jax(tree), from_jax.sdxl_from_jax(tree, sdxl.tiny_config(),
                                                device="cpu")


def write_lora_checkout(root, rng, generator):
    """The CLIs' and the fidelity harness's files under ``root``: the tiny
    checkout (``write_tiny_checkpoint``, seed 2), two kohya LoRA files
    from ``rng`` (alpha = rank, and 2.0) and a tiny SAM ViT file from
    ``generator`` (the decoder's 256-wide embedding). Returns (checkout,
    [lora paths], SAM path)."""
    import dataclasses

    from omg_tpu import config as jconfig
    from omg_tpu_torch.segment import sam_provider, vit_sam
    ckpt = write_tiny_checkpoint(root / "sdxl", seed=2)
    ucfg = jconfig.tiny_unet()
    te = jconfig.tiny_text_encoder().hidden_size
    loras = []
    for i, alpha in enumerate((None, 2.0)):
        path = str(root / f"char{i}.safetensors")
        write_safetensors(path, kohya_lora_sd(rng, ucfg, te, alpha=alpha))
        loras.append(path)
    sam_cfg = dataclasses.replace(vit_sam.tiny_config(), out_chans=256)
    sam = str(root / "sam_vit_tiny.pth")
    torch.save(sam_provider.init_sam(generator, sam_cfg, "cpu").state_dict(),
               sam)
    return ckpt, loras, sam


def record_decodes(monkeypatch, cls, store):
    """Append the latents of every ``cls._decode`` call (an OMG engine of
    either package) to ``store`` as float32 numpy."""
    decode = cls._decode

    def record(self, latents):
        store.append(latents.float().numpy() if isinstance(
            latents, torch.Tensor) else np.asarray(latents, np.float32))
        return decode(self, latents)

    monkeypatch.setattr(cls, "_decode", record)
