"""The port's loaders against the JAX package's on the same files: every
tensor the port loads equals ``from_jax`` of the JAX loader's tree, bit
for bit. SDXL (fp32 and fp16 files), the ControlNet / IdentityNet
directory, the IP-Adapter ``.bin``, both SAM families (upstream keys
that have no module dropped) and the CLIP towers of a CLIPModel file."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import convert as jconvert
from omg_tpu import loader as jloader
from omg_tpu.models import clip as jclip
from omg_tpu.models import clip_vision as jcv
from omg_tpu.models import controlnet as jcn
from omg_tpu.segment import efficientvit as jevit
from omg_tpu.segment import sam_provider as jsp
from omg_tpu.segment import vit_sam as jvit
from omg_tpu_torch import config, convert, from_jax, loader
from omg_tpu_torch.models import resampler, unet
from omg_tpu_torch.segment import efficientvit as evit
from omg_tpu_torch.segment import sam_provider as sp
from omg_tpu_torch.segment import vit_sam

from tests.test_convert import _emit_torch_sd
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (np_tree, numpy_params, sam_numpy,
                                unet_config_json, write_safetensors,
                                write_tiny_checkpoint)


def _without_none(tree):
    """A converted JAX tree without the None placeholders ``_listify``
    leaves for parameterless torch Sequential members (the resampler's
    GELU, the SAM decoder's upscaling activation)."""
    if isinstance(tree, dict):
        return {k: _without_none(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {i: _without_none(v) for i, v in enumerate(tree)
                if v is not None}
    return tree


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        w = want[k]
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.array(w))
        g = got[k]
        assert g.shape == w.shape, k
        assert torch.equal(g.float(), w.float()), k


@pytest.mark.parametrize("file_dtype", [np.float32, np.float16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_load_sdxl_equals_jax(tmp_path, file_dtype, dtype):
    root = write_tiny_checkpoint(tmp_path, seed=3, np_dtype=file_dtype)
    cfg, params, tok1, tok2 = loader.load_sdxl(root, dtype=dtype,
                                               device="cpu")
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jcfg, jparams, jtok1, jtok2 = jloader.load_sdxl(root, dtype=jdt,
                                                    pack=False)
    assert cfg.unet.transformer_layers_per_block == \
        jcfg.unet.transformer_layers_per_block
    assert cfg.text_encoder.projection_dim == 0        # CLIPTextModel
    want = from_jax.sdxl_from_jax(np_tree(jparams), cfg, device="cpu")
    for got, ref in zip(params, want):
        assert next(got.parameters()).device.type == "cpu"
        _assert_state_equal(got.state_dict(), ref.state_dict())
    assert params.unet.conv_in.weight.dtype == dtype
    assert params.vae.decoder.conv_in.weight.dtype == torch.float32
    prompt = ["photo of the man and the woman!"]
    np.testing.assert_array_equal(tok1(prompt), jtok1(prompt))
    np.testing.assert_array_equal(tok2(prompt), jtok2(prompt))


def test_published_sdxl_config_fields(tmp_path):
    """The published SDXL unet/config.json: ``attention_head_dim`` is a
    per-level list (head counts; the head size stays 64) and
    ``transformer_layers_per_block`` [1, 2, 10] sits beside
    ``down_block_types``, whose plain first level carries none."""
    folder = tmp_path / "unet"
    os.makedirs(folder)
    with open(folder / "config.json", "w") as f:
        json.dump(unet_config_json(config.sdxl_unet(),
                                   attention_head_dim=[5, 10, 20],
                                   transformer_layers_per_block=[1, 2, 10]),
                  f)
    cfg = loader._unet_cfg(str(folder), torch.bfloat16)
    assert cfg == config.sdxl_unet()


def test_loading_is_strict(tmp_path):
    root = write_tiny_checkpoint(tmp_path)
    path = os.path.join(root, "unet", "diffusion_pytorch_model.safetensors")
    sd = {k: v.numpy() for k, v in convert.load_safetensors(path).items()}
    cfg = loader._unet_cfg(os.path.join(root, "unet"), torch.float32)
    write_safetensors(path, {k: v for k, v in sd.items()
                             if k != "conv_in.bias"})
    with pytest.raises(KeyError, match="missing.*conv_in.bias"):
        convert.convert_unet(path, cfg, device="cpu")
    write_safetensors(path, dict(sd, **{"conv_in.extra": sd["conv_in.bias"]}))
    with pytest.raises(KeyError, match="unexpected.*conv_in.extra"):
        convert.convert_unet(path, cfg, device="cpu")
    write_safetensors(path, dict(sd, **{"conv_in.bias": sd["conv_in.bias"]
                                        [:-1]}))
    with pytest.raises(ValueError, match="conv_in.bias"):
        convert.convert_unet(path, cfg, device="cpu")


def test_loaders_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_sdxl(str(tmp_path))


def write_controlnet_dir(folder, seed=5):
    """A tiny diffusers ControlNet / IdentityNet directory."""
    ccfg = jconfig.tiny_controlnet()
    os.makedirs(folder, exist_ok=True)
    write_safetensors(os.path.join(folder,
                                   "diffusion_pytorch_model.safetensors"),
                      _emit_torch_sd(numpy_params(jcn.init_params, ccfg,
                                                  seed)))
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(unet_config_json(
            ccfg.unet, conditioning_embedding_out_channels=list(
                ccfg.conditioning_embedding_out_channels)), f)
    return str(folder)


def test_load_controlnet_equals_jax(tmp_path):
    folder = write_controlnet_dir(tmp_path / "idnet")
    cfg, model = loader.load_controlnet(folder, dtype=torch.float32,
                                        device="cpu")
    assert cfg == config.tiny_controlnet()
    jcfg, jparams = jloader.load_controlnet(folder, dtype=jnp.float32)
    want = from_jax.controlnet_from_jax(np_tree(jparams), cfg, device="cpu")
    _assert_state_equal(model.state_dict(), want.state_dict())


def ip_file_dict(ip, ucfg) -> dict:
    """The ``ip_adapter`` half of an adapter file holding the traversal-
    order layers ``ip``: keys 1, 3, 5, ... in diffusers'
    ``attn_processors`` order, down, up, mid."""
    return {f"{2 * slot + 1}.{name}.weight": getattr(ip[pos], name).weight
            for slot, pos in enumerate(unet.ip_file_order(ucfg))
            for name in ("to_k_ip", "to_v_ip")}


def write_ip_adapter_bin(path, seed=6):
    """A tiny InstantID ``ip-adapter.bin`` in the upstream nested layout:
    the resampler under ``image_proj``, the IP projections of the tiny
    UNet's four attn2 under ``ip_adapter`` with the keys 1, 3, 5, 7 in
    diffusers' order -> (path, the IP layers in traversal order)."""
    g = torch.Generator().manual_seed(seed)
    rs = resampler.init_params(g, config.tiny_resampler())
    ip = unet.init_ip_layers(g, config.tiny_unet())
    nested = {"image_proj": rs.state_dict(),
              "ip_adapter": ip_file_dict(ip, config.tiny_unet())}
    torch.save(nested, str(path))
    return str(path), ip


def test_ip_adapter_equals_jax(tmp_path):
    """The port against the JAX converter, which takes the file's layers in
    the forward's traversal order (a defect of the reference, ROADMAP §3):
    the port's layer ``ip_file_order[s]`` is JAX's layer s, and the port
    holds the layers that were written, each in its place."""
    path, ip = write_ip_adapter_bin(tmp_path / "ip-adapter.bin")
    rs_cfg = convert.infer_resampler_cfg(path, dtype=torch.float32)
    assert rs_cfg == config.tiny_resampler()
    got = convert.convert_ip_adapter(path, rs_cfg,
                                     unet_cfg=config.tiny_unet(),
                                     dtype=torch.float32, device="cpu")
    jsd = jconvert.load_state_dict(path)
    jad = jconvert.convert_ip_adapter(jsd, dtype=jnp.float32)
    jrs = jconvert.infer_resampler_cfg(jsd, dtype=jnp.float32)
    assert {k: v for k, v in dataclasses.asdict(jrs).items()
            if k != "dtype"} == {k: v for k, v in
                                 dataclasses.asdict(rs_cfg).items()
                                 if k != "dtype"}
    want_rs = from_jax.resampler_from_jax(
        _without_none(np_tree(jad["image_proj"])), rs_cfg, device="cpu")
    want_ip = from_jax.ip_layers_from_jax(np_tree(jad["ip_adapter"]),
                                          config.tiny_unet(), device="cpu")
    order = unet.ip_file_order(config.tiny_unet())
    assert order != sorted(order)
    _assert_state_equal(got["image_proj"].state_dict(),
                        want_rs.state_dict())
    _assert_state_equal(
        got["ip_adapter"].state_dict(),
        {f"{order[int(k.split('.')[0])]}.{k.split('.', 1)[1]}": v
         for k, v in want_ip.state_dict().items()})
    _assert_state_equal(got["ip_adapter"].state_dict(), ip.state_dict())
    assert len(got["ip_adapter"]) == unet.num_cross_attention_layers(
        config.tiny_unet())


def test_ip_adapter_file_order_at_sdxl_widths():
    """An SDXL adapter file lists its 70 IP layers as diffusers'
    ``attn_processors`` does: down blocks (640 x 4, 1280 x 20), up blocks
    (1280 x 30, 640 x 6), mid block (1280 x 10). Read in that order, each
    lands on an attn2 of its own width (traversal order: down, mid, up);
    read in traversal order, a 640-wide layer would meet a 1280-wide
    attention. The context width is cut to 8 here: the converter reads
    each layer's shape off the file."""
    ucfg = config.sdxl_unet()
    order = unet.ip_file_order(ucfg)
    assert order == (list(range(24)) + list(range(34, 70))
                     + list(range(24, 34)))
    file_widths = [640] * 4 + [1280] * 20 + [1280] * 30 + [640] * 6 + \
        [1280] * 10
    rcfg = config.ResamplerConfig(dim=8, depth=1, dim_head=4, heads=2,
                                  num_queries=2, embedding_dim=4,
                                  output_dim=8, ff_mult=1,
                                  dtype=torch.float32)
    sd = {f"image_proj.{k}": torch.zeros(v.shape) for k, v in
          resampler.Resampler(rcfg, device="meta").state_dict().items()}
    for slot, c in enumerate(file_widths):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{2 * slot + 1}.{name}.weight"] = torch.zeros(c, 8)
    got = convert.convert_ip_adapter(sd, rcfg, dtype=torch.float32,
                                     device="cpu")["ip_adapter"]
    assert [m.to_k_ip.weight.shape[0] for m in got] == \
        [640] * 4 + [1280] * 20 + [1280] * 10 + [1280] * 30 + [640] * 6
    with pytest.raises(ValueError, match="70 cross-attentions"):
        convert.convert_ip_adapter(
            {k: v for k, v in sd.items() if not k.startswith(
                "ip_adapter.139.")}, rcfg, dtype=torch.float32,
            device="cpu")


def test_ip_adapter_in_file_order_drives_a_two_width_unet(tmp_path):
    """A UNet with attention at two widths (32 and 64): an adapter written
    in diffusers' order converts to the traversal-order layers, and the
    forward with them equals the forward with the layers that were
    written."""
    ucfg = dataclasses.replace(config.tiny_unet(),
                               transformer_layers_per_block=(1, 1))
    g = torch.Generator().manual_seed(2)
    model = unet.init_params(g, ucfg, device="cpu")
    ip = unet.init_ip_layers(g, ucfg, device="cpu")
    rs = resampler.init_params(g, config.tiny_resampler(), device="cpu")
    path = str(tmp_path / "ip-adapter.bin")
    torch.save({"image_proj": rs.state_dict(),
                "ip_adapter": ip_file_dict(ip, ucfg)}, path)
    got = convert.convert_ip_adapter(path, config.tiny_resampler(),
                                     unet_cfg=ucfg, dtype=torch.float32,
                                     device="cpu")["ip_adapter"]
    x = torch.randn((2, 8, 8, 4), generator=g)
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=g)
    kw = dict(text_embeds=torch.randn((2, 16), generator=g),
              time_ids=torch.zeros((2, 6)),
              ip_context=torch.randn((2, 4, ucfg.cross_attention_dim),
                                     generator=g), ip_scale=0.8)
    with torch.no_grad():
        want = model(x, 3, ctx, ip_adapter=ip, **kw)
        out = model(x, 3, ctx, ip_adapter=got, **kw)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# upstream keys that have no module in the port, with their tree paths
_SAM_EXTRA = {"prompt_encoder.mask_downscaling.0.weight": (4, 1, 2, 2),
              "prompt_encoder.mask_downscaling.1.bias": (4,),
              "pixel_mean": (3, 1, 1), "pixel_std": (3, 1, 1)}


# Two defects of the JAX converter (ROADMAP §3), undone here: it
# transposes SAM's [n, 256] token tables as it transposes a linear, and
# the decoder's ConvTranspose kernels twice (to its [k, k, out, in], then
# by the generic conv rule), which from_jax maps to the upstream kernel
# transposed (2, 3, 1, 0). The port loads both as upstream stores them.
_SAM_TABLES = ("point_embeddings", "not_a_point_embed", "no_mask_embed",
               "iou_token", "mask_tokens")
_SAM_UPSCALING = ("mask_decoder.output_upscaling.0.weight",
                  "mask_decoder.output_upscaling.3.weight")


def _undo_jax_sam_defects(key, arr):
    if any(t in key for t in _SAM_TABLES):
        return arr.T
    return arr.transpose(3, 2, 0, 1) if key in _SAM_UPSCALING else arr


@pytest.mark.parametrize("family", ["efficientvit", "vit"])
def test_sam_checkpoint_equals_jax(tmp_path, family):
    """A SAM file in the upstream layout (a BatchNorm counter, the mask
    downscaler and the pixel statistics included) -> the same tensors as
    the JAX converter's tree through ``sam_from_jax``, the token tables
    excepted, which it transposes. The ViT geometry comes from the keys;
    the tiny EfficientViT matches no zoo geometry, so it is passed."""
    if family == "vit":
        tree = sam_numpy(jvit.init_params, jvit.tiny_config(), seed=7)
        cfg, given = vit_sam.tiny_config(), None
    else:
        tree = sam_numpy(jevit.init_params, jevit.tiny_config(), seed=7)
        cfg = given = evit.tiny_config()
    sd = dict(from_jax.sam_from_jax(tree, cfg=cfg,
                                    device="cpu").state_dict())
    rng = np.random.default_rng(8)
    for k, shape in _SAM_EXTRA.items():
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    counter = ("image_encoder.backbone.stages.0.op_list.0.norm."
               "num_batches_tracked")
    if family == "efficientvit":
        sd[counter] = torch.tensor(3)
    path = str(tmp_path / ("xl1.pt" if family == "efficientvit"
                           else "sam_vit_h.pth"))
    torch.save(sd, path)
    got = sp.convert_sam_checkpoint(path, cfg=given, device="cpu")
    assert got.image_encoder.cfg == cfg
    want = from_jax._state_dict(_without_none(np_tree(
        jsp.convert_sam_checkpoint(path))))
    # the JAX tree keeps the keys its functions never read
    assert set(want) - set(got.state_dict()) <= set(_SAM_EXTRA) | {counter}
    want = {k: _undo_jax_sam_defects(k, want[k]) for k in got.state_dict()}
    _assert_state_equal(got.state_dict(), want)
    _assert_state_equal(got.state_dict(), {k: sd[k] for k in want})
    if family == "vit":
        enc = vit_sam.convert_encoder(
            {k[len("image_encoder."):]: v for k, v in sd.items()
             if k.startswith("image_encoder.")}, device="cpu")
        _assert_state_equal(enc.state_dict(),
                            got.image_encoder.state_dict())


VISION = dict(image_size=32, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4,
              projection_dim=16)
TEXT = dict(vocab_size=1000, hidden_size=16, intermediate_size=32,
            num_layers=2, num_heads=2, projection_dim=16)


def test_clip_towers_of_a_clipmodel_file(tmp_path):
    """A transformers CLIPModel file holds both towers, ``logit_scale``
    and the ``position_ids`` buffers: each tower loads its own half, as
    the JAX converters give it."""
    vtree = numpy_params(jcv.init_params, jconfig.CLIPVisionConfig(**VISION),
                         11)
    ttree = numpy_params(jclip.init_params, jconfig.CLIPTextConfig(**TEXT),
                         12)
    sd = dict(_emit_torch_sd(vtree), **_emit_torch_sd(ttree))
    sd["logit_scale"] = np.float32(2.6592)
    sd["text_model.embeddings.position_ids"] = np.arange(77)[None]
    sd["vision_model.embeddings.position_ids"] = np.arange(17)[None]
    path = str(tmp_path / "clip.safetensors")
    write_safetensors(path, sd)
    vcfg = config.CLIPVisionConfig(**VISION)
    tcfg = config.CLIPTextConfig(**TEXT, dtype=torch.float32)
    vis = convert.convert_clip_vision(path, vcfg, device="cpu")
    txt = convert.convert_clip(path, tcfg, device="cpu")
    jv = jconvert.convert_clip_vision(path)
    jt = jconvert.convert_clip(path, dtype=jnp.float32)
    want_v = from_jax._state_dict(np_tree(jv))
    want_t = from_jax._state_dict(np_tree(jt))
    _assert_state_equal(vis.state_dict(),
                        {k: want_v[k] for k in vis.state_dict()})
    _assert_state_equal(txt.state_dict(),
                        {k: want_t[k] for k in txt.state_dict()})


def test_mask_provider_from_files(tmp_path, monkeypatch):
    """``build_mask_provider`` with ``sam_checkpoint`` and
    ``clip_checkpoint`` builds the SAM x CLIP detector from the files (the
    CLIP B/32 presets pointed at the tiny towers)."""
    from omg_tpu_torch.segment import build_mask_provider, detector
    from omg_tpu_torch.text.tokenizer import ToyTokenizer
    sam_path = str(tmp_path / "sam_vit_b.pth")
    sam = sp.init_sam(torch.Generator().manual_seed(9), dataclasses.replace(
        vit_sam.tiny_config(), out_chans=256), "cpu")
    torch.save(sam.state_dict(), sam_path)
    clip_path = str(tmp_path / "clip.safetensors")
    write_safetensors(clip_path, dict(
        _emit_torch_sd(numpy_params(jcv.init_params,
                                    jconfig.CLIPVisionConfig(**VISION), 13)),
        **_emit_torch_sd(numpy_params(jclip.init_params,
                                      jconfig.CLIPTextConfig(**TEXT), 14))))
    monkeypatch.setattr(config, "clip_vit_b32_vision",
                        lambda: config.CLIPVisionConfig(**VISION))
    monkeypatch.setattr(config, "clip_vit_b32_text", lambda: config
                        .CLIPTextConfig(**TEXT, dtype=torch.float32))
    provider = build_mask_provider("sam", sam_checkpoint=sam_path,
                                   clip_checkpoint=clip_path,
                                   tokenizer=ToyTokenizer(), device="cpu")
    assert isinstance(provider.box_provider, detector.OpenVocabDetector)
    _assert_state_equal(provider.predictor.sam.state_dict(),
                        sam.state_dict())
    img = np.random.default_rng(15).integers(0, 256, (48, 64, 3), np.uint8)
    masks = provider.masks_for(img, ["man", "woman"])
    assert len(masks) == 2
