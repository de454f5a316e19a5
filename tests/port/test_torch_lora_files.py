"""LoRA files in the three layouts in the wild (kohya, diffusers/PEFT,
the old attn-procs export): the port's ``load_lora`` equals the JAX
package's ``load_lora`` through ``from_jax.lora_from_jax``, exactly, and
every key it yields names a LoRA-bearing ``Linear`` of the tiny port
model with the leaf's shapes (a key that names nothing would be a silent
no-op at run time)."""

import numpy as np
import pytest
import torch

from omg_tpu import lora as jlora
from omg_tpu_torch import from_jax, lora
from omg_tpu_torch.models import clip, unet
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import sdxl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import write_safetensors

CFG = sdxl.tiny_config()
_BLK = "mid_block.attentions.0.transformer_blocks.0"
_DOWN = "down_blocks.1.attentions.0"
_UP = "up_blocks.0.attentions.1.transformer_blocks.0"
_TE = "text_model.encoder.layers"


def _linears() -> dict:
    """{model: {module path: (in, out)}} of every Linear of the tiny
    port models (built without weights)."""
    models = {"unet": unet.UNet2DConditionModel(CFG.unet, "meta"),
              "text_encoder": clip.CLIPTextModel(CFG.text_encoder, "meta"),
              "text_encoder_2": clip.CLIPTextModel(CFG.text_encoder_2,
                                                   "meta")}
    return {name: {p: tuple(m.weight.shape[::-1])
                   for p, m in model.named_modules()
                   if isinstance(m, layers.Linear)}
            for name, model in models.items()}


LINEARS = _linears()

# (model, port module path, kohya flattening of that path)
TARGETS = [
    ("unet", f"{_BLK}.attn1.to_q", f"{_BLK}.attn1.to_q"),
    ("unet", f"{_BLK}.attn1.to_out.0", f"{_BLK}.attn1.to_out.0"),
    ("unet", f"{_BLK}.attn2.to_k", f"{_BLK}.attn2.to_k"),
    ("unet", f"{_BLK}.ff.net.0.proj", f"{_BLK}.ff_net.0.proj"),
    ("unet", f"{_BLK}.ff.net.2", f"{_BLK}.ff_net.2"),
    ("unet", f"{_DOWN}.proj_in", f"{_DOWN}.proj_in"),
    ("unet", f"{_UP}.attn2.to_v", f"{_UP}.attn2.to_v"),
    ("unet", "down_blocks.1.resnets.0.time_emb_proj",
     "down_blocks.1.resnets.0.time_emb_proj"),
    ("text_encoder", f"{_TE}.0.self_attn.q_proj",
     f"{_TE}.0.self_attn.q_proj"),
    ("text_encoder", f"{_TE}.1.mlp.fc1", f"{_TE}.1.mlp.fc1"),
    ("text_encoder_2", f"{_TE}.1.self_attn.out_proj",
     f"{_TE}.1.self_attn.out_proj")]


def _pair(rng, model, path, rank):
    d_in, d_out = LINEARS[model][path]
    return (rng.standard_normal((rank, d_in)).astype(np.float32) * 0.1,
            rng.standard_normal((d_out, rank)).astype(np.float32) * 0.1)


def kohya_sd(rng, rank=4):
    """kohya-ss keys, ``alpha`` on all but the first module, plus a 1x1
    conv LoRA on a linear (squeezed on load) and a 3x3 conv LoRA on a
    conv (skipped)."""
    pre = {"unet": "lora_unet", "text_encoder": "lora_te1",
           "text_encoder_2": "lora_te2"}
    sd = {}
    for i, (model, path, flat) in enumerate(TARGETS):
        down, up = _pair(rng, model, path, rank)
        key = f"{pre[model]}_{flat.replace('.', '_')}"
        if path.endswith("proj_in"):
            down, up = down[:, :, None, None], up[:, :, None, None]
        sd[f"{key}.lora_down.weight"] = down
        sd[f"{key}.lora_up.weight"] = up
        if i:
            sd[f"{key}.alpha"] = np.float32(rank / 2 + i)
    sd["lora_unet_down_blocks_1_resnets_0_conv1.lora_down.weight"] = \
        rng.standard_normal((rank, 32, 3, 3)).astype(np.float32)
    sd["lora_unet_down_blocks_1_resnets_0_conv1.lora_up.weight"] = \
        rng.standard_normal((64, rank, 1, 1)).astype(np.float32)
    return sd


def peft_sd(rng, rank=3):
    """diffusers/PEFT keys, one ``alpha``."""
    sd = {}
    for model, path, _ in TARGETS:
        down, up = _pair(rng, model, path, rank)
        sd[f"{model}.{path}.lora_A.weight"] = down
        sd[f"{model}.{path}.lora_B.weight"] = up
    sd[f"unet.{_BLK}.attn1.to_q.alpha"] = np.float32(6.0)
    return sd


def attn_procs_sd(rng, rank=2):
    """The old unprefixed ``save_attn_procs`` export (UNet attention
    only): ``<block>.processor.to_q_lora.down.weight``."""
    sd = {}
    for model, path, _ in TARGETS[:3] + TARGETS[6:7]:
        blk, _, proj = path.rpartition(".attn")
        attn, proj = proj.split(".")[0], proj.split(".")[1]
        down, up = _pair(rng, model, path, rank)
        base = f"{blk}.attn{attn}.processor.{proj}_lora"
        sd[f"{base}.down.weight"] = down
        sd[f"{base}.up.weight"] = up
    return sd


LAYOUTS = {"kohya": kohya_sd, "peft": peft_sd, "attn_procs": attn_procs_sd}


@pytest.mark.parametrize("np_dtype", [np.float32, np.float16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_lora_equals_jax(tmp_path, layout, np_dtype):
    sd = LAYOUTS[layout](np.random.default_rng(len(layout)))
    path = str(tmp_path / f"{layout}.safetensors")
    write_safetensors(path, sd, np_dtype)
    got = lora.load_lora(path, weight=0.7, device="cpu")
    want = from_jax.lora_from_jax(jlora.load_lora(path, weight=0.7),
                                  device="cpu")
    assert set(got) == set(want) == set(lora.MODELS)
    n = 0
    for model in lora.MODELS:
        assert set(got[model]) == set(want[model]), model
        for key, leaf in got[model].items():
            for role in ("down", "up", "scale"):
                assert leaf[role].dtype == torch.float32
                assert torch.equal(leaf[role], want[model][key][role]), \
                    (key, role)
            d_in, d_out = LINEARS[model][key]   # a LoRA-bearing linear
            assert leaf["down"].shape[0] == d_in
            assert leaf["up"].shape[1] == d_out
            n += 1
    expected = {"kohya": len(TARGETS), "peft": len(TARGETS),
                "attn_procs": 4}[layout]
    assert n == expected


def test_kohya_alpha_scale_and_conv_rules(tmp_path):
    """scale = weight * alpha / rank, alpha = rank without one; the 1x1
    conv LoRA is squeezed, the 3x3 one skipped."""
    sd = kohya_sd(np.random.default_rng(0))
    got = lora.lora_from_state_dict(sd, weight=2.0, device="cpu")["unet"]
    assert float(got[TARGETS[0][1]]["scale"]) == 2.0
    assert float(got[TARGETS[1][1]]["scale"]) == pytest.approx(
        2.0 * (4 / 2 + 1) / 4)
    key = f"{_DOWN}.proj_in"
    assert got[key]["down"].shape == (LINEARS["unet"][key][0], 4)
    assert not any("conv1" in k for k in got)


def test_loaded_lora_runs_in_the_model(tmp_path):
    """A loaded adapter changes the UNet's output exactly as its delta
    predicts at one linear: the key reaches the module."""
    sd = peft_sd(np.random.default_rng(1))
    ad = lora.lora_from_state_dict(sd, device="cpu")["unet"]
    model = unet.init_params(torch.Generator().manual_seed(0), CFG.unet)
    lin = model.get_submodule(f"{_BLK}.attn1.to_q")
    x = torch.randn(2, 5, lin.weight.shape[1])
    want = lin(x) + layers.lora_delta(ad[f"{_BLK}.attn1.to_q"], x)
    torch.testing.assert_close(lin(x, ad), want)
    assert not torch.allclose(lin(x, ad), lin(x))
