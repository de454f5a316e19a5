"""The checkpoint layouts the benchmark writes are the ones the port's
loaders take, and the draws repeat from the seed."""

import json
import pathlib

import pytest
import torch

from benchmark import program, weights
from benchmark.tests import tiny
from omg_tpu_torch.models import clip, unet, vae

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def configs():
    sdxl = json.loads((CONFIGS / "omg_lora2_sdxl.json").read_text())
    return [sdxl, tiny.tiny_config(sdxl)]


@pytest.mark.parametrize("cfg", configs(), ids=["sdxl", "tiny"])
def test_layouts_match_the_port_modules(cfg):
    scfg = program.sdxl_config(cfg)
    pairs = [(weights.unet_spec(cfg["unet"]),
              unet.UNet2DConditionModel(scfg.unet, "meta")),
             (weights.vae_spec(cfg["vae"]), vae.AutoencoderKL(scfg.vae, "meta")),
             (weights.clip_spec(cfg["text_encoder"]),
              clip.CLIPTextModel(scfg.text_encoder, "meta")),
             (weights.clip_spec(cfg["text_encoder_2"]),
              clip.CLIPTextModel(scfg.text_encoder_2, "meta"))]
    for spec, module in pairs:
        assert dict(spec) == {k: tuple(v.shape)
                              for k, v in module.state_dict().items()}


def test_sdxl_sizes():
    cfg = configs()[0]
    assert weights.numel(weights.unet_spec(cfg["unet"])) == 2_567_463_684
    mods = weights.lora_modules(cfg["unet"], cfg["lora"]["target_modules"])
    assert len(mods) == 70 * 8


def test_loras_load_through_the_port():
    cfg = configs()[1]
    (lora,) = program.loras(cfg, 5, 1, "cpu")
    mods = weights.lora_modules(cfg["unet"], cfg["lora"]["target_modules"])
    assert sorted(lora["unet"]) == sorted(m for m, _, _ in mods)
    for m, cin, cout in mods:
        leaf = lora["unet"][m]
        assert leaf["down"].shape == (cin, 4) and leaf["up"].shape == (4, cout)
        assert float(leaf["scale"]) == 1.0


def test_draws_repeat_from_the_seed_and_differ_between_seeds():
    spec = weights.vae_spec(configs()[1]["vae"])
    a = weights.make_state_dict(spec, 2 ** 33 + 1, 2, device="cpu",
                                dtype=torch.float32)
    b = weights.make_state_dict(spec, 2 ** 33 + 1, 2, device="cpu",
                                dtype=torch.float32)
    c = weights.make_state_dict(spec, 2 ** 33 + 2, 2, device="cpu",
                                dtype=torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.conv_in.weight"],
                           c["decoder.conv_in.weight"])
    w = a["decoder.conv_in.weight"]
    assert abs(float(w.std()) * (w[0].numel() ** 0.5) - 1.0) < 0.1
    assert abs(float(a["decoder.conv_norm_out.weight"].mean()) - 1.0) < 0.02
