"""The port's examples (``examples/torch_*.py``) on the CPU, and the console
scripts of ``pyproject.toml``: the quickstart's two-stage flow, the
multi-device example on two gloo ranks against the one-device engine, the
full pipeline from a tiny HF-layout checkout, and every
``[project.scripts]`` entry resolving to a callable ``main``."""

import dataclasses
import importlib
import pathlib
import tomllib

import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu_torch import loader
from omg_tpu_torch.segment import sam_provider, vit_sam
from omg_tpu_torch.utils import image

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (kohya_lora_sd, write_safetensors,
                                write_tiny_checkpoint)

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def examples(monkeypatch):
    """The examples directory on sys.path (the multi-device example's
    ranks import it by name)."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    return importlib.import_module


def test_quickstart_runs_on_the_cpu(examples, tmp_path, capsys):
    quick = examples("torch_quickstart_random_weights")
    out = tmp_path / "quickstart.png"
    res = quick.main(["--device", "cpu", "--out", str(out)])
    assert res.stage1.shape == (2, 32, 32, 3) and res.stage2 is not None
    assert [m is not None for m in res.masks] == [True, True]
    np.testing.assert_array_equal(image.read_png(str(out)), res.image)
    assert "masks found:   [True, True]" in capsys.readouterr().out


def test_multichip_example_matches_one_device(examples):
    """Two gloo CPU ranks, (data, model) = (2, 1), against the engine on
    one device: the same images within one uint8 level (the tolerance of
    test_torch_parallel_omg.py), identical across the ranks."""
    multi = examples("torch_multichip_latency")
    ranks = multi.main(["--ranks", "2", "--device", "cpu"])
    assert [r["grid"] for r in ranks] == [(2, 1), (2, 1)]
    single = multi.generate(multi.engine("cpu"))
    for r in ranks:
        for name in ("stage1", "stage2"):
            got, want = r[name], getattr(single, name)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_array_equal(r["image"], ranks[0]["image"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny HF-layout SDXL checkout, a tiny SAM ViT file (256-wide
    embedding) and two kohya LoRA files."""
    root = tmp_path_factory.mktemp("full")
    ckpt = write_tiny_checkpoint(root / "sdxl", seed=4)
    sam = str(root / "sam_vit_tiny.pth")
    torch.save(sam_provider.init_sam(
        torch.Generator().manual_seed(5),
        dataclasses.replace(vit_sam.tiny_config(), out_chans=256),
        "cpu").state_dict(), sam)
    rng = np.random.default_rng(6)
    loras = []
    for i in range(2):
        path = str(root / f"char{i}.safetensors")
        write_safetensors(path, kohya_lora_sd(
            rng, jconfig.tiny_unet(), jconfig.tiny_text_encoder().hidden_size))
        loras.append(path)
    return dict(ckpt=ckpt, sam=sam, loras=loras)


def test_full_pipeline_from_a_tiny_checkout(examples, files, tmp_path):
    full = examples("torch_full_pipeline")
    out = tmp_path / "omg_out.png"
    res = full.main(["--sdxl", files["ckpt"], "--sam", files["sam"],
                     "--lora", files["loras"][0], "--lora", files["loras"][1],
                     "--steps", "2", "--height", "64", "--width", "64",
                     "--device", "cpu", "--out", str(out)])
    assert res.stage1.shape == (2, 64, 64, 3)
    written = image.read_png(str(out))
    assert written.shape == (64, 64, 3)
    np.testing.assert_array_equal(written, res.image)


def test_full_pipeline_needs_sdxl_before_loading(examples, monkeypatch,
                                                 capsys):
    full = examples("torch_full_pipeline")

    def no_load(*args, **kwargs):
        raise AssertionError("loaded a checkpoint")

    monkeypatch.setattr(loader, "load_sdxl", no_load)
    with pytest.raises(SystemExit) as e:
        full.main(["--sam", "sam.pth"])
    assert e.value.code == 2
    assert "--sdxl" in capsys.readouterr().err


def _scripts() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("name", sorted(_scripts()))
def test_console_scripts_resolve(name):
    module, attr = _scripts()[name].split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_the_port_has_its_console_scripts():
    scripts = _scripts()
    for kind, cli in (("lora", "inference_lora"),
                      ("instantid", "inference_instantid"),
                      ("serve", "serve")):
        assert scripts[f"omg-torch-{kind}"] == f"omg_tpu_torch.cli.{cli}:main"
        assert scripts[f"omg-tpu-{kind}"] == f"omg_tpu.cli.{cli}:main"
