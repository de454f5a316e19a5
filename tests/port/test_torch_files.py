"""The port's file formats against the packages the GPU host lacks: its
safetensors reader and writer against ``safetensors`` in both directions,
its PNG reader and writer against PIL, its bicubic resize against PIL's,
and ``checkpoint.py``'s round trip of the SDXL modules."""

import json
import os

import numpy as np
import PIL.Image
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file, save_file

from omg_tpu_torch import checkpoint, convert
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.utils import image

TENSORS = {
    "f32": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
    "f16": torch.linspace(-3, 3, 5).half(),
    "bf16": torch.linspace(-2, 7, 6).reshape(2, 3).bfloat16(),
    "f64": torch.tensor([1e-300, -2.5], dtype=torch.float64),
    "i64": torch.arange(-2, 2), "i32": torch.arange(3, dtype=torch.int32),
    "i8": torch.tensor([-128, 127], dtype=torch.int8),
    "u8": torch.tensor([255, 0, 7], dtype=torch.uint8),
    "bool": torch.tensor([True, False, True]),
    "empty": torch.zeros(0, 3), "scalar": torch.tensor(2.5),
    "odd": torch.arange(7, dtype=torch.uint8)}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_reads_the_package(tmp_path):
    path = str(tmp_path / "pkg.safetensors")
    save_file(TENSORS, path, metadata={"format": "pt", "note": "x"})
    _assert_same(convert.load_safetensors(path), TENSORS)
    _, meta, _ = convert.read_safetensors_header(path)
    assert meta == {"format": "pt", "note": "x"}


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    path = str(tmp_path / "port.safetensors")
    n = convert.save_safetensors(path, TENSORS, {"config": '{"a": 1}'})
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0   # padded
    _assert_same(load_file(path), TENSORS)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"config": '{"a": 1}'}
    _assert_same(convert.load_safetensors(path), TENSORS)


def test_unaligned_tensor_is_copied(tmp_path):
    """A writer that does not pad its header leaves tensors unaligned:
    the reader copies those instead of viewing them."""
    path = str(tmp_path / "unaligned.safetensors")
    head = json.dumps({"a": {"dtype": "F32", "shape": [2],
                             "data_offsets": [0, 8]}}).encode() + b" "
    assert len(head) % 4
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        f.write(np.float32([1.5, -2.0]).tobytes())
    assert convert.load_safetensors(path)["a"].tolist() == [1.5, -2.0]


def test_torch_pickles_are_unwrapped_and_flattened(tmp_path):
    path = str(tmp_path / "nested.bin")
    torch.save({"state_dict": {"image_proj": {"w": torch.ones(2)},
                               "ip_adapter": {"1.to_k_ip.weight":
                                              torch.zeros(3, 2)}}}, path)
    sd = convert.load_state_dict(path)
    assert set(sd) == {"image_proj.w", "ip_adapter.1.to_k_ip.weight"}


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips_against_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    # smooth rows, so that PIL's encoder picks every row filter
    img = (np.cumsum(rng.integers(0, 40, (29, 41, channels)), axis=1)
           % 256).astype(np.uint8)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    pil_path = str(tmp_path / "pil.png")
    PIL.Image.fromarray(img[..., 0] if channels == 1 else img,
                        mode).save(pil_path)
    np.testing.assert_array_equal(image.read_png(pil_path), img)
    np.testing.assert_array_equal(
        image.read_rgb(pil_path),
        np.asarray(PIL.Image.open(pil_path).convert("RGB")))
    ours = str(tmp_path / "port.png")
    image.write_png(ours, img)
    back = np.asarray(PIL.Image.open(ours))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_png_reader_names_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "palette.png")
    PIL.Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(
        path)
    with pytest.raises(ValueError, match="color type 3"):
        image.read_png(path)


@pytest.mark.parametrize("hw", [(64, 64), (200, 150), (33, 97), (96, 40),
                                (1024, 1024)])
def test_bicubic_resize_matches_pil(hw):
    """``Image.resize((w, h))`` of an RGB image (bicubic, the JAX CLI's
    condition resize), on noise whose overshoot PIL clips between its two
    passes: within one level (the port computes PIL's own fixed-point
    passes, so it is exact)."""
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)
    h, w = hw
    want = np.asarray(PIL.Image.fromarray(img).resize((w, h))).astype(int)
    got = image.resize(img, h, w)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_sdxl_checkpoint_round_trip(tmp_path):
    params = sdxl.init_params(torch.Generator().manual_seed(0),
                              sdxl.tiny_config())
    checkpoint.save_sdxl(str(tmp_path / "ckpt"), params)
    back = checkpoint.load_sdxl(str(tmp_path / "ckpt"), device="cpu")
    for a, b in zip(params, back):
        assert a.cfg == b.cfg
        _assert_same(b.state_dict(), a.state_dict())
