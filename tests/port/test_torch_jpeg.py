"""The port's baseline JPEG decoder (``utils/jpeg.py``) against PIL, pixel
for pixel: PIL-encoded images at odd sizes, two qualities, 4:4:4, 4:2:2
and 4:2:0, grayscale, restart markers and optimized Huffman tables;
cv2-encoded 4:4:0 and 4:1:1 files (the h1v2 fancy and the replicating
upsamplers); the refused formats; the committed fixtures; and the files
through ``utils/image`` and both CLIs' ``read_rgb``.

The fixtures in ``tests/port/data`` were made with PIL by

    python tests/port/test_torch_jpeg.py regenerate

(``_fixture_images`` below): ``small_444.jpg`` (37 x 53 RGB, quality 95,
4:4:4), ``gray.jpg`` (48 x 64 grayscale, quality 75) and
``smooth_1024_420.jpg`` (1024 x 1024 RGB, quality 90, 4:2:0, six seeded
sinusoids), each beside ``<name>.png``, PIL's decode of it, written with
the PNG "Up" filter (which the port's PNG reader undoes in numpy). The
GPU host has no PIL; ``chip_smoke.py`` phase 11 decodes the same files
there and holds them to the same PNGs.
"""

import io
import pathlib
import sys
import zlib

import cv2
import numpy as np
import PIL.Image
import pytest

from omg_tpu_torch.utils import image as image_lib
from omg_tpu_torch.utils import jpeg

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

DATA = pathlib.Path(__file__).resolve().parent / "data"
FIXTURES = ("small_444", "gray", "smooth_1024_420")


def _photo(h, w, c, seed):
    """Sinusoids plus noise: both smooth areas and edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([100 * np.sin(xx / 7 + k) * np.cos(yy / 11 - k)
                    for k in range(c)], -1) + rng.normal(0, 20, (h, w, c))
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 53), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_rgb_matches_pil(size, quality, subsampling):
    img = _photo(*size, 3, seed=sum(size) + quality)
    for kw in ({}, {"restart_marker_blocks": 1}, {"optimize": True}):
        data = _pil_jpeg(img, quality=quality, subsampling=subsampling, **kw)
        got = image_lib.to_rgb(jpeg.decode_jpeg(data))
        np.testing.assert_array_equal(got, _pil_decode(data), err_msg=str(kw))


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 53), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_matches_pil(size):
    img = _photo(*size, 1, seed=3)
    for quality in (50, 95):
        data = _pil_jpeg(img, quality=quality)
        got = jpeg.decode_jpeg(data)
        assert got.shape == size + (1,)
        np.testing.assert_array_equal(image_lib.to_rgb(got),
                                      _pil_decode(data))


@pytest.mark.parametrize("factor", ["440", "411", "422", "420"])
def test_other_samplings_match_pil(factor):
    """cv2's encoder writes the sampling factors PIL's does not (4:4:0
    takes libjpeg-turbo's h1v2 fancy upsampling, 4:1:1 its replication),
    with a restart interval of 2 MCUs."""
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    for h, w in ((1, 1), (2, 17), (17, 2), (33, 65)):
        img = _photo(h, w, 3, seed=h * w)
        ok, enc = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        assert ok
        data = enc.tobytes()
        np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                      _pil_decode(data), err_msg=f"{h}x{w}")


def test_refusals_name_the_format():
    img = _photo(16, 16, 3, seed=1)
    with pytest.raises(ValueError, match="progressive JPEG"):
        jpeg.decode_jpeg(_pil_jpeg(img, progressive=True))
    cmyk = io.BytesIO()
    PIL.Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        jpeg.decode_jpeg(cmyk.getvalue())
    with pytest.raises(ValueError, match="progressive JPEG"):
        image_lib.decode_image(_pil_jpeg(img, progressive=True), "x.jpg")
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xe0 jpeg")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_lib.decode_image(b"GIF89a", "x.gif")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_match_their_pil_decode(name):
    data = (DATA / f"{name}.jpg").read_bytes()
    want = image_lib.read_png(str(DATA / f"{name}.png"))
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_lib.to_rgb(got), _pil_decode(data))
    if name == "smooth_1024_420":
        assert got.shape == (1024, 1024, 3) and len(data) < 300_000


def test_read_rgb_and_the_clis_take_jpeg(monkeypatch):
    """``read_rgb`` reads JPEG files as PIL's ``convert("RGB")``, and both
    CLIs read their face and condition files through it."""
    from omg_tpu_torch.cli import inference_instantid, inference_lora
    from omg_tpu_torch import instantid
    for name in ("small_444", "gray"):
        got = image_lib.read_rgb(str(DATA / f"{name}.jpg"))
        np.testing.assert_array_equal(
            got, _pil_decode((DATA / f"{name}.jpg").read_bytes()))
    path = DATA / "small_444.jpg"
    cond = inference_lora.load_condition(str(path), 32, 48)
    want = image_lib.resize(_pil_decode(path.read_bytes()), 32, 48)
    np.testing.assert_array_equal(cond, want)
    seen = []
    monkeypatch.setattr(instantid, "analyze_face",
                        lambda img: seen.append(img) or "face")
    assert inference_instantid.get_face_info(str(path)) == "face"
    np.testing.assert_array_equal(seen[0], _pil_decode(path.read_bytes()))


def _fixture_images():
    smooth = np.zeros((1024, 1024, 3))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:1024, :1024] / 1024
    for _ in range(6):
        f = rng.uniform(1, 6, 2)
        ph, amp = rng.uniform(0, 6.3, 3), rng.uniform(20, 50, 3)
        smooth += amp * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy)[..., None]
                               + ph)
    return {
        "small_444": (_photo(37, 53, 3, seed=11),
                      dict(quality=95, subsampling=0)),
        "gray": (_photo(48, 64, 1, seed=12), dict(quality=75)),
        "smooth_1024_420": (np.clip(smooth + 128, 0, 255).astype(np.uint8),
                            dict(quality=90, subsampling=2)),
    }


def _png_up(img: np.ndarray) -> bytes:
    """An 8-bit PNG of ``img`` with every row "Up"-filtered."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int16)
    up = np.concatenate([rows[:1], rows[1:] - rows[:-1]]) % 256
    raw = np.concatenate([np.full((h, 1), 2), up], 1).astype(np.uint8)
    png = image_lib.encode_png(img)
    head = png[:png.index(b"IDAT") - 4]
    return (head + image_lib._chunk(b"IDAT", zlib.compress(raw.tobytes(), 9))
            + image_lib._chunk(b"IEND", b""))


def regenerate():
    DATA.mkdir(exist_ok=True)
    for name, (img, kw) in _fixture_images().items():
        data = _pil_jpeg(img, **kw)
        (DATA / f"{name}.jpg").write_bytes(data)
        decoded = np.asarray(PIL.Image.open(io.BytesIO(data)))
        if decoded.ndim == 2:
            decoded = decoded[:, :, None]
        (DATA / f"{name}.png").write_bytes(_png_up(decoded))


if __name__ == "__main__" and sys.argv[1:] == ["regenerate"]:
    regenerate()
