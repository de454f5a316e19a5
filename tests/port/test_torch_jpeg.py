"""The port's JPEG decoder (``utils/jpeg.py``) against PIL, pixel for
pixel: PIL-encoded images at odd sizes, two qualities, 4:4:4, 4:2:2 and
4:2:0, grayscale, restart markers and optimized Huffman tables, sequential
and progressive; CMYK and YCCK files; cv2-encoded 4:4:0 and 4:1:1 files
(the h1v2 fancy and the replicating upsamplers); the refused formats; the
committed fixtures; and the files through ``utils/image`` and both CLIs'
``read_rgb``.

The fixtures in ``tests/port/data`` were made with PIL by

    python tests/port/test_torch_jpeg.py regenerate

(``_fixture_images`` below): ``small_444.jpg`` (37 x 53 RGB, quality 95,
4:4:4), ``gray.jpg`` (48 x 64 grayscale, quality 75) and
``smooth_1024_420.jpg`` (1024 x 1024 RGB, quality 90, 4:2:0, six seeded
sinusoids), ``progressive_1024_420.jpg`` (the same image, progressive),
``progressive_444_rst.jpg`` (37 x 53, quality 95, 4:4:4, progressive, a
restart marker every 3 MCU rows) and ``cmyk.jpg`` (40 x 56 CMYK, quality
90), each beside ``<name>.png``, PIL's decode of it (``convert("RGB")``
for CMYK), written with
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
FIXTURES = ("small_444", "gray", "smooth_1024_420", "progressive_1024_420",
            "progressive_444_rst", "cmyk")


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


def _cmyk_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(img).convert("CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def _as_ycck(data: bytes) -> bytes:
    """PIL's CMYK file with its Adobe transform byte set to 2: the same
    samples read as YCCK (PIL has no YCCK encoder)."""
    i = data.index(b"Adobe")
    return data[:i + 11] + b"\x02" + data[i + 12:]


def test_refusals_name_the_format():
    """Progressive and CMYK files decode as PIL decodes them (they were
    refused before); arithmetic coding (SOF9), a truncated progressive
    file and corrupt data are refused with their names."""
    img = _photo(16, 16, 3, seed=1)
    prog = _pil_jpeg(img, progressive=True)
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog), _pil_decode(prog))
    np.testing.assert_array_equal(image_lib.decode_image(prog, "x.jpg"),
                                  _pil_decode(prog))
    cmyk = _cmyk_jpeg(img)
    np.testing.assert_array_equal(jpeg.decode_jpeg(cmyk), _pil_decode(cmyk))
    base = _pil_jpeg(img)
    sof = base.index(b"\xff\xc0")
    with pytest.raises(ValueError, match=r"arithmetic-coded JPEG \(SOF9\)"):
        jpeg.decode_jpeg(base[:sof + 1] + b"\xc9" + base[sof + 2:])
    big = _pil_jpeg(_photo(64, 64, 3, seed=2), progressive=True)
    with pytest.raises(ValueError, match="truncated progressive JPEG"):
        jpeg.decode_jpeg(big[:len(big) // 2])
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xe0 jpeg")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_lib.decode_image(b"GIF89a", "x.gif")


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 53), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_progressive_matches_pil(size, subsampling):
    """SOF2 files: DC and AC first and refine scans, end-of-band runs,
    restart markers and optimized tables, colour and gray."""
    img = _photo(*size, 3, seed=sum(size) + subsampling)
    for quality in (50, 95):
        for kw in ({}, {"restart_marker_blocks": 1}, {"optimize": True}):
            data = _pil_jpeg(img, quality=quality, subsampling=subsampling,
                             progressive=True, **kw)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                          _pil_decode(data), err_msg=str(kw))
    gray = _pil_jpeg(_photo(*size, 1, seed=7), quality=80, progressive=True)
    np.testing.assert_array_equal(image_lib.to_rgb(jpeg.decode_jpeg(gray)),
                                  _pil_decode(gray))


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _huffman(symbols) -> tuple:
    """Equal-length codes for ``symbols`` (none all ones): the DHT body's
    counts and symbols, and symbol -> (code, length)."""
    syms = sorted(set(symbols))
    n = len(syms).bit_length()
    counts = bytearray(16)
    counts[n - 1] = len(syms)
    return bytes(counts) + bytes(syms), {s: (i, n) for i, s in
                                         enumerate(syms)}


def _partial_progressive(zz, qtable, script) -> bytes:
    """A progressive JPEG with first scans only, one component each:
    ``zz`` [components, blocks, 64] quantized coefficients in zigzag order
    (4:4:4, 8 x (8 * blocks)), ``script`` (component, Ss, Se, Al) scans.
    Bands a script leaves out are never sent, and none is refined."""
    ncomp, nblocks = zz.shape[:2]
    scans = []
    for ci, ss, se, al in script:
        syms, pred = [], 0
        for blk in zz[ci].tolist():
            if ss == 0:
                v = blk[0] >> al
                d, pred = v - pred, v
                s = abs(d).bit_length()
                syms.append((s, (d if d >= 0 else d - 1) & ((1 << s) - 1), s))
                continue
            run = 0
            for c in blk[ss:se + 1]:
                m = abs(c) >> al
                if m == 0:
                    run += 1
                    continue
                while run > 15:
                    syms.append((0xF0, 0, 0))
                    run -= 16
                s = m.bit_length()
                syms.append(((run << 4) | s,
                             (m if c > 0 else ~m) & ((1 << s) - 1), s))
                run = 0
            if run:
                syms.append((0x00, 0, 0))            # EOB, a run of one
        scans.append(((ci, ss, se, al), syms))
    tables = {ac: _huffman(s for (_, ss, _, _), syms in scans
                           if (ss > 0) == ac for s, _, _ in syms)
              for ac in (False, True)}
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                  b"\x00\x01\x00\x00")
    out += _segment(0xDB, b"\x00" + bytes(qtable.tolist()))
    out += _segment(0xC2, bytes([8]) + (8).to_bytes(2, "big")
                    + (8 * nblocks).to_bytes(2, "big") + bytes([ncomp])
                    + b"".join(bytes([ci + 1, 0x11, 0])
                               for ci in range(ncomp)))
    out += b"".join(_segment(0xC4, bytes([ac << 4]) + tables[ac][0])
                    for ac in (False, True))
    for (ci, ss, se, al), syms in scans:
        codes = tables[ss > 0][1]
        bits = "".join(format(codes[s][0], f"0{codes[s][1]}b")
                       + (format(x, f"0{n}b") if n else "")
                       for s, x, n in syms)
        bits += "1" * (-len(bits) % 8)
        data = int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""
        out += _segment(0xDA, bytes([1, ci + 1, 0x00, ss, se, al]))
        out += data.replace(b"\xff", b"\xff\x00")
    return out + b"\xff\xd9"


PARTIAL_SCRIPTS = {
    # the first ten coefficients exact, 10-63 never sent
    "bands_1_9": [(0, 0, 0), (1, 9, 0)],
    # and 10-63 sent without their last bit
    "coarse_10_63": [(0, 0, 0), (1, 9, 0), (10, 63, 1)],
    # the DC without its last bit, 1-9 exact
    "coarse_dc": [(0, 0, 1), (1, 9, 0), (10, 63, 0)],
}


@pytest.mark.parametrize("ncomp", [1, 3])
@pytest.mark.parametrize("script", list(PARTIAL_SCRIPTS))
def test_partial_progressive_scripts_match_pil(ncomp, script):
    """A complete progressive file whose scan script leaves bands 10-63 or
    the last DC bit unsent or unrefined decodes plainly, as libjpeg does
    (its block smoothing looks at coefficients 0-9 only); when 1-9 are not
    exact, libjpeg smooths and the file is refused."""
    rng = np.random.default_rng(len(script) + ncomp)
    nblocks = 7
    zz = np.round(rng.normal(0, 1, (ncomp, nblocks, 64))
                  * (60 / (1 + np.arange(64)))).astype(np.int64)
    zz[..., 0] = rng.integers(-300, 300, (ncomp, nblocks))
    qtable = 2 + np.arange(64) // 4
    scans = [(ci, *band) for band in PARTIAL_SCRIPTS[script]
             for ci in range(ncomp)]
    data = _partial_progressive(zz, qtable, scans)
    got = jpeg.decode_jpeg(data)
    assert got.shape == (8, 8 * nblocks, ncomp if ncomp == 1 else 3)
    np.testing.assert_array_equal(image_lib.to_rgb(got), _pil_decode(data))
    smoothed = [(ci, 0, 0, 0) for ci in range(ncomp)] + [
        (ci, 1, 9, 1 if ci == ncomp - 1 else 0) for ci in range(ncomp)]
    with pytest.raises(ValueError, match="truncated progressive JPEG"):
        jpeg.decode_jpeg(_partial_progressive(zz, qtable, smoothed))


@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck_match_pil(progressive):
    """4-component Adobe files as PIL's ``convert("RGB")``: CMYK
    (transform 0) and YCCK (transform 2), sequential and progressive."""
    for h, w in ((1, 1), (7, 13), (37, 53)):
        data = _cmyk_jpeg(_photo(h, w, 3, seed=h + w), quality=85,
                          progressive=progressive)
        for d in (data, _as_ycck(data)):
            got = jpeg.decode_jpeg(d)
            assert got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, _pil_decode(d))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_match_their_pil_decode(name):
    data = (DATA / f"{name}.jpg").read_bytes()
    want = image_lib.read_png(str(DATA / f"{name}.png"))
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_lib.to_rgb(got), _pil_decode(data))
    if name.endswith("_1024_420"):
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
    smooth = np.clip(smooth + 128, 0, 255).astype(np.uint8)
    return {
        "small_444": (_photo(37, 53, 3, seed=11),
                      dict(quality=95, subsampling=0)),
        "gray": (_photo(48, 64, 1, seed=12), dict(quality=75)),
        "smooth_1024_420": (smooth, dict(quality=90, subsampling=2)),
        "progressive_1024_420": (smooth, dict(quality=90, subsampling=2,
                                              progressive=True)),
        "progressive_444_rst": (_photo(37, 53, 3, seed=13),
                                dict(quality=95, subsampling=0,
                                     progressive=True,
                                     restart_marker_blocks=3)),
        "cmyk": (_photo(40, 56, 3, seed=14), dict(quality=90, cmyk=True)),
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
        data = (_cmyk_jpeg(img, **kw) if kw.pop("cmyk", False)
                else _pil_jpeg(img, **kw))
        (DATA / f"{name}.jpg").write_bytes(data)
        decoded = PIL.Image.open(io.BytesIO(data))
        decoded = np.asarray(decoded.convert("RGB") if decoded.mode == "CMYK"
                             else decoded)
        if decoded.ndim == 2:
            decoded = decoded[:, :, None]
        (DATA / f"{name}.png").write_bytes(_png_up(decoded))


if __name__ == "__main__" and sys.argv[1:] == ["regenerate"]:
    regenerate()
