"""The port's mask stage against the JAX package on a tiny SAM: the
predictor (PIL-style preprocessing within one uint8 level, masks within
0.1% of the pixels, IoU scores at atol 1e-4), the provider's cache, the
grid proposer, the open-vocabulary detector, the synthetic eval, the
provider factory, and ``OMG.generate`` taking its masks from SAM."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.models import clip as jclip
from omg_tpu.models import clip_vision as jcv
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu.segment import detector as jdet
from omg_tpu.segment import detector_eval as jeval
from omg_tpu.segment import efficientvit as jevit
from omg_tpu.segment import sam_provider as jsp
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.models import clip
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.segment import build_mask_provider
from omg_tpu_torch.segment import detector as det
from omg_tpu_torch.segment import detector_eval
from omg_tpu_torch.segment import efficientvit as evit
from omg_tpu_torch.segment import sam_provider as sp
from omg_tpu_torch.text.tokenizer import ToyTokenizer

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import numpy_params, sam_numpy, t, tiny_sdxl, to_jax

MASK_FRAC = 1e-3        # masks may differ in at most 0.1% of the pixels
IOU_ATOL = 1e-4
SHAPES = [(64, 64), (48, 64), (80, 56)]


def _image(shape, seed=0):
    return (np.random.default_rng(seed).random(shape + (3,)) * 255).astype(
        np.uint8)


def _mask_diff(a, b) -> float:
    assert a.shape == b.shape
    return float(np.mean(np.asarray(a, bool) != np.asarray(b, bool)))


@pytest.fixture(scope="module")
def sams():
    """(JAX params, JAX cfg, port Sam) with the same weights: the tiny
    EfficientViT encoder with a 256-wide embedding (the decoder's)."""
    jcfg = dataclasses.replace(jevit.tiny_config(), neck_out_dim=256)
    tree = sam_numpy(jevit.init_params, jcfg, seed=21)
    cfg = dataclasses.replace(evit.tiny_config(), neck_out_dim=256)
    return to_jax(tree), jcfg, from_jax.sam_from_jax(tree, cfg=cfg,
                                                     device="cpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_preprocess_within_one_level_of_pil(sams, shape):
    jp, jcfg, sam = sams
    jpred, pred = jsp.SamPredictor(jp, jcfg), sp.SamPredictor(sam)
    img = _image(shape, 1)
    want = jpred._preprocess(img)
    got = pred._preprocess(img)[0].numpy()
    assert pred._input_size == jpred._input_size
    nh, nw = pred._input_size
    std, mean = np.array(sp._STD), np.array(sp._MEAN)
    levels = [np.round(x[:nh, :nw] * std + mean) for x in (got, want)]
    assert np.abs(levels[0] - levels[1]).max() <= 1
    assert not got[nh:].any() and not got[:, nw:].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_predict_box_matches_jax(sams, shape):
    """set_image, then predict_box on the JAX predictor's embedding: where
    the image is resized, PIL and torch may differ by a uint8 level in the
    encoder's input, which the encoder tests do not cover."""
    jp, jcfg, sam = sams
    jpred, pred = jsp.SamPredictor(jp, jcfg), sp.SamPredictor(sam)
    img = _image(shape, 2)
    jpred.set_image(img)
    pred.set_image(img)
    jemb = np.asarray(jpred._embedding)
    if max(shape) == jcfg.image_size:           # no resize: the same input
        np.testing.assert_allclose(pred._embedding.numpy(), jemb, atol=1e-4)
    pred._embedding = t(jemb)
    h, w = shape
    for box in (np.array([0, 0, w, h], np.float32),
                np.array([5, 3, w * 0.6, h - 4], np.float32)):
        want_m, want_iou = jpred.predict_box(box)
        got_m, got_iou = pred.predict_box(box)
        assert got_m.shape == (h, w) and got_m.dtype == bool
        assert _mask_diff(got_m, want_m) <= MASK_FRAC
        assert abs(got_iou - want_iou) <= IOU_ATOL


def test_provider_caches_the_embedding_by_content(sams):
    jp, jcfg, sam = sams
    provider = sp.SamMaskProvider(sam=sam, device="cpu")
    calls = []
    set_image = provider.predictor.set_image
    provider.predictor.set_image = lambda im: (calls.append(1),
                                               set_image(im))
    img = _image((48, 64), 3)
    masks = provider.masks_for(img, ["man", "woman"])
    again = provider(img.copy(), "man")         # same content, new object
    assert len(calls) == 1
    np.testing.assert_array_equal(again, masks[0])
    provider(_image((48, 64), 4), "man")
    assert len(calls) == 2
    want = jsp.SamMaskProvider(params=jp, cfg=jcfg).masks_for(
        img, ["man", "woman"])
    for g, w in zip(masks, want):
        assert g.dtype == np.float32
        assert _mask_diff(g, w) <= MASK_FRAC


def test_sam_provider_needs_modules(sams, tmp_path):
    """Without modules the provider reads them from the checkpoint file;
    a missing file raises."""
    with pytest.raises(FileNotFoundError):
        sp.SamMaskProvider(str(tmp_path / "sam_vit_h_4b8939.pth"),
                           device="cpu")
    _, _, sam = sams
    torch.save(sam.state_dict(), tmp_path / "xl1.pt")
    loaded = sp.SamMaskProvider(str(tmp_path / "xl1.pt"),
                                cfg=sam.image_encoder.cfg, device="cpu")
    want = sam.state_dict()
    for k, v in loaded.predictor.sam.state_dict().items():
        assert torch.equal(v, want[k]), k


PROPOSER = dict(iou_thresh=-10.0, min_area_frac=0.0, max_area_frac=1.0,
                max_proposals=4, nms_thresh=0.9)


def test_grid_proposer_matches_jax(sams):
    jp, jcfg, sam = sams
    img = _image((48, 64), 5)
    want = jdet.SamGridProposer(jsp.SamPredictor(jp, jcfg), grid=3,
                                **PROPOSER)(img)
    got = det.SamGridProposer(sp.SamPredictor(sam), grid=3, **PROPOSER)(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.box, w.box)
        assert _mask_diff(g.mask, w.mask) <= MASK_FRAC
        assert abs(g.score - w.score) <= IOU_ATOL


# -- the detector with tests/test_detector.py's weight-free stand-ins ----

def _two_blob_image(h=64, w=96):
    img = np.full((h, w, 3), 255, np.uint8)
    img[16:48, 8:40] = (220, 30, 30)      # red, left
    img[16:48, 56:88] = (30, 30, 220)     # blue, right
    return img


def _color_embed_image(crops):
    e = crops.reshape(crops.shape[0], -1, 3).mean(axis=1).astype(np.float32)
    e = e / 255.0 - 0.5
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _color_embed_texts(texts):
    table = {"red": [1.0, -0.5, -0.5], "blue": [-0.5, -0.5, 1.0],
             "green": [-0.5, 1.0, -0.5], "purple": [0.7, -0.6, 0.7]}
    out = np.asarray([table[t] for t in texts], np.float32)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _proposals(proposal_cls):
    """Both blobs, a box spanning both (non-square crop) and a thin strip
    at the edge (a clipped crop)."""
    def fn(image):
        out = []
        for x0, y0, x1, y1 in ((8, 16, 40, 48), (56, 16, 88, 48),
                               (4, 10, 92, 50), (0, 58, 96, 64)):
            m = np.zeros(image.shape[:2], bool)
            m[y0:y1, x0:x1] = True
            out.append(proposal_cls(m, np.array([x0, y0, x1, y1],
                                                np.float32), 0.9))
        return out
    return fn


@pytest.mark.parametrize("queries", [("red", "blue", "green"),
                                     ("blue", "purple", "red"),
                                     ("purple", "red")])
def test_open_vocab_detector_matches_jax(queries):
    img = _two_blob_image()
    dets = [cls(_proposals(proposal), _color_embed_image, _color_embed_texts,
                sim_thresh=0.3, crop_size=16)
            for cls, proposal in ((jdet.OpenVocabDetector, jdet.Proposal),
                                  (det.OpenVocabDetector, det.Proposal))]
    seq = [[d(img, q) for q in queries] for d in dets]
    for g, w in zip(seq[1], seq[0]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    fresh = [cls(_proposals(proposal), _color_embed_image,
                 _color_embed_texts, sim_thresh=0.3, crop_size=16)
             for cls, proposal in ((jdet.OpenVocabDetector, jdet.Proposal),
                                   (det.OpenVocabDetector, det.Proposal))]
    joint = [d.masks_for(img, list(queries)) for d in fresh]
    for g, w in zip(joint[1], joint[0]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_run_ci_eval_matches_jax():
    got = detector_eval.run_ci_eval(n_cases=6, seed=0)
    want = jeval.run_ci_eval(n_cases=6, seed=0)
    assert got == want


# -- the SAM x CLIP detector through build_mask_provider -----------------

VISION = dict(image_size=32, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4,
              projection_dim=16)
TEXT = dict(vocab_size=1000, hidden_size=16, intermediate_size=32,
            num_layers=2, num_heads=2, projection_dim=16)


def test_build_mask_provider_kinds(sams):
    _, _, sam = sams
    assert build_mask_provider("none") is None
    ext = object()
    assert build_mask_provider("external", external=ext) is ext
    with pytest.raises(ValueError, match="unknown segment kind"):
        build_mask_provider("maskrcnn", sam=sam, device="cpu")
    with pytest.raises(FileNotFoundError):
        build_mask_provider("sam", sam_checkpoint="no/such/xl1.pt",
                            device="cpu")
    with pytest.raises(ValueError, match="needs `sam=`"):
        build_mask_provider("sam", device="cpu")
    provider = build_mask_provider("yoloworld", sam=sam, device="cpu")
    assert provider.box_provider is sp.full_image_box


def test_provider_defaults_to_the_card(sams, monkeypatch):
    _, _, sam = sams
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mask_provider("sam", sam=sam)


def test_sam_clip_detector_matches_jax(sams):
    jp, jcfg, sam = sams
    jvcfg = jconfig.CLIPVisionConfig(**VISION)
    jtcfg = jconfig.CLIPTextConfig(**TEXT, dtype=jnp.float32)
    vtree = numpy_params(jcv.init_params, jvcfg, seed=31)
    ttree = numpy_params(jclip.init_params, jtcfg, seed=32)
    tok = ToyTokenizer(1000)
    det_kw = dict(sim_thresh=-1.0, overlap_thresh=0.5)
    jdetector = jdet.build_openvocab_detector(
        jp, sam_cfg=jcfg, clip_vision_params=to_jax(vtree),
        clip_vision_cfg=jvcfg, clip_text_params=to_jax(ttree),
        clip_text_cfg=jtcfg, tokenizer=tok, grid=3,
        proposer_kwargs=PROPOSER, **det_kw)
    vision = from_jax.clip_vision_from_jax(
        vtree, config.CLIPVisionConfig(**VISION), device="cpu")
    text = from_jax.load_into(clip.CLIPTextModel(config.CLIPTextConfig(
        **TEXT, dtype=torch.float32)), ttree)
    provider = build_mask_provider("openvocab", sam=sam, clip_vision=vision,
                                   clip_text=text, tokenizer=tok,
                                   device="cpu")
    pdet = provider.box_provider
    assert isinstance(pdet, det.OpenVocabDetector)
    # the factory's detector, re-made with the test's thresholds
    detector = det.build_openvocab_detector(
        sam, clip_vision=vision, clip_text=text, tokenizer=tok, grid=3,
        proposer_kwargs=PROPOSER, **det_kw)
    img = _image((48, 64), 6)
    classes = ["man", "woman"]
    want = jdetector.masks_for(img, classes)
    got = detector.masks_for(img, classes)
    assert any(m is not None for m in want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _mask_diff(g, w) <= MASK_FRAC
    # crops within a uint8 level of PIL's
    np.testing.assert_allclose(detector._crop_embeds,
                               jdetector._crop_embeds, atol=1e-2)
    assert len(provider.masks_for(img, classes)) == 2


# -- OMG.generate with the SAM provider ----------------------------------

def test_generate_with_sam_masks_matches_jax(sams):
    """Tiny SDXL, 4 Euler steps, two concepts; the masks come from each
    package's SamMaskProvider (whole-image box) on the stage-1 image."""
    jp, jcfg, sam = sams
    jparams, tparams = tiny_sdxl(seed=10)
    tok = ToyTokenizer()
    common = dict(tokenizer=tok, tokenizer_2=tok, num_steps=4)
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jparams,
                    mask_provider=jsp.SamMaskProvider(params=jp, cfg=jcfg),
                    **common)
    teng = omg.OMG(cfg=sdxl.tiny_config(), params=tparams,
                   mask_provider=sp.SamMaskProvider(sam=sam, device="cpu"),
                   **common)
    kw = dict(negative_prompt="ugly", seed=14, height=64, width=64,
              prompt_rewrite="[photo of the man]-*-[ugly]|"
                             "[photo of the woman]-*-[blurry]",
              initial_noise=np.random.default_rng(15).standard_normal(
                  (1, 8, 8, 4)).astype(np.float32))
    prompt = "photo of the man and the woman at the beach"
    want = jeng.generate(prompt, **kw)
    got = teng.generate(prompt, **kw)
    assert len(got.masks) == 2 and all(m is not None for m in got.masks)
    for g, w in zip(got.masks, want.masks):
        assert _mask_diff(g, w) <= MASK_FRAC
    assert got.stage2 is not None and want.stage2 is not None
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
    assert got.timings["masks"] > 0
