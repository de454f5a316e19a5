"""The port's bench (``python -m omg_tpu_torch.bench``) and detector
validation tool (``omg_tpu_torch/tools/validate_detector.py``) on the
CPU at the tiny size: the contract of ``tests/test_bench_smoke.py`` case
for case (one JSON line per mode); latency and throughput latents against
JAX's stage functions on the same ``build_workload`` arrays (5e-4 on
latents, 1/255 on images, fp32, as ``tests/test_golden.py``), square and
non-square; live drift only, ``tools/drift_measured.json`` untouched; the
refusals; and the validator's skip path, ``validate_image`` against the
JAX tool's on the stub detector, and ``main`` on tiny seeded files."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.control import p2p as jp2p
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu.segment.detector import OpenVocabDetector as JDetector
from omg_tpu.segment.detector import Proposal as JProposal
from omg_tpu_torch import bench, config, convert
from omg_tpu_torch.models import clip, clip_vision
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.segment import sam_provider, vit_sam
from omg_tpu_torch.segment.detector import OpenVocabDetector, Proposal
from omg_tpu_torch.tools import validate_detector
from omg_tpu_torch.utils import image as image_io
from tools import validate_detector as jvalidate

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (TOKENIZER_CORPUS, learn_merges, tiny_sdxl,
                                write_clip_tokenizer)

ROOT = pathlib.Path(__file__).resolve().parents[2]
LATENT_ATOL = 5e-4
IMAGE_ATOL = 1 / 255
STEPS = 4
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _run_bench(monkeypatch, capsys, env: dict) -> dict:
    """``bench.main`` at the tiny size, 4 steps, one rep, on the CPU:
    exactly one JSON line on stdout with the contract fields."""
    values = {"OMG_BENCH_SIZE": "tiny", "OMG_BENCH_STEPS": str(STEPS),
              "OMG_BENCH_REPS": "1"}
    for key, value in dict(values, **env).items():
        monkeypatch.setenv(key, value)
    rec, _ = bench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    printed = json.loads(lines[0])
    assert RECORD_KEYS <= set(printed)
    assert printed == json.loads(json.dumps(rec))
    assert rec["value"] > 0
    return rec


# ---------------------------------------------------------------- (a)

def test_bench_latency_mode(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {})
    assert rec["unit"] == "s"
    assert rec["metric"] == "omg_2concept_32x32_4step_e2e_latency"
    ex = rec["extra"]
    assert ex["stage1_s"] > 0 and ex["stage2_s"] > 0 and ex["vae_s"] > 0
    assert ex["concept_crop"] == "none"
    # the CPU takes the plain attention: no kernel launch, no peak
    assert (ex["backend"], ex["device"], ex["k1_launches"],
            ex["k1b_launches"], ex["peak_gib"]) == ("cpu", "cpu", 0, 0, None)
    assert ex["flash"] is True


def test_bench_crop_mode(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_CROP": "strips"})
    assert rec["extra"]["concept_crop"] == "strips"


def test_bench_lcm_mode(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_SCHED": "lcm"})
    assert rec["extra"]["scheduler"] == "lcm"


def test_bench_throughput_mode(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_MODE": "throughput",
                                           "OMG_BENCH_REQUESTS": "3",
                                           "OMG_BENCH_CHUNK": "2"})
    assert rec["unit"] == "images/min/chip"
    # R rounded up to a chunk multiple; rate reported over actual count
    assert rec["extra"]["requests"] == 4
    assert rec["extra"]["chunk"] == 2


# ---------------------------------------------------------------- (b), (c)

def _jax_lora(flat: dict) -> dict:
    """The port's flat LoRA (numpy) -> the JAX package's nested tree."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key.replace("to_out.0", "to_out").split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(int(p) if p.isdigit() else p, {})
        node[parts[-1]] = {k: jnp.asarray(v) for k, v in leaf.items()}
    return tree


def _jax_workload(work: dict, height: int, width: int) -> dict:
    """``build_workload``'s arrays as the JAX bench builds its inputs."""
    ep, pp, en, pn = (jnp.asarray(work[k]) for k in (
        "embeds_pos", "pooled_pos", "embeds_neg", "pooled_neg"))
    tids = jsdxl.add_time_ids((height, width), (0, 0), (height, width))
    return {"base": jmc.make_base_inputs(ep, pp, en, pn, tids, 7.5),
            "concept": jmc.make_concept_inputs(ep, pp, en, pn, tids),
            "ctl": jp2p.P2PControl.build(
                ["x", "x"], num_steps=STEPS, self_replace_steps=0.4,
                width=width // 32, height=height // 32),
            "loras": [_jax_lora(t) for t in work["loras"]],
            "masks": jnp.asarray(work["masks"])}


@pytest.fixture(scope="module")
def weights():
    return tiny_sdxl(seed=3)


@pytest.mark.parametrize("height,width", [(32, 32), (64, 32)])
def test_latency_matches_jax(weights, height, width):
    """``latency``'s stage-2 latents and copy B's image against JAX's
    ``sample_stage1_cached(initial_noise=...)``, ``sample_stage2_resumed``
    and ``decode_latents`` on the same arrays."""
    jparams, params = weights
    cfg = sdxl.tiny_config()
    work = bench.build_workload(cfg, height, width, STEPS)
    knobs = bench.Knobs(size="tiny", steps=STEPS, reps=1, drift=("none",))
    with torch.inference_mode():
        rec, lat2 = bench.latency(cfg, params, work, knobs, "cpu", height,
                                  width)
        img = sdxl.decode_latents(cfg, params.vae, lat2)
    assert rec["metric"] == (f"omg_2concept_{height}x{width}_{STEPS}step_"
                             "e2e_latency")
    jcfg, jw = jsdxl.tiny_config(), _jax_workload(work, height, width)
    sched = jsched.make_schedule("euler", STEPS)
    fusion = work["fusion_start"]
    _, cache = jmc.sample_stage1_cached(
        jcfg, sched, jparams.unet, key=jax.random.PRNGKey(5), height=height,
        width=width, base_inputs=jw["base"], fusion_start=fusion,
        initial_noise=work["noise"][:1])
    want = jmc.sample_stage2_resumed(
        jcfg, sched, jparams.unet, cache, base_inputs=jw["base"],
        controller=jw["ctl"], concept_inputs=[jw["concept"]] * 2,
        concept_loras=jw["loras"], masks=jw["masks"], fusion_start=fusion)
    np.testing.assert_allclose(lat2.numpy(), np.asarray(want),
                               atol=LATENT_ATOL)
    want_img = jsdxl.decode_latents(jcfg, jparams.vae, want)
    assert img.shape == (2, height, width, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img),
                               atol=IMAGE_ATOL)


def test_throughput_matches_jax_per_request(weights):
    """Two requests in one chunk (one batched program): each request's
    stage-2 latents against JAX's ``two_stage_latents`` of it alone."""
    jparams, params = weights
    cfg = sdxl.tiny_config()
    work = bench.build_workload(cfg, 32, 32, STEPS, requests=2)
    knobs = bench.Knobs(size="tiny", steps=STEPS, reps=1, mode="throughput",
                        requests=2, chunk=2)
    with torch.inference_mode():
        rec, lat2 = bench.throughput(cfg, params, work, knobs, "cpu", 32, 32)
    assert (rec["extra"]["requests"], rec["extra"]["chunk"]) == (2, 2)
    assert lat2.shape == (2, 2, 4, 4, 4)
    jcfg, jw = jsdxl.tiny_config(), _jax_workload(work, 32, 32)
    sched = jsched.make_schedule("euler", STEPS)
    for r in range(2):
        _, want = jmc.two_stage_latents(
            jcfg, sched, jparams.unet,
            jsched.scale_initial_noise(sched,
                                       jnp.asarray(work["noise"][r:r + 1])),
            jw["base"], jw["ctl"], (jw["concept"], jw["concept"]),
            tuple(jw["loras"]), jw["masks"],
            fusion_start=work["fusion_start"])
        np.testing.assert_allclose(lat2[r].numpy(), np.asarray(want),
                                   atol=LATENT_ATOL)
    # the two requests drew different noise
    assert float((lat2[0] - lat2[1]).abs().max()) > 1e-2


def test_workload_is_the_benchs():
    """bench.py's workload: [1, 77, 2048] and [1, 1280] embeddings, rank-32
    LoRAs on the mid block's 10 transformer blocks (8 projections each,
    scale 0.8, std 0.01), the left/right masks, the fusion gate scaling
    with the steps, and the same arrays from the same seed."""
    cfg = sdxl.sdxl_config()
    work = bench.build_workload(cfg, 1216, 832, 50, requests=2)
    assert work["embeds_pos"].shape == work["embeds_neg"].shape == \
        (1, 77, 2048)
    assert work["pooled_pos"].shape == (1, 1280)
    assert work["noise"].shape == (2, 152, 104, 4)
    assert work["fusion_start"] == 15
    assert bench.build_workload(cfg, 64, 64, 10)["fusion_start"] == 3
    masks = work["masks"]
    assert masks.shape == (2, 152, 104)
    assert masks[0, :, :52].all() and not masks[0, :, 52:].any()
    np.testing.assert_array_equal(masks[0] + masks[1], 1.0)
    for tree in work["loras"]:
        assert len(tree) == 10 * 8
        leaf = tree["mid_block.attentions.0.transformer_blocks.9.attn2.to_k"]
        assert (leaf["down"].shape, leaf["up"].shape) == ((2048, 32),
                                                          (32, 1280))
        assert leaf["scale"] == np.float32(0.8)
        assert 0.009 < float(leaf["down"].std()) < 0.011
    a, b = work["loras"]
    key = "mid_block.attentions.0.transformer_blocks.0.attn1.to_q"
    assert not np.array_equal(a[key]["down"], b[key]["down"])
    again = bench.build_workload(cfg, 1216, 832, 50, requests=2)
    np.testing.assert_array_equal(again["noise"], work["noise"])
    np.testing.assert_array_equal(again["loras"][1][key]["up"],
                                  b[key]["up"])


# ---------------------------------------------------------------- (d)

def test_drift_is_live_only(monkeypatch, capsys):
    """Every drift mode measured live against the exact run, with its
    interval and kind; nothing read from or written to the TPU's
    ``tools/drift_measured.json``."""
    path = ROOT / "tools" / "drift_measured.json"
    before = path.read_bytes()
    rec = _run_bench(monkeypatch, capsys, {
        "OMG_BENCH_DRIFT": "crop,int8,deepcache,deepcache_front",
        "OMG_BENCH_STEPS": "8"})
    ex = rec["extra"]
    for name in ("crop", "int8", "deepcache", "deepcache_front"):
        d = ex[f"{name}_drift"]
        assert d["measured"] == "live", (name, d)
        assert d["stage2_latent_mae"] > 0 and np.isfinite(d["pixel_psnr_db"])
    assert ex["deepcache_drift"]["interval"] == 3
    assert (ex["deepcache_front_drift"]["interval"],
            ex["deepcache_front_drift"]["kind"]) == (3, "front")
    assert path.read_bytes() == before


def test_drift_none_and_approximate_runs_report_null(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_DRIFT": "none"})
    assert all(rec["extra"][f"{n}_drift"] is None for n in
               ("crop", "int8", "deepcache", "deepcache_front"))
    # an approximate run measures no drift (there is no exact run)
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_DEEPCACHE": "2",
                                           "OMG_BENCH_DEEPCACHE_KIND":
                                           "front"})
    ex = rec["extra"]
    assert (ex["deepcache_interval"], ex["deepcache_kind"],
            ex["crop_drift"]) == (2, "front", None)


def test_no_flash_and_int8_and_bf16_vae(monkeypatch, capsys):
    rec = _run_bench(monkeypatch, capsys, {"OMG_BENCH_NO_FLASH": "1",
                                           "OMG_BENCH_QUANT": "int8",
                                           "OMG_BENCH_VAE": "bf16",
                                           "OMG_BENCH_DRIFT": "none"})
    ex = rec["extra"]
    assert (ex["flash"], ex["k1_launches"], ex["quant"], ex["vae_dtype"]) \
        == (False, 0, "int8", "bf16")
    # the gate is restored after the run
    from omg_tpu_torch.ops import flash_attention as fa
    assert fa.use_flash(4096, 4096, 64, "cuda") is True


def test_refusals(monkeypatch):
    monkeypatch.setenv("OMG_BENCH_SIZE", "tiny")
    monkeypatch.setenv("OMG_BENCH_PACKED", "1")
    with pytest.raises(ValueError, match="PACKED"):
        bench.main(["--device", "cpu"])
    monkeypatch.delenv("OMG_BENCH_PACKED")
    for key, value in (("OMG_BENCH_SCHED", "heun"),
                       ("OMG_BENCH_DRIFT", "crop,fp8"),
                       ("OMG_BENCH_MODE", "serve")):
        with monkeypatch.context() as m:
            m.setenv(key, value)
            with pytest.raises(ValueError, match=key):
                bench.main(["--device", "cpu"])
    # the strips have no batched program: named, not looped per request
    monkeypatch.setenv("OMG_BENCH_MODE", "throughput")
    monkeypatch.setenv("OMG_BENCH_CROP", "strips")
    with pytest.raises(ValueError, match="sample_stage2_batch"):
        bench.main(["--device", "cpu"])


def test_no_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    monkeypatch.setenv("OMG_BENCH_SIZE", "tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


# ---------------------------------------------------------------- (e)

def test_validate_detector_skips_cleanly_without_checkpoints(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "omg_tpu_torch.tools.validate_detector",
         "--sam_checkpoint", str(tmp_path / "missing.pt")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("SKIP")


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
             "green": [-0.5, 1.0, -0.5]}
    out = np.asarray([table[t] for t in texts], np.float32)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _blob_proposals(proposal_cls):
    def proposals(image):
        out = []
        for x0, x1 in ((8, 40), (56, 88)):
            m = np.zeros(image.shape[:2], bool)
            m[16:48, x0:x1] = True
            out.append(proposal_cls(m, np.array([x0, 16, x1, 48],
                                                np.float32), 0.9))
        return out
    return proposals


def test_validate_image_matches_jax_tool():
    """The stub detector of ``tests/test_detector.py`` in both packages:
    the port's record equals the JAX tool's, and the sweep's state is
    restored."""
    img = _two_blob_image()
    classes, sweep = ["red", "blue", "green"], [0.1, 0.3, 0.99]
    dets = [cls(_blob_proposals(prop), _color_embed_image,
                _color_embed_texts, sim_thresh=0.3, crop_size=16)
            for cls, prop in ((OpenVocabDetector, Proposal),
                              (JDetector, JProposal))]
    got = validate_detector.validate_image(dets[0], img, classes, sweep)
    want = jvalidate.validate_image(dets[1], img, classes, sweep)
    assert got == want
    assert got["n_proposals"] == 2 and got["per_class"]["green"] is None
    assert got["sim_thresh_sweep"]["0.99"]["red"] is False
    assert got["sim_thresh_sweep"]["0.1"]["red"] is True
    assert dets[0].sim_thresh == 0.3 and dets[0]._assigned == {}


VISION = config.tiny_clip_vision()
TEXT = config.tiny_text_encoder(projection_dim=VISION.projection_dim)


def test_validate_detector_main_on_seeded_files(tmp_path, monkeypatch,
                                                capsys):
    """``main`` on a tiny SAM ViT file, a CLIPModel-layout file of
    both tiny towers, a CLIP tokenizer folder, a PNG and a JPEG: the
    report holds every image's record, the hit rates and the composite
    evaluation; the printed summary names the report."""
    sam_path = tmp_path / "sam_vit_b.pth"
    sam = sam_provider.init_sam(
        torch.Generator().manual_seed(9), dataclasses.replace(
            vit_sam.tiny_config(), out_chans=256), "cpu")
    torch.save(sam.state_dict(), sam_path)
    g = torch.Generator().manual_seed(10)
    towers = {**clip_vision.init_params(g, VISION, "cpu").state_dict(),
              **clip.init_params(g, TEXT, "cpu").state_dict()}
    clip_path = tmp_path / "clip.safetensors"
    convert.save_safetensors(str(clip_path), towers)
    tok_dir = tmp_path / "tokenizer"
    write_clip_tokenizer(str(tok_dir), learn_merges(TOKENIZER_CORPUS, 120))
    photo = np.random.default_rng(11).integers(0, 256, (48, 64, 3), np.uint8)
    image_io.write_png(str(tmp_path / "photo.png"), photo)
    jpeg = ROOT / "tests" / "port" / "data" / "small_444.jpg"
    monkeypatch.setattr(config, "clip_vit_b32_vision", lambda: VISION)
    monkeypatch.setattr(config, "clip_vit_b32_text", lambda: TEXT)
    out = tmp_path / "report.json"
    rc = validate_detector.main([
        "--sam_checkpoint", str(sam_path), "--clip_checkpoint",
        str(clip_path), "--tokenizer_dir", str(tok_dir), "--images",
        f"{tmp_path / 'photo.png'},{jpeg}", "--grid", "3", "--sweep",
        "0.0,0.5", "--composites", "2", "--out", str(out), "--device",
        "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    # the composite evaluation's summary, then the run's
    summary = json.loads(printed[printed.rindex("\n{\n") + 1:])
    assert summary["images"] == 2 and summary["out"] == str(out)
    report = json.loads(out.read_text())
    assert set(report["images"]) == {"photo.png", "small_444.jpg"}
    rec = report["images"]["photo.png"]
    assert rec["size"] == [48, 64]
    assert set(rec["per_class"]) == {"man", "woman"}
    assert set(rec["sim_thresh_sweep"]) == {"0.0", "0.5"}
    assert report["images"]["small_444.jpg"]["size"] == list(
        image_io.read_rgb(str(jpeg)).shape[:2])
    assert set(report["hit_rate_by_sim_thresh"]) == {"0.0", "0.5"}
    assert report["hit_rate_by_sim_thresh"]["0.0"]["man"].endswith("/2")
    assert report["overlap_violations"] == 0
    assert report["composite_eval"]["n_cases"] == 2
    assert report["config"]["device"] == "cpu"
    assert summary["hit_rate_by_sim_thresh"] == \
        report["hit_rate_by_sim_thresh"]
