"""The port's serving and fidelity tools (``omg_tpu_torch/tools``) at the
tiny size with ``--device cpu``: serve_bench and soak_bench run to their
records, the ceiling and stage-2 checks fire when they should, and the
fidelity harness's noise, metrics, self-check and skips agree with the JAX
harness (``tools/fidelity_harness.py``)."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from omg_tpu_torch.pipelines import omg
from omg_tpu_torch.serving.registry import Registry
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.tools import fidelity_harness, serve_bench, soak_bench
from tools import fidelity_harness as jharness

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import write_tiny_checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the keys of the JAX tool's printed record, and the port's additions
SERVE_KEYS = {"geometry", "steps", "requests", "max_batch", "reps",
              "warmup_single_s", "warmup_multi_s",
              "single_request_latency_s", "single_request_server_s",
              "multi_prompt_wall_s", "multi_prompt_img_per_min_chip",
              "concurrent_wall_s", "concurrent_img_per_min_chip",
              "mask_provider_calls", "bare_compute_ceiling_ipm",
              "engine_s", "http_over_engine", "ceiling_checked", "device",
              "power_limit", "k1"}
SOAK_KEYS = {"geometry", "steps", "reps", "warmup_s",
             "per_class_latency_s", "storm_vs_serial", "pair_vs_serial",
             "mixup_mean_diff",
             "device", "power_limit", "k1"}


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def tiny_serve(monkeypatch):
    for key, value in (("SIZE", "tiny"), ("R", "2"), ("CHUNK", "2"),
                       ("REPS", "2")):
        monkeypatch.setenv("OMG_SERVE_" + key, value)


def test_serve_bench_prints_its_record(tiny_serve, capsys, tmp_path):
    out = tmp_path / "serve.json"
    rec = serve_bench.main(["--device", "cpu", "--out", str(out)])
    printed = _last_json(capsys.readouterr().out)
    assert SERVE_KEYS <= set(printed)
    assert json.loads(out.read_text())["metrics"] == rec["metrics"]
    assert (printed["geometry"], printed["requests"], printed["device"]) == \
        ("32x32", 2, "cpu")
    # warm-up single and pair, then per rep the ceiling pair, the single
    # request, the POSTed pair and two concurrent POSTs: two classes each
    assert rec["mask_provider_calls"] == 2 * (1 + 2 + 2 * (2 + 1 + 2 + 2))
    # the CPU takes the plain attention: no kernel launch
    assert all(part["launches"] == 0 for part in rec["k1"].values())
    # a tiny pass is too short for the 5% ceiling bound, and says so
    assert rec["engine_s"] < serve_bench.CEILING_MIN_S
    assert rec["ceiling_checked"] is False
    assert rec["metrics"].get("stage2_skipped", 0) == 0


def test_ceiling_check_fires(tiny_serve, monkeypatch):
    """With the engine's own pass made slow (a sleep in the tool's thread
    only), the HTTP rates out-run the ceiling and the tool fails."""
    batch = omg.OMG.generate_batch

    def slow(self, requests):
        if threading.current_thread() is threading.main_thread():
            time.sleep(serve_bench.CEILING_MIN_S)
        return batch(self, requests)

    monkeypatch.setattr(omg.OMG, "generate_batch", slow)
    with pytest.raises(AssertionError, match="exceeds the engine's"):
        serve_bench.main(["--device", "cpu"])


def test_check_stage2_fires_on_a_gate_miss():
    engine, side = serve_bench.engine_for(
        "test", "tiny", 2, "cpu", None, serve_bench.strip_provider({"n": 0}))
    client = serve_bench.Client(OMGServer(engine, Registry()))
    job = {"prompt": serve_bench.GATE_PROMPT, "seed": 1,
           "prompt_rewrite": serve_bench.REWRITE, "height": side,
           "width": side}
    try:
        hit = client.post(job)
        miss = client.post(dict(job, prompt=serve_bench.MISS_PROMPT))
    finally:
        client.close()
    assert serve_bench.check_stage2(hit) is hit
    with pytest.raises(AssertionError, match="stage 2 did not run"):
        serve_bench.check_stage2(miss)


def test_check_gate_fires_on_a_colliding_prompt(monkeypatch):
    engine, _ = serve_bench.engine_for(
        "test", "tiny", 2, "cpu", None, serve_bench.strip_provider({"n": 0}))
    serve_bench.check_gate(engine)
    monkeypatch.setattr(serve_bench, "MISS_PROMPT", "a man at the beach")
    with pytest.raises(AssertionError, match="the gate hits 'man'"):
        serve_bench.check_gate(engine)


def test_soak_bench_prints_its_record(monkeypatch, capsys):
    monkeypatch.setenv("OMG_SOAK_SIZE", "tiny")
    monkeypatch.setenv("OMG_SOAK_REPS", "2")
    rec = soak_bench.main(["--device", "cpu"])
    printed = _last_json(capsys.readouterr().out)
    assert SOAK_KEYS <= set(printed)
    assert set(rec["per_class_latency_s"]) == {"euler", "dc3front",
                                               "gate_miss"}
    assert rec["per_class_latency_s"]["euler"]["n"] == 4
    assert rec["metrics"]["stage2_skipped"] == 3
    # fp32 on the CPU: a storm image, and each image of the batched pair,
    # is its serial baseline within one level, far from another job's
    assert all(d["max"] <= 1 for d in rec["storm_vs_serial"].values())
    assert rec["pair_vs_serial"]["max"] <= 1
    assert rec["mixup_mean_diff"] > 10


@pytest.mark.parametrize("seed", [14, 15])
@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 32, 48)],
                         ids=["1x64x64", "2x32x48"])
def test_initial_latents_equal_the_jax_harness(seed, shape):
    got = fidelity_harness.initial_latents(seed, *shape)
    want = jharness.torch_initial_latents(seed, *shape)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (shape[0], shape[1] // 8, shape[2] // 8, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "inverse", "same", "shifted"])
def test_psnr_and_ssim_equal_the_jax_harness(case):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    b = {"random": rng.integers(0, 256, a.shape, dtype=np.uint8),
         "inverse": 255 - a, "same": a.copy(),
         "shifted": np.clip(a.astype(int) + 3, 0, 255).astype(np.uint8)}[case]
    assert fidelity_harness.psnr(a, b) == jharness.psnr(a, b)
    assert fidelity_harness.ssim(a, b) == jharness.ssim(a, b)
    assert fidelity_harness.lpips_distance(a, b) is None   # not installed


def test_self_check_reports_exact_equality(tmp_path):
    out = tmp_path / "self_report.json"
    report = fidelity_harness.run_self_check(str(out), device="cpu")
    assert report["self_exact_equal"] is True
    assert report["lpips"] is None
    assert report["psnr"] == 99.0 and abs(report["ssim"] - 1.0) < 1e-9
    assert report["stage2_latent_mae"] == 0.0
    assert json.loads(out.read_text())["mode"] == "self_check"
    # the approximate modes drift, and the report says by how much
    assert np.isfinite(report["crop_psnr"]) and report["crop_psnr"] < 99
    assert report["deepcache_psnr"] < 99
    assert report["deepcache_stage2_latent_mae"] > 0


def test_harness_skips_cleanly_without_checkpoints(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "omg_tpu_torch.tools.fidelity_harness",
         "--pretrained_sdxl_model", str(tmp_path / "missing"),
         "--prompt", "x"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "SKIP: no checkpoint" in proc.stdout


def test_harness_skips_without_diffusers_or_the_reference(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A checkpoint directory with no diffusers: the engine runs and the
    report says the reference was skipped; with an (empty) diffusers but
    no reference checkout, the same. The prompt and the checkpoint stay
    required."""
    ckpt = write_tiny_checkpoint(tmp_path / "sdxl", seed=1)
    out = tmp_path / "report.json"
    args = ["--pretrained_sdxl_model", ckpt, "--prompt", "x",
            "--segment_type", "none", "--steps", "2", "--height", "64",
            "--width", "64", "--device", "cpu", "--out", str(out)]
    assert fidelity_harness.main(args) == 0
    assert "SKIP reference run: No module named 'diffusers'" in \
        capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["reference"] == "skipped (diffusers/repo unavailable)"
    assert report["config"]["device"] == "cpu"
    (tmp_path / "diffusers").mkdir()
    (tmp_path / "diffusers" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "diffusers", raising=False)
    try:
        assert fidelity_harness.main(args + ["--reference_repo",
                                             str(tmp_path / "none")]) == 0
    finally:
        sys.modules.pop("diffusers", None)
    assert "SKIP reference run (repo not importable)" in \
        capsys.readouterr().out
    assert json.loads(out.read_text())["reference"] == report["reference"]
    with pytest.raises(SystemExit, match="required"):
        fidelity_harness.main(["--prompt", "x"])
