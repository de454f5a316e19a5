"""The port stands without jax, and without the packages the GPU host
lacks (PIL, cv2, transformers, tokenizers, safetensors, regex, ftfy); its
CLIs answer --help and refuse to run without a card unless asked for the
CPU, and its chip smoke refuses to run on a machine without a CUDA
device."""

import importlib.util
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""       # no card, whatever the host has
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import omg_tpu_torch.pipelines.omg, omg_tpu_torch.from_jax\n"
            "import omg_tpu_torch.ops.flash_attention\n"
            "import omg_tpu_torch.parallel.launch\n"
            "import omg_tpu_torch.parallel.mesh\n"
            "import omg_tpu_torch.segment, omg_tpu_torch.segment.detector\n"
            "import omg_tpu_torch.segment.detector_eval\n"
            "import omg_tpu_torch.segment.sam_provider\n"
            "import omg_tpu_torch.models.clip_vision\n"
            "import omg_tpu_torch.models.controlnet\n"
            "import omg_tpu_torch.models.resampler\n"
            "import omg_tpu_torch.instantid\n"
            "import omg_tpu_torch.diffusion.schedulers\n"
            "import omg_tpu_torch.convert, omg_tpu_torch.loader\n"
            "import omg_tpu_torch.checkpoint, omg_tpu_torch.utils.image\n"
            "import omg_tpu_torch.cli.inference_lora\n"
            "import omg_tpu_torch.cli.inference_instantid\n"
            "import omg_tpu_torch.text.tokenizer\n"
            "import omg_tpu_torch.serving.conditions\n"
            "import omg_tpu_torch.serving.registry\n"
            "import omg_tpu_torch.serving.server\n"
            "import omg_tpu_torch.serving.warmup\n"
            "import omg_tpu_torch.utils.profiling\n"
            "import omg_tpu_torch.cli.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'omg_tpu', 'PIL', 'cv2',\n"
            "              'transformers', 'safetensors', 'regex', 'ftfy',\n"
            "              'tokenizers', 'insightface'))\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_cli_help_and_no_card():
    """``--help`` needs no card; a run that asks for none fails at once
    for want of one, before any file is read."""
    proc = _run(["-m", "omg_tpu_torch.cli.inference_lora", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--lora_path" in proc.stdout and "--device" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.inference_instantid", "--help"])
    assert proc.returncode == 0 and "--face_adapter_path" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.inference_lora",
                 "--pretrained_sdxl_model", "no/such/dir"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "no/such/dir" not in proc.stderr


def test_serve_cli_help_and_no_card():
    proc = _run(["-m", "omg_tpu_torch.cli.serve", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--registry" in proc.stdout and "--device" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.serve",
                 "--pretrained_sdxl_model", "no/such/dir"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "no/such/dir" not in proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_times_k1_at_the_controlnet_batches():
    """Phase 3 holds K1 at the batches the conditioned paths give it:
    1 (guess mode's cond row), 3 (the stage-2 base rows) and 4 (the
    IdentityNet on the concept lanes), at both self-attention shapes."""
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = {(b, h, n, 64) for b in (1, 3, 4)
            for h, n in ((10, 4096), (20, 1024))}
    assert want <= set(mod.KERNEL_SHAPES)
    assert (mod.CN_PATH_LAUNCHES, mod.IID_PATH_LAUNCHES) == (8736, 7036)


def test_chip_smoke_serving_counts():
    """Phase 3 holds K1 at every shape phase 10 launches it at (R = 4: B =
    8 in stage 1, 28 in stage 2; R = 2 with config #5's ControlNets: 4, 6,
    8 and 14; guess mode: 1, 2 and 7), and phase 10 (a) expects its
    launches per shape."""
    spec = importlib.util.spec_from_file_location("chip_smoke_serving",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = {(b, h, n, 64) for b in (8, 28)
            for h, n in ((10, 4096), (20, 1024))}
    assert want <= set(mod.KERNEL_SHAPES)
    assert mod.BATCH_SHAPE_LAUNCHES == {
        "8,10,4096,64": 500, "8,20,1024,64": 3000,
        "28,10,4096,64": 340, "28,20,1024,64": 2040}
    assert sum(mod.BATCH_SHAPE_LAUNCHES.values()) == 5880
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    for table in (mod.BATCH_SHAPE_LAUNCHES, mod.CONFIG5_SHAPES,
                  mod.GUESS_SHAPES, mod.HTTP_SHAPES):
        assert set(table) <= checked
