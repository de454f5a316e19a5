"""The port stands without jax (and without PIL or cv2), and its chip
smoke refuses to run on a machine without a CUDA device."""

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
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'omg_tpu', 'PIL', 'cv2'))\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


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
