"""The port stands without jax (and without PIL), and its chip smoke
refuses to run on a machine without a CUDA device."""

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
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'omg_tpu', 'PIL'))\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout
