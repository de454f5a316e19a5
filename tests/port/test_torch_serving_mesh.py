"""``cli/serve.py --mesh N``: rank 0 serves HTTP and hands each job group
to the follower ranks, which run it in step (``serving/mesh.py``). On
gloo CPU ranks from a tiny checkout: the served image within 1/255 of
the JAX server's ``_generate`` on ``OMG(mesh=make_latency_mesh(2))``
over the virtual devices, every rank making the same calls in the same
order, a job that fails before any collective answered 500 with the
server still up, the bf16 decode split over the ranks; the real CLI in a
subprocess answering a POST with both ranks' images identical, then
SIGTERM leaving no process; and ``--mesh 3`` in a world of one rank."""

import base64
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omg_tpu import loader as jloader
from omg_tpu.parallel import mesh as jmesh
from omg_tpu.pipelines import omg as jomg
from omg_tpu.serving.server import OMGServer as JOMGServer
from omg_tpu_torch.cli import serve as cli_serve
from omg_tpu_torch.parallel import comm, launch
from omg_tpu_torch.utils import image as image_lib

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, normal,
                                write_tiny_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JOB = {"prompt": "photo of the man and the woman at the beach",
       "negative_prompt": "ugly", "height": 64, "width": 64, "seed": 5,
       "prompt_rewrite": "[photo of the man]-*-[ugly]|"
                         "[photo of the woman]-*-[blurry]"}
BATCH = {"prompts": ["a man at the beach", "a woman in the park"],
         "height": 64, "width": 64, "seed": 6, "negative_prompt": "ugly"}
# LCM's schedule refuses 60 steps: generate raises before any collective
FAILS = dict(JOB, scheduler="lcm", steps=60)
STEPS = 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import dataclasses

    import torch

    from omg_tpu_torch.segment import sam_provider, vit_sam
    root = tmp_path_factory.mktemp("mesh_serve")
    ckpt = write_tiny_checkpoint(root / "sdxl", seed=13)
    sam = str(root / "sam.pth")
    torch.save(sam_provider.init_sam(
        torch.Generator().manual_seed(14),
        dataclasses.replace(vit_sam.tiny_config(), out_chans=256),
        "cpu").state_dict(), sam)
    return {"ckpt": ckpt, "sam": sam}


def _argv(files, *extra):
    return ["--pretrained_sdxl_model", files["ckpt"],
            "--efficientViT_checkpoint", files["sam"], "--device", "cpu",
            "--num_steps", str(STEPS), *extra]


@pytest.fixture(scope="module")
def served(files):
    """Two gloo ranks serving ``JOB``, ``BATCH``, ``FAILS`` and ``JOB``
    again through ``cli.serve.main``, and JAX's server's ``_generate`` of
    ``JOB`` on its latency mesh over two virtual devices."""
    seeds = (JOB["seed"], BATCH["seed"], BATCH["seed"] + 1)
    noise = {s: np.asarray(jax.random.normal(jax.random.PRNGKey(s),
                                             (1, 8, 8, 4))) for s in seeds}
    case = {"argv": _argv(files, "--mesh", "2", "--port", "0"),
            "posts": [JOB, BATCH, FAILS, JOB], "noise": noise,
            "latents": normal(np.random.default_rng(15), 1, 8, 8, 4)}
    ranks = launch.spawn(workers.serve_mesh_rank, 2, backend="gloo",
                         devices=["cpu"] * 2, args=(case,))
    jcfg, jparams, jtok1, jtok2 = jloader.load_sdxl(
        files["ckpt"], dtype=jnp.float32, pack=False)
    jeng = jomg.OMG(cfg=jcfg, params=jparams, tokenizer=jtok1,
                    tokenizer_2=jtok2, mask_provider=left_right_masks,
                    num_steps=STEPS, mesh=jmesh.make_latency_mesh(2))
    want = JOMGServer(jeng)._generate(dict(JOB))
    return ranks, want


def _png(b64):
    return image_lib.decode_png(base64.b64decode(b64)).astype(int)


def test_served_image_matches_jax_mesh_server(served):
    ranks, want = served
    code, got = ranks[0]["responses"][0]
    assert code == 200, got
    assert got["stage2_ran"] and got["masks_found"] == [True, True]
    for key in ("image", "stage1"):
        g, w = _png(got[key]), _png(want[key])
        assert g.shape == w.shape == (64, 64, 3)
        assert np.abs(g - w).max() <= 1, key
    assert ranks[0]["responses"][3][1]["image"] == got["image"]


def test_every_rank_runs_the_same_jobs_in_order(served):
    """The batch of two runs as the mesh engine's serial fallback: every
    rank makes the same ``generate`` calls in the same order; the job
    that fails validation in the worker (before any collective) is 500
    on rank 0, skipped by the followers, and the server serves on."""
    ranks, _ = served
    codes = [code for code, _ in ranks[0]["responses"]]
    assert codes == [200, 200, 500, 200]
    assert "origin grid" in ranks[0]["responses"][2][1]["error"]
    assert len(ranks[0]["responses"][1][1]["results"]) == 2
    calls = [r["calls"] for r in ranks]
    assert calls[0] == calls[1]
    assert [seed for _, seed in calls[0]] == [5, 6, 7, 5, 5]


def test_bf16_decode_split_over_the_ranks(served):
    """``decode_latents(dtype=bf16, spatial=...)`` H-split over the two
    ranks equals the whole bf16 decode within bf16 rounding (the split
    group norms sum their statistics in another order)."""
    ranks, _ = served
    for r in ranks:
        d = r["decode_bf16"]
        assert d["split"].shape == (1, 64, 64, 3)
        assert np.abs(d["split"] - d["whole"]).max() <= 2.0 ** -5
    np.testing.assert_array_equal(ranks[0]["decode_bf16"]["split"],
                                  ranks[1]["decode_bf16"]["split"])


def _children(pid: int) -> list:
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(entry))
            except (OSError, IndexError, ValueError):
                pass
    return kids


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_cli_subprocess_serves_and_stops(files):
    """``python -m omg_tpu_torch.cli.serve --mesh 2 --device cpu --port 0``
    answers a POST (both ranks' records show identical images), and
    SIGTERM ends it and every process it started."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "omg_tpu_torch.cli.serve",
         *_argv(files, "--mesh", "2", "--port", "0")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        lines, url = [], None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            url = m.group(1) if m else None
        assert url, "".join(lines)
        kids = _children(proc.pid)
        assert len(kids) >= 2
        req = urllib.request.Request(url + "/generate", json.dumps(
            dict(JOB, steps=2)).encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert _png(out["image"]).shape == (64, 64, 3)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, rest
    recs = [json.loads(x) for x in (lines + rest.splitlines())
            if x.startswith('{"serve_mesh_job"')]
    assert sorted(r["rank"] for r in recs) == [0, 1]
    assert recs[0]["images"] == recs[1]["images"] and recs[0]["images"]
    assert all(r["error"] is None and r["requests"] == 1 for r in recs)
    time.sleep(0.5)
    assert not [k for k in kids if _alive(k)]


def test_mesh_larger_than_the_world_exits(tmp_path):
    """``--mesh 3`` inside a world of one rank: ``make_latency_mesh``'s
    message as a SystemExit, before any weight loads."""
    comm.init(str(tmp_path / "store"), 0, 1, "gloo", 60.0)
    try:
        with pytest.raises(SystemExit,
                           match="latency mesh needs 3 devices; only 1 "
                                 "visible"):
            cli_serve.main(["--pretrained_sdxl_model", str(tmp_path / "no"),
                            "--device", "cpu", "--mesh", "3"])
    finally:
        comm.shutdown()


class _FakeServer:
    """The two calls a handover makes, recorded; a job's "fail" field makes
    it raise before ("before") or after ("after") a collective."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _clean(job):
        return {k: v for k, v in job.items() if not k.startswith("_")}

    def _generate(self, job):
        self.calls.append(job.get("prompt"))
        if job.get("fail") == "before":
            raise ValueError("invalid job")
        if job.get("fail") == "after":
            comm.COLLECTIVES += 1
            raise RuntimeError("a collective timed out")
        return {"image": "aW1n", "stage1": "czE="}

    def _generate_batch(self, jobs):
        return [self._generate(j) for j in jobs]


def test_handover_protocol(tmp_path):
    """Rank 0 stores each group's cleaned jobs under the next number; the
    follower reads them in order and the last reader deletes the key; an
    idle follower returns only when told to stop; a failure before any
    collective fails the job alone, one after a collective ends the server
    (rank 0 refuses further jobs, the follower raises); the stop ends the
    follower's loop."""
    import threading

    import torch.distributed as dist

    from omg_tpu_torch.serving import mesh as mesh_serving
    store = dist.FileStore(str(tmp_path / "store"), 2)
    lead = mesh_serving.Handover(0, 2, store)
    follower = mesh_serving.Handover(1, 2, store)
    srv, fsrv = _FakeServer(), _FakeServer()
    stop = threading.Event()
    threading.Timer(0.2, stop.set).start()
    assert follower.receive(stop) is None and follower.next == 0
    assert lead.lead(srv, [{"prompt": "a", "_req": object()}])["image"]
    assert follower.receive(threading.Event()) == {"jobs": [{"prompt": "a"}]}
    assert not store.check([mesh_serving.KEY.format(0)])
    assert len(lead.lead(srv, [{"prompt": "b"}, {"prompt": "c"}])) == 2
    with pytest.raises(ValueError, match="invalid"):
        lead.lead(srv, [{"prompt": "d", "fail": "before"}])
    assert lead.fatal is None
    ended = threading.Event()
    lead.on_fatal = ended.set
    with pytest.raises(mesh_serving.LockstepError, match="out of step"):
        lead.lead(srv, [{"prompt": "e", "fail": "after"}])
    assert ended.wait(5) and lead.fatal is not None
    with pytest.raises(RuntimeError, match="has stopped"):
        lead.lead(srv, [{"prompt": "f"}])
    with pytest.raises(mesh_serving.LockstepError):
        mesh_serving.follow(fsrv, follower, threading.Event())
    assert fsrv.calls == ["b", "c", "d", "e"] and srv.calls == ["a"] + \
        fsrv.calls
    lead2 = mesh_serving.Handover(0, 2, dist.FileStore(
        str(tmp_path / "store2"), 2))
    follower2 = mesh_serving.Handover(1, 2, lead2.store)
    lead2.lead(srv, [{"prompt": "g"}])
    lead2.stop()
    lead2.stop()
    assert mesh_serving.follow(fsrv, follower2, threading.Event()) == 1
    assert lead2.next == 2 and follower2.next == 2


def test_abandoned_jobs_are_never_handed_over():
    """``_run_group`` drops abandoned jobs before its handover sees the
    group; the rest go through ``handover.lead``."""
    import threading

    from omg_tpu_torch.serving.server import OMGServer
    seen = []

    class Recorder:
        def lead(self, server, jobs):
            seen.append([j["prompt"] for j in jobs])
            return server._generate_batch(jobs) if len(jobs) > 1 else \
                server._generate(jobs[0])

        def stop(self):
            pass

    class Engine:
        def generate(self, prompt, **kw):
            raise AssertionError("not reached")

    srv = OMGServer(Engine(), handover=Recorder())
    srv._generate = lambda job: {"prompt": job["prompt"]}
    srv._generate_batch = lambda jobs: [{"prompt": j["prompt"]} for j in jobs]
    pairs = [({"prompt": p, "height": 64, "width": 64},
              {"event": threading.Event(), "abandoned": p == "gone"})
             for p in ("gone", "kept", "also")]
    srv._run_group(pairs)
    assert seen == [["kept", "also"]]
    assert [d.get("result") for _, d in pairs[1:]] == [
        {"prompt": "kept"}, {"prompt": "also"}]


def test_job_record_is_one_write(monkeypatch):
    """A rank's record line leaves in one write, newline included, so the
    lines of ranks that share an unbuffered output pipe cannot interleave
    (the subprocess test's parse of both ranks' lines once failed on one
    rank's record with the other's inside it)."""
    from omg_tpu_torch.serving import mesh as mesh_serving
    writes = []

    class Out:
        def write(self, text):
            writes.append(text)

        def flush(self):
            pass

    class Server:
        def _generate(self, job):
            if job.get("fail"):
                raise ValueError("refused")
            return {"image": "aW1n", "stage1": "czE="}

    monkeypatch.setattr(sys, "stdout", Out())
    assert mesh_serving.run_job(Server(), 3, 1, [{}])["image"] == "aW1n"
    with pytest.raises(ValueError, match="refused"):
        mesh_serving.run_job(Server(), 4, 1, [{"fail": True}])
    assert len(writes) == 2 and all(w.endswith("}\n") for w in writes)
    recs = [json.loads(w) for w in writes]
    assert [(r["serve_mesh_job"], r["rank"], r["error"]) for r in recs] == [
        (3, 1, None), (4, 1, "refused")]
    assert len(recs[0]["images"]) == 2 and recs[1]["images"] == []
