"""The serving path of the port on the CPU: condition preprocessing
against PIL and cv2 (what the JAX module calls), the registry against the
JAX one, the HTTP server's endpoints, error codes, queue drain, deadlines
and jobs against the JAX server's, the warmup, the profiling helpers and
``cli/serve`` from a tiny checkout."""

import base64
import dataclasses
import io
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from omg_tpu.serving import conditions as jcond
from omg_tpu.serving import registry as jreg
from omg_tpu.serving.server import OMGServer as JServer
from omg_tpu_torch import from_jax
from omg_tpu_torch.cli import serve as cli_serve
from omg_tpu_torch.parallel import launch
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.serving import conditions, registry, server as srv_lib
from omg_tpu_torch.serving import warmup as warmup_lib
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.utils import image as image_lib
from omg_tpu_torch.utils import profiling

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, mid_block_lora,
                                tiny_sdxl_numpy, write_tiny_checkpoint)

H = W = 32
DATA = pathlib.Path(__file__).resolve().parent / "data"


def _structured(h, w, seed):
    """Discs of random colour over a sinusoidal ramp with a little noise:
    edges of every orientation and weak gradients for the hysteresis."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 3))
    for _ in range(6):
        cx, cy, rad = r.uniform(0, w), r.uniform(0, h), r.uniform(8, h / 3)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < rad ** 2] += r.uniform(
            -120, 120, 3)
    img += 40 * np.sin(xx / 17 + yy / 23)[..., None] + r.normal(0, 8,
                                                                 (h, w, 3))
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def _png_b64(img):
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ------------------------------------------------------------ conditions

def test_snap_resolution_matches_jax():
    assert conditions.RESOLUTIONS == jcond.RESOLUTIONS
    for h in range(300, 2100, 37):
        for w in range(300, 2100, 53):
            assert conditions.snap_resolution(h, w) == \
                jcond.snap_resolution(h, w)


@pytest.mark.parametrize("shape,size", [((100, 60, 3), (64, 64)),
                                        ((37, 91, 3), (96, 64)),
                                        ((300, 200, 3), (128, 160))])
def test_resize_and_center_crop_matches_pil(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    got = conditions.resize_and_center_crop(img, *size)
    want = jcond.resize_and_center_crop(img, *size)
    assert got.shape == want.shape == size + (3,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got, want)     # PIL's passes, bit for bit


@pytest.mark.parametrize("kind", ["noise", "structured", "blurred", "gray",
                                  "large"])
def test_canny_matches_cv2(kind):
    """cv2.Canny(image, 100, 200) on colour input picks, per pixel, the
    channel of largest gradient; the port does the same. Held to 99.5% of
    the pixels; on these images the maps are identical."""
    rng = np.random.default_rng(7)
    img = {"noise": lambda: rng.integers(0, 256, (96, 128, 3), np.uint8),
           "structured": lambda: _structured(160, 224, 1),
           "blurred": lambda: cv2.GaussianBlur(_structured(128, 128, 2),
                                               (0, 0), 1.5),
           "gray": lambda: _structured(96, 96, 3)[..., 0],
           "large": lambda: _structured(512, 384, 4)}[kind]()
    got = conditions.canny(img)
    want = cv2.Canny(img, 100, 200)
    assert got.shape == img.shape[:2] + (3,) and got.dtype == np.uint8
    assert (got[..., 0] == got[..., 2]).all()
    assert (got[..., 0] == want).mean() >= 0.995
    np.testing.assert_array_equal(got[..., 0], want)
    if kind != "noise":
        assert 0 < (want > 0).mean() < 0.5


def test_prepare_condition_matches_jax():
    photo = _structured(90, 120, 5)
    for kind in ("canny", "Canny Edge", "pose", "depth", None):
        got = conditions.prepare_condition(photo, kind, 64, 96)
        want = jcond.prepare_condition(photo, kind, 64, 96)
        if kind is None:
            assert got is None and want is None
        else:
            np.testing.assert_array_equal(got, want)
    seen = []

    def depth(img, size):
        seen.append((img.shape, size))
        return img[..., :1].repeat(3, -1)
    out = conditions.prepare_condition(photo, "depth", 64, 96,
                                       depth_provider=depth)
    assert seen == [((64, 96, 3), (64, 96))] and out.shape == (64, 96, 3)
    assert conditions.condition_kind("Human pose") == "pose"


def test_registry_from_json_matches_jax(tmp_path):
    data = {"man": [{"name": "A", "prompt": "photo of A man",
                     "negative_prompt": "n", "path": str(tmp_path / "a")}],
            "woman": [{"name": "B", "prompt": "photo of B woman",
                       "negative_prompt": "m", "path": "/nonexistent"}],
            "styles": [{"name": "S", "path": str(tmp_path / "s")}]}
    p = tmp_path / "reg.json"
    p.write_text(json.dumps(data))
    (tmp_path / "a").write_text("x")
    got, want = registry.Registry.from_json(str(p)), \
        jreg.Registry.from_json(str(p))
    for field in ("characters_man", "characters_woman", "styles"):
        g, w = getattr(got, field), getattr(want, field)
        assert {k: vars(v) for k, v in g.items()} == \
            {k: vars(v) for k, v in w.items()}
    loaded = got.lora_cache(lambda path: path)
    assert loaded == want.lora_cache(lambda path: path) == {
        "A": str(tmp_path / "a")}
    d = registry.default_registry()
    assert (len(d.characters_man), len(d.characters_woman), len(d.styles)) \
        == (4, 4, 3)


# ------------------------------------------------------------ the server

class FakeEngine:
    """Records every call; ``gate`` holds generate/generate_batch;
    prompt "boom" fails."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.calls = []

    @staticmethod
    def _result(prompt):
        img = np.full((2, 8, 8, 3), len(prompt), np.uint8)
        return omg.GenerationResult(stage1=img, stage2=img,
                                    masks=[np.ones((8, 8))])

    def generate(self, prompt, **kw):
        self.gate.wait(30)
        if prompt == "boom":
            raise RuntimeError("engine failed")
        self.calls.append(("generate", [prompt]))
        return self._result(prompt)

    def generate_batch(self, reqs):
        self.gate.wait(30)
        self.calls.append(("batch", [r["prompt"] for r in reqs]))
        return [self._result(r["prompt"]) for r in reqs]


def _serve(srv):
    threading.Thread(target=srv.serve, args=("127.0.0.1", 0),
                     daemon=True).start()
    return "http://" + srv.wait_bound()


def _post(url, body, path="/generate", ctype="application/json"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def fake_server():
    eng = FakeEngine()
    srv = OMGServer(eng, registry.Registry(), max_batch=4)
    url = _serve(srv)
    yield srv, eng, url
    eng.gate.set()
    srv.shutdown()


def test_endpoints_and_error_codes(fake_server):
    srv, eng, url = fake_server
    code, page = _get(url, "/")
    assert code == 200
    for needle in ("character1", "resolution", "condition", "face1",
                   "prompt_rewrite", "fetch('/registry')", "/generate"):
        assert needle.encode() in page
    code, reg = _get(url, "/registry")
    reg = json.loads(reg)
    # per-request DeepCache on any engine but a concept-crop one (JAX's
    # expression; False before DeepCache was ported)
    assert code == 200 and reg["deepcache_per_request"] is True
    eng.concept_crop = True
    assert json.loads(_get(url, "/registry")[1])[
        "deepcache_per_request"] is False
    del eng.concept_crop
    assert reg["instantid"] is False and reg["conditions"] == []
    assert len(reg["resolutions"]) == 9
    assert sorted(reg["schedulers"]) == ["ddim", "dpmpp_2m", "euler", "lcm"]
    code, hz = _get(url, "/healthz")
    assert code == 200 and json.loads(hz)["ok"] is True
    assert _get(url, "/nope")[0] == 404
    assert _post(url, {}, "/nope")[0] == 404
    code, out = _post(url, {"prompt": "a man", "height": H, "width": W})
    out = json.loads(out)
    assert code == 200 and out["stage2_ran"] is True
    assert image_lib.decode_png(base64.b64decode(out["image"])).shape == \
        (8, 8, 3)
    code, body = _post(url, b"prompt=a+man&height=32&width=32",
                       "/generate_form", "application/x-www-form-urlencoded")
    assert code == 200 and b"data:image/png;base64," in body
    for bad in (b"not json", {"prompt": "x", "scheduler": "nope"},
                {"prompt": "x", "cache_schedule": "frnt"},
                {"prompts": "hello"}, {"prompts": ["a"] * 9},
                {"prompt": "x", "condition": "canny",
                 "condition_image": base64.b64encode(
                     b"\xff\xd8\xff\xe0 jpeg").decode()}):
        code, body = _post(url, bad)
        assert code == 400, bad
    assert b"corrupt JPEG" in body
    code, body = _post(url, {"prompt": "boom"})
    assert code == 500 and b"engine failed" in body
    code, body = _post(url, b"prompt=boom", "/generate_form",
                       "application/x-www-form-urlencoded")
    assert code == 500
    code, m = _get(url, "/metrics")
    assert code == 200 and json.loads(m)["counters"]["http_requests"] > 0


def test_jpeg_condition_uploads():
    """A baseline JPEG photo becomes the condition (decoded as PIL decodes
    it), and so does a progressive one (a 400 before progressive JPEG was
    decoded)."""
    data = (DATA / "small_444.jpg").read_bytes()
    srv = OMGServer(FakeEngine(), registry.Registry(),
                    controlnets={"canny": "a ControlNet"})
    url = _serve(srv)
    try:
        code, out = _post(url, {"prompt": "a man", "height": H, "width": W,
                                "condition": "canny",
                                "condition_image": base64.b64encode(
                                    data).decode()})
        assert code == 200, out
        cond = image_lib.decode_png(base64.b64decode(
            json.loads(out)["condition"]))
        photo = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(
            cond, jcond.prepare_condition(photo, "canny", H, W))
        buf = io.BytesIO()
        PIL.Image.fromarray(photo).save(buf, "JPEG", progressive=True)
        code, body = _post(url, {"prompt": "a man", "height": H, "width": W,
                                 "condition": "canny",
                                 "condition_image": base64.b64encode(
                                     buf.getvalue()).decode()})
        assert code == 200, body
        prog = np.asarray(PIL.Image.open(io.BytesIO(buf.getvalue())).convert(
            "RGB"))
        np.testing.assert_array_equal(
            image_lib.decode_png(base64.b64decode(
                json.loads(body)["condition"])),
            jcond.prepare_condition(prog, "canny", H, W))
    finally:
        srv.shutdown()


def test_drain_concurrent_jobs_into_one_batch():
    """Jobs queued behind a busy worker drain into one generate_batch;
    an incompatible one (another scheduler) runs next, in order."""
    eng = FakeEngine()
    srv = OMGServer(eng, registry.Registry(), max_batch=4)
    job = {"height": H, "width": W, "prompt_rewrite": "[the man]-*-[x]"}
    eng.gate.clear()
    threads = [threading.Thread(target=srv.submit,
                                args=(dict(job, prompt="first"),))]
    threads[0].start()
    time.sleep(0.3)                      # the worker holds "first"
    for p, extra in (("a", {}), ("b", {}), ("c", {"scheduler": "lcm"})):
        threads.append(threading.Thread(
            target=srv.submit, args=(dict(job, prompt=p, **extra),)))
        threads[-1].start()
        time.sleep(0.1)
    before = profiling.METRICS.counters.get("batched_requests", 0)
    eng.gate.set()
    for t in threads:
        t.join(30)
    assert eng.calls == [("generate", ["first"]), ("batch", ["a", "b"]),
                         ("generate", ["c"])]
    assert profiling.METRICS.counters["batched_requests"] == before + 2


def test_submit_many_is_one_queue_item():
    eng = FakeEngine()
    srv = OMGServer(eng, registry.Registry(), max_batch=4)
    out = srv.submit_many([{"prompt": p, "height": H, "width": W, "seed": i}
                           for i, p in enumerate(("x", "yy", "zzz"))])
    assert eng.calls == [("batch", ["x", "yy", "zzz"])]
    assert [o["stage2_ran"] for o in out] == [True] * 3


def test_queue_bound_timeout_and_cancel():
    eng = FakeEngine()
    srv = OMGServer(eng, registry.Registry(), max_queue=1)
    url = _serve(srv)
    try:
        eng.gate.clear()
        job = {"prompt": "hold", "height": H, "width": W}
        t1 = threading.Thread(target=srv.submit, args=(job,))
        t1.start()
        time.sleep(0.3)                  # the worker holds it
        with pytest.raises(srv_lib.RequestTimeout):
            srv.submit(dict(job, prompt="doomed"), timeout=0.3)
        # the abandoned job still fills the queue: one more is refused
        code, body = _post(url, dict(job, prompt="third"))
        assert code == 429 and b"queue is full" in body
        assert json.loads(_get(url, "/healthz")[1])["capacity"] == 1
        eng.gate.set()
        t1.join(30)
        with pytest.raises(srv_lib.RequestCancelled):
            eng.gate.clear()
            srv.submit(dict(job, prompt="gone"), cancelled=lambda: True)
        eng.gate.set()
        ok = srv.submit(dict(job, prompt="after"), timeout=30)
        assert ok["stage2_ran"]
        ran = [p for _, ps in eng.calls for p in ps]
        assert "doomed" not in ran and "after" in ran
        # a 504 over HTTP: the server's default deadline
        srv.request_timeout = 0.2
        eng.gate.clear()
        code, _ = _post(url, dict(job, prompt="slow"))
        assert code == 504
    finally:
        eng.gate.set()
        srv.shutdown()


def test_private_keys_stripped():
    eng = FakeEngine()
    srv = OMGServer(eng, registry.Registry())
    out = srv.submit({"prompt": "x", "height": H, "width": W,
                      "_condition_rendered": np.zeros((4, 4, 3), np.uint8)})
    assert "condition" not in out


def _both_servers(**kw):
    """The port's and the JAX server's request builders, no worker."""
    out = []
    for cls in (OMGServer, JServer):
        s = cls.__new__(cls)
        s.registry = kw.get("registry") or registry.Registry()
        s.loras, s.instantid = {}, kw.get("instantid")
        s.controlnets = kw.get("controlnets", {})
        s.pose_provider = s.depth_provider = None
        s.face_provider = kw.get("face_provider")
        out.append(s)
    return out


@pytest.mark.parametrize("job", [
    {"prompt": "x"},
    {"prompt": "the man", "height": 1000, "width": 600, "seed": 3,
     "steps": 8, "scheduler": "lcm", "guidance_scale": 5,
     "negative_prompt": "bad", "cache_interval": 1},
    {"prompt": "two", "character1": "A", "character2": "B", "style": "S",
     "height": 40, "width": 48},
    {"prompt": "faces", "face_embeddings": [[0.5] * 4, None],
     "face_kps": [[[10, 10], [20, 10], [15, 15], [12, 20], [18, 20]]],
     "height": 64, "width": 64},
    {"prompt": "edges", "condition": "Canny Edge", "controlnet_scale": 0.7,
     "control_guidance_start": 0.1, "height": 600, "width": 900},
], ids=["minimal", "fields", "registry", "faces", "canny"])
def test_job_to_request_matches_jax(job):
    reg = registry.Registry()
    reg.add_character("man", registry.CharacterSpec("A", "photo of A", "n",
                                                    "/nonexistent"))
    reg.add_character("woman", registry.CharacterSpec("B", "photo of B",
                                                      "m", "/nonexistent"))
    iid, cn = object(), object()
    if job["prompt"] == "edges":
        job = dict(job, condition_image=_png_b64(_structured(200, 300, 6)))
    mine, theirs = _both_servers(registry=reg, instantid=iid,
                                 controlnets={"canny": cn})
    got, want = (s._job_to_request(dict(job)) for s in (mine, theirs))
    assert sorted(got) == sorted(want)
    for key in got:
        g, w = got[key], want[key]
        if key == "face_kps_provider":
            continue
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key == "face_embeddings":
            assert [None if e is None else e.tolist() for e in g] == \
                [None if e is None else e.tolist() for e in w]
        else:
            assert g == w or g is w, key


def test_face_images_need_a_face_provider():
    seen = []

    def face_provider(img):
        seen.append(img.shape)
        return np.zeros((5, 2), np.float32), np.ones(4, np.float32)
    mine, _ = _both_servers(instantid=object(), face_provider=face_provider)
    face = _png_b64(np.zeros((20, 24, 3), np.uint8))
    req = mine._job_to_request({"prompt": "x", "face_images": [face, ""]})
    assert seen == [(20, 24, 3)]
    assert req["face_embeddings"][1] is None
    assert req["face_kps_provider"](np.zeros((8, 8, 3), np.uint8)) is None
    mine.face_provider = None
    with pytest.raises(RuntimeError, match="insightface is not installed"):
        mine._job_to_request({"prompt": "x", "face_images": [face]})


# ----------------------------------------------- the port's tiny engine

@pytest.fixture(scope="module")
def tiny_engine():
    cfg = sdxl.tiny_config()
    params = from_jax.sdxl_from_jax(tiny_sdxl_numpy(70), cfg, device="cpu")
    tok = ToyTokenizer()
    return omg.OMG(cfg=cfg, params=params, tokenizer=tok, tokenizer_2=tok,
                   mask_provider=left_right_masks, num_steps=2)


def test_http_batch_on_the_port_engine(tiny_engine):
    """A "prompts" request of 3 is one batch of 3 through generate_batch;
    a prompt without the gate word reports the stage-1 fallback."""
    srv = OMGServer(tiny_engine, registry.Registry(), max_batch=4)
    url = _serve(srv)
    try:
        before = profiling.METRICS.summary()["counters"].get(
            "batched_requests", 0)
        code, out = _post(url, {
            "prompts": ["the man at sea", "the man on a hill",
                        "two people"], "seed": 5, "height": H, "width": W,
            "prompt_rewrite": "[the man]-*-[ugly]"})
        assert code == 200
        res = json.loads(out)["results"]
        assert [r["stage2_ran"] for r in res] == [True, True, False]
        for r in res:
            img = image_lib.decode_png(base64.b64decode(r["image"]))
            assert img.shape == (H, W, 3)
        assert res[0]["image"] != res[1]["image"]
        counters = json.loads(_get(url, "/metrics")[1])["counters"]
        assert counters["batched_requests"] == before + 3
    finally:
        srv.shutdown()


def test_warmup_runs_every_program(tiny_engine):
    logs = []
    lora = from_jax.lora_from_jax(mid_block_lora(
        np.random.default_rng(1), 64, 48), device="cpu")
    n = warmup_lib.warmup(tiny_engine.cfg,
                          unet_params=tiny_engine.params.unet, steps=4,
                          buckets=((32, 32), (32, 48)),
                          concept_counts=(1, 2), sample_lora=lora,
                          vae_params=tiny_engine.params.vae,
                          batch_sizes=(1, 3), log=logs.append)
    # per bucket: stage 1 at 2 and 6 lanes, stage 2 at 5, 15, 7 and 21
    # lanes, one decode
    assert n == 2 * 7 == len(logs)
    assert any("stage 2 K=2 (21 lanes)" in m for m in logs)
    # DeepCache (refused before it was ported): each program is the full
    # forward that keeps the cache and a shallow forward from it
    shallow = []
    apply_shallow = type(tiny_engine.params.unet).apply_shallow
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(tiny_engine.params.unet), "apply_shallow",
                   lambda self, x, *a, **k: shallow.append(x.shape[0])
                   or apply_shallow(self, x, *a, **k))
        n = warmup_lib.warmup(tiny_engine.cfg,
                              unet_params=tiny_engine.params.unet, steps=4,
                              buckets=((32, 32),), concept_counts=(2,),
                              sample_lora=lora, cache_interval=3,
                              cache_schedule="front", log=logs.append)
    assert n == 2 and shallow == [2, 7]


def test_profiling_trace_and_metrics():
    m = profiling.Metrics(max_samples=3)
    with pytest.raises(ValueError):
        with profiling.trace("fails", m):
            raise ValueError("x")
    for _ in range(5):
        with profiling.trace("ok", m):
            pass
    s = m.summary()["latency"]
    assert s["fails"]["n"] == 1 and s["ok"]["n"] == 3
    m.count("c", 2)
    assert m.summary()["counters"] == {"c": 2}


def _tiny_preprocessor_files(root):
    """A width-0.125 ``body_pose_model.pth`` and a tiny DPT directory."""
    from omg_tpu_torch import convert
    from omg_tpu_torch.models import dpt, openpose
    body = str(root / "body_pose_model.pth")
    torch.save(openpose.init_params(torch.Generator().manual_seed(10),
                                    0.125).state_dict(), body)
    cfg = dpt.tiny_config()
    depth = root / "dpt"
    depth.mkdir()
    convert.save_safetensors(str(depth / "model.safetensors"), dpt.init_params(
        torch.Generator().manual_seed(11), cfg).state_dict())
    (depth / "config.json").write_text(json.dumps({
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}))
    return body, str(depth)


def test_serve_cli_from_a_tiny_checkout(tmp_path):
    """``--mesh 2`` (refused before the mesh server was ported) reaches
    ``build_server`` on two gloo CPU ranks, each with its rank's handover
    and a latency-mesh engine; the server from files on the CPU, with
    both condition preprocessors, answers a request; the approximate
    modes' flags (refused before they were ported) reach the engine and
    the warmup."""
    from omg_tpu_torch.models import dpt, openpose
    body, depth = _tiny_preprocessor_files(tmp_path)
    from omg_tpu_torch.segment import sam_provider, vit_sam
    ckpt = write_tiny_checkpoint(tmp_path / "sdxl", seed=8)
    sam = str(tmp_path / "sam.pth")
    torch.save(sam_provider.init_sam(
        torch.Generator().manual_seed(9),
        dataclasses.replace(vit_sam.tiny_config(), out_chans=256),
        "cpu").state_dict(), sam)
    reg = tmp_path / "reg.json"
    reg.write_text(json.dumps({"man": [{
        "name": "A", "prompt": "photo of the man", "negative_prompt": "n",
        "path": "/nonexistent"}]}))
    built = launch.spawn(workers.serve_build_rank, 2, backend="gloo",
                         devices=["cpu"] * 2, args=(
        ["--pretrained_sdxl_model", ckpt, "--efficientViT_checkpoint", sam,
         "--registry", str(reg), "--num_steps", "2", "--device", "cpu",
         "--mesh", "2"],))
    assert built == [dict(rank=r, size=2, mesh=(2, 1), steps=2)
                     for r in (0, 1)]
    srv = cli_serve.build_server(cli_serve.parse_args([
        "--pretrained_sdxl_model", ckpt, "--efficientViT_checkpoint", sam,
        "--registry", str(reg), "--num_steps", "2", "--device", "cpu",
        "--pose_detector_checkpoint", body, "--dpt_checkpoint", depth]))
    assert isinstance(srv.pose_provider, openpose.BodyEstimator)
    assert srv.pose_provider.model.width_mult == 0.125
    assert isinstance(srv.depth_provider, dpt.DepthEstimator)
    assert srv.depth_provider.cfg == dpt.tiny_config()
    assert srv.depth_provider(np.zeros((40, 30, 3), np.uint8),
                              (16, 24)).shape == (16, 24, 3)
    url = _serve(srv)
    try:
        assert json.loads(_get(url, "/registry")[1])["man"] == ["A"]
        code, out = _post(url, {"prompt": "the man", "character1": "A",
                                "height": 64, "width": 64, "seed": 1})
        assert code == 200, out
        out = json.loads(out)
        assert image_lib.decode_png(base64.b64decode(out["image"])).shape \
            == (64, 64, 3)
    finally:
        srv.shutdown()
    from omg_tpu_torch.nn import layers
    base = ["--pretrained_sdxl_model", ckpt, "--efficientViT_checkpoint", sam,
            "--registry", str(reg), "--num_steps", "4", "--device", "cpu"]
    srv = cli_serve.build_server(cli_serve.parse_args(
        base + ["--quantize", "int8", "--concept_crop"]))
    assert srv.engine.quantize == "int8" and srv.engine.concept_crop
    assert any(isinstance(m, layers.QuantLinear)
               for m in srv.engine.params.unet.modules())
    # 8 steps: the request's "front" schedule for interval 3 is full on
    # steps 0, 2 (fusion start), 7 and each range's first (3): shallow on
    # step 1 and 4-6 in stage 1, 4-6 in stage 2
    srv = cli_serve.build_server(cli_serve.parse_args(
        base + ["--cache_interval", "3", "--num_steps", "8"]))
    assert (srv.engine.cache_interval, srv.engine.cache_schedule) == \
        (3, "uniform")
    shallow = []
    apply_shallow = type(srv.engine.params.unet).apply_shallow
    url = _serve(srv)
    try:
        caps = json.loads(_get(url, "/registry")[1])
        assert caps["deepcache_per_request"]
        assert caps["approx_modes"]["cache_interval"] == 3
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(type(srv.engine.params.unet), "apply_shallow",
                       lambda *a, **k: shallow.append(1) or
                       apply_shallow(*a, **k))
            code, out = _post(url, {"prompt": "the man", "character1": "A",
                                    "height": 64, "width": 64, "seed": 1,
                                    "cache_schedule": "front"})
        assert code == 200, out
        assert len(shallow) == 7
    finally:
        srv.shutdown()

