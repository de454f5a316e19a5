"""HTTP serving front end (port of ``omg_tpu/serving/server.py``).

A long-lived process holds the models, a character and style registry
and per-request LoRA choice, and serves a JSON API and a small web page
on the standard library's ``http.server``:

  GET  /            -> the HTML page
  GET  /registry    -> JSON of the characters, styles and capabilities
  GET  /metrics     -> counters and latency records (utils/profiling)
  GET  /healthz     -> worker liveness and queue depth
  POST /generate    -> a JSON job, or {"prompts": [...], ...} for several:
      {"prompt", "negative_prompt", "character1"/"character2" (registry
       names) or "prompt_rewrite", "style", "seed", "height", "width",
       "guidance_scale", "steps", "scheduler", "condition" +
       "condition_image" (base64 PNG or JPEG), "controlnet_scale",
       "face_embeddings"/"face_kps"/"face_images"}
    -> {"image", "stage1" (base64 PNG), "seconds", "height", "width",
        "stage2_ran" (False: "image" is the stage-1 fallback, no concept
        mask was found), "masks_found": [bool per concept]}
  POST /generate_form -> the same from an HTML form

One worker thread drains the queue: up to ``max_batch`` compatible jobs
(same resolution bucket, step count, scheduler and condition kind) run as
one ``OMG.generate_batch``; a ``prompts`` request is one queue item and
batches within itself. Robustness as in the JAX server: a bounded queue
(HTTP 429 when full), per-request deadlines (504) and disconnects that
abandon a queued job before it costs device time, 400 for malformed jobs
and 500 for failures in the worker; preprocessing (face analysis,
condition rendering) runs in the submitter's thread.

Over a mesh (``cli/serve.py --mesh N``) every rank builds the same
server; rank 0 serves and, through its ``handover`` (``serving/mesh.py``),
hands each job group it runs to the follower ranks, which make the same
calls in the same order.

What differs from the JAX server on a host without PIL: uploads are PNG
or JPEG (``utils/image.decode_image``, sequential or progressive, CMYK
too; an arithmetic-coded JPEG is answered 400 and the message names it),
results go out as PNG; face photos need a ``face_provider`` (there is no
insightface).
"""

from __future__ import annotations

import base64
import functools
import html
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from omg_tpu_torch import instantid as iid_lib
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.diffusion.schedulers import KINDS as _SCHED_KINDS
from omg_tpu_torch.pipelines import multiconcept
from omg_tpu_torch.serving import conditions
from omg_tpu_torch.serving.registry import Registry
from omg_tpu_torch.utils import image as image_lib
from omg_tpu_torch.utils.profiling import METRICS, trace


def decode_upload(b64: str) -> np.ndarray:
    """A base64 PNG or baseline-JPEG upload -> uint8 RGB [H, W, 3]; another
    format raises ``ValueError`` (HTTP 400) naming it."""
    return image_lib.to_rgb(image_lib.decode_image(base64.b64decode(b64),
                                                   "uploaded image"))


def _png_b64(arr) -> str:
    return base64.b64encode(image_lib.encode_png(
        np.asarray(arr).astype(np.uint8))).decode()


class ServerBusy(RuntimeError):
    """Bounded work queue is full — served as HTTP 429."""


class RequestTimeout(TimeoutError):
    """Waiter exceeded its deadline — served as HTTP 504; the job is
    abandoned (skipped by the worker if it has not started yet)."""


class RequestCancelled(RuntimeError):
    """Client went away while waiting; the queued job is abandoned."""


# The single page: character and style choices from the registry, the
# nine resolution buckets, condition kind and photo, InstantID face
# uploads, seed, steps, CFG and ControlNet scale, and both stage outputs.
# It reads the capabilities from GET /registry and posts JSON to
# /generate.
_UI = """<!doctype html><title>OMG</title>
<style>
body{font-family:system-ui,sans-serif;margin:2em auto;max-width:62em}
fieldset{border:1px solid #ccc;margin:.6em 0;padding:.6em}
label{display:inline-block;margin:.2em 1em .2em 0}
textarea,input[type=text]{width:100%;box-sizing:border-box}
img{max-width:100%;border:1px solid #ddd;margin:.3em 0}
#err{color:#b00;white-space:pre-wrap}
.cols{display:flex;gap:1em}.cols>div{flex:1}
</style>
<h2>OMG multi-concept generation</h2>
<fieldset><legend>Prompt</legend>
<textarea id=prompt rows=2>Close-up photo of the cool man and beautiful
 woman as they discover a mysterious island, smiling, 35mm photograph,
 4k</textarea>
<textarea id=negative rows=1>noisy, blurry, soft, deformed, ugly</textarea>
</fieldset>
<fieldset><legend>Concepts</legend>
<label>Character 1 <select id=character1></select></label>
<label>Character 2 <select id=character2></select></label>
<label>Style <select id=style></select></label>
<span id=facebox hidden>
<label>Face 1 <input type=file id=face1 accept=image/*></label>
<label>Face 2 <input type=file id=face2 accept=image/*></label></span>
</fieldset>
<fieldset><legend>Generation</legend>
<label>Resolution <select id=resolution></select></label>
<label>Scheduler <select id=scheduler></select></label>
<label id=dcbox hidden>DeepCache N <input id=deepcache type=number min=0
 placeholder=off style=width:5em>
 <select id=dcsched></select></label>
<label>Seed <input id=seed type=number value=42 style=width:6em></label>
<label>Steps <input id=steps type=number value=50 style=width:5em></label>
<label>CFG <input id=cfg type=number step=0.5 value=7.5
 style=width:5em></label>
<span id=condbox hidden>
<label>Condition <select id=condition><option>none</option></select></label>
<label>Condition photo <input type=file id=condimg accept=image/*></label>
<label>ControlNet scale <input id=cnscale type=number step=0.1 value=1.0
 style=width:5em></label></span>
</fieldset>
<details><summary>Advanced: prompt_rewrite DSL (overrides characters)
</summary><textarea id=rewrite rows=2
 placeholder="[region prompt]-*-[negative]|[region prompt]-*-[negative]">
</textarea></details>
<p><button id=go>Generate</button> <span id=status></span></p>
<p id=err></p>
<div class=cols><div><h4>Result</h4><div id=out></div></div>
<div><h4>Stage 1 / condition</h4><div id=aux></div></div></div>
<script>
const $ = id => document.getElementById(id);
const b64 = f => new Promise((res, rej) => {
  if (!f) return res(null);
  const r = new FileReader();
  r.onload = () => res(r.result.split(',')[1]);
  r.onerror = rej; r.readAsDataURL(f); });
function fill(sel, names) {
  sel.append(new Option('(none)', ''));
  for (const n of names) sel.append(new Option(n, n));
}
async function init() {
  const caps = await (await fetch('/registry')).json();
  fill($('character1'), [...caps.man, ...caps.woman]);
  fill($('character2'), [...caps.woman, ...caps.man]);
  fill($('style'), caps.styles);
  for (const [h, w] of caps.resolutions || [[1024, 1024]])
    $('resolution').append(new Option(`${w} x ${h}`, `${h},${w}`));
  $('scheduler').append(new Option('(default)', ''));
  for (const s of caps.schedulers || [])
    $('scheduler').append(new Option(s, s));
  for (const c of caps.conditions || []) {
    $('condition').append(new Option(c, c));
    $('condbox').hidden = false;
  }
  $('facebox').hidden = !caps.instantid;
  $('dcbox').hidden = !caps.deepcache_per_request;
  for (const k of caps.cache_schedules || ['uniform'])
    $('dcsched').append(new Option(k, k));
  $('dcsched').value = 'front';   // measured: faster AND lower drift
}
const num = (id, dflt) => {
  const v = +$(id).value;
  return Number.isFinite(v) ? v : dflt;   // blanked input -> default
};
$('go').onclick = async () => {
  $('status').textContent = 'generating…'; $('err').textContent = '';
  const [h, w] = $('resolution').value.split(',').map(Number);
  const job = {prompt: $('prompt').value, negative_prompt: $('negative').value,
    character1: $('character1').value, character2: $('character2').value,
    style: $('style').value, seed: num('seed', 42), steps: num('steps', 50),
    guidance_scale: num('cfg', 7.5), height: h, width: w};
  if ($('rewrite').value.trim()) job.prompt_rewrite = $('rewrite').value.trim();
  if ($('scheduler').value) job.scheduler = $('scheduler').value;
  if ($('deepcache').value !== '') {
    job.cache_interval = num('deepcache', 0);
    job.cache_schedule = $('dcsched').value;
  }
  if ($('condition').value !== 'none' && $('condimg').files[0]) {
    job.condition = $('condition').value;
    job.condition_image = await b64($('condimg').files[0]);
    job.controlnet_scale = num('cnscale', 1.0);
  }
  const faces = [await b64($('face1').files[0]),
                 await b64($('face2').files[0])];
  if (faces[0] || faces[1]) job.face_images = faces;
  try {
    const r = await fetch('/generate', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(job)});
    const res = await r.json();
    if (!r.ok) throw new Error(res.error || r.status);
    $('status').textContent = res.seconds + ' s';
    $('out').innerHTML = `<img src="data:image/png;base64,${res.image}">`;
    let aux = `<img src="data:image/png;base64,${res.stage1}">`;
    if (res.condition)
      aux += `<img src="data:image/png;base64,${res.condition}">`;
    $('aux').innerHTML = aux;
  } catch (e) {
    $('status').textContent = ''; $('err').textContent = String(e);
  }
};
init();
</script>"""


class OMGServer:
    def __init__(self, engine, registry: Optional[Registry] = None,
                 instantid=None, max_batch: int = 4,
                 face_provider=None, controlnets: Optional[dict] = None,
                 pose_provider=None, depth_provider=None,
                 max_queue: int = 32,
                 request_timeout: Optional[float] = None,
                 handover=None):
        """``engine``: an ``OMG`` (or anything with its ``generate`` and
        ``generate_batch``). ``instantid``: ``InstantIDModels``, enabling
        face requests: per-concept ``face_embeddings`` with optional
        ``face_kps``, or ``face_images`` (base64 PNG or JPEG) analysed by
        ``face_provider`` (image -> (kps [5, 2], embedding)); without a
        provider, face photos fail with the insightface message.
        ``controlnets``: {kind: ControlNetModel} for 'pose', 'canny' and
        'depth' conditions; ``pose_provider``/``depth_provider``: photo ->
        condition map (without one, a pose or depth photo passes through
        as a precomputed map). ``max_batch``: the queue drain's width.
        ``max_queue``: the bound past which submits get ``ServerBusy``
        (429). ``request_timeout``: the default deadline in seconds (None:
        wait forever). Registry LoRAs load onto the engine's device.
        ``handover``: rank 0's ``serving.mesh.Handover`` over a mesh
        engine (None on one device)."""
        self.engine = engine
        self.instantid = instantid
        self.controlnets = controlnets or {}
        self.pose_provider = pose_provider
        self.depth_provider = depth_provider
        self.registry = registry or Registry()
        self.loras = self.registry.lora_cache(functools.partial(
            lora_lib.load_lora, device=getattr(engine, "device", "cuda")))
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        self.request_timeout = request_timeout
        self.face_provider = face_provider
        self.handover = handover
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._running = threading.Lock()    # held while a group runs
        self._bound = threading.Event()
        self._work: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._worker = threading.Thread(target=self._run_worker, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- worker

    @staticmethod
    def _bucket(job: dict, default_interval: int = 0,
                default_schedule: str = "uniform"):
        try:
            h = int(job.get("height", 1024))
            w = int(job.get("width", 1024))
            if min(h, w) >= 512:
                h, w = conditions.snap_resolution(h, w)
            # one batch shares the scheduler (LCM few-step requests batch
            # with each other, never with euler ones) and the condition
            # kind (each kind is its own ControlNet, and generate_batch
            # takes one). The DeepCache interval is keyed on its
            # resolved value (absent -> engine default, <= 1 -> exact),
            # so an explicit no-op field does not split a batch.
            ci = job.get("cache_interval")
            ci = default_interval if ci is None else int(ci)
            ci = ci if ci > 1 else 0
            kind = str(job.get("cache_schedule") or default_schedule)
            return (h, w, int(job.get("steps", 0)),
                    str(job.get("scheduler", "")),
                    ci, kind if ci else "",
                    str(job.get("condition", "")
                        if job.get("condition_image") else ""))
        except Exception:
            # malformed job: unique bucket -> never batched; the error
            # surfaces from _generate with a real message instead of
            # killing the worker
            return object()

    def _bucket_key(self, job: dict):
        # resolve against THIS engine's defaults so "absent" and an
        # explicit equal value land in the same bucket
        return self._bucket(
            job, getattr(self.engine, "cache_interval", 0) or 0,
            getattr(self.engine, "cache_schedule", "uniform") or "uniform")

    def _batchable(self, job: dict) -> bool:
        # face and spatial-condition jobs batch too (generate_batch
        # shares one InstantID stack and one ControlNet); guess-mode jobs
        # run alone
        return not job.get("guess_mode")

    def _run_worker(self):
        # items stashed by the drain (incompatible with the batch being
        # formed) are served BEFORE new queue items — re-enqueueing them
        # would put earlier-submitted requests behind later ones
        pending: list = []
        while True:
            item = pending.pop(0) if pending else self._work.get()
            try:
                # submit_many envelope: a pre-grouped list of
                # (job, done) pairs — batch within the group only
                group = item if isinstance(item, list) else [item]
                if not isinstance(item, list):
                    # drain queued compatible jobs into one batch
                    if self._batchable(item[0]):
                        key = self._bucket_key(item[0])
                        while len(group) < self.max_batch:
                            try:
                                nxt = self._work.get_nowait()
                            except queue.Empty:
                                break
                            if (isinstance(nxt, tuple)
                                    and self._batchable(nxt[0])
                                    and self._bucket_key(nxt[0]) == key):
                                group.append(nxt)
                            else:
                                # incompatible: run it next, in order
                                pending.append(nxt)
                                break
                with self._running:
                    self._run_group(group)
            except Exception:
                # never let the single worker die: _run_group resolves
                # every done-event itself; anything escaping here is a
                # bookkeeping bug, logged but survivable
                import traceback
                traceback.print_exc()

    def _run_group(self, group: list) -> None:
        """Execute (job, done) pairs: compatible runs as batches (in
        max_batch chunks), the rest one by one. Resolves every done
        event, also on error. Jobs whose waiter timed out or disconnected
        (done["abandoned"]) are dropped before they cost device time."""
        while group:
            dropped = [d for _, d in group if d.get("abandoned")]
            if dropped:
                METRICS.count("abandoned_dropped", len(dropped))
                group = [(j, d) for j, d in group
                         if not d.get("abandoned")]
                if not group:
                    return
            head = group[0]
            batch = [head]
            if self._batchable(head[0]):
                key = self._bucket_key(head[0])
                while (len(batch) < self.max_batch
                       and len(batch) < len(group)
                       and self._batchable(group[len(batch)][0])
                       and self._bucket_key(group[len(batch)][0]) == key):
                    batch.append(group[len(batch)])
            group = group[len(batch):]
            if len(batch) == 1:
                job, done = batch[0]
                try:
                    done["result"] = self._call([job])
                except Exception as e:  # surfaced to the client as 500
                    done["error"] = str(e)
                done["event"].set()
                continue
            try:
                results = self._call([j for j, _ in batch])
                for (_, done), res in zip(batch, results):
                    done["result"] = res
                    done["event"].set()
            except Exception as e:
                for _, done in batch:
                    done["error"] = str(e)
                    done["event"].set()

    def _call(self, jobs: list):
        """``_generate`` of one job, ``_generate_batch`` of several; under a
        mesh, handed to the follower ranks first."""
        if self.handover is not None:
            return self.handover.lead(self, jobs)
        return (self._generate(jobs[0]) if len(jobs) == 1
                else self._generate_batch(jobs))

    @staticmethod
    def _clean(job: dict) -> dict:
        # strip private keys a client could inject (e.g.
        # _condition_rendered, echoed back as the condition image)
        return {k: v for k, v in job.items() if not k.startswith("_")}

    def _prepare(self, job: dict) -> dict:
        """Host-side preprocessing in the SUBMITTER's thread (face
        analysis, condition rendering, prompt assembly): the prepared
        OMG.generate kwargs ride along in job["_req"], so the worker
        thread spends its time driving the card, and request N+1's
        preprocessing overlaps request N's compute. Raises here (bad
        scheduler, missing ControlNet, ...) surface immediately without
        a queue round-trip."""
        job = self._clean(job)
        job["_req"] = self._job_to_request(job)
        return job

    def _wait(self, done: dict, deadline, cancelled) -> None:
        """Wait for the worker until an optional absolute deadline with
        an optional cancellation poll; mark the job abandoned when
        giving up. ``deadline`` is time.time()-based (None = forever)."""
        poll = None if (deadline is None and cancelled is None) else 0.25
        while not done["event"].wait(poll):
            if cancelled is not None and cancelled():
                done["abandoned"] = True
                METRICS.count("requests_cancelled")
                raise RequestCancelled("client disconnected")
            if deadline is not None and time.time() >= deadline:
                done["abandoned"] = True
                METRICS.count("request_timeouts")
                raise RequestTimeout("request deadline exceeded")

    def _deadline(self, timeout) -> Optional[float]:
        timeout = self.request_timeout if timeout is None else timeout
        return None if timeout is None else time.time() + float(timeout)

    def submit(self, job: dict, timeout: Optional[float] = None,
               cancelled=None) -> dict:
        """Prepare, enqueue, and wait. ``timeout`` overrides the server
        default; ``cancelled`` is a zero-arg callable polled while
        waiting (True = give up and abandon the job)."""
        done = {"event": threading.Event()}
        try:
            self._work.put_nowait((self._prepare(job), done))
        except queue.Full:
            METRICS.count("rejected_busy")
            raise ServerBusy(
                f"work queue is full ({self.max_queue} pending); "
                f"retry later") from None
        self._wait(done, self._deadline(timeout), cancelled)
        if "error" in done:
            raise RuntimeError(done["error"])
        return done["result"]

    def submit_many(self, jobs: list, timeout: Optional[float] = None,
                    cancelled=None) -> list:
        """Run several jobs, compatible ones as one batch (the
        multi-prompt request). The group is enqueued as one item, so its
        batching does not race the idle worker."""
        pairs = [(self._prepare(job), {"event": threading.Event()})
                 for job in jobs]
        try:
            self._work.put_nowait(list(pairs))
        except queue.Full:
            METRICS.count("rejected_busy")
            raise ServerBusy(
                f"work queue is full ({self.max_queue} pending); "
                f"retry later") from None
        deadline = self._deadline(timeout)   # one deadline for the group
        try:
            for _, done in pairs:
                self._wait(done, deadline, cancelled)
        except (RequestTimeout, RequestCancelled):
            for _, done in pairs:     # one deadline covers the group
                if not done["event"].is_set():
                    done["abandoned"] = True
            raise
        bad = next((d["error"] for _, d in pairs if "error" in d), None)
        if bad is not None:
            raise RuntimeError(bad)
        return [d["result"] for _, d in pairs]

    # ----------------------------------------------------------- generate

    def _lookup(self, name):
        reg = self.registry
        return (reg.characters_man.get(name)
                or reg.characters_woman.get(name))

    def _face_info(self, image_rgb: np.ndarray):
        """(kps [5, 2], embedding [512]) of the largest face, from the
        ``face_provider``; without one, the insightface message."""
        if self.face_provider is not None:
            return self.face_provider(image_rgb)
        return iid_lib.analyze_face(image_rgb)

    def _job_to_request(self, job: dict) -> dict:
        """HTTP job dict -> OMG.generate keyword arguments.

        Side effect: stores the rendered spatial condition (if any) in
        ``job["_condition_rendered"]``, so that the response can echo it
        beside the image."""
        height = int(job.get("height", 1024))
        width = int(job.get("width", 1024))
        if min(height, width) >= 512:
            # snap to the SDXL aspect buckets (bounds the batch keys)
            height, width = conditions.snap_resolution(height, width)

        rewrite = job.get("prompt_rewrite", "")
        concept_loras = []
        if not rewrite:
            parts = []
            for key in ("character1", "character2"):
                spec = self._lookup(job.get(key, ""))
                if spec is not None:
                    parts.append(f"[{spec.prompt}]-*-[{spec.negative_prompt}]")
                    concept_loras.append(self.loras.get(spec.name))
            rewrite = "|".join(parts)
        style = self.loras.get(job.get("style", ""))

        iid_kwargs = {}
        embeds = None
        if self.instantid is not None and job.get("face_images"):
            # raw face photos, analysed here
            embeds = []
            for b64 in job["face_images"]:
                if not b64:
                    embeds.append(None)
                    continue
                _kps, emb = self._face_info(decode_upload(b64))
                embeds.append(np.asarray(emb, np.float32))
        elif self.instantid is not None and job.get("face_embeddings"):
            embeds = [np.asarray(e, np.float32) if e is not None else None
                      for e in job["face_embeddings"]]
        if embeds is not None:
            iid_kwargs = dict(instantid=self.instantid,
                              face_embeddings=embeds)
            if job.get("face_kps"):
                # explicit canvas-frame keypoints from the client
                all_kps = [np.asarray(k, np.float32)
                           for k in job["face_kps"]]
                iid_kwargs["face_kps_image"] = iid_lib.draw_kps(
                    height, width, all_kps)
            else:
                # the keypoints of the faces found on the stage-1 image
                # (the photos' own keypoints are not a canvas layout);
                # none without a face detector
                def _provider(stage1_img):
                    try:
                        return iid_lib.stage1_kps_provider(stage1_img)
                    except Exception:
                        return None
                iid_kwargs["face_kps_provider"] = _provider

        cn_kwargs = {}
        kind = conditions.condition_kind(job.get("condition"))
        if kind is not None and job.get("condition_image"):
            photo = decode_upload(job["condition_image"])
            cond = conditions.prepare_condition(
                photo, kind, height, width,
                pose_provider=self.pose_provider,
                depth_provider=self.depth_provider)
            cn = self.controlnets.get(kind)
            if cn is None:
                raise ValueError(
                    f"no ControlNet loaded for condition {kind!r} "
                    f"(available: {sorted(self.controlnets)})")
            job["_condition_rendered"] = cond
            cn_kwargs = dict(
                spatial_condition=cond, controlnet_params=cn,
                controlnet_scale=float(job.get("controlnet_scale", 1.0)),
                # the per-step guidance window and guess mode
                control_guidance_start=float(
                    job.get("control_guidance_start", 0.0)),
                control_guidance_end=float(
                    job.get("control_guidance_end", 1.0)),
                controlnet_guess_mode=bool(job.get("guess_mode", False)))

        sched_kwargs = {}
        if job.get("scheduler"):
            if job["scheduler"] not in _SCHED_KINDS:
                raise ValueError(f"unknown scheduler {job['scheduler']!r} "
                                 f"(one of {sorted(_SCHED_KINDS)})")
            sched_kwargs["scheduler"] = job["scheduler"]
        if job.get("cache_interval") is not None:
            # per-request DeepCache (0/1 = exact)
            sched_kwargs["cache_interval"] = int(job["cache_interval"])
        if job.get("cache_schedule"):
            # full-step placement kind (uniform/front) — validated at
            # submit time, where ValueError maps to HTTP 400
            ks = str(job["cache_schedule"])
            if ks not in multiconcept.DEEPCACHE_SCHEDULES:
                raise ValueError(
                    f"unknown cache_schedule {ks!r} (one of "
                    f"{multiconcept.DEEPCACHE_SCHEDULES})")
            sched_kwargs["cache_schedule"] = ks
        return dict(
            prompt=job["prompt"],
            negative_prompt=job.get("negative_prompt",
                                    "noisy, blurry, soft, deformed, ugly"),
            **cn_kwargs, **sched_kwargs,
            prompt_rewrite=rewrite, concept_loras=concept_loras,
            style_lora=style, seed=int(job.get("seed", 42)),
            height=height, width=width,
            guidance_scale=float(job.get("guidance_scale", 7.5)),
            num_steps=int(job.get("steps", 0)) or None, **iid_kwargs)

    @staticmethod
    def _payload(result, t0: float, height: int, width: int,
                 condition=None) -> dict:
        METRICS.count("images_generated")
        if result.stage2 is None:
            # no mask found, stage 2 skipped: the image is stage 1's.
            # Count it, so that /metrics shows the rate, and tell the
            # client below
            METRICS.count("stage2_skipped")
        out = {
            "image": _png_b64(result.image),
            "stage1": _png_b64(result.stage1[1]),
            "seconds": round(time.time() - t0, 3),
            "height": height, "width": width,
            # whether "image" is the fused two-stage result or the
            # stage-1 fallback
            "stage2_ran": result.stage2 is not None,
            "masks_found": [m is not None for m in result.masks],
        }
        if condition is not None:
            out["condition"] = _png_b64(condition)
        return out

    def _generate(self, job: dict) -> dict:
        t0 = time.time()
        # submit() pre-builds the request in the caller's thread so the
        # worker overlaps preprocessing with compute; direct callers
        # (tests, embedding) without a _req still work
        req = job.get("_req") or self._job_to_request(job)
        with trace("serve/generate"):
            result = self.engine.generate(req.pop("prompt"), **req)
        return self._payload(result, t0, req["height"], req["width"],
                             condition=job.get("_condition_rendered"))

    def _generate_batch(self, jobs: list) -> list:
        t0 = time.time()
        reqs = [j.get("_req") or self._job_to_request(j) for j in jobs]
        with trace("serve/generate_batch"):
            results = self.engine.generate_batch(reqs)
        METRICS.count("batched_requests", len(jobs))
        return [self._payload(r, t0, q["height"], q["width"],
                              condition=j.get("_condition_rendered"))
                for r, q, j in zip(results, reqs, jobs)]

    # -------------------------------------------------------------- serve

    def serve(self, host: str = "127.0.0.1", port: int = 7861):
        """Serve until ``shutdown``. Binds loopback by default; pass
        host="0.0.0.0" to expose. Port 0 takes a free port: ``address``
        then names the bound one."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body if isinstance(body, bytes)
                                 else body.encode())

            def do_GET(self):
                if self.path == "/":
                    self._send(200, _UI, "text/html")
                elif self.path == "/registry":
                    reg = server.registry
                    self._send(200, json.dumps({
                        "man": list(reg.characters_man),
                        "woman": list(reg.characters_woman),
                        "styles": list(reg.styles),
                        "loaded_loras": list(server.loras),
                        # capabilities the UI adapts to
                        "conditions": sorted(server.controlnets),
                        "instantid": server.instantid is not None,
                        "resolutions": conditions.RESOLUTIONS,
                        # per-request scheduler override (LCM few-step
                        # requests batch among themselves)
                        "schedulers": sorted(_SCHED_KINDS),
                        # engine-level approximate modes in effect
                        # (clients see what fidelity they are getting)
                        "approx_modes": {
                            "quantize": getattr(server.engine,
                                                "quantize", "") or None,
                            "concept_crop": bool(getattr(
                                server.engine, "concept_crop", False)),
                            "cache_interval": getattr(
                                server.engine, "cache_interval", 0) or None,
                        },
                        # per-request DeepCache (the job field
                        # "cache_interval"; requests bucket by it), on
                        # any engine but a concept-crop one, which
                        # refuses it
                        "deepcache_per_request": not getattr(
                            server.engine, "concept_crop", False),
                        "cache_schedules": list(
                            multiconcept.DEEPCACHE_SCHEDULES),
                    }))
                elif self.path == "/metrics":
                    self._send(200, json.dumps(METRICS.summary()))
                elif self.path == "/healthz":
                    alive = server._worker.is_alive()
                    # non-200 when wedged so probes keying on the status
                    # code stop routing traffic here
                    self._send(200 if alive else 503, json.dumps(
                        {"ok": alive, "queued": server._work.qsize(),
                         "capacity": server.max_queue}))
                else:
                    self._send(404, "{}")

            def _client_gone(self):
                """True once the client hung up: with the request body
                fully read, a readable socket that peeks EOF means the
                peer closed — poll this while waiting so a disconnected
                client's queued job is abandoned, not computed."""
                import select
                import socket as socklib
                try:
                    r, _, _ = select.select([self.connection], [], [], 0)
                    if not r:
                        return False
                    return self.connection.recv(
                        1, socklib.MSG_PEEK) == b""
                except (OSError, ValueError):
                    return True

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path == "/generate":
                    try:
                        job = json.loads(raw or b"{}")
                        if "prompts" in job:
                            # one job per prompt, shared settings, the
                            # seed offset per prompt; compatible ones
                            # run as one batch
                            prompts = job.pop("prompts")
                            if (not isinstance(prompts, list)
                                    or not prompts
                                    or not all(isinstance(p, str)
                                               for p in prompts)):
                                raise ValueError(
                                    "prompts must be a non-empty list "
                                    "of strings")
                            if len(prompts) > 8:
                                raise ValueError(
                                    "at most 8 prompts per request")
                            seed = int(job.get("seed", 42))
                            jobs = [dict(job, prompt=p, seed=seed + i)
                                    for i, p in enumerate(prompts)]
                            out = {"results": server.submit_many(
                                jobs, cancelled=self._client_gone)}
                        else:
                            out = server.submit(
                                job, cancelled=self._client_gone)
                        self._send(200, json.dumps(out))
                    except ServerBusy as e:
                        self._send(429, json.dumps({"error": str(e)}))
                    except RequestTimeout as e:
                        self._send(504, json.dumps({"error": str(e)}))
                    except RequestCancelled:
                        # the peer is gone; there is nobody to answer
                        try:
                            self.connection.close()
                        except OSError:
                            pass
                    except ValueError as e:
                        # submit-time validation (malformed JSON, bad
                        # scheduler/cache_schedule/prompts fields, an
                        # image that does not decode) is a client error;
                        # worker-side failures surface as RuntimeError
                        # and stay 500
                        self._send(400, json.dumps({"error": str(e)}))
                    except Exception as e:
                        self._send(500, json.dumps({"error": str(e)}))
                elif self.path == "/generate_form":
                    try:
                        from urllib.parse import parse_qs
                        fields = {k: v[0] for k, v in
                                  parse_qs(raw.decode()).items()}
                        out = server.submit(fields)
                        self._send(200,
                                   "<img src='data:image/png;base64,"
                                   + out["image"] + "'/>"
                                   + f"<p>{out['seconds']} s</p>",
                                   "text/html")
                    except Exception as e:
                        # escape: the message can echo request fields
                        self._send(500, f"<pre>{html.escape(str(e))}</pre>",
                                   "text/html")
                else:
                    self._send(404, "{}")

            def log_message(self, *a):
                # no per-request stdout spam; the signal lives in
                # METRICS (surfaced at /metrics) instead of being lost
                METRICS.count("http_requests")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._bound.set()
        print(f"omg_tpu_torch serving on http://{self.address}", flush=True)
        self.httpd.serve_forever()

    @property
    def address(self) -> str:
        """host:port of the bound server (after ``serve`` started)."""
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    def wait_bound(self, timeout: float = 30.0) -> str:
        """Block until ``serve`` (in another thread) has bound -> address."""
        if not self._bound.wait(timeout):
            raise TimeoutError("the server did not bind")
        return self.address

    def shutdown(self) -> None:
        """Stop ``serve`` and close its socket; over a mesh, hand the
        follower ranks a stop."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self.handover is not None:
            self.handover.stop()
