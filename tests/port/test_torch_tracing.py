"""The port's request tracer (``utils/profiling``): the span tree of each
top-level call, the phase timings built from it, the counted host-device
syncs and LoRA lanes, the bounded record, and the profiler ranges on the
host clock.

The last test needs an NVIDIA GPU and skips elsewhere. This file imports
no jax, so on the GPU machine it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_tracing.py
"""

import dataclasses
import traceback
import warnings

import numpy as np
import pytest
import torch

from omg_tpu_torch import config
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.models import controlnet
from omg_tpu_torch.nn import layers
from omg_tpu_torch.parallel import comm, mesh
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.utils import profiling

STEPS = 6
FUSION = 0          # stage 2 runs steps 1..5; P2P's self-replace window 0..1
H = W = 64
PROMPT = "a man and a woman in a park"
REWRITE = "[the man]-*-[b]|[the woman]-*-[b]"
PHASES = ["encode", "stage1", "decode", "masks", "stage2", "decode"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the module, as every port test
    module runs (the workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg() -> sdxl.SDXLConfig:
    """The tiny SDXL with a third UNet level, so that its deepest
    self-attention has the (H/32)(W/32) tokens that P2P's self-replace
    edits, as SDXL's level 2 has at every canvas."""
    u = dataclasses.replace(config.tiny_unet(),
                            block_out_channels=(32, 32, 64),
                            transformer_layers_per_block=(0, 1, 1))
    return sdxl.tiny_config()._replace(unet=u)


def unet_lora(unet, seed: int) -> dict:
    """A rank-2 adapter on every attention linear of ``unet``."""
    g = torch.Generator().manual_seed(seed)
    dev = unet.conv_in.weight.device
    out = {}
    for name, m in unet.named_modules():
        if isinstance(m, layers.Linear) and ".attn" in name:
            n_out, n_in = m.weight.shape
            out[m.lora_key] = {
                "down": (0.1 * torch.randn(n_in, 2, generator=g)).to(dev),
                "up": (0.1 * torch.randn(2, n_out, generator=g)).to(dev),
                "scale": torch.tensor(1.0, device=dev)}
    return out


def left_right(image, cls):
    m = np.zeros(image.shape[:2], np.float32)
    if cls == "man":
        m[:, :image.shape[1] // 2] = 1.0
    else:
        m[:, image.shape[1] // 2:] = 1.0
    return m


def build(device, **engine_kw):
    cfg = tiny_cfg()
    params = sdxl.init_params(torch.Generator(device).manual_seed(0), cfg)
    tok = ToyTokenizer()
    eng = omg.OMG(cfg=cfg, params=params, tokenizer=tok, tokenizer_2=tok,
                  mask_provider=left_right, num_steps=STEPS, **engine_kw)
    loras = [{"unet": unet_lora(params.unet, s)} for s in (1, 2)]
    return eng, loras


@pytest.fixture(scope="module")
def tiny():
    with torch.inference_mode():
        return build(torch.device("cpu"))


def request(loras, seed=3, **kw):
    return dict(prompt=PROMPT, negative_prompt="blurry",
                prompt_rewrite=REWRITE, concept_loras=loras, seed=seed,
                height=H, width=W, fusion_start=FUSION, **kw)


def generate(eng, loras, **kw):
    r = request(loras, **kw)
    with torch.inference_mode():
        return eng.generate(r.pop("prompt"), **r)


def last(root: str) -> profiling.Request:
    req = profiling.REQUESTS[-1]
    assert req.root.name == root
    return req


def check_tree(req: profiling.Request) -> None:
    """Ids are positions, every parent opened before its child and holds
    it in time, one request id for all."""
    assert req.root.parent is None and req.root.span_id == 0
    for i, s in enumerate(req.spans):
        assert s.span_id == i and s.t0 <= s.t1
        if i:
            p = req.spans[s.parent]
            assert s.parent < i and p.t0 <= s.t0 and s.t1 <= p.t1
    assert not req.open


def stage_steps(req, name):
    (stage,) = req.children(req.root, name)
    return req.children(stage, "step")


PATHS = {
    "exact": ({}, {}),
    "crop": ({"concept_crop": True}, {}),
    "deepcache": ({}, {"cache_interval": 2}),
    "controlnet": ({}, {"controlnet": True}),
}


def spatial_controlnet(eng) -> dict:
    """A spatial ControlNet of the engine's UNet geometry and its
    condition image: ``generate``'s keyword arguments."""
    cfg = dataclasses.replace(config.tiny_controlnet(), unet=eng.cfg.unet)
    cn = controlnet.init_params(torch.Generator().manual_seed(5), cfg)
    cond = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    return dict(controlnet_params=cn, spatial_condition=cond)


@pytest.mark.parametrize("path", list(PATHS))
def test_generate_span_tree(path, tiny):
    engine_kw, kw = PATHS[path]
    eng, loras = tiny
    if engine_kw:
        eng = dataclasses.replace(eng, **engine_kw)
    if kw.pop("controlnet", False):
        kw.update(spatial_controlnet(eng))
    generate(eng, loras, **kw)
    req = last("omg.generate")
    check_tree(req)
    assert [s.name for s in req.children(req.root)] == PHASES
    s1, s2 = stage_steps(req, "stage1"), stage_steps(req, "stage2")
    assert [s.attrs["step"] for s in s1] == list(range(STEPS))
    # the trajectory path's stage 2 resumes after the fusion start
    assert [s.attrs["step"] for s in s2] == list(range(FUSION + 1, STEPS))
    # a ControlNet runs on the base lanes before each UNet forward
    cn = ["controlnet"] if path == "controlnet" else []
    for s in s1:
        assert [k.name for k in req.children(s)] == cn + ["unet"]
    # crop: the base lanes and the strips as two forwards a step
    unets = ["unet", "unet"] if path == "crop" else cn + ["unet"]
    for s in s2:
        assert [k.name for k in req.children(s)] == unets


def test_generate_batch_span_tree(tiny):
    eng, loras = tiny
    with torch.inference_mode():
        eng.generate_batch([request(loras, seed=s) for s in (3, 4)])
    req = last("omg.generate_batch")
    check_tree(req)
    assert [s.name for s in req.children(req.root)] == PHASES
    assert len(stage_steps(req, "stage1")) == STEPS
    s2 = stage_steps(req, "stage2")
    assert len(s2) == STEPS - FUSION - 1
    # two requests' 7 lanes in one forward, through every adapted linear
    n_leaves = len(loras[0]["unet"])
    assert {req.total(s, "lora.lane_deltas") for s in s2} == {14 * n_leaves}
    assert {req.total(s, "lora.live_lane_deltas") for s in s2} == {
        8 * n_leaves}
    # no step copies to the card but P2P's one upload of the two pairs'
    # lane index
    assert {req.total(s, "sync") for s in stage_steps(req, "stage1")} == {0}
    assert [req.total(s, "sync") for s in s2] == [1] + [0] * (len(s2) - 1)
    # a single request runs serially: a generate span inside the batch's
    with torch.inference_mode():
        eng.generate_batch([request(loras)])
    req = last("omg.generate_batch")
    (inner,) = req.children(req.root)
    assert inner.name == "omg.generate"
    assert [s.name for s in req.children(inner)] == PHASES


def test_timings_are_the_phase_spans(tiny):
    eng, loras = tiny
    res = generate(eng, loras)
    req = last("omg.generate")
    phases = req.children(req.root)
    assert set(res.timings) == {"encode", "stage1", "decode", "masks",
                                "stage2"}
    # each phase's seconds on the monotonic clock, within the span's
    # host times (time_ns) of the same boundaries
    for name, secs in res.timings.items():
        spans = [p for p in phases if p.name == name]
        assert abs(secs - sum(p.t1 - p.t0 for p in spans) / 1e9) < 1e-3
    # the phases follow each other: both decodes add up
    assert all(a.t1 <= b.t0 for a, b in zip(phases, phases[1:]))
    assert len([p for p in phases if p.name == "decode"]) == 2


def test_sync_counts_and_live_lora_lanes(tiny):
    """No step copies to the card: the sigma, the UNet's timestep and the
    guidance scale are filled on the device, and P2P's lane indices go
    there once a request, in one copy, when the first stage-2 step's first
    edited attention asks for them (``P2PControl.lane_index``)."""
    eng, loras = tiny
    generate(eng, loras)
    req = last("omg.generate")
    assert [req.total(s, "sync") for s in stage_steps(req, "stage1")] == \
        [0] * STEPS
    s2 = stage_steps(req, "stage2")
    assert [req.total(s, "sync") for s in s2] == [1] + [0] * (len(s2) - 1)
    assert req.total(s2[0], "sync_wait_ns") > 0
    assert all(req.total(s, "sync_wait_ns") == 0 for s in s2[1:])
    # K = 2: 3 base lanes carry the zero pad, 4 concept lanes an adapter
    (stage2,) = req.children(req.root, "stage2")
    lanes = req.total(stage2, "lora.lane_deltas")
    live = req.total(stage2, "lora.live_lane_deltas")
    n_leaves = len(loras[0]["unet"])
    assert lanes == 7 * n_leaves * (STEPS - FUSION - 1)
    assert 100.0 * live / lanes == pytest.approx(400.0 / 7)
    (stage1,) = req.children(req.root, "stage1")
    assert req.total(stage1, "lora.lane_deltas") == 0


def test_lora_lanes_are_counted_where_the_deltas_run(tiny):
    """The lane counters count each adapted linear's rows as its delta is
    computed: a DeepCache shallow forward runs fewer linears than a full
    one, a rank's lane slice only its lanes, and the live share stays the
    stack's."""
    eng, loras = tiny
    generate(eng, loras, cache_interval=2)
    req = last("omg.generate")
    s2 = stage_steps(req, "stage2")
    per = [req.total(s, "lora.lane_deltas") for s in s2]
    # the tiny UNet's shallow path holds no attention: no delta at all
    n_leaves = len(loras[0]["unet"])
    assert sorted(set(per)) == [0, 7 * n_leaves]
    for s in s2:
        assert 7 * req.total(s, "lora.live_lane_deltas") == \
            4 * req.total(s, "lora.lane_deltas")
    stack = lora_lib.stack_loras([None, loras[0]["unet"]], repeat=2)
    key = next(iter(stack))
    lin = next(m for m in eng.params.unet.modules()
               if isinstance(m, layers.Linear) and m.lora_key == key)
    x = torch.zeros(2, 3, lin.weight.shape[1])
    for lo, live in ((0, 0), (1, 1), (2, 2)):
        with profiling.request("x"):
            with torch.inference_mode():
                lin(x, lora_lib.lane_slice(stack, lo, lo + 2))
        (span,) = profiling.REQUESTS[-1].spans
        assert span.counters == {"lora.lane_deltas": 2,
                                 "lora.live_lane_deltas": live,
                                 "lora.gemm_accumulated": 2}


@pytest.mark.parametrize("entry", ["generate", "generate_batch",
                                   "text_to_image"])
def test_lora_deltas_accumulate_in_the_gemm(tiny, entry):
    """Every lane delta of stage 2 (``text_to_image``: of its denoise) is
    added by the accumulate of a GEMM: ``lora.gemm_accumulated`` counts
    what ``lora.lane_deltas`` counts."""
    eng, loras = tiny
    if entry == "text_to_image":
        text_to_image(eng.cfg, eng.params, lora=loras[0]["unet"])
        req, phase = last("sdxl.text_to_image"), "denoise"
    else:
        if entry == "generate":
            generate(eng, loras)
        else:
            with torch.inference_mode():
                eng.generate_batch([request(loras, seed=s) for s in (3, 4)])
        req, phase = last(f"omg.{entry}"), "stage2"
    (span,) = req.children(req.root, phase)
    lanes = req.total(span, "lora.lane_deltas")
    assert lanes > 0 and req.total(span, "lora.gemm_accumulated") == lanes


@pytest.mark.parametrize("layout", ["int8", "rows"])
def test_no_gemm_accumulate_off_the_float_path(layout):
    """A W8A8 projection (its product comes back dequantized) and a
    row-split one (its partial products are summed over the group before
    the bias; here a group of one rank) add each delta as a tensor of its
    own: ``lora.gemm_accumulated`` stays 0, the lane counts as before."""
    with torch.inference_mode():
        eng, loras = build(torch.device("cpu"),
                           **({"quantize": "int8"} if layout == "int8"
                              else {}))
    unet = eng.params.unet
    if layout == "int8":
        assert all(isinstance(m, layers.QuantLinear)
                   for m in unet.modules() if isinstance(m, layers.Linear)
                   and m.lora_key in loras[0]["unet"])
    else:
        one = comm.Group((0,), 0)
        for m in unet.modules():
            if isinstance(m, layers.Linear) and m.lora_key.endswith(
                    "to_out.0"):
                m.tp = layers.TPSplit(1, mesh.Split(m.weight.shape[1], one))
        loras = [{"unet": {k: v for k, v in lo["unet"].items()
                           if k.endswith("to_out.0")}} for lo in loras]
    generate(eng, loras)
    req = last("omg.generate")
    (stage2,) = req.children(req.root, "stage2")
    n_leaves = len(loras[0]["unet"])
    assert req.total(stage2, "lora.lane_deltas") == \
        7 * n_leaves * (STEPS - FUSION - 1)
    assert 7 * req.total(stage2, "lora.live_lane_deltas") == \
        4 * req.total(stage2, "lora.lane_deltas")
    assert req.total(stage2, "lora.gemm_accumulated") == 0


def text_to_image(cfg, params, lora=None, steps=3):
    ids = torch.as_tensor(ToyTokenizer()(["a photo"] * 2), dtype=torch.long)
    with torch.inference_mode():
        return sdxl.text_to_image(
            cfg, params, ids1_pos=ids, ids2_pos=ids, ids1_neg=ids,
            ids2_neg=ids, generator=torch.Generator().manual_seed(0),
            height=H, width=W, steps=steps, lora=lora)


def test_text_to_image_span_tree(tiny):
    eng, loras = tiny
    text_to_image(eng.cfg, eng.params, lora=loras[0]["unet"])
    req = last("sdxl.text_to_image")
    check_tree(req)
    assert [s.name for s in req.children(req.root)] == ["encode", "denoise",
                                                        "decode"]
    steps = stage_steps(req, "denoise")
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    for s in steps:
        (u,) = req.children(s)
        assert u.name == "unet"
        # the sigma and the timestep are filled on the device, and the
        # guidance scale is there already
        assert req.total(s, "sync") == 0
        assert u.counters["lora.live_lane_deltas"] == \
            u.counters["lora.lane_deltas"] == 4 * len(loras[0]["unet"])


def test_requests_stay_bounded_and_failures_leave_a_record(tiny,
                                                           monkeypatch):
    first = profiling.REQUESTS[-1].rid if profiling.REQUESTS else 0
    for _ in range(70):
        with profiling.request("x"):
            with profiling.span("y"):
                profiling.count("n")
    assert len(profiling.REQUESTS) == profiling.REQUESTS.maxlen == 64
    assert [r.rid for r in profiling.REQUESTS] == list(
        range(first + 7, first + 71))
    assert profiling.REQUESTS[-1].spans[1].counters == {"n": 1}

    def fail(*a, **kw):
        with profiling.span("inside"):
            raise RuntimeError("stage 2 failed")
    monkeypatch.setattr(multiconcept, "sample_stage2_resumed", fail)
    eng, loras = tiny
    with pytest.raises(RuntimeError, match="stage 2 failed"):
        generate(eng, loras)
    req = last("omg.generate")
    check_tree(req)
    assert [s.name for s in req.children(req.root)] == PHASES[:5]
    assert req.spans[-1].name == "inside"
    assert profiling._LOCAL.request is None
    # no request open: spans and counts record nothing
    with profiling.span("alone") as s:
        profiling.count("n")
    assert s is None and profiling.REQUESTS[-1] is req


class CountingRange:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_profiler_no_range(tiny, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        CountingRange)
    CountingRange.entered = 0
    eng, loras = tiny
    generate(eng, loras)
    assert CountingRange.entered == 0


def test_spans_are_profiler_ranges_on_its_clock(tiny):
    from torch.profiler import ProfilerActivity, profile
    eng, loras = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        text_to_image(eng.cfg, eng.params, steps=2)
    req = last("sdxl.text_to_image")
    names = {s.name for s in req.spans}
    starts: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            starts.setdefault(e.name(), []).append(e.start_ns())
    for s in req.spans:
        gap = min(abs(t - s.t0) for t in starts[s.name])
        assert gap <= 2e6, (s.name, gap)
    assert len(starts["step"]) == 2 and len(starts["unet"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["generate", "generate_batch",
                                   "text_to_image"])
def test_no_uncounted_sync_on_the_card(entry, monkeypatch):
    """Under CUDA's sync debug mode, every synchronizing call that a tiny
    request makes from the program's code is made in ``profiling.sync``
    (the phases' ``torch.cuda.synchronize`` does not warn), and none is
    made inside a denoise step but P2P's one upload of its lane indices
    in an OMG request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debug mode is CUDA's")
    dev = torch.device("cuda")
    with torch.inference_mode():
        eng, loras = build(dev)

    def run():
        if entry == "generate":
            generate(eng, loras)
        elif entry == "generate_batch":
            with torch.inference_mode():
                eng.generate_batch([request(loras, seed=s) for s in (3, 4)])
        else:
            text_to_image(eng.cfg, eng.params, lora=loras[0]["unet"])

    run()                                   # warm
    torch.cuda.synchronize()
    sites, in_step = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            program = [f for f in traceback.extract_stack()
                       if "omg_tpu_torch" in f.filename]
            sites.append(program[-1] if program else None)
            req = profiling._LOCAL.request
            if req is not None and any(s.name == "step" for s in req.open):
                in_step.append(program[-2].name if len(program) > 1
                               else None)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        monkeypatch.setattr(warnings, "showwarning", show)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    mine = [f for f in sites if f is not None]
    outside = {(f.filename, f.lineno, f.name) for f in mine
               if (f.filename, f.name) != (profiling.__file__, "sync")}
    assert mine and not outside, outside
    req = profiling.REQUESTS[-1]
    assert req.total(req.root, "sync") >= len(mine)
    assert set(in_step) <= ({"lane_index"} if entry != "text_to_image"
                            else set()), in_step
    steps = [s for s in req.spans if s.name == "step"]
    assert sum(req.total(s, "sync") for s in steps) == \
        (0 if entry == "text_to_image" else 1)
