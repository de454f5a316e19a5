"""Stage 1's CUDA graphs: ``models/unet.py``'s ``graphed`` forward and
its engage rule in ``pipelines/multiconcept.py`` (``_graphs_engage``).

The CPU tests hold the timestep's device form to the host number's bits,
the rule to what it observes, and the loop's static inputs to each step's
values, through a stand-in capture that runs the forward's body on the
graph's static buffers. The tests marked ``cuda`` need an NVIDIA GPU and
skip elsewhere. This file imports no jax, so on the GPU machine they run
alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/port/test_torch_stage1_graphs.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from omg_tpu_torch import config
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.models import controlnet
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.tools import serve_bench
from omg_tpu_torch.utils import profiling
from test_torch_tracing import (  # noqa: F401 (a fixture)
    left_right, one_torch_thread, tiny_cfg, unet_lora)

STEPS = 6
FUSION = 0          # stage 1: ranges [0, 1) and [1, 6); stage 2: 1..5
PROMPT = "a man and a woman in a park"
REWRITE = "[the man]-*-[b]|[the woman]-*-[b]"
GRAPH_KEYS = ("graph.captures", "graph.replays")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def card_cfg() -> sdxl.SDXLConfig:
    """A small bf16 SDXL whose level-0 self-attention is K1's: one head of
    64 over the 32 x 32 latent of a 256² image; level 2 has P2P's
    (H/32)(W/32) tokens."""
    bf16 = dict(dtype=torch.bfloat16)
    u = dataclasses.replace(config.tiny_unet(),
                            block_out_channels=(64, 64, 128),
                            transformer_layers_per_block=(1, 1, 1),
                            attention_head_dim=64, **bf16)
    c = sdxl.tiny_config()
    return c._replace(
        unet=u, text_encoder=dataclasses.replace(c.text_encoder, **bf16),
        text_encoder_2=dataclasses.replace(c.text_encoder_2, **bf16))


def build(cfg, device):
    with torch.inference_mode():
        params = sdxl.init_params(torch.Generator(device).manual_seed(0), cfg)
        tok = ToyTokenizer()
        eng = omg.OMG(cfg=cfg, params=params, tokenizer=tok, tokenizer_2=tok,
                      mask_provider=left_right, num_steps=STEPS)
        loras = [{"unet": unet_lora(params.unet, s)} for s in (1, 2)]
    return eng, loras


def request(loras, size, seed=3, **kw):
    return dict(prompt=PROMPT, negative_prompt="blurry",
                prompt_rewrite=REWRITE, concept_loras=loras, seed=seed,
                height=size, width=size, fusion_start=FUSION, **kw)


def run(eng, loras, size, entry="generate", **kw):
    """One tiny request (two for ``generate_batch``) -> (results, the
    request's record)."""
    with torch.inference_mode():
        if entry == "generate":
            r = request(loras, size, **kw)
            out = [eng.generate(r.pop("prompt"), **r)]
        else:
            out = eng.generate_batch([request(loras, size, seed=s, **kw)
                                      for s in (3, 4)])
    return out, profiling.REQUESTS[-1]


def stage1_steps(req) -> list:
    return [s for p in req.children(req.root, "stage1")
            for s in req.children(p, "step")]


def graph_counts(req) -> tuple:
    return tuple(sum(req.total(s, k) for s in stage1_steps(req))
                 for k in GRAPH_KEYS)


def recorded_steps(monkeypatch) -> list:
    """Every scheduler step's (input latents, guided eps, output latents),
    as the loops call ``schedulers.step`` through its module."""
    seen = []
    step = schedulers.step

    def wrapped(sched, state, guided, i, x, **kw):
        out, st = step(sched, state, guided, i, x, **kw)
        seen.append((x.clone(), guided.clone(), out.clone()))
        return out, st
    monkeypatch.setattr(schedulers, "step", wrapped)
    return seen


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("timestep", [1, 21, 261, 501, 981, 999])
def test_time_embeddings_of_a_device_timestep(timestep):
    """A 0-dim fp32 tensor holding the timestep (a graph's static input)
    gives the host number's bits."""
    cfg = config.tiny_unet()
    with torch.inference_mode():
        model = unet_lib.init_params(torch.Generator().manual_seed(0), cfg)
        g = torch.Generator().manual_seed(timestep)
        pdim = (model.add_embedding.linear_1.weight.shape[1]
                - 6 * cfg.addition_time_embed_dim)
        text = torch.randn((3, pdim), generator=g)
        tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]]).expand(3, 6)
        want = unet_lib.time_embeddings(model, cfg, timestep, text, tids)
        t = torch.full((), float(timestep), dtype=torch.float32)
        got = unet_lib.time_embeddings(model, cfg, t, text, tids)
    assert bits_equal(got, want)


@pytest.mark.parametrize("case,want", [
    ("card", True), ("cpu", False), ("deepcache", False),
    ("deepcache_schedule", False), ("controlnet", False)])
def test_the_engage_rule(case, want):
    """Graphs engage on latents on a card with no DeepCache and no base
    ControlNet, and nowhere else."""
    x = types.SimpleNamespace(is_cuda=case != "cpu")
    spec = {"deepcache": 2,
            "deepcache_schedule": multiconcept.deepcache_schedule(
                STEPS, 2)}.get(case, 0)
    cns = [object()] if case == "controlnet" else []
    dc = multiconcept._DeepCache(spec, 0)
    assert multiconcept._graphs_engage(x, dc, cns) is want


def test_a_capture_leaves_its_launches_to_the_replays():
    """Launches made while ``recorded`` (a capture, which runs nothing)
    count nowhere; each replay passes them to ``count_launch``, which a
    tally by shape sees as it sees an eager launch."""
    n, seq = fa.LAUNCHES, fa.SEQ_LAUNCHES
    tally: dict = {}
    with serve_bench.k1_launches(tally):
        with fa.recorded() as k1:
            fa.count_launch((2, 10, 4096, 64), False)
            fa.count_launch((2, 20, 512, 64), True)
        assert (fa.LAUNCHES, fa.SEQ_LAUNCHES, tally["by_shape"]) == (
            n, seq, {})
        for _ in range(2):                  # two replays
            for launch in k1:
                fa.count_launch(*launch)
    assert k1 == [((2, 10, 4096, 64), False), ((2, 20, 512, 64), True)]
    assert (fa.LAUNCHES, fa.SEQ_LAUNCHES) == (n + 2, seq + 2)
    assert tally == {"by_shape": {"2,10,4096,64": 2}, "launches": 2}


@pytest.fixture(scope="module")
def tiny():
    return build(tiny_cfg(), torch.device("cpu"))


def spatial_controlnet(eng, size) -> dict:
    cfg = dataclasses.replace(config.tiny_controlnet(), unet=eng.cfg.unet)
    with torch.inference_mode():
        cn = controlnet.init_params(torch.Generator().manual_seed(5), cfg)
    cond = np.random.default_rng(5).integers(0, 256, (size, size, 3),
                                             np.uint8)
    return dict(controlnet_params=cn, spatial_condition=cond)


@pytest.mark.parametrize("path", ["exact", "batch", "deepcache",
                                  "controlnet"])
def test_cpu_runs_never_capture(path, tiny, monkeypatch):
    """On the CPU no run captures or replays, with or without DeepCache or
    a ControlNet, and the UNet is only ever called eagerly."""
    eng, loras = tiny
    calls = []
    hook = eng.params.unet.register_forward_pre_hook(
        lambda m, a, kw: calls.append(kw.get("graphed", False)),
        with_kwargs=True)
    kw = {"deepcache": {"cache_interval": 2},
          "controlnet": spatial_controlnet(eng, 64)}.get(path, {})
    try:
        _, req = run(eng, loras, 64,
                     "generate_batch" if path == "batch" else "generate",
                     **kw)
    finally:
        hook.remove()
    assert stage1_steps(req)
    assert graph_counts(req) == (0, 0)
    assert not any(k in s.counters for s in req.spans for k in GRAPH_KEYS)
    assert calls and not any(calls)


def cpu_capture(replays: list):
    """A stand-in for ``_Graph._capture`` on the CPU: the 'graph' runs the
    forward's body on the static buffers at each replay, and notes the
    timestep and sample it found there."""
    def capture(self, unet, graphs):
        sample, ctx, text_embeds, time_ids = self.inputs

        def replay():
            replays.append((float(self.t), sample.clone()))
            self.out.copy_(unet._forward(sample, self.t, ctx,
                                         text_embeds=text_embeds,
                                         time_ids=time_ids))
        self.graph = types.SimpleNamespace(replay=replay)
        return torch.empty_like(sample), []
    return capture


@pytest.mark.parametrize("entry", ["generate", "generate_batch"])
def test_each_step_fills_the_static_inputs(entry, tiny, monkeypatch):
    """With the rule let through on the CPU and a capture that runs the
    forward's body on the graph's buffers, every replay finds its step's
    timestep and scaled latents there: each scheduler step, and the
    images, equal the eager run's bit for bit. The key's first forward is
    eager, its second captures; the hooked UNet call still sees one
    forward a step with 2R rows."""
    eng, loras = tiny
    R = 2 if entry == "generate_batch" else 1
    eager_steps = recorded_steps(monkeypatch)
    eager, _ = run(eng, loras, 64, entry)
    monkeypatch.undo()

    replays, inputs = [], []
    monkeypatch.setattr(multiconcept, "_graphs_engage",
                        lambda x, dc, cns: not dc.on and not cns)
    monkeypatch.setattr(unet_lib._Graph, "_capture", cpu_capture(replays))
    hook = eng.params.unet.register_forward_pre_hook(
        lambda m, a, kw: inputs.append((kw.get("graphed", False),
                                        a[0].shape[0], a[1], a[0].clone())),
        with_kwargs=True)
    graph_steps = recorded_steps(monkeypatch)
    try:
        graphed, req = run(eng, loras, 64, entry)
    finally:
        hook.remove()
        unet_lib._GRAPHS.pop(eng.params.unet, None)

    assert len(graph_steps) == len(eager_steps)
    for a, b in zip(graph_steps, eager_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))
    for a, b in zip(graphed, eager):
        assert np.array_equal(a.stage1, b.stage1)
        assert np.array_equal(a.stage2, b.stage2)
    stage1 = [c for c in inputs if c[0]]
    assert [c[1] for c in stage1] == [2 * R] * STEPS
    # replays from the key's second forward: each its step's timestep
    # and the latents the hooked call was given
    assert len(replays) == STEPS - 1
    for (t, sample), (_, _, t_in, x_in) in zip(replays, stage1[1:]):
        assert t == float(t_in)
        assert bits_equal(sample, x_in)
    assert len({t for t, _ in replays}) == STEPS - 1
    assert graph_counts(req) == (1, STEPS - 1)


# ---------------------------------------------------------------- card

CARD = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are the card's")
    return build(card_cfg(), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["generate", "generate_batch"])
def test_graphed_stage1_equals_eager_on_the_card(entry, card, monkeypatch):
    """On the card, stage 1 from graphs gives the eager run's latents to
    the last bit, at every scheduler step of both stages, with the same
    K1 launches, by shape too; ``graph.replays`` counts every stage-1
    step but the key's eager first, and the hooked UNet call fires once
    a step with 2R rows."""
    eng, loras = card
    R = 2 if entry == "generate_batch" else 1
    unet_lib._GRAPHS.pop(eng.params.unet, None)
    monkeypatch.setattr(multiconcept, "_graphs_engage",
                        lambda x, dc, cns: False)
    run(eng, loras, CARD, entry)                      # warm
    eager_steps = recorded_steps(monkeypatch)
    with serve_bench.k1_launches({}) as eager_k1:
        eager, _ = run(eng, loras, CARD, entry)
    assert eager_k1["launches"] > 0
    monkeypatch.undo()

    lanes = []
    hook = eng.params.unet.register_forward_pre_hook(
        lambda m, a, kw: lanes.append(a[0].shape[0]) if kw.get("graphed")
        else None, with_kwargs=True)
    try:
        first, req1 = run(eng, loras, CARD, entry)    # eager, then capture
        graph_steps = recorded_steps(monkeypatch)
        with serve_bench.k1_launches({}) as graph_k1:
            graphed, req2 = run(eng, loras, CARD, entry)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    assert graph_counts(req1) == (1, STEPS - 1)
    assert graph_counts(req2) == (0, STEPS)
    assert lanes == [2 * R] * (2 * STEPS)
    assert graph_k1 == eager_k1
    assert len(graph_steps) == len(eager_steps)
    for a, b in zip(graph_steps, eager_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))
    for a, b in zip(graphed, eager):
        assert np.array_equal(a.stage1, b.stage1)
        assert np.array_equal(a.stage2, b.stage2)
    for a, b in zip(first, eager):
        assert np.array_equal(a.stage2, b.stage2)
