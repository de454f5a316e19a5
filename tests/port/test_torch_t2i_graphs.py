"""The text-to-image denoise's CUDA graphs: ``pipelines/sdxl.py``'s engage
rule (``_graphs_engage``) and ``models/unet.py``'s ``graphed`` forward
with a request's LoRA factors, captured once a request.

The CPU tests drive the loop through a stand-in capture that runs the
forward's body once when it captures, as a real capture runs the Python
(so what it counts is recorded there), and again at each replay on the
graph's static buffers with the factors it was captured with, counting
nothing of its own, as a real replay runs no Python. The test marked
``cuda`` needs an NVIDIA GPU and skips elsewhere. This file imports no
jax, so on the GPU machine it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/port/test_torch_t2i_graphs.py
"""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.pipelines import multiconcept, omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.tools import serve_bench
from omg_tpu_torch.utils import profiling
import test_torch_stage1_graphs as s1
from test_torch_stage1_graphs import bits_equal, card_cfg, recorded_steps
from test_torch_tracing import (  # noqa: F401 (a fixture)
    left_right, one_torch_thread, tiny_cfg, unet_lora)

STEPS = 6
GRAPH_KEYS = ("graph.captures", "graph.replays")
LORA_KEYS = ("lora.lane_deltas", "lora.live_lane_deltas",
             "lora.gemm_accumulated")


def build(cfg, device):
    with torch.inference_mode():
        params = sdxl.init_params(torch.Generator(device).manual_seed(0), cfg)
        adapters = [unet_lora(params.unet, s) for s in (1, 2)]
    return cfg, params, adapters


def t2i(cfg, params, lora, size, seed=0):
    """One request of one image -> (image, the request's record)."""
    ids = torch.as_tensor(ToyTokenizer()(["a photo of a cat"]),
                          dtype=torch.long)
    with torch.inference_mode():
        img = sdxl.text_to_image(
            cfg, params, ids1_pos=ids, ids2_pos=ids, ids1_neg=ids,
            ids2_neg=ids, generator=torch.Generator().manual_seed(seed),
            height=size, width=size, steps=STEPS, lora=lora)
    req = profiling.REQUESTS[-1]
    assert req.root.name == "sdxl.text_to_image"
    return img, req


def steps_of(req) -> list:
    return [s for p in req.children(req.root, "denoise")
            for s in req.children(p, "step")]


def graph_counts(req) -> tuple:
    return tuple(sum(req.total(s, k) for s in steps_of(req))
                 for k in GRAPH_KEYS)


def graphs_of(unet) -> dict:
    return unet_lib._GRAPHS[unet].by_key


def cpu_capture(replays: list):
    """A stand-in for ``_Graph._capture`` on the CPU. Capturing runs the
    forward's body once, inside the caller's recorders; the 'graph' runs
    it again at each replay on the static buffers with the factor tensors
    it was captured with, counting nothing, and notes the timestep, the
    sample and the factors. As a real graph keeps the tensors' addresses
    and not the request's ``LoraFactors``, it holds the tensors and not
    the object: a graph replayed after its request would add that
    request's deltas."""
    def capture(self, unet, graphs):
        sample, ctx, text_embeds, time_ids = self.inputs
        lora = self.lora()
        if lora is not None:
            groups = lora.groups
            lora = layers.LoraFactors(lora, lora.live)
            lora.groups = groups

        def body():
            return unet._forward(sample, self.t, ctx,
                                 text_embeds=text_embeds, time_ids=time_ids,
                                 lora=lora)

        with fa.recorded() as k1:
            out = body()

        def replay():
            replays.append((float(self.t), sample.clone(), lora))
            with fa.recorded(), profiling.recorded():
                self.out.copy_(body())
        self.graph = types.SimpleNamespace(replay=replay)
        return out, k1
    return capture


def graphs_on_the_cpu(monkeypatch, replays: list) -> None:
    monkeypatch.setattr(sdxl, "_graphs_engage", lambda x: True)
    monkeypatch.setattr(unet_lib._Graph, "_capture", cpu_capture(replays))


# ---------------------------------------------------------------- CPU

@pytest.fixture(scope="module")
def tiny():
    return build(tiny_cfg(), torch.device("cpu"))


@pytest.fixture(autouse=True)
def no_graphs_left(tiny):
    yield
    unet_lib._GRAPHS.pop(tiny[1].unet, None)


@pytest.mark.parametrize("where,want", [("card", True), ("cpu", False)])
def test_the_engage_rule(where, want):
    """The denoise graphs its forwards where its latents are on a card,
    and nowhere else."""
    x = types.SimpleNamespace(is_cuda=where == "card")
    assert sdxl._graphs_engage(x) is want


def test_cpu_runs_never_capture(tiny):
    """On the CPU the UNet is only ever called eagerly, and no step
    counts a capture or a replay."""
    cfg, params, adapters = tiny
    calls = []
    hook = params.unet.register_forward_pre_hook(
        lambda m, a, kw: calls.append(kw.get("graphed", False)),
        with_kwargs=True)
    try:
        _, req = t2i(cfg, params, adapters[0], 64)
    finally:
        hook.remove()
    assert len(calls) == STEPS and not any(calls)
    assert graph_counts(req) == (0, 0)
    assert params.unet not in unet_lib._GRAPHS


@pytest.mark.parametrize("adapter", ["lora", "none"])
def test_each_step_fills_the_static_inputs(adapter, tiny, monkeypatch):
    """With the rule let through on the CPU, every replay finds its
    step's timestep and scaled latents in the graph's buffers: each
    scheduler step, and the image, equal the eager run's bit for bit,
    with a LoRA and without. The first forward is eager, the second
    captures; the hooked UNet call still sees one 2-lane forward a
    step."""
    cfg, params, adapters = tiny
    lora = adapters[0] if adapter == "lora" else None
    eager_steps = recorded_steps(monkeypatch)
    eager, _ = t2i(cfg, params, lora, 64)
    monkeypatch.undo()

    replays, inputs = [], []
    graphs_on_the_cpu(monkeypatch, replays)
    hook = params.unet.register_forward_pre_hook(
        lambda m, a, kw: inputs.append((kw.get("graphed", False),
                                        a[0].shape[0], a[1], a[0].clone())),
        with_kwargs=True)
    graph_steps = recorded_steps(monkeypatch)
    try:
        graphed, req = t2i(cfg, params, lora, 64)
    finally:
        hook.remove()

    assert len(graph_steps) == len(eager_steps) == STEPS
    for a, b in zip(graph_steps, eager_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))
    assert bits_equal(graphed, eager)
    assert [c[:2] for c in inputs] == [(True, 2)] * STEPS
    assert len(replays) == STEPS - 1
    for (t, sample, _), (_, _, t_in, x_in) in zip(replays, inputs[1:]):
        assert t == float(t_in)
        assert bits_equal(sample, x_in)
    assert len({t for t, _, _ in replays}) == STEPS - 1
    assert graph_counts(req) == (1, STEPS - 1)


def test_each_request_captures_its_own_adapter(tiny, monkeypatch):
    """Two requests with different adapters, one after the other, each
    give their own eager run's image and steps: the second request's
    first forward is eager, its second captures a graph of its own
    factors, which then replaces the first request's graph. A graph kept
    across the requests would replay the first adapter's factors."""
    cfg, params, adapters = tiny
    eager = []
    for lora in adapters:
        with monkeypatch.context() as m:
            steps = recorded_steps(m)
            img, _ = t2i(cfg, params, lora, 64)
        eager.append((img, steps))
    assert not bits_equal(eager[0][0], eager[1][0])

    replays: list = []
    graphs_on_the_cpu(monkeypatch, replays)
    firsts = []
    for (want, want_steps), lora in zip(eager, adapters):
        with monkeypatch.context() as m:
            steps = recorded_steps(m)
            img, req = t2i(cfg, params, lora, 64)
        assert bits_equal(img, want)
        for a, b in zip(steps, want_steps):
            assert all(bits_equal(x, y) for x, y in zip(a, b))
        assert graph_counts(req) == (1, STEPS - 1)
        (g,) = graphs_of(params.unet).values()
        assert isinstance(g, unet_lib._Graph)
        firsts.append(weakref.ref(g))
        del g
    gc.collect()
    assert firsts[0]() is None and firsts[1]() is not None
    factors = [f for _, _, f in replays]
    assert len(factors) == 2 * (STEPS - 1)
    a, b = factors[:STEPS - 1], factors[STEPS - 1:]
    assert all(f is a[0] for f in a) and all(f is b[0] for f in b)
    assert a[0] is not b[0]
    assert set(a[0]) == set(adapters[0])


@pytest.mark.parametrize("order", [("lora", "none"),
                                   ("none", "lora", "none")])
def test_a_request_without_factors_after_one_with_them(order, tiny,
                                                       monkeypatch):
    """A request without a LoRA after one with a LoRA, at the same key,
    gives its eager run's image and captures a graph of its own: the
    earlier request's graph read factors that went with it, and a replay
    of it would add their deltas."""
    cfg, params, adapters = tiny
    loras = {"lora": adapters[0], "none": None}
    eager = {}
    for name in set(order):
        eager[name], _ = t2i(cfg, params, loras[name], 64)
    assert not bits_equal(eager["lora"], eager["none"])

    graphs_on_the_cpu(monkeypatch, [])
    for name in order:
        img, req = t2i(cfg, params, loras[name], 64)
        assert graph_counts(req) == (1, STEPS - 1)
        assert bits_equal(img, eager[name])
        assert len(graphs_of(params.unet)) == 1


def test_stage1_after_a_lora_request_on_one_unet(tiny, monkeypatch):
    """OMG's stage 1 (no factors) after a t2i request with a LoRA on the
    same UNet, at the same key: stage 1 captures anew and gives its
    eager run's latents at every step."""
    cfg, params, adapters = tiny
    with torch.inference_mode():
        tok = ToyTokenizer()
        eng = omg.OMG(cfg=cfg, params=params, tokenizer=tok,
                      tokenizer_2=tok, mask_provider=left_right,
                      num_steps=STEPS)
    loras = [{"unet": a} for a in adapters]

    def stage1(m):
        steps = recorded_steps(m)
        out, req = s1.run(eng, loras, 64)
        return out[0].stage1, steps, req
    with monkeypatch.context() as m:
        want, want_steps, _ = stage1(m)

    graphs_on_the_cpu(monkeypatch, [])
    monkeypatch.setattr(multiconcept, "_graphs_engage",
                        lambda x, dc, cns: not dc.on and not cns)
    t2i(cfg, params, adapters[0], 64)
    (t2i_key,) = graphs_of(params.unet)
    with monkeypatch.context() as m:
        got, steps, req = stage1(m)
    assert set(graphs_of(params.unet)) == {t2i_key}
    assert s1.graph_counts(req) == (1, STEPS - 1)
    assert len(steps) == len(want_steps) > STEPS
    for a, b in zip(steps, want_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(got, want)


def test_a_graph_holds_its_factors_weakly():
    """A graph refers to its request's factors weakly: once the request
    drops them, the key serves no later call, whatever factors it
    brings, none included; a key without factors serves calls without
    them."""
    f = layers.LoraFactors({"k": {"down": torch.ones(2, 1),
                                  "up": torch.ones(1, 2)}})
    seen = unet_lib._Seen(f, None)
    assert seen.lora() is f
    del f
    gc.collect()
    assert seen.lora() is unet_lib._GONE
    assert unet_lib._Seen(None, None).lora() is None
    # a key's eager call with new factors keeps its graph, not a chain
    graph = object()
    first = unet_lib._Seen(None, graph)
    assert unet_lib._Seen(None, first).prev is graph


def test_a_graphed_step_counts_what_an_eager_step_counts(tiny,
                                                         monkeypatch):
    """Each step of a graphed run counts in its spans the LoRA deltas and
    K1 launches of the eager run's step (each forward's last layer
    stands in for a K1 launch here, none being made on the CPU): the
    capture records them, and every replay counts them again."""
    cfg, params, adapters = tiny
    head = unet_lib.UNet2DConditionModel._head

    def launching_head(self, x, seq):
        fa.count_launch((x.shape[0], 1, 1, 1), False)
        return head(self, x, seq)
    monkeypatch.setattr(unet_lib.UNet2DConditionModel, "_head",
                        launching_head)
    monkeypatch.setattr(fa, "count_launch",
                        lambda shape, seq_local: profiling.count("k1", 1))
    keys = LORA_KEYS + ("k1",)

    def counts(req):
        return [{k: req.total(s, k) for k in keys} for s in steps_of(req)]
    _, eager = t2i(cfg, params, adapters[0], 64)
    replays: list = []
    graphs_on_the_cpu(monkeypatch, replays)
    with serve_bench.k1_launches({}) as tally:
        _, graphed = t2i(cfg, params, adapters[0], 64)
    assert tally["launches"] == 0       # each went to the stand-in's count
    want = counts(eager)
    assert want[0]["k1"] == 1 and all(v > 0 for v in want[0].values())
    assert want == [want[0]] * STEPS
    assert counts(graphed) == want
    assert graph_counts(graphed) == (1, STEPS - 1)


# ---------------------------------------------------------------- card

CARD = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are the card's")
    return build(card_cfg(), torch.device("cuda"))


@pytest.mark.cuda
def test_graphed_text_to_image_equals_eager_on_the_card(card, monkeypatch):
    """On the card, two requests with different adapters, graphed one
    after the other, give their eager runs' latents at every scheduler
    step and their images to the last bit, with the same K1 launches by
    shape. Each request captures once; the second request's capture
    releases the first's graph, and what stays allocated after a request
    does not grow: no request's factors outlive it."""
    cfg, params, adapters = card
    unet_lib._GRAPHS.pop(params.unet, None)
    monkeypatch.setattr(sdxl, "_graphs_engage", lambda x: False)
    t2i(cfg, params, adapters[0], CARD)                 # warm
    eager = []
    for lora in adapters:
        with monkeypatch.context() as m, \
                serve_bench.k1_launches({}) as k1:
            steps = recorded_steps(m)
            img, _ = t2i(cfg, params, lora, CARD)
        eager.append((img, steps, k1))
    monkeypatch.undo()
    assert eager[0][2]["launches"] > 0
    assert not bits_equal(eager[0][0], eager[1][0])

    refs, held = [], []
    for (want, want_steps, want_k1), lora in zip(eager, adapters):
        with monkeypatch.context() as m, \
                serve_bench.k1_launches({}) as k1:
            steps = recorded_steps(m)
            img, req = t2i(cfg, params, lora, CARD)
        torch.cuda.synchronize()
        assert graph_counts(req) == (1, STEPS - 1)
        assert k1 == want_k1
        assert bits_equal(img, want)
        assert len(steps) == len(want_steps) == STEPS
        for a, b in zip(steps, want_steps):
            assert all(bits_equal(x, y) for x, y in zip(a, b))
        (g,) = graphs_of(params.unet).values()
        refs.append(weakref.ref(g))
        del g, steps
        gc.collect()
        held.append(torch.cuda.memory_allocated())
    assert refs[0]() is None and refs[1]() is not None
    assert held[1] == held[0]


@pytest.mark.cuda
def test_requests_without_factors_after_a_lora_request_on_the_card(
        card, monkeypatch):
    """On the card, a t2i request without a LoRA after one with a LoRA,
    and OMG's stage 1 after a t2i request with a LoRA, on one UNet at one
    key: each captures a graph of its own and gives its eager run's
    output to the last bit, at every scheduler step; none replays a
    graph that read freed factors."""
    cfg, params, adapters = card
    with torch.inference_mode():
        tok = ToyTokenizer()
        eng = omg.OMG(cfg=cfg, params=params, tokenizer=tok,
                      tokenizer_2=tok, mask_provider=left_right,
                      num_steps=STEPS)
    loras = [{"unet": a} for a in adapters]
    unet_lib._GRAPHS.pop(params.unet, None)
    with monkeypatch.context() as m:
        m.setattr(sdxl, "_graphs_engage", lambda x: False)
        m.setattr(multiconcept, "_graphs_engage", lambda x, dc, cns: False)
        s1.run(eng, loras, CARD)                        # warm
        want_steps = recorded_steps(m)
        want, _ = t2i(cfg, params, None, CARD)
        n = len(want_steps)
        (want_s1,), _ = s1.run(eng, loras, CARD)
        want_s1_steps = want_steps[n:]
        want_steps = want_steps[:n]

    t2i(cfg, params, adapters[0], CARD)
    (key,) = graphs_of(params.unet)
    with monkeypatch.context() as m:
        steps = recorded_steps(m)
        img, req = t2i(cfg, params, None, CARD)
    torch.cuda.synchronize()
    assert graph_counts(req) == (1, STEPS - 1)
    assert bits_equal(img, want)
    assert len(steps) == len(want_steps) == STEPS
    for a, b in zip(steps, want_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))

    t2i(cfg, params, adapters[1], CARD)
    with monkeypatch.context() as m:
        steps = recorded_steps(m)
        (got,), req = s1.run(eng, loras, CARD)
    torch.cuda.synchronize()
    assert set(graphs_of(params.unet)) == {key}
    assert s1.graph_counts(req) == (1, STEPS - 1)
    assert len(steps) == len(want_s1_steps) > STEPS
    for a, b in zip(steps, want_s1_steps):
        assert all(bits_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(got.stage1, want_s1.stage1)
    assert np.array_equal(got.stage2, want_s1.stage2)
