"""Where the card time of a LoRA-adapted SDXL UNet forward goes.

At SDXL's published widths (bf16 UNet, random weights) with a rank-32
adapter on ``to_q``, ``to_k``, ``to_v`` and ``to_out.0`` of every attn1
and attn2, three layouts of the benchmark's cells:

  * ``t2i``: 8 lanes, one shared (2-D) adapter, as ``sdxl.text_to_image``;
  * ``omg``: 7 stage-2 lanes, three zero-pad base lanes and two concepts
    of two lanes each (``stack_loras``), as ``OMG.generate``;
  * ``batch``: 28 lanes, four requests of that layout with eight
    adapters, as ``OMG.generate_batch``.

For each: the device ms of a forward with the adapters and without them
(CUDA events, the median of ``--reps``), and the forward's card time by
the operator that launched each kernel and its input shapes, with and
without the adapters (``torch.profiler``): the rows whose time the
adapters add are their cost, by call site (the kernel table also holds
the profiler's own ranges, such as the ``unet`` span). The adapters are
prepared once, as a request prepares them (``lora.prepare``,
``stack_loras``).

    python -m omg_tpu_torch.tools.lora_probe [--cases t2i,omg,batch]
        [--reps 3] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time

import torch

from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import sdxl

RANK = 32
ADAPTED = re.compile(r"attn[12]\.(to_q|to_k|to_v|to_out\.0)$")
CASES = {"t2i": (8, None), "omg": (7, 1), "batch": (28, 4)}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def adapter(unet, seed: int, device) -> dict:
    """A rank-32 adapter on every attention projection, N(0, 0.01²)
    factors, scale 0.8, fp32 leaves."""
    g = torch.Generator(device).manual_seed(seed)
    out = {}
    for name, m in unet.named_modules():
        if isinstance(m, layers.Linear) and ADAPTED.search(name):
            d_out, d_in = m.weight.shape
            out[name] = {
                "down": torch.randn(d_in, RANK, generator=g,
                                    device=device) * 0.01,
                "up": torch.randn(RANK, d_out, generator=g,
                                  device=device) * 0.01,
                "scale": torch.tensor(0.8, device=device)}
    return out


def case_lora(name: str, adapters: list, dtype):
    """The case's LoRA as a request hands it to the UNet."""
    lanes, requests = CASES[name]
    if requests is None:
        return lora_lib.prepare(adapters[0], dtype)
    trees = []
    for r in range(requests):
        a, b = adapters[2 * r % len(adapters)], adapters[(2 * r + 1)
                                                         % len(adapters)]
        trees += [None] * 3 + [a, a, b, b]
    return lora_lib.stack_loras(trees, dtype=dtype)


def inputs(cfg, lanes: int, device, seed: int = 1):
    g = torch.Generator(device).manual_seed(seed)
    u = cfg.unet

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(u.dtype)
    tids = sdxl.add_time_ids((1024, 1024), (0, 0), (1024, 1024),
                             device=device).expand(lanes, 6)
    return (r(lanes, 128, 128, 4), r(lanes, 77, u.cross_attention_dim),
            r(lanes, cfg.text_encoder_2.projection_dim), tids)


def forward_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def by_call_site(fn) -> dict:
    """Self device ms of each (operator, input shapes) over one call, and
    of each kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    ops, kernels = {}, {}
    for e in prof.key_averages(group_by_input_shape=True):
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        if e.input_shapes:
            key = f"{e.key} {e.input_shapes}"
            ops[key] = ops.get(key, 0.0) + ms
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if ms > 0 and not e.input_shapes and not e.key.startswith("aten::"):
            kernels[e.key[:120]] = kernels.get(e.key[:120], 0.0) + ms
    return {"ops": ops, "kernels": kernels}


def top(d: dict, n: int) -> list:
    return sorted(d.items(), key=lambda kv: -abs(kv[1]))[:n]


def run_case(name: str, cfg, unet, adapters, reps: int, device) -> dict:
    lanes, _ = CASES[name]
    x, ctx, pooled, tids = inputs(cfg, lanes, device)
    t0 = time.perf_counter()
    lora = case_lora(name, adapters, cfg.unet.dtype)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3

    def fwd(lo):
        return lambda: unet(x, 500, ctx, text_embeds=pooled, time_ids=tids,
                            lora=lo)
    with torch.no_grad():
        fwd(lora)()
        fwd(None)()
        torch.cuda.synchronize()
        with_ms = forward_ms(fwd(lora), reps)
        without_ms = forward_ms(fwd(None), reps)
        on, off = by_call_site(fwd(lora)), by_call_site(fwd(None))
    diff = {k: on["ops"].get(k, 0.0) - off["ops"].get(k, 0.0)
            for k in set(on["ops"]) | set(off["ops"])}
    kdiff = {k: on["kernels"].get(k, 0.0) - off["kernels"].get(k, 0.0)
             for k in set(on["kernels"]) | set(off["kernels"])}
    rec = {"lanes": lanes, "prepare_ms_host": prep_ms,
           "forward_ms_lora": with_ms, "forward_ms_none": without_ms,
           "lora_ms": with_ms - without_ms,
           "lora_ops": top(diff, 30), "lora_kernels": top(kdiff, 20)}
    log(f"{name}: {lanes} lanes, forward {with_ms:.2f} ms with LoRA, "
        f"{without_ms:.2f} ms without (+{with_ms - without_ms:.2f})")
    for k, v in rec["lora_ops"][:16]:
        log(f"  {v:9.3f} ms  {k}")
    for k, v in rec["lora_kernels"][:10]:
        log(f"  {v:9.3f} ms  kernel {k}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="t2i,omg,batch")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    cfg = sdxl.sdxl_config()
    out = {"device": torch.cuda.get_device_name(device),
           "torch": torch.__version__}
    unet = unet_lib.init_params(torch.Generator(device).manual_seed(0),
                                cfg.unet, device)
    adapters = [adapter(unet, 10 + i, device) for i in range(8)]
    for name in args.cases.split(","):
        out[name] = run_case(name, cfg, unet, adapters, args.reps, device)
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, (dict, list))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
