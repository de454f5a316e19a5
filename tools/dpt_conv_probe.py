"""Time DPT-large's forward on one GPU with its convolutions through cuDNN
and without it (the port's choice, ``nn/layers.conv_fp32(cudnn=False)``).

    python3 tools/dpt_conv_probe.py

fp32 with TF32 off, seeded random weights, one [1, 3, 384, 384] input.
For each route: ms per forward (host clock over 5 calls after 2 warm-up
calls, ended by a synchronize), the peak memory over the live weights,
whether two calls give equal outputs, and the error against the same
model on the CPU; then the slowest convolutions of one cuDNN forward,
timed one module at a time. Prints the card's name and power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from omg_tpu_torch.models import dpt  # noqa: E402


@contextlib.contextmanager
def through_cudnn():
    """DPT's convolutions as ``F.conv2d``/``F.conv_transpose2d`` (cuDNN,
    TF32 off by the process's flags)."""
    conv, tconv = dpt.Conv.forward, dpt.ConvTranspose.forward
    dpt.Conv.forward = lambda self, x: F.conv2d(
        x, self.weight, self.bias, self.stride, self.padding)
    dpt.ConvTranspose.forward = lambda self, x: F.conv_transpose2d(
        x, self.weight, self.bias, stride=self.k)
    try:
        yield
    finally:
        dpt.Conv.forward, dpt.ConvTranspose.forward = conv, tconv


def timed(model, x) -> tuple:
    for _ in range(2):
        model(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        y = model(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return y, ms, peak, bool(torch.equal(y, model(x)))


def slowest_convs(model, x, n: int = 4) -> list:
    times = {}

    def pre(mod, inp):
        torch.cuda.synchronize()
        mod._t0 = time.perf_counter()

    def post(mod, inp, out):
        torch.cuda.synchronize()
        times[mod._name] = (time.perf_counter() - mod._t0) * 1e3

    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, (dpt.Conv, dpt.ConvTranspose)):
            mod._name = name
            hooks += [mod.register_forward_pre_hook(pre),
                      mod.register_forward_hook(post)]
    model(x)
    for h in hooks:
        h.remove()
    return sorted(times.items(), key=lambda kv: -kv[1])[:n]


def main() -> int:
    if not torch.cuda.is_available():
        print("dpt_conv_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card:", card)
    dev = torch.device("cuda")
    cfg = dpt.DPTConfig()
    with torch.inference_mode():
        model = dpt.init_params(torch.Generator(dev).manual_seed(42), cfg,
                                dev)
        x = torch.randn(1, 3, cfg.image_size, cfg.image_size, device=dev,
                        generator=torch.Generator(dev).manual_seed(43))
        cpu = dpt.DPT(cfg, "cpu")
        cpu.load_state_dict(model.state_dict())
        ref = cpu(x.cpu())
        for name, ctx in (("without cuDNN", contextlib.nullcontext),
                          ("through cuDNN", through_cudnn)):
            with ctx():
                y, ms, peak, same = timed(model, x)
                err = ((y.cpu() - ref).abs().max() / ref.abs().max()).item()
                print(f"{name}: {ms:.3f} ms per forward, peak "
                      f"+{peak:.3f} GiB over the weights, repeat-equal "
                      f"{same}, vs CPU {err:.2e}")
                for conv, cms in slowest_convs(model, x):
                    print(f"  {cms:9.3f} ms  {conv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
