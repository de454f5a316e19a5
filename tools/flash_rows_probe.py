"""Time the flash-attention kernel's two D = 64 variants on one GPU.

    python3 tools/flash_rows_probe.py

At every D = 64 shape of chip_smoke.py's phases 3 and 3b, launches the
kernel with 192 query rows per CTA (three consumer warpgroups, one CTA per
SM) and with 64 (one warpgroup, two CTAs per SM), in turns, and prints
both times beside the variant ``launch_plan`` picks and the per-wave cost
ratio the two imply (the plan's WAVE_COST_192 : WAVE_COST_64). Needs an
NVIDIA GPU with nvcc.
"""

import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from omg_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_rows_probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = fa.build()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(dev).manual_seed(0)
    shapes = [(b, h, n, n) for b, h, n, d in chip_smoke.KERNEL_SHAPES
              if d == 64] + list(chip_smoke.SEQ_SHAPES)
    for b, h, nq, nk in shapes:
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for n in (nq, nk, nk))
        o = torch.empty_like(q)
        ref = fa.flash_attention_ref(q, k, v).float()
        base = fa.launch_plan(b, h, nq, nk, 64, (q.stride(), k.stride(),
                                                  v.stride(), o.stride()),
                              sms)
        times: dict = {}
        for rows in (192, 64, 64, 192):
            plan = base._replace(rows=rows, grid=(-(-nq // rows), b * h),
                                 q=base.q._replace(box=(64, rows, 1, 1)))
            packed = plan.pack()

            def launch():
                err = lib.omg_flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    packed, 0.125, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            launch()
            torch.cuda.synchronize()
            err = (o.float() - ref).abs().max().item()
            if err > chip_smoke.KERNEL_ULPS * max(ref.abs().max().item(), 1):
                raise AssertionError(f"{rows} rows disagree: {err}")
            times.setdefault(rows, []).append(chip_smoke.cuda_ms(launch, 50))
        t192, t64 = min(times[192]), min(times[64])
        waves192 = -(-b * h * -(-nq // 192) // sms)
        waves64 = -(-b * h * -(-nq // 64) // (2 * sms))
        print(f"[{b},{h},{nq},64] x {nk}: 192 rows {t192:.4f} ms "
              f"({waves192} waves), 64 rows {t64:.4f} ms ({waves64} waves); "
              f"plan takes {base.rows}; wave cost 192:64 = "
              f"{(t192 / waves192) / (t64 / waves64):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
