"""Flash attention for SDXL self-attention: a hand-written Hopper kernel.

Port of ``omg_tpu/ops/flash_attention.py``. The JAX package routes the
UNet's large dense self-attentions (10 heads x 4096 tokens and 20 heads x
1024 tokens at 1024x1024) to a Pallas TPU kernel; here they go to
``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a`` (WMMA bf16 tiles,
online softmax in fp32, ragged edges masked by bounds). The source note
in the .cu file says what bounds it on the card.

Beside the kernel:
  * ``flash_attention_ref`` — the plain PyTorch version (fp32 scores and
    softmax, probabilities cast to ``v.dtype`` before P.V). CPU tensors
    take it; the tests and ``chip_smoke.py`` compare the kernel with it.
  * ``flash_attention`` dispatches by the tensor's device: a CUDA tensor
    launches the kernel or raises, a CPU tensor takes the plain version.
  * ``use_flash`` — the JAX gate's shape rule, decided by device.
  * ``LAUNCHES`` — how many times the kernel was launched.

The kernel is compiled with ``nvcc`` from the package's own source into
``build/omg_tpu_torch/`` beside the package, at first use, and loaded with
``ctypes`` (a plain C entry point: seconds to build, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

# Kernel launches since import (chip_smoke.py zeroes it around a run).
LAUNCHES = 0

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "omg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (64, 128)

_lock = threading.Lock()
_lib = None
# Set by the first build in this process: wall seconds and nvcc's output
# (the -Xptxas -v register / shared-memory report).
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "built from source and needs the CUDA toolkit")
    return found


def build() -> ctypes.CDLL:
    """Compile (once per source/flag hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = _BUILD_DIR / f"libomg_flash_attention_{tag}.so"
        t0 = time.perf_counter()
        log = "(cached build)"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True, check=False, timeout=900)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.omg_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log,
                          path=str(so))
        _lib = lib
        return lib


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain dense attention on [B, H, N, D]: fp32 scores and softmax,
    probabilities cast to v.dtype before P.V (``nn.attention.sdpa``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _check_operand(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bf16, {name} is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride on the head dim")
    # rows are read as 16-byte vectors
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned "
                         f"(strides {t.stride()})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    _check_operand("q", q, (b, h, nq, d))
    _check_operand("k", k, (b, h, nk, d))
    _check_operand("v", v, (b, h, nk, d))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    o = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o                   # nothing to compute, nothing launched
    lib = build()
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.omg_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, nq, nk, d, strides, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention. q: [B, H, Nq, D], k/v: [B, H, Nk, D].

    CUDA tensors launch the Hopper kernel (bf16, D in {64, 128}, any
    Nq/Nk) or raise; CPU tensors take ``flash_attention_ref``."""
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def use_flash(nq: int, nk: int, head_dim: int,
              device: torch.device | str) -> bool:
    """Route large dense self-attention to the kernel on a CUDA device.

    The JAX gate's shape rule (``omg_tpu/ops/flash_attention.py``
    ``use_flash``): square, ``round_up(N, 128) >= 1024``, head_dim 64 or
    128. Cross-attention (77 keys), CLIP's masked attention and the VAE's
    512-dim head stay on the plain path; off CUDA everything does."""
    if torch.device(device).type != "cuda":
        return False
    return nq == nk and _round_up(nq, 128) >= 1024 and head_dim in HEAD_DIMS
