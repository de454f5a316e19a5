"""Flash attention for SDXL self-attention: a hand-written Hopper kernel.

Port of ``omg_tpu/ops/flash_attention.py``. The JAX package routes the
UNet's large dense self-attentions (10 heads x 4096 tokens and 20 heads x
1024 tokens at 1024x1024) to a Pallas TPU kernel; here they go to
``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``: TMA loads of K/V
into a 2-stage mbarrier ring fed by a producer warp, ``wgmma`` for both
products, the online softmax and the O accumulator in registers. The
source note in the .cu file says what bounds it on the card.

Beside the kernel:
  * ``flash_attention_ref`` — the plain PyTorch version (fp32 scores and
    softmax, probabilities cast to ``v.dtype`` before P.V). CPU tensors
    take it; the tests and ``chip_smoke.py`` compare the kernel with it.
  * ``flash_attention`` dispatches by the tensor's device: a CUDA tensor
    launches the kernel or raises, a CPU tensor takes the plain version.
  * ``launch_plan`` — everything about a launch that is not a pointer:
    query rows per CTA (64 per consumer warpgroup: 192 or 64 at D = 64,
    128 at D = 128), the grid, and the tensor maps' dims, byte strides
    and boxes. The kernel takes it as it is; the CPU tests check it.
  * ``use_flash`` — the JAX gate's shape rule, decided by device.
  * ``LAUNCHES`` — how many times the kernel was launched as K1, each
    counted by ``count_launch`` (which tools that tally launches by shape
    wrap); a CUDA graph's capture takes its launches out (``recorded``)
    and each replay counts them again.

K1b, the sequence-sharded form (``flash_attention_seq_sharded`` in the
JAX package: a local block of query rows against K/V all-gathered over
the ranks that split the sequence), is the same kernel launched with
Nq < Nk: ``flash_attention_seq_local`` launches it on gathered K/V and
counts ``SEQ_LAUNCHES``; ``flash_attention_seq_sharded`` gathers K/V over
a ``parallel.comm.Group`` first. ``flash_attention_ref`` is the plain
version of both.

The kernel is compiled with ``nvcc`` from the package's own source into
``build/omg_tpu_torch/`` beside the package, at first use, and loaded with
``ctypes`` (a plain C entry point: seconds to build, no PyTorch headers).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

from omg_tpu_torch.parallel import comm

# Kernel launches since import, as K1 (square self-attention) and as K1b
# (a sequence shard's query rows against the gathered K/V); chip_smoke.py
# zeroes both around a run.
LAUNCHES = 0
SEQ_LAUNCHES = 0

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "omg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (64, 128)
BLOCK_N = 128       # keys per K/V tile (BN in the .cu)
BOX_COLS = 64       # columns of a TMA box: 128-byte swizzle, 64 bf16
ELEM_BYTES = 2      # bf16
H100_SMS = 132
# The time of one wave of 192-row CTAs (three consumer warpgroups, one CTA
# per SM) against one wave of 64-row CTAs (one warpgroup, two per SM), at
# D = 64 on an H100 (tools/flash_rows_probe.py): 11 to 8. Per-CTA time
# scales with Nk alike in both, so the choice reads only the grid.
WAVE_COST_192, WAVE_COST_64 = 11, 8

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
    if _lib is not None:
        return _lib
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
        plan = ctypes.POINTER(ctypes.c_int64)
        fn = lib.omg_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [plan, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        enc = lib.omg_flash_attention_encode
        enc.argtypes = [ctypes.c_void_p] * 3 + [plan]
        enc.restype = ctypes.c_int
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


class TensorMap(NamedTuple):
    """One operand's TMA tensor map: 4-D, innermost first."""
    dims: tuple      # (D, N, H, B)
    strides: tuple   # bytes between rows, heads, batches
    box: tuple       # (64, rows, 1, 1): one load


class LaunchPlan(NamedTuple):
    """What the kernel needs besides the four pointers."""
    d: int
    rows: int        # query rows per CTA: 64 per consumer warpgroup
    grid: tuple      # (query tiles, B * H)
    h: int
    nq: int
    nk: int
    o_strides: tuple  # element strides of o: (batch, head, row)
    q: TensorMap
    k: TensorMap
    v: TensorMap

    def pack(self):
        """The 43 int64 that ``omg_flash_attention_fwd`` reads."""
        vals = (self.d, self.rows, *self.grid, self.h, self.nq, self.nk,
                *self.o_strides)
        for m in (self.q, self.k, self.v):
            vals += m.dims + m.strides + m.box
        return (ctypes.c_int64 * len(vals))(*vals)


def _tensor_map(name: str, stride: tuple, n: int, h: int, b: int, d: int,
                rows: int) -> TensorMap:
    if stride[-1] != 1:
        raise ValueError(f"{name} must have unit stride on the head dim")
    # TMA wants 16-byte aligned strides
    if any(s % 8 for s in stride[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned "
                         f"(strides {stride})")
    sb, sh, sn = (s * ELEM_BYTES for s in stride[:-1])
    return TensorMap(dims=(d, n, h, b), strides=(sn, sh, sb),
                     box=(BOX_COLS, rows, 1, 1))


def _rows_d64(bh: int, nq: int, sm_count: int) -> int:
    waves_192 = -(-bh * -(-nq // 192) // sm_count)
    waves_64 = -(-bh * -(-nq // 64) // (2 * sm_count))
    return 64 if WAVE_COST_64 * waves_64 < WAVE_COST_192 * waves_192 else 192


def launch_plan(b: int, h: int, nq: int, nk: int, d: int, strides: tuple,
                sm_count: int = H100_SMS) -> LaunchPlan:
    """The launch of q [b, h, nq, d] against k/v [b, h, nk, d].

    ``strides``: the element strides (batch, head, row, dim) of q, k, v and
    o. Refuses head dims other than 64 and 128, a non-unit inner stride
    and strides that are not a multiple of 8 elements (16 bytes). Query
    rows per CTA: 128 at d = 128; at d = 64, 192 (three consumer
    warpgroups) or 64 (one, two CTAs per SM), whichever needs fewer waves
    of the grid by the measured cost of a wave of each."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel: B*H = {b * h} > 65535")
    rows = 128 if d == 128 else _rows_d64(b * h, nq, sm_count)
    qs, ks, vs, os_ = strides
    if os_[-1] != 1:
        raise ValueError("o must have unit stride on the head dim")
    return LaunchPlan(
        d=d, rows=rows, grid=(-(-nq // rows), b * h), h=h, nq=nq, nk=nk,
        o_strides=tuple(os_[:3]),
        q=_tensor_map("q", qs, nq, h, b, d, rows),
        k=_tensor_map("k", ks, nk, h, b, d, BLOCK_N),
        v=_tensor_map("v", vs, nk, h, b, d, BLOCK_N))


@functools.lru_cache(maxsize=512)
def _packed_plan(*args):
    return launch_plan(*args).pack()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ERRORS = {-1: "no instantiation for this head dim / row count",
           -2: "cuTensorMapEncodeTiled not found through the CUDA runtime",
           -3: "the kernel's entry register count is not what its setmaxnreg "
               "plan assumes (see the ptxas report)"}


def _check_operand(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bf16, {name} is "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            seq_local: bool) -> torch.Tensor:
    b, h, nq, d = q.shape
    nk = k.shape[2]
    _check_operand("q", q, (b, h, nq, d))
    _check_operand("k", k, (b, h, nk, d))
    _check_operand("v", v, (b, h, nk, d))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    o = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    strides = (q.stride(), k.stride(), v.stride(), o.stride())
    plan = _packed_plan(b, h, nq, nk, d, strides, _sm_count(q.device.index))
    if o.numel() == 0:
        return o                   # nothing to compute, nothing launched
    lib = build()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.omg_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), plan,
            d ** -0.5, stream)
    if err != 0:
        reason = (_ERRORS.get(err) or (f"tensor-map encode failed, CUresult "
                                       f"{-1000 - err}" if err <= -1000
                                       else f"cudaError {err}"))
        raise RuntimeError(f"flash_attention kernel launch failed: {reason}")
    count_launch(tuple(q.shape), seq_local)
    return o


def count_launch(shape: tuple, seq_local: bool) -> None:
    """Count one launch with q of ``shape``: in ``SEQ_LAUNCHES`` for K1b,
    else in ``LAUNCHES``."""
    global LAUNCHES, SEQ_LAUNCHES
    if seq_local:
        SEQ_LAUNCHES += 1
    else:
        LAUNCHES += 1


@contextlib.contextmanager
def recorded():
    """The block's launches, left uncounted, as a list of (q shape,
    seq_local): a CUDA graph's capture runs nothing, and each replay
    passes them to ``count_launch``."""
    global count_launch
    launches, outer = [], count_launch

    def record(shape: tuple, seq_local: bool) -> None:
        launches.append((shape, seq_local))
    count_launch = record
    try:
        yield launches
    finally:
        count_launch = outer


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention. q: [B, H, Nq, D], k/v: [B, H, Nk, D].

    CUDA tensors launch the Hopper kernel (bf16, D in {64, 128}, any
    Nq/Nk) or raise; CPU tensors take ``flash_attention_ref``."""
    if q.device.type == "cuda":
        return _launch(q, k, v, seq_local=False)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_seq_local(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """K1b: a sequence shard's query rows q [B, H, Nq, D] against the whole
    sequence's K/V [B, H, Nk, D], Nq < Nk (the kernel's grid runs over the
    query rows and its loop over the keys, so unequal lengths are native).

    CUDA tensors launch the kernel (counted in ``SEQ_LAUNCHES``) or raise;
    CPU tensors take ``flash_attention_ref``."""
    if q.device.type == "cuda":
        return _launch(q, k, v, seq_local=True)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_seq_sharded(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                group: comm.Group) -> torch.Tensor:
    """Self-attention with the token axis split over ``group`` (JAX
    ``flash_attention_seq_sharded``): each rank holds the query, key and
    value rows of its block [B, H, N/S, D]; K and V are all-gathered along
    N (the one collective of the layer) and K1b runs the local query rows
    against them. Exact: every query row sees every key, so no softmax
    state crosses ranks."""
    k = comm.all_gather(k, 2, group)
    v = comm.all_gather(v, 2, group)
    return flash_attention_seq_local(q, k, v)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def use_flash(nq: int, nk: int, head_dim: int,
              device: torch.device | str, *, seq_local: bool = False) -> bool:
    """Route large dense self-attention to the kernel on a CUDA device.

    The JAX gate's shape rule (``omg_tpu/ops/flash_attention.py``
    ``use_flash``): square, ``round_up(N, 128) >= 1024``, head_dim 64 or
    128. Cross-attention (77 keys), CLIP's masked attention and the VAE's
    512-dim head stay on the plain path; off CUDA everything does.

    ``seq_local``: ``nq`` is one shard's block of query rows of a
    sequence-sharded self-attention (nq < nk); the rule is then
    ``nq >= 256`` and head_dim 64 or 128."""
    if torch.device(device).type != "cuda":
        return False
    if seq_local:
        return nq >= 256 and head_dim in HEAD_DIMS
    return nq == nk and _round_up(nq, 128) >= 1024 and head_dim in HEAD_DIMS
