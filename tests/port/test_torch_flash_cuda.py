"""The flash-attention kernel against its plain version on the card.

Needs an NVIDIA GPU with nvcc; elsewhere every case skips. This file
imports no jax, so on the GPU machine it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_flash_cuda.py
"""

import pytest
import torch

from omg_tpu_torch.ops import flash_attention as fa

# bf16 output: both sides round O (and the kernel P) to 8 mantissa bits,
# so a few units in the last place of the largest |o| apart.
BF16_ULPS = 4 * 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk,d", [
    (2, 10, 4096, 4096, 64), (2, 20, 1024, 1024, 64),
    (2, 20, 988, 988, 64), (1, 2, 1025, 1025, 64), (1, 2, 100, 65, 64),
    (2, 10, 1024, 1024, 128), (1, 1, 64, 0, 64),
    # the last 128-key tile full / holding one real key
    (1, 2, 1152, 1152, 64), (2, 20, 1025, 1025, 64),
    # one query row; D = 128 at stage-2 width; the 64-row variant at D = 128
    (1, 2, 1, 1024, 64), (7, 10, 1024, 1024, 128), (1, 2, 256, 1024, 128)])
def test_kernel_matches_plain(cuda, b, h, nq, nk, d):
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=g, device=cuda,
                           dtype=torch.bfloat16) for n in (nq, nk, nk))
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    if nk == 0:
        assert torch.count_nonzero(out) == 0
        return
    ref = fa.flash_attention_ref(q, k, v).float()
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_ULPS * max(ref.abs().max().item(), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk", [
    (2, 10, 2048, 4096), (2, 20, 512, 1024),     # 2-way seq at 1024^2
    (2, 10, 1024, 4096), (2, 20, 256, 1024),     # 4-way seq
    (1, 10, 2048, 4096),                         # data-split lanes
    (2, 10, 1976, 3952), (2, 20, 494, 988)])     # the 1216x832 bucket
def test_seq_local_kernel_matches_plain(cuda, b, h, nq, nk):
    """K1b: a sequence shard's query rows against the whole K/V."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(b, h, n, 64, generator=g, device=cuda,
                           dtype=torch.bfloat16) for n in (nq, nk, nk))
    before = fa.SEQ_LAUNCHES
    out = fa.flash_attention_seq_local(q, k, v)
    torch.cuda.synchronize()
    assert fa.SEQ_LAUNCHES == before + 1
    ref = fa.flash_attention_ref(q, k, v).float()
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_ULPS * max(ref.abs().max().item(), 1.0), err


@pytest.mark.cuda
def test_small_grid_takes_64_rows(cuda):
    """K1b's 4-way level-2 shape would give 80 CTAs of 192 rows on the
    card's SMs: the plan takes the 64-row variant, which is right too."""
    b, h, nq, nk = 2, 20, 256, 1024
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(cuda).manual_seed(4)
    q, k, v = (torch.randn(b, h, n, 64, generator=g, device=cuda,
                           dtype=torch.bfloat16) for n in (nq, nk, nk))
    strides = (q.stride(), k.stride(), v.stride(), q.stride())
    assert fa.launch_plan(b, h, nq, nk, 64, strides, sms).rows == 64
    out = fa.flash_attention_seq_local(q, k, v)
    ref = fa.flash_attention_ref(q, k, v).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_ULPS * max(ref.abs().max().item(), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_kernel_takes_strided_heads(cuda, n):
    """[B, N, H, D] -> [B, H, N, D] head split as a view, no copy."""
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, n, 3 * 640, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (10, 64)).transpose(1, 2)
               for t in x.chunk(3, dim=-1))
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous()).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_ULPS * max(ref.abs().max().item(), 1.0), err
