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
    (2, 10, 1024, 1024, 128), (1, 1, 64, 0, 64)])
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
def test_kernel_takes_strided_heads(cuda):
    """[B, N, H, D] -> [B, H, N, D] head split as a view, no copy."""
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, 1024, 3 * 640, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (10, 64)).transpose(1, 2)
               for t in x.chunk(3, dim=-1))
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous()).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= BF16_ULPS * max(ref.abs().max().item(), 1.0), err
