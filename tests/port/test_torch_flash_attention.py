"""Flash attention in the port: the plain version against the JAX Pallas
kernel (interpret mode) and JAX sdpa, the gate against the JAX TPU rule,
and the wrapper's dispatch by device. The kernel itself is tested on the
card (test_torch_flash_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.nn import attention as jattention
from omg_tpu.ops import flash_attention as jfa
from omg_tpu_torch.nn import attention
from omg_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal

ATOL = 1e-5   # fp32 on both sides; only the summation order differs


def _qkv(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, h, nq, d), normal(rng, b, h, nk, d),
            normal(rng, b, h, nk, d))


@pytest.mark.parametrize("nq,nk,d,bq,bk", [
    (256, 256, 64, 128, 128),     # aligned
    (256, 256, 128, 128, 128),    # head_dim 128
    (250, 250, 64, 128, 128),     # unaligned: padded keys masked
    (130, 250, 64, 128, 128),     # nq != nk
    (100, 100, 64, 4, 4),         # kv_len % bk == 0, then padding blocks
])
def test_plain_matches_jax_kernel_and_sdpa(nq, nk, d, bq, bk):
    q, k, v = _qkv(0, 1, 2, nq, nk, d)
    want_kernel = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq, bk=bk,
        interpret=True))
    want_sdpa = np.asarray(jattention.sdpa(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v)))
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_sdpa, atol=ATOL)


@pytest.mark.parametrize("n", [77, 896, 897, 960, 988, 1008, 1024, 3840,
                               3952, 4096])
@pytest.mark.parametrize("d", [64, 128, 512])
def test_use_flash_matches_jax_tpu_rule(n, d, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert fa.use_flash(n, n, d, "cuda") == jfa.use_flash(n, n, d)
    assert fa.use_flash(n, 77, d, "cuda") == jfa.use_flash(n, 77, d)
    # off CUDA everything takes the plain path, as JAX off the TPU
    assert not fa.use_flash(n, n, d, "cpu")


def test_cpu_dispatch_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 1024, 1024, 64))
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES == before          # no kernel launch on the CPU
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_jax(masked):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 3, 9, 9, 8))
    mask = None
    if masked:
        mask = torch.triu(torch.full((9, 9), float("-inf")), 1)[None, None]
    want = np.asarray(jattention.sdpa(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()),
        mask=None if mask is None else jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(attention.sdpa(q, k, v, mask=mask).numpy(),
                               want, atol=ATOL)
