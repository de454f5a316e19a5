"""The flash-attention kernel's launch plan, checked on the CPU.

``launch_plan`` decides everything about a launch but the pointers: query
rows per CTA, the grid, and the dims, byte strides and boxes of the three
TMA tensor maps. The kernel takes it as it is, so these tests are the CPU's
view of what the card is asked to do. No jax, no card."""

import math

import pytest

import chip_smoke
from omg_tpu_torch.ops import flash_attention as fa

SMS = 132


def contiguous(b, h, n, d):
    return (h * n * d, n * d, d, 1)


def expected_rows(b, h, nq, d):
    """128 at D = 128; at D = 64 the variant whose waves cost less, a
    wave of 192-row CTAs (one per SM) costing 11 and one of 64-row CTAs
    (two per SM) 8."""
    if d == 128:
        return 128
    waves_192 = math.ceil(b * h * math.ceil(nq / 192) / SMS)
    waves_64 = math.ceil(b * h * math.ceil(nq / 64) / (2 * SMS))
    return 64 if 8 * waves_64 < 11 * waves_192 else 192


def check_plan(plan, b, h, nq, nk, d, strides):
    rows = expected_rows(b, h, nq, d)
    assert plan.rows == rows
    assert plan.grid == (math.ceil(nq / rows), b * h)
    assert (plan.d, plan.h, plan.nq, plan.nk) == (d, h, nq, nk)
    assert plan.o_strides == tuple(strides[3][:3])
    for m, st, n, box_rows in ((plan.q, strides[0], nq, rows),
                               (plan.k, strides[1], nk, 128),
                               (plan.v, strides[2], nk, 128)):
        assert m.dims == (d, n, h, b)
        assert m.strides == (2 * st[2], 2 * st[1], 2 * st[0])
        assert all(s % 16 == 0 for s in m.strides)
        assert m.box == (64, box_rows, 1, 1)
    packed = list(plan.pack())
    assert len(packed) == 43
    assert packed[:10] == [d, rows, *plan.grid, h, nq, nk, *strides[3][:3]]
    for i, m in enumerate((plan.q, plan.k, plan.v)):
        assert packed[10 + 11 * i:21 + 11 * i] == [*m.dims, *m.strides,
                                                     *m.box]


@pytest.mark.parametrize("b,h,n,d", chip_smoke.KERNEL_SHAPES)
def test_plan_at_kernel_shapes(b, h, n, d):
    strides = (contiguous(b, h, n, d),) * 4
    check_plan(fa.launch_plan(b, h, n, n, d, strides, SMS),
               b, h, n, n, d, strides)


@pytest.mark.parametrize("b,h,nq,nk", chip_smoke.SEQ_SHAPES)
def test_plan_at_seq_shapes(b, h, nq, nk):
    """K1b: a shard's query rows against the whole K/V."""
    q, kv = contiguous(b, h, nq, 64), contiguous(b, h, nk, 64)
    strides = (q, kv, kv, q)
    check_plan(fa.launch_plan(b, h, nq, nk, 64, strides, SMS),
               b, h, nq, nk, 64, strides)


def test_small_grid_takes_64_rows():
    """K1b's 4-way level-2 shape: 80 CTAs of 192 rows (a third of them
    padding) would leave 52 of 132 SMs idle; 64-row CTAs give 160, two per
    SM, in one wave."""
    strides = (contiguous(2, 20, 256, 64), contiguous(2, 20, 1024, 64),
               contiguous(2, 20, 1024, 64), contiguous(2, 20, 256, 64))
    plan = fa.launch_plan(2, 20, 256, 1024, 64, strides, SMS)
    assert plan.rows == 64 and plan.grid == (4, 40)
    assert plan.q.box == (64, 64, 1, 1) and plan.k.box == (64, 128, 1, 1)
    # the 2-way shape: one wave of 120 CTAs of 192 rows beats two of 64
    assert fa.launch_plan(2, 20, 512, 1024, 64, strides, SMS).rows == 192
    # the rule reads the card's SM count: with 160 SMs the 64-row grid of
    # the 2-way shape fits one wave too
    assert fa.launch_plan(2, 20, 512, 1024, 64, strides, 160).rows == 64
    # at D = 128 the 128-row variant is the only one
    s128 = (contiguous(2, 20, 256, 128),) * 4
    assert fa.launch_plan(2, 20, 256, 256, 128, s128, SMS).rows == 128


@pytest.mark.parametrize("b,h,n,rows", [
    (7, 10, 4096, 192), (2, 20, 1024, 192),   # 12 / 2 waves of 192 rows
    (7, 20, 1024, 64), (2, 10, 4096, 64)])    # 9 / 5 waves of 64 beat 7 / 4
def test_main_path_row_choice(b, h, n, rows):
    """The four self-attention shapes of one ``generate`` on an H100."""
    strides = (contiguous(b, h, n, 64),) * 4
    assert fa.launch_plan(b, h, n, n, 64, strides, SMS).rows == rows


@pytest.mark.parametrize("n", [1024, 4096])
def test_plan_of_fused_qkv_views(n):
    """[2, n, 3 * 640] -> chunk -> [2, 10, n, 64] views: the head stride
    (64) is below the row stride (1920) and the maps take them as given."""
    view = (n * 1920, 64, 1920, 1)
    strides = (view, view, view, contiguous(2, 10, n, 64))
    plan = fa.launch_plan(2, 10, n, n, 64, strides, SMS)
    check_plan(plan, 2, 10, n, n, 64, strides)
    assert plan.q.strides == (3840, 128, n * 3840)
    rows = {1024: 192, 4096: 64}[n]
    assert plan.rows == rows and plan.grid == (-(-n // rows), 20)


def test_plan_with_no_keys():
    """Nk = 0 is planned like any length (the kernel stands q's map in)."""
    q = contiguous(1, 1, 64, 64)
    plan = fa.launch_plan(1, 1, 64, 0, 64, (q, contiguous(1, 1, 0, 64),
                                            contiguous(1, 1, 0, 64), q), SMS)
    assert plan.nk == 0 and plan.k.dims == (64, 0, 1, 1)
    assert plan.grid == (1, 1)


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_plan_refuses_strided_head_dim(which):
    strides = [contiguous(2, 10, 1024, 64)] * 4
    strides[which] = (10 * 1024 * 128, 1024 * 128, 128, 2)
    with pytest.raises(ValueError, match="unit stride"):
        fa.launch_plan(2, 10, 1024, 1024, 64, tuple(strides), SMS)


@pytest.mark.parametrize("stride", [(10 * 1024 * 68, 1024 * 68, 68, 1),
                                    (10 * 1028 * 64 + 4, 1028 * 64, 64, 1)])
def test_plan_refuses_unaligned_rows(stride):
    """TMA takes byte strides in multiples of 16: 8 bf16 elements."""
    strides = (stride,) + (contiguous(2, 10, 1024, 64),) * 3
    with pytest.raises(ValueError, match="16-byte"):
        fa.launch_plan(2, 10, 1024, 1024, 64, strides, SMS)


@pytest.mark.parametrize("d", [32, 80, 96, 256])
def test_plan_refuses_head_dims(d):
    strides = (contiguous(2, 10, 1024, d),) * 4
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_plan(2, 10, 1024, 1024, d, strides, SMS)
