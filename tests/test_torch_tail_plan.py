"""Rows 13-14 (the fused encoder tail) on the CPU: the launch plan
(``experimental_fused_encoder.tail_launch_plan``: the regime by T, D and
the dtype; the resident plan's heads, rows, buffers, blocks and shared
bytes; the walk of items over rows; the tiled regime's sub-tile and block
bytes), and what the wrappers hand the C entry points and how they count
the launch, in each regime.

The kernels themselves run on the card: tests/test_torch_kernel_gpu.py and
chip_smoke.py hold them to the plain versions there, and hold the plan's
regime and shared bytes to the C side's. tests/test_torch_fused_encoder.py
holds the plain versions to the JAX package.
"""

import pytest
import torch

from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
from newsrecommendation_tpu_torch.ops import (
    experimental_fused_encoder as fe,
)
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels
from tests.test_torch_mhsa_sep_plan import fake_launch  # noqa: F401

SMS = 132  # the H100's SMs
F32, BF16 = torch.float32, torch.bfloat16
# The shapes chip_smoke.py and the card tests run rows 13-14 at below
# T = 65: (N, T, H, D, Q).
RESIDENT_SHAPES = [(7040, 20, 20, 20, 200), (128, 50, 20, 20, 200),
                   (1024, 20, 20, 20, 200), (64, 50, 20, 20, 200),
                   (128, 64, 20, 20, 200), (16, 20, 20, 20, 200),
                   (33, 50, 20, 20, 200), (7, 5, 3, 4, 7), (5, 13, 2, 33, 9),
                   (6, 20, 4, 8, 16), (4, 20, 2, 4, 5)]


def _itemsize(dtype):
    return 2 if dtype == BF16 else 4


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("t, fwd, bwd", [
    (1, "resident", "resident"), (20, "resident", "resident"),
    (64, "resident", "resident"), (65, "tiled", "tiled"),
    (85, "tiled", "tiled"), (86, "tiled", "tiled"),
    (87, "tiled", "tiled"), (512, "tiled", "tiled")])
def test_regime_by_t_and_dtype(t, fwd, bwd, dtype):
    """At 20 heads of 20, Q = 200: resident up to T = 64 in both dtypes;
    past it tiled in both directions, across the T = 86 / 85 where the
    per-row kernels once left shared memory. The plan carries a resident
    launch only in that regime and a sub-tile only in the tiled one, and
    five ints for the C entry points (the regime's index, the resident
    plan, the sub-tile; zeros outside their regimes)."""
    for kind, regime in (("fwd", fwd), ("bwd", bwd)):
        plan = fe.tail_launch_plan(kind, 64, t, 20, 20, 200, dtype, SMS)
        assert plan.regime == regime == fe.tail_regime(
            kind, t, 20, 20, 200, _itemsize(dtype))
        args = plan.args()
        assert len(args) == 5 and args[0] == fe.TAIL_REGIMES.index(regime)
        assert (args[1:4] == (0,) * 3) == (regime != "resident")
        assert (args[4] != 0) == (regime == "tiled")
        assert (plan.attn is not None) == (regime == "resident"
                                           and kind == "bwd" and dtype == BF16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("heads, d, regime", [
    (20, 64, "resident"), (3, 64, "resident"), (2, 65, "global"),
    (1, 200, "global")])
def test_heads_past_64_leave_the_resident_regime(heads, d, regime, dtype):
    """Row 15's per-query pass holds heads of up to 64; wider heads take
    the per-row kernels ("global") at any T."""
    for kind in ("fwd", "bwd"):
        assert fe.tail_launch_plan(kind, 8, 20, heads, d, 200, dtype,
                                   SMS).regime == regime


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n, t, heads, d, q", RESIDENT_SHAPES)
def test_resident_plan_fits_a_block(n, t, heads, d, q, dtype):
    """At every shape the smoke and the card tests run below T = 65 the
    plan is resident, its shared bytes are the layout's and within a
    block's 232,448, and its grid is at most one block per item and what
    the SMs hold; the bf16 backward's row 16 plan is row 16's own (f32
    takes row 4's kernel)."""
    itemsize = _itemsize(dtype)
    for kind in ("fwd", "bwd"):
        p = fe.tail_launch_plan(kind, n, t, heads, d, q, dtype, SMS)
        assert p.regime == "resident"
        assert 1 <= p.heads <= min(4, heads) and p.nbuf in (1, 2)
        assert p.smem == fe.resident_smem(kind, t, heads, d, q, itemsize,
                                          p.heads, p.nbuf)
        assert p.smem <= kernels.MAX_SMEM == 232448
        per_sm = bl.SM_SMEM // (p.smem + 1024)
        assert 1 <= p.blocks <= min(n, SMS * per_sm)
        want = (bl.launch_plan("bwd", n, t, heads, d, itemsize, SMS)
                if kind == "bwd" and dtype == BF16 else None)
        assert p.attn == want


def test_resident_layout_at_the_news_encoder():
    """At (7040, 20) in bf16 the forward's block holds row 15's stage and
    f32 arrays, the f32 ctx of its row (20 x 432 floats) and alpha: the
    plan takes four heads and two buffers, which put on an SM the three
    blocks the kernel's registers allow; the backward, whose e is f32,
    gets three with one buffer."""
    p = fe.tail_launch_plan("fwd", 7040, 20, 20, 20, 200, BF16, SMS)
    ctx = 20 * 432 * 4
    assert p.smem >= ctx + bl.smem_bytes("fwd", 20, 20, 2, p.heads, 20,
                                         p.nbuf)
    assert bl.SM_SMEM // (p.smem + 1024) >= fe.RESIDENT_BLOCKS[2] == 3
    assert (p.heads, p.nbuf) == (4, 2)
    b = fe.tail_launch_plan("bwd", 7040, 20, 20, 20, 200, BF16, SMS)
    assert (b.heads, b.nbuf) == (4, 1)
    assert bl.SM_SMEM // (b.smem + 1024) >= 3


def _walk(plan, n, heads):
    """The (batch row, first head) of each sub-item each block computes, in
    its order, as csrc/fused_tail.cuh tail_walk walks them: block b takes
    rows b, b + blocks, ..., each row's head groups in turn."""
    groups = -(-heads // plan.heads)
    total = n * groups
    out = []
    for b in range(plan.blocks):
        k, seen = b * groups, []
        while k < total:
            seen.append((k // groups, k % groups * plan.heads))
            k = k + 1 if (k + 1) % groups else min(
                k + 1 + (plan.blocks - 1) * groups, total)
        out.append(seen)
    return out


@pytest.mark.parametrize("n, t, heads, d, q", [
    (37, 20, 20, 20, 200), (7, 5, 3, 4, 7), (5, 13, 2, 33, 9),
    (200, 20, 20, 20, 200)])
@pytest.mark.parametrize("blocks", [1, 3, 40])
def test_an_item_never_splits_a_row(n, t, heads, d, q, blocks):
    """Walked as tail_walk walks them, every (row, head group) is computed
    once, and all head groups of a row on one block, one after another:
    the pooling after a row's last sub-item sees its whole context."""
    plan = fe.tail_launch_plan("fwd", n, t, heads, d, q, BF16, SMS)
    plan = plan._replace(blocks=min(blocks, n))
    groups = -(-heads // plan.heads)
    walks = _walk(plan, n, heads)
    done = [s for w in walks for s in w]
    assert sorted(done) == [(r, g * plan.heads) for r in range(n)
                            for g in range(groups)]
    for b, w in enumerate(walks):
        rows = [r for r, _ in w]
        assert rows == [r for r in range(b, n, plan.blocks)
                        for _ in range(groups)]


def test_plan_is_a_function_of_the_shapes_and_the_card():
    """The same shapes and card give the same plan (the dw1 splits and row
    16's plan too), computed afresh or cached; another SM count changes
    only the grid."""
    args = ("bwd", 7040, 20, 20, 20, 200, BF16)
    first = fe.tail_launch_plan(*args, SMS)
    fe.tail_launch_plan.cache_clear()
    again = fe.tail_launch_plan(*args, SMS)
    assert first == again
    other = fe.tail_launch_plan(*args, 66)
    assert other._replace(blocks=first.blocks,
                          attn=first.attn) == first
    assert other.blocks < first.blocks


# The tiled regime's sub-tile by T at 20 heads of 20: the largest of 64,
# 32, 16 whose attention block fits 232,448 bytes; past T = 1024 none does
# and the per-row kernel takes the rows from global memory.
TILED_M = {65: 64, 512: 64, 1000: 16, 7000: 0}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("t", [65, 512, 1000, 7000])
def test_tiled_grid_and_scratch(t, n, dtype):
    """The tiled plan at T = 65, 512, 1000 (the sub-tile falls as the
    head's K and V fill the block) and 7000 (global: no sub-tile, the
    per-row kernel's slots). Tiled: the attention block's bytes are the
    layout's, within a block, and a larger sub-tile would not fit; the
    pooling block fits; the C entry points get the sub-tile. The grids and
    the row scratch are the C side's (tests/test_torch_kernel_gpu.py holds
    the scratch sizes there)."""
    heads, d, q = 20, 20, 200
    hd = heads * d
    for kind in ("fwd", "bwd"):
        plan = fe.tail_launch_plan(kind, n, t, heads, d, q, dtype, SMS)
        m = TILED_M[t]
        assert plan.tile == m == fe.tile_m(t, d)
        if not m:
            assert plan.regime == "global" and plan.args()[4] == 0
            continue
        assert plan.regime == "tiled"
        assert plan.smem == fe.tiled_smem(t, d, m) <= kernels.MAX_SMEM
        assert m == 64 or fe.tiled_smem(t, d, 2 * m) > kernels.MAX_SMEM
        assert fe.pool_smem(hd, q) <= kernels.MAX_SMEM
        assert plan.args() == (fe.TAIL_REGIMES.index("tiled"), 0, 0, 0, m)


@pytest.mark.parametrize("t", [65, 300, 512, 541, 1000])
def test_tiled_plan_is_a_function_of_the_shapes(t):
    """The tiled plan depends on T and the head width alone: the same at
    any N, SM count and dtype, computed afresh or cached."""
    first = fe.tail_launch_plan("bwd", 128, t, 20, 20, 200, BF16, SMS)
    fe.tail_launch_plan.cache_clear()
    for kind in ("fwd", "bwd"):
        for n, sms, dtype in ((128, SMS, BF16), (1, SMS, F32),
                              (7040, 66, BF16), (64, 132, F32)):
            assert fe.tail_launch_plan(kind, n, t, 20, 20, 200, dtype,
                                       sms) == first


@pytest.mark.parametrize("t", [20])
def test_plan_raises_on_other_dtypes(t):
    with pytest.raises(TypeError, match="not supported"):
        fe.tail_launch_plan("fwd", 4, t, 2, 4, 5, torch.float16, SMS)


@pytest.mark.parametrize("t, dtype, regime", [
    (20, BF16, "resident"), (20, F32, "resident"), (65, F32, "tiled"),
    (1600, BF16, "global")])
def test_wrappers_launch_the_plan_and_count_its_regime(fake_launch,
                                                       monkeypatch, t, dtype,
                                                       regime):
    """Rows 13 and 14 hand the C entry points the regime's index, the
    resident plan and the tiled sub-tile (zeros outside their regimes);
    row 13 a scratch only in the global regime (its slots) and the tiled
    one (a row's context and scores each); row 14, resident in bf16, row
    16's plan and no zero bias, no stage and no row 4 plan; in f32 and
    past it, row 4's plan, and a zero bias only where row 4's regime is
    not "resident" (whose kernels take no bias); tiled, a stage of a row's
    scores and d_alpha each. The row scratch's sizes come from the C size
    functions. Each launch counts under its variant and its regime."""
    monkeypatch.setattr(fe, "_n_splits", lambda *a: 3)
    sized = []
    monkeypatch.setattr(kernels, "rows_scratch",
                        lambda *a: sized.append(a) or torch.zeros((a[2], 1)))
    n, heads, d, q = 2, 2, 20, 5  # heads of 20: T = 1600 is past "tiled"
    hd = heads * d
    qkv = torch.zeros((n, t, 3 * hd), dtype=dtype)
    mask = torch.ones((n, t))
    pool = (torch.zeros((hd, q), dtype=dtype), torch.zeros((1, q)),
            torch.zeros((q, 1), dtype=dtype), torch.zeros((1, 1)))
    seed = torch.zeros(1, dtype=torch.int32)
    g = torch.zeros((n, hd), dtype=dtype)
    for m in (None, mask):
        out = fe.fused_tail_fwd(qkv, m, *pool, seed, heads, 0.2, False)
        assert out.shape == (n, hd) and out.dtype == dtype
        grads = fe.fused_tail_bwd(qkv, m, *pool, seed, g, heads, 0.2, False)
        assert grads[0].shape == qkv.shape
    fwd = fe.tail_launch_plan("fwd", n, t, heads, d, q, dtype, SMS)
    bwd = fe.tail_launch_plan("bwd", n, t, heads, d, q, dtype, SMS)
    assert fwd.regime == bwd.regime == regime
    calls = list(fake_launch)
    assert len(calls) == 4
    for args in calls[0::2]:  # row 13: 9 pointers, then 12 ints
        assert args[9:14] == (n, t, heads, d, q)
        assert args[14:19] == fwd.args()
        assert (args[8] is None) == (regime not in ("global", "tiled"))
        assert args[19] == (1 if regime == "global" else 0)
    for args in calls[1::2]:  # row 14: 23 pointers, then 23 ints
        ints = args[23:]
        assert ints[:6] == (n, t, heads, d, q, 3)
        assert ints[14:19] == bwd.args()
        assert ints[19:22] == bwd.attn_args()
        row16 = regime == "resident" and dtype == BF16
        row4 = fa.bwd_launch_plan(n, t, heads, d, dtype, SMS)
        # the zero bias of row 4
        assert (args[9] is None) == (row16 or row4.regime == "resident")
        assert ints[8:14] == ((0,) * 6 if row16 else row4.args())
        assert (ints[19:22] != (0, 0, 0)) == row16
        if regime == "tiled":  # the rows' scores and d_alpha, no slots
            assert args[20] is not None and ints[6] == 0
    itemsize = _itemsize(dtype)
    want = ([("fused_tail_fwd", "fused_tail_fwd_row_floats"),
             ("fused_tail_bwd", "fused_tail_bwd_row_floats")] * 2
            if regime == "tiled" else [])
    assert [a[:2] for a in sized] == want
    assert all(a[2] == n and a[4:] == (t, heads, d, q, itemsize)
               for a in sized)
    assert kernels.launch_counts("fused_tail_fwd") == {"tail": 1,
                                                       "tail_masked": 1}
    assert kernels.launch_counts("fused_tail_bwd") == {"tail_bwd": 1,
                                                       "tail_bwd_masked": 1}
    assert kernels.regime_counts("fused_tail_fwd") == {regime: 2}
    assert kernels.regime_counts("fused_tail_bwd") == {regime: 2}
