"""Rows 1-2 (the fused-qkv forward, with and without the f32 probs) and
row 11 (row 2 on 2-D I/O) on the CPU: the launch plan
(``fused_attention.fwd_launch_plan``: the regime by T, D and the dtype;
the resident plan's heads, buffers, blocks and shared bytes; the
tensor-core and tiled plans' tiles over every query and chunks over every
key), and what the wrappers hand the C entry points and how they count
the launch, for rows 1, 2 and 11 and for rows 15-16's forward where it
falls back on row 1's launch.

The kernels themselves run on the card: tests/test_torch_kernel_gpu.py and
chip_smoke.py hold them to the plain versions there, and hold the plan's
regime and shared bytes to the C side's. tests/test_torch_fused_attention.py
holds the plain versions to the JAX package.
"""

import pytest
import torch

from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels
from tests.test_torch_mhsa_sep_plan import _covers, fake_launch  # noqa: F401

SMS = 132  # the H100's SMs
F32, BF16 = torch.float32, torch.bfloat16


def _itemsize(dtype):
    return 2 if dtype == BF16 else 4


@pytest.mark.parametrize("probs", [False, True])
@pytest.mark.parametrize("t, d, dtype, regime", [
    (20, 20, F32, "resident"), (20, 20, BF16, "resident"),
    (50, 20, F32, "resident"), (64, 20, F32, "resident"),
    (64, 20, BF16, "resident"), (64, 64, BF16, "resident"),
    (64, 64, F32, "resident"), (1, 1, F32, "resident"),
    (65, 20, BF16, "mma"), (65, 20, F32, "tiled"), (65, 64, BF16, "mma"),
    (65, 64, F32, "tiled"), (300, 20, BF16, "mma"), (300, 20, F32, "tiled"),
    (511, 20, BF16, "mma"), (511, 20, F32, "tiled"), (2000, 8, BF16, "mma"),
    (64, 65, F32, "rowwise"), (64, 65, BF16, "rowwise"),
    (65, 65, BF16, "rowwise"), (400, 80, F32, "rowwise")])
def test_regime_by_t_d_and_dtype(t, d, dtype, regime, probs):
    """Resident (row 15's design) at T <= 64 with heads of up to 64, in
    both dtypes; past T = 64 tensor cores in bf16 and the tiled kernel in
    f32; row-wise wherever the head passes 64. Rows 1 and 2 take the same
    regime. The plan carries its regime's launch only, and three ints for
    the C entry points (zeros row-wise)."""
    plan = fa.fwd_launch_plan(64, t, 20, d, dtype, SMS, probs=probs)
    assert plan.regime == regime == fa.fwd_regime(t, d, _itemsize(dtype))
    assert (plan.resident is not None) == (regime == "resident")
    assert (plan.launch is not None) == (regime in ("mma", "tiled"))
    args = plan.args()
    assert len(args) == 3 and all(isinstance(x, int) for x in args)
    assert (args == (0,) * 3) == (regime == "rowwise")


@pytest.mark.parametrize("n, t, heads, d, dtype", [
    (64, 50, 20, 20, F32), (512, 50, 20, 20, F32), (1024, 20, 20, 20, F32),
    (7040, 20, 20, 20, BF16), (7040, 20, 20, 20, F32),
    (128, 50, 20, 20, BF16), (64, 50, 20, 20, BF16), (3, 7, 3, 4, BF16),
    (1, 1, 1, 1, F32), (2, 64, 1, 64, F32), (9, 64, 5, 20, BF16),
    (4, 64, 8, 50, F32)])
def test_resident_plan_fits_a_block_and_fills_the_card(n, t, heads, d,
                                                       dtype):
    """Row 15's forward layout and plan (the bias and probs take no shared
    memory): up to four heads an item and every query, one or two buffers,
    shared bytes as the kernel lays them out, within a block; the first
    plan (two buffers, then one; most heads first) that leaves room for
    two blocks an SM; the grid is as many blocks as the SMs hold, at least
    two an SM, or one per item."""
    itemsize = _itemsize(dtype)
    for probs in (False, True):
        r = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS,
                               probs=probs).resident
        assert r.kind == "fwd" and r.rows == t
        assert 1 <= r.heads <= min(4, heads) and r.nbuf in (1, 2)
        assert r.smem == bl.smem_bytes("fwd", t, d, itemsize, r.heads, t,
                                       r.nbuf)
        assert r.smem <= kernels.MAX_SMEM == 232448
        per_sm = min(bl.MAX_PER_SM, bl.SM_SMEM // (r.smem + 1024))
        assert r.items == n * -(-heads // r.heads)
        assert r.blocks == min(r.items, SMS * max(per_sm, 2))
        assert r == bl.launch_plan("fwd", n, t, heads, d, itemsize, SMS)
        # no plan before it in that order leaves room for two blocks an SM
        order = [(min(heads, g), b) for b in (2, 1) for g in (4, 2, 1)]
        assert per_sm >= 2 or all(
            bl.SM_SMEM // (bl.smem_bytes("fwd", t, d, itemsize, g, t, b)
                           + 1024) < 2 for g, b in order)
        assert all(
            bl.SM_SMEM // (bl.smem_bytes("fwd", t, d, itemsize, g, t, b)
                           + 1024) < 2
            for g, b in order[:order.index((r.heads, r.nbuf))])
        assert fa.fwd_launch_plan(n, t, heads, d, dtype, SMS,
                                  probs=probs).args() == (r.heads, r.nbuf,
                                                          r.blocks)


@pytest.mark.parametrize("n, t, heads, d, dtype, want", [
    (7040, 20, 20, 20, BF16, (4, 2)), (1024, 20, 20, 20, F32, (4, 2)),
    (64, 50, 20, 20, F32, (2, 2)), (512, 50, 20, 20, F32, (2, 2))])
def test_resident_plan_at_the_main_shapes(n, t, heads, d, dtype, want):
    """The news encoder (7040, 20) and the corpus chunk (1024, 20) take
    four heads an item in two buffers, as row 15 does; the 50-news user
    encoder two heads (four leave room for one block an SM)."""
    r = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS).resident
    assert (r.heads, r.nbuf) == want


@pytest.mark.parametrize("n, t, heads, d", [
    (128, 300, 20, 20), (64, 511, 20, 20), (2, 65, 2, 5), (3, 4097, 5, 8),
    (1, 100, 1, 64), (7, 250, 3, 33), (16, 400, 8, 50)])
def test_mma_plan_covers_every_query_and_key(n, t, heads, d):
    """On tensor cores rows 5 and 7's layout at d_k = d_v = D: a block per
    (row, head) and tile of 128 or 64 queries, two threads a query, chunks
    of 16 to 256 keys in steps of 16, one or two buffers; the shared bytes
    are flash.cuh's forward layout. Row 2's plan is row 1's with a probs
    tile per warp of 16 queries, 16 rows of FWD_MMA_PROBS_ROW floats,
    within a block."""
    plan = fa.fwd_launch_plan(n, t, heads, d, BF16, SMS)
    probs = fa.fwd_launch_plan(n, t, heads, d, BF16, SMS, probs=True)
    p = plan.launch
    assert probs.launch == p._replace(smem=p.smem + 4 * p.tile * 40)
    assert probs.launch.smem <= kernels.MAX_SMEM
    _covers(plan, n, t, heads)
    assert p.kind == "fwd" and p.threads == 2 * p.tile
    assert p.tile == bw.mma_tile(n * heads, t, SMS)
    assert p.chunk % 16 == 0 and 16 <= p.chunk <= 256 and p.nbuf in (1, 2)
    assert p.smem == bw.smem_bytes("fwd", d, 2, p.tile, p.chunk, p.nbuf)
    assert plan.args() == (p.tile, p.chunk, p.nbuf)


@pytest.mark.parametrize("probs", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [
    (128, 300, 20, 20), (64, 511, 20, 20), (2, 65, 2, 5), (3, 4097, 5, 8),
    (1, 100, 1, 64), (16, 400, 8, 50), (2, 90, 2, 17), (2, 90, 2, 21)])
def test_tiled_plan_covers_every_query_and_key(n, t, heads, d, probs):
    """The tiled kernel: SEP_TILED_THREADS threads a block of one (row,
    head), one query each, SEP_TILED_CHUNK keys staged at once as f32 at
    the kernel's compile-time width (8, 16, 20, 24, 32 or 64) for K and V,
    with the mask; one buffer; row 2 adds a tile of FWD_PROBS_KEYS keys'
    a, a row of FWD_PROBS_ROW floats per query."""
    plan = fa.fwd_launch_plan(n, t, heads, d, F32, SMS, probs=probs)
    p = plan.launch
    _covers(plan, n, t, heads)
    assert p.threads == p.tile == fa.SEP_TILED_THREADS == 128
    assert (p.chunk, p.nbuf) == (fa.SEP_TILED_CHUNK, 1) == (128, 1)
    width = next(w for w in (8, 16, 20, 24, 32, 64) if d <= w)
    assert p.smem == 4 * 128 * (2 * width + 1) + (4 * 128 * 33 if probs
                                                  else 0)
    assert plan.args() == (128, 128, 1)


@pytest.mark.parametrize("t", [5, 64, 65, 511])
def test_plan_raises_on_other_dtypes(t):
    with pytest.raises(TypeError, match="not supported"):
        fa.fwd_launch_plan(2, t, 2, 4, torch.float16, SMS)


# ---- what the wrappers hand the C entry points ------------------------------


def _expect(args, qkv, bias, mask, regime, plan, n, t, heads, d,
            probs=False):
    """The arguments of one faked launch of row 1 (or 2 and 11,
    ``probs``): qkv, bias, mask, out, (probs,) the biased copy (tensor
    cores only), the global stage (row-wise only), the shape, the regime's
    index, the plan's three ints, the slots, the stream."""
    off = 1 if probs else 0
    assert args[0] == qkv.data_ptr() and args[1] == bias.data_ptr()
    assert args[2] == (None if mask is None else mask.data_ptr())
    assert all(isinstance(x, int) for x in args[3:4 + off])
    assert (args[4 + off] is not None) == (regime == "mma")
    assert (args[5 + off] is not None) == (regime == "rowwise")
    assert args[6 + off:] == (n, t, heads, d, fa.FWD_REGIMES.index(regime),
                              *plan.args(),
                              1 if regime == "rowwise" else 0, 0)


@pytest.mark.parametrize("t, d, dtype, regime", [
    (20, 4, BF16, "resident"), (50, 4, F32, "resident"),
    (300, 4, BF16, "mma"), (300, 4, F32, "tiled"), (20, 70, F32, "rowwise"),
    (300, 70, BF16, "rowwise")])
def test_rows_1_and_2_launch_the_plan_and_count_its_regime(fake_launch, t, d,
                                                          dtype, regime):
    """Row 1 (the forward without probs) and row 2 (with) hand the C entry
    points the operands, the shape, the regime's index and the plan's
    three ints, then the slots of the row-wise kernel's global scratch; the
    biased copy only on tensor cores, the global scratch only row-wise.
    Each launch counts under its variant and its regime."""
    n, heads = 2, 3
    qkv = torch.zeros((n, t, 3 * heads * d), dtype=dtype)
    bias = torch.zeros((3 * heads * d,), dtype=dtype)
    mask = torch.ones((n, t))
    for m in (None, mask, mask):
        out = fa._launch("bias" if m is None else "bias_masked", qkv, bias, m,
                         heads)
        assert out.shape == (n, t, heads * d) and out.dtype == dtype
    for m in (None, mask):
        ctx, probs = fa.qkv_fwd_probs(qkv, bias, m, heads)
        assert ctx.shape == (n, t, heads * d)
        assert probs.shape == (n, t, heads * t) and probs.dtype == F32
    plan = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS)
    assert plan.regime == regime
    calls = list(fake_launch)
    for args, m in zip(calls[:3], (None, mask, mask)):
        _expect(args, qkv, bias, m, regime, plan, n, t, heads, d)
    probs_plan = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS, probs=True)
    for args, m in zip(calls[3:], (None, mask)):
        _expect(args, qkv, bias, m, regime, probs_plan, n, t, heads, d,
                probs=True)
    assert kernels.launch_counts("qkv_fwd") == {"bias": 1, "bias_masked": 2}
    assert kernels.launch_counts("qkv_fwd_probs") == {
        "bias_probs": 1, "bias_masked_probs": 1}
    assert kernels.regime_counts("qkv_fwd") == {regime: 3}
    assert kernels.regime_counts("qkv_fwd_probs") == {regime: 2}


@pytest.mark.parametrize("t, d, dtype, regime", [
    (20, 4, BF16, "resident"), (300, 4, BF16, "mma"), (300, 4, F32, "tiled"),
    (20, 70, F32, "rowwise")])
def test_row_11_launches_row_2s_plan(fake_launch, t, d, dtype, regime):
    """Row 11 (2-D I/O) launches row 2's entry point on the (N, T, 3HD)
    view of its (N*T, 3HD) input, unmasked, in row 2's regime and plan,
    and counts as row 11 under that regime."""
    n, heads = 2, 3
    qkv2d = torch.zeros((n * t, 3 * heads * d), dtype=dtype)
    bias = torch.zeros((3 * heads * d,), dtype=dtype)
    out, probs = q2.qkv2d_fwd(qkv2d, bias, heads, t)
    assert out.shape == (n, t, heads * d) and probs.shape == (n, t, heads * t)
    plan = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS, probs=True)
    assert plan.regime == regime
    (args,) = fake_launch
    _expect(args, qkv2d, bias, None, regime, plan, n, t, heads, d,
            probs=True)
    assert kernels.launch_counts("qkv2d_fwd") == {"fwd2d": 1}
    assert kernels.regime_counts("qkv2d_fwd") == {regime: 1}


@pytest.mark.parametrize("t, d, dtype, regime", [
    (20, 80, F32, "rowwise"), (400, 64, F32, "tiled"),
    (1300, 20, BF16, "mma")])
def test_blanes_fallback_launches_row_1s_plan(fake_launch, t, d, dtype,
                                              regime):
    """Rows 15-16's forward past its own layouts (heads wider than 64, or
    one head's K and V past a block: f32 D = 64 past T = 318, bf16 D <= 32
    past 1,232) launches row 1's entry point with a zero bias, in row 1's
    plan, counted as row 15 under that regime."""
    n, heads = 2, 1
    assert bl.regime(t, d, _itemsize(dtype)) == "qkv"
    qkv = torch.zeros((n, t, 3 * heads * d), dtype=dtype)
    mask = torch.ones((n, t))
    bl.blanes_fwd(qkv, mask, heads)
    plan = fa.fwd_launch_plan(n, t, heads, d, dtype, SMS)
    assert plan.regime == regime
    (args,) = fake_launch
    assert args[0] == qkv.data_ptr() and args[2] == mask.data_ptr()
    assert (args[4] is not None) == (regime == "mma")
    assert (args[5] is not None) == (regime == "rowwise")
    assert args[6:] == (n, t, heads, d, fa.FWD_REGIMES.index(regime),
                        *plan.args(), 1 if regime == "rowwise" else 0, 0)
    assert kernels.launch_counts("blanes_fwd") == {"blanes": 0,
                                                   "blanes_masked": 1}
    assert kernels.regime_counts("blanes_fwd") == {regime: 1}
    assert not any(kernels.launch_counts("qkv_fwd").values())
