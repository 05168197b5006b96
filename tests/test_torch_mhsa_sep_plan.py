"""Rows 5-8 (exp-MHSA on separate q, k, v) on the CPU: the launch plans
(``fused_attention.sep_bwd_launch_plan`` for rows 6 and 8: the regime by
T, the two widths and the dtype; the resident plan's heads, buffers,
blocks and shared bytes; the tensor-core plan's tiles and chunks over
every query and key; ``sep_fwd_launch_plan`` for rows 5 and 7: the regime,
the tiles over every query, the chunks over every key, the shared bytes),
what the wrappers hand the C entry points and how they count the launch,
and the plain versions of rows 5-8 against the JAX package's Pallas
kernels (interpret mode) past T = 64, where the card takes the
tensor-core and tiled regimes.

The kernels themselves run on the card: tests/test_torch_kernel_gpu.py
and chip_smoke.py hold them to these plain versions there, and hold the
plan's shared bytes to the C side's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops.pallas import fused_attention as jfa
from newsrecommendation_tpu.ops.pallas import set_pallas_mode
from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels
from tests.test_torch_qkv_bwd_plan import _check_covers

SMS = 132  # the H100's SMs
F32, BF16 = torch.float32, torch.bfloat16


def _itemsize(dtype):
    return 2 if dtype == BF16 else 4


@pytest.mark.parametrize("t, dk, dv, dtype, regime", [
    (20, 20, 20, F32, "resident"), (20, 20, 32, BF16, "resident"),
    (20, 20, 32, F32, "resident"), (64, 20, 32, F32, "resident"),
    (64, 64, 64, BF16, "resident"), (1, 1, 1, F32, "resident"),
    (65, 20, 32, BF16, "mma"), (65, 20, 32, F32, "wide"),
    (300, 20, 32, BF16, "mma"), (511, 20, 32, BF16, "mma"),
    (511, 20, 32, F32, "wide"), (2000, 20, 32, BF16, "mma"),
    (100, 64, 8, BF16, "mma"), (100, 8, 72, BF16, "wide"),
    (5, 65, 8, F32, "wide"), (5, 8, 65, BF16, "wide")])
def test_regime_by_t_widths_and_dtype(t, dk, dv, dtype, regime):
    """Resident at T <= 64 in both dtypes; past it tensor cores in bf16 and
    the wide kernel in f32; the wide kernel wherever either width passes
    64. The plan carries the launches of its regime only."""
    plan = fa.sep_bwd_launch_plan(64, t, 20, dk, dv, dtype, SMS)
    assert plan.regime == regime
    assert fa.sep_bwd_regime(t, dk, dv, _itemsize(dtype)) == regime
    assert (plan.resident is not None) == (regime == "resident")
    assert (plan.query is not None) == (plan.key is not None) == (
        regime == "mma")
    args = plan.args()
    assert len(args) == 6 and all(isinstance(x, int) for x in args)
    if regime == "wide":
        assert args == (0,) * 6


@pytest.mark.parametrize("n, t, heads, dk, dv, dtype", [
    (7040, 20, 20, 20, 32, BF16), (7040, 20, 20, 20, 20, BF16),
    (7040, 20, 20, 20, 32, F32), (1024, 20, 20, 20, 32, F32),
    (9, 64, 5, 20, 32, BF16), (9, 64, 5, 20, 32, F32),
    (2, 64, 1, 64, 64, F32), (3, 7, 3, 4, 6, BF16), (1, 1, 1, 1, 1, F32)])
def test_resident_plan_fits_a_block_and_fills_the_card(n, t, heads, dk, dv,
                                                       dtype):
    """Row 16's resident layout at the larger width: up to four heads an
    item, one or two buffers, shared bytes as the kernel lays them out
    (nbuf buffers of q, k, v and g rows, an odd number of 16 bytes apart;
    bf16 f32 copies of k and v; round(a) and ds, (heads, T, T|1) f32
    each) within a block. Of those, the plan leaving room for the most
    blocks an SM (up to the three its registers allow), then the most
    heads, then two buffers; every item walked by as many blocks as the
    SMs then hold."""
    itemsize = _itemsize(dtype)
    r = fa.sep_bwd_launch_plan(n, t, heads, dk, dv, dtype, SMS).resident
    d = max(dk, dv)
    assert r.kind == "bwd" and r.rows == t
    assert 1 <= r.heads <= min(4, heads) and r.nbuf in (1, 2)

    def row_bytes(width, group):
        rb = group * -(-d // (16 // itemsize)) * (16 // itemsize) * width
        return rb + 16 if (rb // 16) % 2 == 0 else rb

    def smem(group, nbuf):
        wide = 2 * t * row_bytes(4, group) if itemsize == 2 else 0
        return (nbuf * 4 * t * row_bytes(itemsize, group) + wide
                + 2 * group * t * (t | 1) * 4)

    def per_sm(nbytes):
        return min(fa.SEP_PER_SM, bl.SM_SMEM // (nbytes + 1024))

    assert r.smem == smem(r.heads, r.nbuf) <= kernels.MAX_SMEM
    assert r.smem == bl.smem_bytes("bwd", t, d, itemsize, r.heads, t, r.nbuf)
    others = [(per_sm(smem(min(g, heads), b)), min(g, heads), b)
              for g in (4, 2, 1) for b in (2, 1)
              if smem(min(g, heads), b) <= kernels.MAX_SMEM]
    assert (per_sm(r.smem), r.heads, r.nbuf) == max(others)
    assert r.items == n * -(-heads // r.heads)
    assert r.blocks == min(r.items, SMS * per_sm(r.smem))


def test_resident_plan_at_the_news_encoders_shape():
    """At (7040, 20), 20 heads, d_k 20, d_v 32 in bf16: four heads and one
    buffer a block (56,320 bytes: three blocks an SM, where two buffers
    leave room for two), 396 blocks walking 35,200 items; at d_v = d_k =
    20 the plan is row 16's own."""
    r = fa.sep_bwd_launch_plan(7040, 20, 20, 20, 32, BF16, SMS).resident
    assert (r.heads, r.nbuf, r.smem, r.items, r.blocks) == (
        4, 1, 56320, 35200, 396)
    assert fa.sep_bwd_launch_plan(7040, 20, 20, 20, 20, BF16,
                                  SMS).resident == bl.launch_plan(
        "bwd", 7040, 20, 20, 20, 2, SMS)


@pytest.mark.parametrize("n, t, heads, dk, dv", [
    (64, 511, 20, 20, 32), (128, 300, 20, 20, 32), (2, 65, 2, 20, 32),
    (3, 4097, 5, 8, 12), (1, 100, 1, 64, 8), (7, 250, 3, 33, 20)])
def test_mma_plan_covers_every_query_and_key(n, t, heads, dk, dv):
    """On tensor cores each side's grid is (N*H, tiles) with tiles of 64
    or 128 rows that cover T, its chunks walk all T rows of the other
    side, its shared bytes are flash.cuh's layout at the larger width and
    fit a block."""
    plan = fa.sep_bwd_launch_plan(n, t, heads, dk, dv, BF16, SMS)
    _check_covers(plan, n, t, heads, max(dk, dv), "")
    assert plan.args() == tuple(x for p in (plan.query, plan.key)
                                for x in (p.tile, p.chunk, p.nbuf))


@pytest.mark.parametrize("n, t", [(64, 511), (128, 300)])
def test_mma_plan_fills_the_card(n, t):
    """At the user encoder's long shapes each side launches at least two
    blocks an SM (tiles of 128 rows there)."""
    plan = fa.sep_bwd_launch_plan(n, t, 20, 20, 32, BF16, SMS)
    for side in (plan.query, plan.key):
        assert side.tile == 128
        assert side.grid[0] * side.grid[1] >= 2 * SMS


@pytest.mark.parametrize("t", [5, 64, 65, 511])
def test_plan_raises_on_other_dtypes(t):
    with pytest.raises(TypeError, match="not supported"):
        fa.sep_bwd_launch_plan(2, t, 2, 4, 6, torch.float16, SMS)


# ---- rows 5 and 7: the forward's launch plan --------------------------------


@pytest.mark.parametrize("t, dk, dv, dtype, regime", [
    (20, 20, 20, F32, "rowwise"), (20, 20, 32, BF16, "rowwise"),
    (64, 20, 32, F32, "rowwise"), (64, 20, 32, BF16, "rowwise"),
    (64, 64, 64, BF16, "rowwise"), (1, 1, 1, F32, "rowwise"),
    (65, 20, 32, BF16, "mma"), (65, 20, 32, F32, "tiled"),
    (300, 20, 32, BF16, "mma"), (300, 20, 32, F32, "tiled"),
    (511, 20, 32, BF16, "mma"), (511, 20, 32, F32, "tiled"),
    (2000, 20, 32, BF16, "mma"), (100, 64, 8, BF16, "mma"),
    (100, 8, 64, F32, "tiled"), (100, 64, 64, F32, "tiled"),
    (100, 65, 8, BF16, "rowwise"), (100, 8, 65, F32, "rowwise"),
    (65, 65, 65, BF16, "rowwise"), (900, 80, 8, F32, "rowwise")])
def test_fwd_regime_by_t_widths_and_dtype(t, dk, dv, dtype, regime):
    """Row-wise at T <= 64 in both dtypes and wherever either width passes
    64; past T = 64 tensor cores in bf16 and the tiled kernel in f32. The
    plan carries a launch past the row-wise regime only, and three ints
    for the C entry point (zeros row-wise)."""
    plan = fa.sep_fwd_launch_plan(64, t, 20, dk, dv, dtype, SMS)
    assert plan.regime == regime
    assert fa.sep_fwd_regime(t, dk, dv, _itemsize(dtype)) == regime
    assert (plan.launch is None) == (regime == "rowwise")
    args = plan.args()
    assert len(args) == 3 and all(isinstance(x, int) for x in args)
    assert (args == (0,) * 3) == (regime == "rowwise")


def _covers(plan, n, t, heads):
    """The grid (N*H, tiles) covers every query once, and the chunks of a
    walk cover every key once."""
    p = plan.launch
    assert p.grid == (n * heads, -(-t // p.tile))
    queries = [i for y in range(p.grid[1])
               for i in range(y * p.tile, min(t, (y + 1) * p.tile))]
    assert queries == list(range(t))
    keys = [j for c in range(-(-t // p.chunk))
            for j in range(c * p.chunk, min(t, (c + 1) * p.chunk))]
    assert keys == list(range(t))
    assert 0 < p.smem <= kernels.MAX_SMEM


@pytest.mark.parametrize("n, t, heads, dk, dv", [
    (64, 511, 20, 20, 32), (128, 300, 20, 20, 32), (2, 65, 2, 5, 12),
    (3, 4097, 5, 8, 12), (1, 100, 1, 64, 8), (7, 250, 3, 33, 20),
    (1, 100, 1, 64, 64)])
def test_fwd_mma_plan_covers_every_query_and_key(n, t, heads, dk, dv):
    """On tensor cores a block per (row, head) and tile of 128 or 64
    queries (64 where 128 leaves fewer than two blocks an SM), two threads
    a query, chunks of 16 to 256 keys in steps of 16, one or two buffers;
    the shared bytes are flash.cuh's forward layout at the larger width:
    Q [tile], then per buffer K and V [chunk] and the mask."""
    plan = fa.sep_fwd_launch_plan(n, t, heads, dk, dv, BF16, SMS)
    p = plan.launch
    _covers(plan, n, t, heads)
    assert p.kind == "fwd" and p.threads == 2 * p.tile
    assert p.tile == bw.mma_tile(n * heads, t, SMS)
    assert p.chunk % 16 == 0 and 16 <= p.chunk <= 256 and p.nbuf in (1, 2)
    rb = bw._row_bytes(max(dk, dv))
    assert p.smem == p.tile * rb + p.nbuf * (
        2 * p.chunk * rb + -(-4 * p.chunk // 16) * 16)
    assert p.smem == bw.smem_bytes("fwd", max(dk, dv), 2, p.tile, p.chunk,
                                   p.nbuf)
    assert plan.args() == (p.tile, p.chunk, p.nbuf)


@pytest.mark.parametrize("n, t", [(64, 511), (128, 300)])
def test_fwd_mma_plan_fills_the_card(n, t):
    """At the user encoder's long shapes the forward launches tiles of 128
    queries, at least two blocks an SM, and leaves room for three blocks
    an SM by shared memory (the kernel's launch bounds)."""
    p = fa.sep_fwd_launch_plan(n, t, 20, 20, 32, BF16, SMS).launch
    assert p.tile == 128 and p.grid[0] * p.grid[1] >= 2 * SMS
    assert 3 * (p.smem + 1024) <= bw.SM_SMEM


@pytest.mark.parametrize("n, t, heads, dk, dv", [
    (64, 511, 20, 20, 32), (128, 300, 20, 20, 32), (2, 65, 2, 5, 12),
    (3, 4097, 5, 8, 12), (1, 100, 1, 64, 64), (7, 250, 3, 33, 20)])
def test_fwd_tiled_plan_covers_every_query_and_key(n, t, heads, dk, dv):
    """The tiled kernel: SEP_TILED_THREADS threads a block of one (row,
    head), one query each, SEP_TILED_CHUNK keys staged at once as f32 at
    the kernel's compile-time widths of d_k and d_v (8, 16, 24, 32 or 64),
    with the mask; one buffer."""
    plan = fa.sep_fwd_launch_plan(n, t, heads, dk, dv, F32, SMS)
    p = plan.launch
    _covers(plan, n, t, heads)
    assert p.threads == p.tile == fa.SEP_TILED_THREADS
    assert (p.chunk, p.nbuf) == (fa.SEP_TILED_CHUNK, 1)

    def width(d):
        return next(w for w in (8, 16, 24, 32, 64) if d <= w)

    assert p.smem == 4 * p.chunk * (width(dk) + width(dv) + 1)
    assert plan.args() == (p.tile, p.chunk, 1)


@pytest.mark.parametrize("t", [5, 64, 65, 511])
def test_fwd_plan_raises_on_other_dtypes(t):
    with pytest.raises(TypeError, match="not supported"):
        fa.sep_fwd_launch_plan(2, t, 2, 4, 6, torch.float16, SMS)


# ---- what the wrapper hands the C entry point -------------------------------


@pytest.fixture
def fake_launch(monkeypatch):
    """kernels.call without a card: the operand check, device context and
    stream stubbed, the entry point a function that records its arguments
    and returns 0, a global scratch of one slot."""
    import contextlib
    import types

    calls = []
    monkeypatch.setattr(kernels, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernels, "entry",
                        lambda *a: (lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(kernels, "scratch",
                        lambda *a: (torch.zeros((1, 1)), 1))
    monkeypatch.setattr(bw, "_sms", lambda device: SMS)
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()


@pytest.mark.parametrize("t, dtype, regime", [
    (20, BF16, "resident"), (20, F32, "resident"), (300, BF16, "mma"),
    (300, F32, "wide")])
def test_wrapper_launches_the_plan_and_counts_its_regime(fake_launch, t,
                                                         dtype, regime):
    """mhsa_sep_bwd hands the C entry point the operands, the shape, the
    row strides of q, k, v cut from one projection, the regime's index and
    the plan's six ints, then the slots of the wide kernel's scratch; a
    scratch only where the regime reads one. Each launch counts under its
    variant and its regime."""
    n, heads, dk, dv = 2, 3, 4, 6
    proj = torch.zeros((n, t, heads * (2 * dk + dv) + 1), dtype=dtype)
    q, k, v, _ = torch.split(proj, [heads * dk, heads * dk, heads * dv, 1],
                             -1)
    g = torch.zeros((n, t, heads * dv), dtype=dtype)
    mask = torch.ones((n, t))
    for m in (None, mask, mask):
        d_q, d_k, d_v = fa.mhsa_sep_bwd(q, k, v, m, g, heads)
        assert d_q.shape == d_k.shape == (n, t, heads * dk)
        assert d_v.shape == (n, t, heads * dv)
    plan = fa.sep_bwd_launch_plan(n, t, heads, dk, dv, dtype, SMS)
    ld = heads * (2 * dk + dv) + 1
    for args, m in zip(fake_launch, (None, mask, mask)):
        assert args[0] == q.data_ptr() and args[4] == g.data_ptr()
        assert args[3] == (None if m is None else m.data_ptr())
        assert (args[8] is None) == (regime == "resident")
        assert args[9:] == (n, t, heads, dk, dv, ld, ld, ld,
                            fa.SEP_REGIMES.index(regime), *plan.args(),
                            1 if regime == "wide" else 0, 0)
    assert kernels.launch_counts("mhsa_bwd") == {"mhsa_bwd": 1,
                                                 "mhsa_bwd_masked": 2}
    assert kernels.regime_counts("mhsa_bwd") == {regime: 3}


@pytest.mark.parametrize("t, dtype, dk, regime", [
    (20, BF16, 4, "rowwise"), (20, F32, 4, "rowwise"), (300, BF16, 4, "mma"),
    (300, F32, 4, "tiled"), (300, F32, 70, "rowwise")])
def test_fwd_wrapper_launches_the_plan_and_counts_its_regime(
        fake_launch, t, dtype, dk, regime):
    """mhsa_sep_fwd hands the C entry point the operands, the shape, the
    row strides of q, k, v cut from one projection, the regime's index and
    the plan's three ints, then the slots of the row-wise kernel's global
    scratch; a scratch only where the regime reads one. Each launch counts
    under its variant and its regime."""
    n, heads, dv = 2, 3, 6
    proj = torch.zeros((n, t, heads * (2 * dk + dv) + 1), dtype=dtype)
    q, k, v, _ = torch.split(proj, [heads * dk, heads * dk, heads * dv, 1],
                             -1)
    mask = torch.ones((n, t))
    for m in (None, mask, mask):
        out = fa.mhsa_sep_fwd(q, k, v, m, heads)
        assert out.shape == (n, t, heads * dv) and out.dtype == dtype
    plan = fa.sep_fwd_launch_plan(n, t, heads, dk, dv, dtype, SMS)
    assert plan.regime == regime
    ld = heads * (2 * dk + dv) + 1
    rowwise = regime == "rowwise"
    for args, m in zip(fake_launch, (None, mask, mask)):
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[3] == (None if m is None else m.data_ptr())
        assert (args[5] is None) == (not rowwise)
        assert args[6:] == (n, t, heads, dk, dv, ld, ld, ld,
                            fa.SEP_FWD_REGIMES.index(regime), *plan.args(),
                            1 if rowwise else 0, 0)
    assert kernels.launch_counts("mhsa_fwd") == {"mhsa": 1, "mhsa_masked": 2}
    assert kernels.regime_counts("mhsa_fwd") == {regime: 3}


# ---- the plain versions against JAX's kernels past T = 64 -------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels_past_t64(dtype, masked):
    """exp_mhsa_reference and exp_mhsa_bwd_reference against JAX's
    _fwd_call / _bwd_call (and the masked pair) in interpret mode at
    T = 80, a grid block per batch row, equal widths (where the TPU
    kernels are right), a fully masked row: the functions the card's
    tensor-core regime is held to."""
    n, t, heads, d = 2, 80, 2, 4
    rng = np.random.default_rng(21)
    q, k, v, g = (rng.normal(size=(n, t, heads * d)).astype(np.float32)
                  for _ in range(4))
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    set_pallas_mode("interpret")
    try:
        if masked:
            want = jfa._masked_fwd_call(jq, jk, jv, jnp.asarray(mask), heads,
                                        d, 1)
            wants = jfa._masked_bwd_call(jq, jk, jv, jnp.asarray(mask), jg,
                                         heads, d, 1)
        else:
            want = jfa._fwd_call(jq, jk, jv, heads, d, 1)
            wants = jfa._bwd_call(jq, jk, jv, jg, heads, d, 1)
    finally:
        set_pallas_mode("auto")
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    tm = torch.from_numpy(mask) if masked else None
    fwd_tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
               else dict(rtol=5e-2, atol=5e-2))
    bwd_tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
               else dict(rtol=5e-2, atol=5e-2))
    out = fa.exp_mhsa_reference(tq, tk, tv, tm, heads)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **fwd_tol)
    grads = fa.exp_mhsa_bwd_reference(tq, tk, tv, tm, tg, heads)
    for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **bwd_tol,
                                   err_msg=name)
    if masked:
        assert (out[1] == 0).all() and all((x[1] == 0).all() for x in grads)
