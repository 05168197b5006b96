"""Rows 1-4 past the resident kernel, on the CPU: the launch plan of rows
3-4 (``fused_attention.bwd_launch_plan``: the regime by dtype, T and D, and
on tensor cores tiles and chunks that cover every query and key, fit a
block and fill the card), and the plain versions of rows 1-4 against the
JAX package's Pallas kernels (interpret mode) at a head width the card's
old limits refused (D = 50).

The kernels themselves run on the card: tests/test_torch_kernel_gpu.py
and chip_smoke.py hold them to these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops.pallas import fused_attention as jfa
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels

SMS = 132  # the H100's SMs


@pytest.mark.parametrize("d, t, dtype, regime", [
    (20, 20, torch.float32, "resident"), (20, 201, torch.bfloat16, "resident"),
    (20, 201, torch.float32, "resident"), (20, 202, torch.bfloat16, "mma"),
    (20, 202, torch.float32, "tiled"), (20, 511, torch.bfloat16, "mma"),
    (20, 599, torch.float32, "tiled"),
    (20, 600, torch.float32, "tiled_global"),
    (20, 5000, torch.bfloat16, "mma"), (50, 50, torch.bfloat16, "resident"),
    (50, 300, torch.bfloat16, "mma"), (50, 300, torch.float32, "tiled_global"),
    (50, 400, torch.bfloat16, "mma"), (64, 212, torch.bfloat16, "mma"),
    (80, 300, torch.bfloat16, "tiled_global"),
    (400, 20, torch.float32, "resident"),
    (400, 40, torch.bfloat16, "tiled_global")])
def test_plan_takes_the_regime_of_dtype_and_t(d, t, dtype, regime):
    """Resident wherever its T x T block fits (both dtypes); past it bf16
    heads of up to 64 on tensor cores, f32 and wider heads on the tiled
    kernel, in shared memory while it fits and in global slots after."""
    assert fa.bwd_launch_plan(64, t, 20, d, dtype, SMS).regime == regime
    assert fa.resident(t, d) == (regime == "resident")


@pytest.mark.parametrize("n, t, heads, d", [
    (64, 511, 20, 20), (128, 300, 20, 20), (128, 512, 20, 20),
    (2, 1000, 20, 20), (4, 300, 8, 50), (4, 400, 8, 50), (1, 202, 1, 64),
    (3, 4097, 5, 8), (7, 250, 3, 33)])
def test_mma_plan_covers_every_query_and_key(n, t, heads, d):
    """On tensor cores each side's grid is (N*H, tiles) with tiles of 64 or
    128 rows that cover T, 16 rows a warp; its chunks of 16 to 256 rows
    walk all T rows of the other side; its shared bytes are flash.cuh's
    layout and fit a block."""
    _check_covers(fa.bwd_launch_plan(n, t, heads, d, torch.bfloat16, SMS),
                  n, t, heads, d, "")


def _check_covers(plan, n, t, heads, d, suffix):
    """Each side's grid, tile, chunk walk, buffers and shared bytes (of
    blockwise.smem_bytes's kind, + ``suffix``)."""
    assert plan.regime == "mma"
    for side, kind in ((plan.query, "bwd_query"), (plan.key, "bwd_key")):
        kind += suffix
        assert side.kind == kind and side.tile in (64, 128)
        assert side.grid == (n * heads, -(-t // side.tile))
        rows = set()
        for y in range(side.grid[1]):
            rows.update(range(y * side.tile, min(t, (y + 1) * side.tile)))
        assert rows == set(range(t))  # every own row once
        assert side.threads == 2 * side.tile  # a warp per 16 rows
        assert 16 <= side.chunk <= 256 and side.chunk % 16 == 0
        walked = set()
        for c in range(-(-t // side.chunk)):
            walked.update(range(c * side.chunk,
                                min(t, (c + 1) * side.chunk)))
        assert walked == set(range(t))
        assert side.nbuf in (1, 2)
        assert side.smem == bw.smem_bytes(kind, d, 2, side.tile, side.chunk,
                                          side.nbuf)
        assert side.smem <= kernels.MAX_SMEM == 232448
    assert plan.args() == (plan.query.tile, plan.query.chunk,
                           plan.query.nbuf, plan.key.tile, plan.key.chunk,
                           plan.key.nbuf)


@pytest.mark.parametrize("n, t, heads, d", [
    (64, 511, 20, 20), (128, 300, 20, 20), (128, 512, 20, 20),
    (2, 1000, 20, 20), (4, 300, 8, 50), (1, 202, 1, 64), (3, 4097, 5, 8),
    (7, 250, 3, 33)])
def test_probs_plan_covers_every_query_and_key(n, t, heads, d):
    """Row 3's plan (probs=True) covers as row 4's does; each side also
    stages the f32 probs of its chunk over its tile, rows 4 floats longer
    than they are wide (room for a 16-byte copy's shift), so its shared
    bytes exceed row 4's at the same tile, chunk and buffers by exactly
    that tile per buffer."""
    plan = fa.bwd_launch_plan(n, t, heads, d, torch.bfloat16, SMS, probs=True)
    _check_covers(plan, n, t, heads, d, "_probs")
    for side, kind in ((plan.query, "bwd_query"), (plan.key, "bwd_key")):
        rows, cols = ((side.tile, side.chunk) if kind == "bwd_query"
                      else (side.chunk, side.tile))
        assert side.smem - bw.smem_bytes(
            kind, d, 2, side.tile, side.chunk, side.nbuf) == (
                side.nbuf * 4 * rows * (cols + 4))
    assert fa.bwd_launch_plan(n, t, heads, d, torch.float32, SMS,
                              probs=True) == fa.bwd_launch_plan(
                                  n, t, heads, d, torch.float32, SMS)


@pytest.mark.parametrize("n, t", [(64, 511), (128, 300), (128, 512)])
def test_mma_plan_fills_the_card(n, t):
    """At the training shapes each side puts at least two blocks on every
    SM, and each block's shared bytes leave room for two an SM."""
    plan = fa.bwd_launch_plan(n, t, 20, 20, torch.bfloat16, SMS)
    for side in (plan.query, plan.key):
        assert side.grid[0] * side.grid[1] >= 2 * SMS
        assert 2 * (side.smem + 1024) <= bw.SM_SMEM


@pytest.mark.parametrize("n, t", [(64, 511), (128, 300), (128, 512)])
def test_probs_plan_fills_the_card(n, t):
    """Row 3's plan, with its probs tiles, fills the card as row 4's."""
    plan = fa.bwd_launch_plan(n, t, 20, 20, torch.bfloat16, SMS, probs=True)
    for side in (plan.query, plan.key):
        assert side.grid[0] * side.grid[1] >= 2 * SMS
        assert 2 * (side.smem + 1024) <= bw.SM_SMEM


@pytest.mark.parametrize("t", [5, 201, 202, 700, 10000])
@pytest.mark.parametrize("d", [4, 20, 50, 64, 65, 400])
def test_plan_raises_on_f16_only(t, d):
    """Every T and D has a plan in f32 and bf16; other dtypes raise."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = fa.bwd_launch_plan(3, t, 2, d, dtype, SMS)
        assert plan.regime in fa.REGIMES
        assert (plan.query is None) == (plan.regime != "mma")
        assert plan.regime != "mma" or dtype == torch.bfloat16 and d <= 64
    with pytest.raises(TypeError):
        fa.bwd_launch_plan(3, t, 2, d, torch.float16, SMS)


# ---- the plain versions against JAX at D = 50 -------------------------------

N, T, HEADS, D = 3, 40, 2, 50
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def interpret():
    set_pallas_mode("interpret")
    set_fused_tail("off")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")


def _case(dtype, masked, seed=3):
    rng = np.random.default_rng(seed)
    hd = HEADS * D
    qkv = rng.normal(size=(N, T, 3 * hd)).astype(np.float32)
    bias = rng.normal(scale=0.5, size=(3 * hd,)).astype(np.float32)
    g = rng.normal(size=(N, T, hd)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((N, T)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        mask[1] = 0.0  # a fully masked row
    tt = getattr(torch, dtype)
    jt = getattr(jnp, dtype)
    port = (torch.from_numpy(qkv).to(tt), torch.from_numpy(bias).to(tt),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(g).to(tt))
    ref = (jnp.asarray(qkv, jt), jnp.asarray(bias, jt),
           None if mask is None else jnp.asarray(mask), jnp.asarray(g, jt))
    return port, ref


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_rows_1_2_plain_match_jax_at_d50(interpret, dtype, masked):
    (qkv, bias, mask, _), (jq, jb, jm, _) = _case(dtype, masked)
    ctx, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, mask, HEADS)
    ref1 = jfa._qkv_fwd_call(jq, jm, HEADS, D, 128, bias=jb)
    ref2, ref_probs = jfa._qkv_fwd_probs_call(jq, jm, HEADS, D, 128, bias=jb)
    np.testing.assert_allclose(_np(ctx), _np(ref1), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(ctx), _np(ref2), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(probs), _np(ref_probs),
                               **FWD_TOL["float32"])
    if masked:
        assert (ctx[1] == 0).all() and (probs[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_rows_3_4_plain_match_jax_at_d50(interpret, dtype, masked):
    (qkv, bias, mask, g), (jq, jb, jm, jg) = _case(dtype, masked, seed=4)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, mask, HEADS)
    _, jprobs = jfa._qkv_fwd_probs_call(jq, jm, HEADS, D, 128, bias=jb)
    row3 = fa.qkv_bwd_probs_reference(qkv, bias, probs, g, HEADS)
    row4 = fa.qkv_bwd_reference(qkv, bias, mask, g, HEADS)
    ref3 = jfa._qkv_bwd_probs_call(jq, jprobs, jg, HEADS, D, 128, bias=jb)
    ref4 = jfa._qkv_bwd_call(jq, jm, jg, HEADS, D, 128, bias=jb)
    np.testing.assert_allclose(_np(row3), _np(ref3), **BWD_TOL[dtype])
    np.testing.assert_allclose(_np(row4), _np(ref4), **BWD_TOL[dtype])
    assert torch.equal(row3, row4)
    if masked:
        assert (row4[1] == 0).all()


# ---- launches counted per regime --------------------------------------------


@pytest.fixture
def fake_launch(monkeypatch):
    """kernels.call without a card: the device context and stream stubbed,
    every entry point a function that queues nothing and returns 0, a
    global scratch of one slot."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernels, "entry", lambda *a: (lambda *args: 0))
    monkeypatch.setattr(kernels, "scratch",
                        lambda *a: (torch.zeros((1, 1)), 1))
    monkeypatch.setattr(bw, "_sms", lambda device: SMS)
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


@pytest.mark.parametrize("t, dtype, regime", [
    (50, torch.bfloat16, "resident"), (300, torch.bfloat16, "mma"),
    (300, torch.float32, "tiled"), (700, torch.float32, "tiled_global")])
def test_launches_are_counted_per_regime(fake_launch, t, dtype, regime):
    """Rows 3 and 4 count each launch under their variant and under the
    regime their plan took, which regime_counts sums over the variants;
    a reset clears both."""
    n, heads, d = 2, 4, 20
    qkv = torch.zeros((n, t, 3 * heads * d), dtype=dtype)
    bias = torch.zeros(3 * heads * d, dtype=dtype)
    g = torch.zeros((n, t, heads * d), dtype=dtype)
    probs = torch.zeros((n, t, heads * t))
    mask = torch.ones((n, t))
    fa._bwd_call("bwd_probs", "qkv_bwd_probs", "qkv_bwd_probs", qkv, bias,
                 probs, g, torch.empty_like(qkv), n, t, heads, d)
    for m in (None, mask, mask):
        fa._bwd_call("bwd" if m is None else "bwd_masked", "qkv_bwd",
                     "qkv_bwd", qkv, bias, m, g, torch.empty_like(qkv), n, t,
                     heads, d)
    assert kernels.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    assert kernels.launch_counts("qkv_bwd") == {"bwd": 1, "bwd_masked": 2}
    assert kernels.regime_counts("qkv_bwd_probs") == {regime: 1}
    assert kernels.regime_counts("qkv_bwd") == {regime: 3}
    assert kernels.regime_counts("fused_tail_bwd") == {}
    kernels.reset_launch_counts()
    assert kernels.regime_counts("qkv_bwd") == {}
    assert not any(kernels.launch_counts("qkv_bwd").values())


@pytest.mark.parametrize("overrides, want", [
    ({}, {"qkv_fwd_probs": {"resident": 24},
          "qkv_bwd_probs": {"resident": 24}}),
    ({"user_log_length": 300}, {"qkv_fwd_probs": {"resident": 12,
                                                  "mma": 12},
                                "qkv_bwd_probs": {"resident": 12,
                                                  "mma": 12}}),
    ({"user_log_length": 300, "bwd_residuals": "recompute"},
     {"qkv_fwd": {"resident": 12, "mma": 12},
      "qkv_bwd": {"resident": 12, "mma": 12}}),
    ({"user_log_length": 512}, {"qkv_fwd_probs": {"resident": 12},
                                "qkv_bwd_probs": {"resident": 12},
                                "flash_fwd": {"mma": 12},
                                "flash_bwd": {"mma": 12}}),
    ({"user_log_length": 512, "compute_dtype": "float32"},
     {"qkv_fwd_probs": {"resident": 12}, "qkv_bwd_probs": {"resident": 12},
      "flash_fwd": {"cuda_core": 12}, "flash_bwd": {"cuda_core": 12}}),
    ({"user_log_length": 512, "fused_tail": "on"},
     {"fused_tail_fwd": {"resident": 12, "tiled": 12},
      "fused_tail_bwd": {"resident": 12, "tiled": 12}}),
    ({"user_log_length": 300, "compute_dtype": "float32"},
     {"qkv_fwd_probs": {"resident": 12, "tiled": 12},
      "qkv_bwd_probs": {"resident": 12, "tiled": 12}}),
    ({"attention_layout": "blanes"}, {})])
def test_smoke_expects_each_encoders_regime(overrides, want):
    """chip_smoke's expected launches per regime of a train run: each
    encoder's forward (rows 1-2, fwd_launch_plan) and backward (rows 3-4,
    bwd_launch_plan) in the regime of its length's plan (the news encoder
    at 20 words, the user encoder at user_log_length), none for the user
    encoder on the flash route (512 news), where rows 9-10 take it in
    blockwise.launch_plan's regime (tensor cores in bf16, CUDA cores in
    f32), none where rows 15-16 take both; with the fused tail rows 13-14
    in their tail_launch_plan's regimes (resident at 20 words, tiled at
    512 news)."""
    import chip_smoke

    from newsrecommendation_tpu_torch.config import Config

    cfg = Config(compute_dtype="bfloat16").replace(**overrides)
    assert chip_smoke.expected_regimes(12, cfg) == want


# ---- the resident regime's plan (csrc/qkv_bwd.cuh, namespace qb) ------------

F32, BF16 = torch.float32, torch.bfloat16
# Every shape the smoke and the card tests give the short kernel, and some
# it must take: (N, T, H, D).
SHORT_SHAPES = [(7040, 20, 20, 20), (128, 50, 20, 20), (1024, 20, 20, 20),
                (64, 50, 20, 20), (7, 5, 3, 4), (6, 40, 3, 5), (4, 17, 5, 8),
                (5, 64, 4, 20), (3, 33, 2, 32), (2, 64, 2, 32), (9, 31, 6, 24),
                (300, 20, 7, 20), (1, 1, 1, 1), (64, 20, 4, 8)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("probs", [False, True])
def test_resident_plan_fits_a_block_at_every_shape(dtype, probs):
    """Every (T, D) of the resident regime (T up to 201 at D = 20, heads up
    to 64 at T = 20) has a plan within a block's 232,448 bytes: the short
    kernel's (T <= 64, D <= 32; 256 threads, its layout's bytes) or the
    first design's (one block of 128 threads per (row, head))."""
    itemsize = 2 if dtype == BF16 else 4
    shapes = [(t, 20) for t in range(1, 202)]
    shapes += [(t, d) for t in (1, 7, 20, 32, 33, 50, 64, 65)
               for d in range(1, 65)]
    for t, d in shapes:
        plan = fa.bwd_launch_plan(16, t, 20, d, dtype, SMS, probs=probs)
        assert plan.regime == "resident", (t, d)
        r = plan.resident
        assert r.smem <= kernels.MAX_SMEM == 232448
        if fa.short_resident(t, d):
            assert r.threads == fa.RES_THREADS == 256
            assert r.smem == fa.resident_smem(t, d, itemsize, r.heads,
                                              r.nbuf, probs)
        else:
            assert (r.heads, r.nbuf, r.threads) == (1, 1, 128)
            assert r.items == r.blocks == 16 * 20
        assert plan.args() == (r.heads, r.nbuf, r.blocks, r.threads, r.smem,
                               0)


@pytest.mark.parametrize("n, t, heads, d", SHORT_SHAPES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_resident_items_cover_every_row_and_head_once(n, t, heads, d, dtype):
    """The short kernel's items (batch row n, heads h0 .. h0 + gn - 1 of
    group item % groups) cover each (row, head) exactly once, and the grid's
    walk (block b takes items b, b + blocks, ...) each item exactly once."""
    for probs in (False, True):
        r = fa.bwd_launch_plan(n, t, heads, d, dtype, SMS,
                               probs=probs).resident
        groups = -(-heads // r.heads)
        assert r.items == n * groups and 1 <= r.heads <= min(4, heads)
        seen = np.zeros((n, heads), dtype=int)
        for item in range(r.items):
            row, grp = divmod(item, groups)
            h0 = grp * r.heads
            seen[row, h0:h0 + min(r.heads, heads - h0)] += 1
        assert (seen == 1).all()
        walked = sorted(i for b in range(r.blocks)
                        for i in range(b, r.items, r.blocks))
        assert walked == list(range(r.items))


def _batches(gn, t, warp, rb, warps=8):
    """qb::for_batches: warp ``warp``'s batches (head, first row, rows)."""
    rows = gn * t
    lo, hi = warp * rows // warps, (warp + 1) * rows // warps
    out = []
    while lo < hi:
        h, i = divmod(lo, t)
        k = min(rb, hi - lo, t - i)
        out.append((h, i, k))
        lo += k
    return out


@pytest.mark.parametrize("t", [1, 5, 17, 20, 32, 33, 50, 64])
@pytest.mark.parametrize("gn", [1, 2, 3, 4])
def test_resident_phases_cover_every_row_and_output_once(t, gn):
    """Inside an item of gn heads: phase A's batches (at most 5 rows of one
    head where a lane holds one key, 3 where it holds two) take each (head,
    row) once, every warp within one row of an even share; phase B's
    tasks (product, head, four rows, four lanes) take each output once."""
    rb = 5 if t <= 32 else 3
    seen = np.zeros((gn, t), dtype=int)
    shares = []
    for warp in range(8):
        batches = _batches(gn, t, warp, rb)
        shares.append(sum(k for _, _, k in batches))
        for h, i, k in batches:
            assert 1 <= k <= rb and i + k <= t
            seen[h, i:i + k] += 1
    assert (seen == 1).all()
    assert max(shares) - min(shares) <= 1
    for d in (1, 4, 5, 20, 32):
        nrt, ndt = -(-t // 4), -(-d // 4)
        per_head = nrt * ndt
        per_prod = gn * per_head
        out = np.zeros((3, gn, t, d), dtype=int)
        for task in range(3 * per_prod):
            prod, rest = divmod(task, per_prod)
            hl, rest = divmod(rest, per_head)
            rt, dt = divmod(rest, ndt)
            out[prod, hl, 4 * rt:4 * rt + 4, 4 * dt:4 * dt + 4] += 1
        assert (out == 1).all()


@pytest.mark.parametrize("n, t", [(7040, 20), (128, 50)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_resident_plan_fills_the_card(n, t, dtype):
    """At the news encoder's (7040, 20) and the L = 50 user encoder's
    (128, 50) the short kernel puts on every SM the blocks its registers
    allow (RES_PER_SM: three for row 3, two for row 4), each block's shared
    bytes leaving room for them."""
    for probs, per_sm in ((True, 3), (False, 2)):
        r = fa.bwd_launch_plan(n, t, 20, 20, dtype, SMS, probs=probs).resident
        assert fa.RES_PER_SM[probs] == per_sm
        assert r.blocks == min(r.items, SMS * per_sm) == SMS * per_sm
        assert per_sm * (r.smem + 1024) <= bw.SM_SMEM


@pytest.mark.parametrize("t, d, kind", [
    (64, 20, "short"), (65, 20, "first"), (20, 32, "short"),
    (20, 33, "first"), (201, 20, "first"), (202, 20, None),
    (64, 32, "short"), (64, 33, "first")])
def test_resident_regime_edges(t, d, kind):
    """The short kernel takes T <= 64 at heads of up to 32, the first
    design the rest of the resident range (T <= 201 at D = 20); past it
    another regime, in both dtypes."""
    for dtype in (F32, BF16):
        plan = fa.bwd_launch_plan(8, t, 4, d, dtype, SMS)
        if kind is None:
            assert plan.regime != "resident" and plan.resident is None
            continue
        assert plan.regime == "resident"
        assert fa.short_resident(t, d) == (kind == "short")
        assert plan.resident.threads == (256 if kind == "short" else 128)


@pytest.mark.parametrize("t, d, dtype", [
    (20, 20, BF16), (50, 20, F32), (65, 20, BF16), (300, 20, BF16),
    (300, 20, F32)])
def test_rows_3_4_12_hand_the_c_side_the_plan(fake_args, t, d, dtype):
    """Rows 3, 4 (both masks) and 12 (on row 3's entry point, its (N, T,
    3HD) view) hand the C entry points qkv, the bias, probs or the mask,
    g, dqkv, the scratch of the regime, the shape and the plan's six ints,
    then the slots; each counts under its variant and the plan's regime."""
    n, heads = 3, 5
    hd = heads * d
    qkv = torch.zeros((n, t, 3 * hd), dtype=dtype)
    bias = torch.zeros(3 * hd, dtype=dtype)
    g = torch.zeros((n, t, hd), dtype=dtype)
    probs = torch.zeros((n, t, heads * t))
    mask = torch.ones((n, t))
    fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
    fa.qkv_bwd(qkv, bias, None, g, heads)
    fa.qkv_bwd(qkv, bias, mask, g, heads)
    q2.qkv2d_bwd(qkv.view(n * t, -1), bias, probs, g, heads, t)
    plans = [fa.bwd_launch_plan(n, t, heads, d, dtype, SMS, probs=p)
             for p in (True, False, False, True)]
    for (lib, fn, args), plan, third in zip(fake_args, plans,
                                            (probs, None, mask, probs)):
        assert (lib, fn) == (("qkv_bwd", "qkv_bwd") if third is not probs
                             else ("qkv_bwd_probs", "qkv_bwd_probs"))
        assert args[:5] == (qkv.data_ptr(), bias.data_ptr(),
                            kernels.ptr(third), g.data_ptr(), args[4])
        assert (args[5] is not None) == (plan.regime == "mma")  # biased
        assert (args[6] is not None) == (plan.regime == "mma")  # stats
        assert args[8:12] == (n, t, heads, d)
        assert args[12:18] == plan.args()
    regime = plans[0].regime
    assert kernels.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    assert kernels.launch_counts("qkv_bwd") == {"bwd": 1, "bwd_masked": 1}
    assert kernels.launch_counts("qkv2d_bwd") == {"bwd2d": 1}
    for k, count in (("qkv_bwd_probs", 1), ("qkv_bwd", 2), ("qkv2d_bwd", 1)):
        assert kernels.regime_counts(k) == {regime: count}


@pytest.mark.parametrize("t, d, dtype, regime", [
    (20, 20, F32, "resident"), (20, 80, BF16, "resident"),
    (300, 20, BF16, "mma"), (300, 20, F32, "tiled")])
def test_no_bias_takes_no_zeros_in_the_resident_regime(fake_args, t, d,
                                                       dtype, regime):
    """A launch on qkv that carries its bias (rows 14 and 16 past their own
    kernels) hands a null bias to the resident regime, whose kernels add
    none, and a zero bias (3HD zeros) to the others."""
    n, heads = 2, 3
    hd = heads * d
    qkv = torch.zeros((n, t, 3 * hd), dtype=dtype)
    g = torch.zeros((n, t, hd), dtype=dtype)
    fa._bwd_call("bwd", "qkv_bwd", "qkv_bwd", qkv, None, None, g,
                 torch.empty_like(qkv), n, t, heads, d)
    ((_, _, args),) = fake_args
    assert fa.bwd_launch_plan(n, t, heads, d, dtype, SMS).regime == regime
    assert (args[1] is None) == (regime == "resident")
    assert kernels.regime_counts("qkv_bwd") == {regime: 1}


@pytest.fixture
def fake_args(monkeypatch):
    """kernels.call without a card, each entry point recording (source,
    entry, arguments) and returning 0; a global scratch of one slot."""
    import contextlib
    import types

    calls = []
    monkeypatch.setattr(kernels, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        kernels, "entry",
        lambda lib, fn, dtype: (lambda *args: calls.append((lib, fn, args))
                                or 0))
    monkeypatch.setattr(kernels, "scratch",
                        lambda *a: (torch.zeros((1, 1)), 1))
    monkeypatch.setattr(bw, "_sms", lambda device: SMS)
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()
