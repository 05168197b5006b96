"""The port's key-blocked ("flash") attention on the CPU: the plain versions
of kernel rows 9 (forward) and 10 (backward) and the autograd Function
against the JAX package's blockwise Pallas kernels, and the routing of
long sequences by flash_min_seq against JAX's multi_head_self_attention.

The JAX kernels run in Pallas interpret mode, with block_rows 8 and
block_kv 8, so a 24-key sequence spans three key blocks and the running
max is rescaled between them. The CUDA kernels themselves are held to
these plain versions on the card by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import blockwise as jbw
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.ops.pallas import config as jax_config
from newsrecommendation_tpu_torch.ops import attention as torch_attention
from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from tests.test_torch_mhsa_sep_plan import fake_launch  # noqa: F401

N, T, HEADS, D = 6, 24, 3, 8
BLOCK = 8  # key block: three blocks of 24 keys
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def jax_kernels():
    set_pallas_mode("interpret")
    set_fused_tail("off")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")


def make_case(seed=0):
    """q, k, v (N, T, H*D) and a key mask with a fully masked row (2) and
    rows whose largest scores sit in the last key block (the first two
    blocks' accumulators must be rescaled)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
               for _ in range(3))
    k[:, 2 * BLOCK:] *= 2.5
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0
    g = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    return q, k, v, mask, g


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("t", [24, 512, 513, 600, 1000, 2048])
def test_key_block_is_jax_s(t):
    assert bw.kv_block(t, 256) == jbw._kv_blocks(t, 256)
    assert bw.kv_block(t, BLOCK) == jbw._kv_blocks(t, BLOCK)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    q, k, v, mask, _ = make_case()
    km = mask if masked else None
    jo, jm, jden = jbw._fwd_call(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if km is None else jnp.asarray(km), HEADS, BLOCK, BLOCK)
    o, m, den = bw.flash_fwd_reference(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if km is None else _t(km), HEADS, BLOCK)
    assert o.dtype == getattr(torch, dtype) and o.shape == (N, T, HEADS * D)
    assert m.shape == den.shape == (N, T, HEADS)
    assert m.dtype == den.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(jo), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(m), _np(jm), **FWD_TOL["float32"])
    np.testing.assert_allclose(_np(den), _np(jden), **FWD_TOL["float32"])
    if masked:
        assert (o[2] == 0).all() and (np.asarray(jo, np.float32)[2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    q, k, v, mask, g = make_case(seed=1)
    km = mask if masked else None
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    tm = None if km is None else _t(km)
    o, m, den = bw.flash_fwd_reference(tq, tk, tv, tm, HEADS, BLOCK)
    tg = _t(g, dtype)
    delta = bw.delta_of(tg, o, HEADS)
    got = bw.flash_bwd_reference(tq, tk, tv, tm, tg, m, den, delta, HEADS,
                                 BLOCK)
    want = jbw._bwd_call(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if km is None else jnp.asarray(km), _j(g, dtype),
        jnp.asarray(m.numpy()), jnp.asarray(den.numpy()),
        jnp.asarray(delta.numpy()), HEADS, BLOCK, BLOCK)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == getattr(torch, dtype) and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), **BWD_TOL[dtype],
                                   err_msg=f"d{name}")
    if masked:  # a fully masked row passes no gradient
        assert all((x[2] == 0).all() for x in got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax_kernels_at_d80(jax_kernels, dtype, masked):
    """Rows 9-10's plain versions against JAX's blockwise kernels at a head
    of 80 (news_dim 400 in 5 heads, which the card's wide kernels take),
    block_kv 8 over 24 keys."""
    rng = np.random.default_rng(7)
    heads, d = 2, 80
    q, k, v, g = (rng.normal(size=(N, T, heads * d)).astype(np.float32)
                  for _ in range(4))
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0
    km = mask if masked else None
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    tm = None if km is None else _t(km)
    jm = None if km is None else jnp.asarray(km)
    o, m, den = bw.flash_fwd_reference(tq, tk, tv, tm, heads, BLOCK)
    jo, jmax, jden = jbw._fwd_call(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                   jm, heads, BLOCK, BLOCK)
    np.testing.assert_allclose(_np(o), _np(jo), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(m), _np(jmax), **FWD_TOL["float32"])
    np.testing.assert_allclose(_np(den), _np(jden), **FWD_TOL["float32"])
    delta = bw.delta_of(tg, o, heads)
    got = bw.flash_bwd_reference(tq, tk, tv, tm, tg, m, den, delta, heads,
                                 BLOCK)
    want = jbw._bwd_call(_j(q, dtype), _j(k, dtype), _j(v, dtype), jm,
                         _j(g, dtype), jnp.asarray(m.numpy()),
                         jnp.asarray(den.numpy()),
                         jnp.asarray(delta.numpy()), heads, BLOCK, BLOCK)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), **BWD_TOL[dtype],
                                   err_msg=f"d{name}")


def _jax_grads(q, k, v, mask, g, dtype):
    def loss(q, k, v):
        if mask is None:
            out = jbw.flash_exp_mhsa(q, k, v, HEADS, BLOCK, BLOCK)
        else:
            out = jbw.flash_exp_mhsa_masked(q, k, v, jnp.asarray(mask),
                                            HEADS, BLOCK, BLOCK)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.grad(loss, argnums=(0, 1, 2))(_j(q, dtype), _j(k, dtype),
                                             _j(v, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_function_matches_jax_grad(jax_kernels, dtype, masked):
    q, k, v, mask, g = make_case(seed=2)
    km = mask if masked else None
    want = _jax_grads(q, k, v, km, g, dtype)
    xs = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = (bw.flash_exp_mhsa(*xs, HEADS, BLOCK) if km is None
           else bw.flash_exp_mhsa_masked(*xs, _t(km), HEADS, BLOCK))
    assert type(out.grad_fn).__name__ == "_FlashExpMhsaBackward"
    (out.float() * _t(g)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        assert x.grad.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(x.grad), _np(w), **BWD_TOL[dtype],
                                   err_msg=f"d{name}")


def test_function_matches_autograd_through_full_attention():
    """The flash Function's gradients are those of the full-T plain version
    (rows 1-2), which torch differentiates itself."""
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    q, k, v, mask, g = make_case(seed=3)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    (out * _t(g)).sum().backward()
    ys = [_t(x).requires_grad_() for x in (q, k, v)]
    qkv = torch.cat(ys, -1)
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, torch.zeros(qkv.shape[-1]),
                                         _t(mask), HEADS)
    np.testing.assert_allclose(_np(out), _np(ref), **FWD_TOL["float32"])
    (ref * _t(g)).sum().backward()
    for x, y in zip(xs, ys):
        np.testing.assert_allclose(_np(x.grad), _np(y.grad),
                                   **BWD_TOL["float32"])


def test_views_of_one_projection_need_no_copy():
    """q, k, v cut from one fused (N, T, 3HD) tensor give what contiguous
    copies give, forward and backward."""
    q, k, v, mask, g = make_case(seed=4)
    fused = _t(np.concatenate([q, k, v], -1)).requires_grad_()
    views = torch.split(fused, HEADS * D, dim=-1)
    out = bw.flash_exp_mhsa_masked(*views, _t(mask), HEADS, BLOCK)
    (out * _t(g)).sum().backward()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    (ref * _t(g)).sum().backward()
    assert torch.equal(out, ref)
    assert torch.equal(fused.grad, torch.cat([x.grad for x in xs], -1))


def test_without_grad_the_forward_saves_nothing():
    q, k, v, mask, _ = make_case()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        plain = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    with torch.inference_mode():
        served = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    graded = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    assert plain.grad_fn is None and served.grad_fn is None
    assert torch.equal(plain, graded.detach()) and torch.equal(served, plain)


def test_other_devices_raise():
    """Off the CPU there is no plain stand-in, with or without grad: a meta
    tensor (standing in for a CUDA one) raises."""
    q = torch.empty((2, 16, 8), device="meta", requires_grad=True)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            with pytest.raises(kernels.NoKernelError, match="no kernel"):
                bw.flash_exp_mhsa(q, q, q, 2)
    with pytest.raises(ValueError, match="one \\(N, T, H\\*D\\) shape"):
        bw.flash_fwd_reference(torch.zeros(2, 16, 8), torch.zeros(2, 15, 8),
                               torch.zeros(2, 16, 8), None, 2)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, mask, g = make_case()
    kernels.reset_launch_counts()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    (bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS) * _t(g)).sum().backward()
    assert all(not any(kernels.launch_counts(kern).values())
               for kern in kernels.KERNELS)


@pytest.fixture
def flash_from(jax_kernels):
    """Set both packages' flash_min_seq for a test, restoring 512."""
    def set_both(t):
        jax_config.set_flash_min_seq(t)
        kernel_config.set_flash_min_seq(t)

    try:
        yield set_both
    finally:
        set_both(512)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_min_seq_routes_as_jax(flash_from, masked):
    """multi_head_self_attention with flash_min_seq forced down to the
    sequence length takes the flash route in both packages, and the two
    agree, output and gradients; one key more and both take the fused
    route."""
    rng = np.random.default_rng(5)
    params = jax_attention.init_multi_head_self_attention(
        jax.random.PRNGKey(0), HEADS * D, HEADS, D)
    tparams = {name: {leaf: torch.tensor(np.asarray(w)).requires_grad_()
                      for leaf, w in p.items()}
               for name, p in params.items()}
    x = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32) if masked else None
    g = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    for flash_min, route in ((T, "_FlashExpMhsaBackward"),
                             (T + 1, "_ExpMhsaQkvBiasBackward")):
        flash_from(flash_min)

        def jloss(p, x):
            out = jax_attention.multi_head_self_attention(
                p, x, None if mask is None else jnp.asarray(mask),
                n_heads=HEADS)
            return jnp.sum(out * g), out

        (_, jout), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tx = _t(x).requires_grad_()
        out = torch_attention.multi_head_self_attention(
            tparams, tx, None if mask is None else _t(mask), n_heads=HEADS)
        assert type(out.grad_fn).__name__ == route
        (out * _t(g)).sum().backward()
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), _np(jgx), **BWD_TOL["float32"])
        for name in ("wq", "wk", "wv"):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    _np(tparams[name][leaf].grad), _np(jgp[name][leaf]),
                    **BWD_TOL["float32"], err_msg=f"{name}/{leaf}")
                tparams[name][leaf].grad = None


# ---- the kernels' launch plan (ops/blockwise.py:launch_plan) ----------------
# What the CUDA kernels are launched with, computed in Python so that it is
# checked here; tests/test_torch_kernel_gpu.py holds the C side's layout to
# it on the card.

SMS = 132  # the H100's SMs


@pytest.mark.parametrize("dtype, d, regime", [
    (torch.bfloat16, 20, "mma"), (torch.bfloat16, 4, "mma"),
    (torch.bfloat16, 33, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.float32, 20, "cuda_core"), (torch.float32, 64, "cuda_core")])
def test_launch_plan_regime_by_dtype_and_width(dtype, d, regime):
    """bf16 heads of up to 64 run on tensor cores (padded to whole k-steps
    of 16); f32 on CUDA cores, chunks of 256 rows of the other side: the
    forward 256 threads over 64 queries (4 a thread) up to D = 24 and 32
    (2 a thread) past it, each backward side 128 threads over 128 own
    rows."""
    plan = bw.launch_plan(64, 512, 4, d, dtype)
    assert plan.regime == regime
    assert bw.uses_mma(d, torch.empty((), dtype=dtype).element_size()) == (
        regime == "mma")
    for p in plan[1:]:
        if regime == "cuda_core":
            assert p.chunk == bw.CORE_CHUNK == 256 and p.nbuf in (1, 2)
            want = ((64 if d <= 24 else 32, 256) if p.kind == "fwd"
                    else (128, 128))
            assert (p.tile, p.threads) == want
        else:
            assert p.tile in (64, 128) and p.threads == 2 * p.tile
            assert p.nbuf in (1, 2) and p.chunk % 16 == 0
            assert 16 <= p.chunk <= bw.MAX_CHUNK


# The CUDA-core plan at the main path's T and ragged ones, at D = 8, 20, 64:
# (fwd tile, nbuf of fwd, bwd_key, bwd_query), f32 rows of (12, 20, 68)
# floats (a width of 8, 20, 64, plus 4 where its float4s are even).
CORE_PLANS = {8: (64, 2, 2, 2), 20: (64, 2, 1, 1), 64: (32, 1, 1, 1)}


@pytest.mark.parametrize("t", [512, 513, 1000, 2048])
@pytest.mark.parametrize("d", [8, 20, 64])
def test_core_plan_tiles_smem_and_grid(t, d):
    """The f32 plan at T = 512, 513, 1000, 2048 and D = 8, 20, 64: its
    tiles, buffers, shared bytes (own Q rows and per buffer 256 rows of two
    operands and 1 float a row, 4 on the key side, as f32 rows of
    core_row_floats) and grid (N*H, tiles over T); two buffers only where
    they leave room for the blocks the kernel's registers allow on an SM;
    the forward walks each key block in chunks of 256 that never cross it."""
    n, heads = 128, 20
    plan = bw.launch_plan(n, t, heads, d, torch.float32, sms=SMS)
    assert plan.regime == "cuda_core"
    rs = {8: 12, 20: 20, 64: 68}[d]
    assert bw.core_row_floats(d) == rs
    fwd_tile, *nbufs = CORE_PLANS[d]
    for p, nbuf in zip(plan[1:], nbufs):
        tile = fwd_tile if p.kind == "fwd" else 128
        assert (p.tile, p.chunk, p.nbuf) == (tile, 256, nbuf)
        assert p.threads == (256 if p.kind == "fwd" else 128)
        assert p.grid == (n * heads, -(-t // tile))
        own = tile * rs if p.kind == "fwd" else 0
        per_row = 4 if p.kind == "bwd_key" else 1
        assert p.smem == 4 * (own + nbuf * (2 * 256 * rs + per_row * 256))
        assert p.smem <= bw.MAX_SMEM
        assert bw.SM_SMEM // (p.smem + 1024) >= bw.core_resident(p.kind, d)
        if nbuf == 1:
            two = bw.smem_bytes(p.kind, d, 4, tile, 256, 2)
            assert (two > bw.MAX_SMEM or bw.SM_SMEM // (two + 1024)
                    < bw.core_resident(p.kind, d))
    block = bw.kv_block(t)
    walk = bw.key_walk(t, block, plan.fwd.chunk)
    for b0 in range(0, t, block):
        tasks = [w for w in walk if b0 <= w[0] < b0 + block]
        assert all(k0 + nk <= b0 + block and nk <= 256
                   for k0, nk, _, _ in tasks)
        # a block of up to 256 keys is one task: its scores stay in
        # registers between the max walk and the exp walk
        assert (len(tasks) == 1) == (block <= 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [512, 513, 1000, 2048])
@pytest.mark.parametrize("n, heads, d", [(128, 20, 20), (32, 20, 20),
                                         (3, 4, 64), (2, 3, 8)])
def test_launch_plan_covers_every_row_and_key_block(t, n, heads, d, dtype):
    """The tiles cover every (row, head, query) (and key, on the backward's
    key side) once; the forward's key walk covers every key block once in a
    max walk and then once in an exp walk, its chunks clipped at the key
    block's edges (kv_block: 256 at T = 512 and 2048, 200 at 1000, T itself
    at 513); the backward's chunks cover every row of the other side. In
    bf16 and in f32."""
    plan = bw.launch_plan(n, t, heads, d, dtype, sms=SMS)
    for p in plan[1:]:
        rows, tiles = p.grid
        assert rows == n * heads
        assert tiles == -(-t // p.tile) and (tiles - 1) * p.tile < t
        covered = [r for i in range(tiles)
                   for r in range(i * p.tile, min((i + 1) * p.tile, t))]
        assert covered == list(range(t))
    block = bw.kv_block(t)
    assert block == {512: 256, 513: 513, 1000: 200, 2048: 256}[t]
    walk = bw.key_walk(t, block, plan.fwd.chunk)
    for b0 in range(0, t, block):
        tasks = [w for w in walk if b0 <= w[0] < b0 + block]
        assert all(k0 + nk <= b0 + block and nk <= plan.fwd.chunk
                   for k0, nk, _, _ in tasks)
        for pass_ in (2, 3):
            keys = [k for w in tasks if w[pass_]
                    for k in range(w[0], w[0] + w[1])]
            assert keys == list(range(b0, b0 + block))
        last_max = max(i for i, w in enumerate(walk)
                       if w[2] and b0 <= w[0] < b0 + block)
        first_exp = min(i for i, w in enumerate(walk)
                        if w[3] and b0 <= w[0] < b0 + block)
        assert last_max <= first_exp  # the block's max is whole first
    blocks = [w[0] // block for w in walk]
    assert blocks == sorted(blocks)  # one block after another
    for p in (plan.bwd_key, plan.bwd_query):
        assert -(-t // p.chunk) * p.chunk >= t and p.chunk <= bw.MAX_CHUNK


def test_key_walk_restages_a_block_longer_than_a_chunk():
    """A key block longer than a chunk is walked twice: its chunks for the
    max, then the same chunks again for e; a block that fits is one task
    taking both walks."""
    assert bw.key_walk(512, 256, 256) == [(0, 256, True, True),
                                         (256, 256, True, True)]
    assert bw.key_walk(513, 513, 256) == [
        (0, 256, True, False), (256, 256, True, False), (512, 1, True, False),
        (0, 256, False, True), (256, 256, False, True), (512, 1, False, True)]
    assert bw.key_walk(40, 8, 16) == [(b, 8, True, True)
                                      for b in range(0, 40, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1, 4, 8, 16, 20, 24, 32, 33, 48, 64])
@pytest.mark.parametrize("t", [40, 512, 513, 1000, 2048, 4096])
def test_launch_plan_fits_a_block(dtype, d, t):
    """Every launch's shared memory fits one block (232,448 bytes), and
    its bytes are smem_bytes' at its plan."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for p in bw.launch_plan(16, t, 4, d, dtype)[1:]:
        assert p.smem <= kernels.MAX_SMEM == 232448
        assert p.smem == bw.smem_bytes(p.kind, d, itemsize, p.tile, p.chunk,
                                       p.nbuf)


@pytest.mark.parametrize("n, t", [(128, 512), (32, 2048)])
def test_launch_plan_fills_the_card(n, t):
    """At the long-history shapes of the main paths (bf16, 20 heads of
    20) every launch has at least two blocks per SM of the H100 and room
    for at least two on an SM (its 228 KB, 1 KB more per block)."""
    plan = bw.launch_plan(n, t, 20, 20, torch.bfloat16, sms=SMS)
    assert plan.regime == "mma"
    for p in plan[1:]:
        assert p.grid[0] * p.grid[1] >= 2 * SMS, p
        assert bw.SM_SMEM // (p.smem + 1024) >= 2, p


@pytest.mark.parametrize("d", [65, 80, 100, 200, 400, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_refuses_what_the_kernels_do_not_take(d, dtype):
    """Heads past 64 (news_dim 400 with 1, 2, 4 or 5 heads, and any wider)
    take the wide kernels in either dtype: WIDE_WARPS rows a block, a warp
    each, every row of every (row, head) covered, nothing staged. In f16
    the plan raises."""
    for width in (d, d + 1024):
        plan = bw.launch_plan(2, 512, 2, width, dtype)
        assert plan.regime == "wide"
        for p in plan[1:]:
            assert (p.tile, p.chunk, p.nbuf, p.smem) == (bw.WIDE_WARPS, 0,
                                                         0, 0)
            assert p.grid == (4, 512 // bw.WIDE_WARPS)
            assert p.threads == 32 * bw.WIDE_WARPS
    with pytest.raises(TypeError, match="float16"):
        bw.launch_plan(2, 512, 2, 20, torch.float16)
    # the C side's own refusals (a tile, chunk or buffer count it does not
    # take) raise in the wrapper on the card: tests/test_torch_kernel_gpu.py


@pytest.mark.parametrize("dtype, d, regime", [
    (torch.float32, 20, "cuda_core"), (torch.bfloat16, 20, "mma"),
    (torch.float32, 80, "wide"), (torch.bfloat16, 80, "wide")])
def test_flash_wrappers_launch_the_plan_and_count_its_regime(
        fake_launch, dtype, d, regime):
    """Rows 9 and 10 hand the C entry points the operands, the shape, the
    row stride of q, k, v cut from one projection, (the forward) the key
    block, and the plan's ints: the forward's tile, chunk and buffers, the
    backward's for its key side and then its query side. Each launch counts
    under its variant and its plan's regime."""
    n, t, heads = 2, 512, 3
    q, k, v = torch.split(torch.zeros((n, t, 3 * heads * d), dtype=dtype),
                          heads * d, -1)
    g = torch.zeros((n, t, heads * d), dtype=dtype)
    m, den, delta = (torch.zeros((n, t, heads)) for _ in range(3))
    mask = torch.ones((n, t))
    for km in (None, mask, mask):
        o, m_out, den_out = bw.flash_fwd(q, k, v, km, heads)
        assert o.shape == q.shape and o.dtype == dtype
        assert m_out.shape == den_out.shape == (n, t, heads)
        grads = bw.flash_bwd(q, k, v, km, g, m, den, delta, heads)
        assert all(x.shape == q.shape and x.dtype == dtype for x in grads)
    plan = bw.launch_plan(n, t, heads, d, dtype, sms=SMS)
    assert plan.regime == regime
    fwd_calls, bwd_calls = fake_launch[0::2], fake_launch[1::2]
    for args, km in zip(fwd_calls, (None, mask, mask)):
        assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if km is None else km.data_ptr())
        assert args[7:] == (n, t, heads, d, 3 * heads * d, bw.kv_block(t),
                            plan.fwd.tile, plan.fwd.chunk, plan.fwd.nbuf, 0)
    kp, qp = plan.bwd_key, plan.bwd_query
    for args, km in zip(bwd_calls, (None, mask, mask)):
        assert args[3] == (None if km is None else km.data_ptr())
        assert args[4] == g.data_ptr()
        assert args[11:] == (n, t, heads, d, 3 * heads * d, kp.tile,
                             kp.chunk, kp.nbuf, qp.tile, qp.chunk, qp.nbuf, 0)
    assert kernels.launch_counts("flash_fwd") == {"flash": 1,
                                                  "flash_masked": 2}
    assert kernels.launch_counts("flash_bwd") == {"flash_bwd": 1,
                                                  "flash_bwd_masked": 2}
    assert kernels.regime_counts("flash_fwd") == {regime: 3}
    assert kernels.regime_counts("flash_bwd") == {regime: 3}


def _rn32(x):
    """The float32 nearest to the rational x, ties to even."""
    from fractions import Fraction

    if x == 0:
        return np.float32(0.0)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    mantissa = round(x / Fraction(2) ** (e - 23))  # 24 bits, ties to even
    return np.float32(float(Fraction(mantissa) * Fraction(2) ** (e - 23)))


def test_reciprocal_division_is_exact():
    """The tensor-core backward forms a = e / den from the row's rcp = 1/den
    (IEEE) as q = e * rcp, then q + (e - den * q) * rcp with two fmas
    (csrc/flash.cuh div_by). That is the IEEE quotient e / den of the plain
    version, checked exactly on 20,000 float32 pairs: e in (e^-30, 1], den
    from e^-25 to e^10, 1,000 mantissas just above 1 and 100 just below 2,
    and e = 0."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    n = 20000
    e = np.exp(-rng.random(n) * 30).astype(np.float32)
    e[-10:] = 0.0
    den = np.exp(rng.uniform(-25, 10, n)).astype(np.float32)
    den[:1000] = np.float32(1) + np.arange(1000, dtype=np.float32) * (
        np.float32(2 ** -23))
    den[1000:1100] = np.nextafter(np.float32(2), np.float32(0))
    rcp = np.float32(1) / den
    q = e * rcp
    # e - den * q is exact in float64 (a 48-bit product within a factor 2
    # of e), so casting it rounds once, as the fma does
    r = (e.astype(np.float64) - den.astype(np.float64)
         * q.astype(np.float64)).astype(np.float32)
    got = np.array([_rn32(Fraction(float(qi)) + Fraction(float(ri))
                          * Fraction(float(yi)))
                    for qi, ri, yi in zip(q, r, rcp)], dtype=np.float32)
    np.testing.assert_array_equal(got, e / den)
