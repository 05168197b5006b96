"""The CUDA kernels (csrc/qkv_fwd.cu, rows 1 and 2; csrc/qkv_bwd_probs.cu,
row 3; csrc/qkv_bwd.cu, row 4; csrc/mhsa_sep.cu, rows 5-8;
csrc/flash_fwd.cu and csrc/flash_bwd.cu, rows 9 and 10; rows 11 and 12 on
rows 2 and 3's entry points; csrc/fused_tail_fwd.cu and
csrc/fused_tail_bwd.cu, rows 13 and 14; csrc/blanes.cu, rows 15 and 16)
against their plain PyTorch versions, on the card. Imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Elsewhere every test here skips: a CUDA kernel has no CPU mode.
"""

import hashlib

import numpy as np
import pytest
import torch

from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import experimental_fused_encoder as fe
from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernel_config, kernels

pytestmark = pytest.mark.gpu

# bf16: kernel and plain version round at the same points and differ only
# in the order of their f32 sums, which flips a rounding now and then: two
# ulps, and an absolute 2^-8 for an ulp of ds carried into dq and dk.
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -8)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": BF16_TOL}


@pytest.fixture(autouse=True)
def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _inputs(n, t, heads, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    hd = heads * d
    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(rng.normal(size=(n, t, 3 * hd))
                           .astype(np.float32)).to(tdt).cuda()
    bias = torch.from_numpy(rng.normal(scale=0.5, size=(3 * hd,))
                            .astype(np.float32)).to(tdt).cuda()
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[::3] = 0.0  # fully masked rows
    return qkv, bias, torch.from_numpy(mask).cuda()


# Rows 1-2 on both sides of each regime switch (T = 64 and 65: resident,
# then tensor cores in bf16 or tiled in f32; D = 64 and 66: row-wise past
# 64), at the L = 300 user encoder's width, and at D = 5, where a bf16
# head row is not 4 bytes long (element copies).
FWD_SHAPES = [(64, 20, 20, 20), (33, 50, 20, 20), (7, 5, 3, 4),
              (3, 300, 2, 8), (2, 511, 1, 33), (5, 64, 4, 20),
              (5, 65, 4, 20), (4, 300, 20, 20), (6, 40, 3, 5), (3, 90, 3, 5),
              (3, 64, 2, 64), (3, 70, 2, 66)]


def _fwd_regime(t, d, dtype):
    """Rows 1-2's regime as the kernels' design states it: resident at
    T <= 64 with heads of up to 64, past it tensor cores in bf16 and the
    tiled kernel in f32; row-wise for wider heads."""
    if d > 64:
        return "rowwise"
    if t <= 64:
        return "resident"
    return "mma" if dtype in ("bfloat16", torch.bfloat16) else "tiled"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", FWD_SHAPES)
def test_kernel_matches_plain(dtype, n, t, heads, d):
    qkv, bias, mask = _inputs(n, t, heads, d, dtype)
    fa.reset_launch_counts()
    for km in (None, mask):
        out = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if km is None
               else fa.exp_mhsa_qkv_bias_masked(qkv, bias, km, heads))
        ref = fa.exp_mhsa_qkv_bias_reference(qkv, bias, km, heads)
        torch.cuda.synchronize()
        assert out.dtype == qkv.dtype and out.shape == (n, t, heads * d)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **TOL[dtype])
    assert (out[::3] == 0).all()
    assert fa.launch_counts() == {"bias": 1, "bias_masked": 1}
    assert fa.regime_counts("qkv_fwd") == {_fwd_regime(t, d, dtype): 2}


def test_kernel_raises_on_what_it_does_not_take():
    # T=512 is no limit of row 1 (long sequences reach the flash kernels by
    # routing, not by a raise here): it agrees with the plain version
    q = torch.randn((1, 512, 24), device="cuda")
    b = torch.zeros(24, device="cuda")
    out = fa.exp_mhsa_qkv_bias(q, b, 2)
    ref = fa.exp_mhsa_qkv_bias_reference(q, b, None, 2)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               **TOL["float32"])
    # D = 64 at T = 400 takes the tiled kernel; D = 80 at T = 400 passes a
    # block's shared memory in the row-wise kernel: its working set moves
    # to a global slot per block. Both agree
    for d in (64, 80):
        q = torch.randn((2, 400, 3 * d), device="cuda")
        b = torch.randn(3 * d, device="cuda")
        np.testing.assert_allclose(
            fa.exp_mhsa_qkv_bias(q, b, 1).cpu().numpy(),
            fa.exp_mhsa_qkv_bias_reference(q, b, None, 1).cpu().numpy(),
            **TOL["float32"])
    q = torch.zeros((2, 5, 24), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda",
                                            dtype=torch.float16), 2)
    q = torch.zeros((2, 5, 48), device="cuda")[..., :24]
    with pytest.raises(ValueError, match="contiguous"):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda"), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t, d", [(5, 4), (70, 4), (5, 66)])
def test_masked_max_underflows_to_zero(dtype, t, d):
    """m is the max over ALL keys: a masked key 110 (or more) above the
    others makes exp(s - m) underflow on every key left, so the row's
    output is exactly 0 (a max over unmasked keys only would give about
    1e-14). A row whose scores all lie below about -88.7 has den = inf
    (1e-8 exp(-m) overflows) and a = 0, so its output and probs are 0,
    unmasked and masked, while the other rows match the plain version.
    Rows 1 and 2 in every regime: resident (T = 5), tensor cores or tiled
    (T = 70), row-wise (D = 66)."""
    heads = 3
    hd = heads * d
    tdt = getattr(torch, dtype)
    regime = _fwd_regime(t, d, dtype)
    qkv = torch.zeros((1, t, 3 * hd))
    qkv[0, :, :hd] = 2.0          # every query 2
    qkv[0, 0, hd:2 * hd] = 15.0   # key 0 scores 30 sqrt(D) (masked)
    qkv[0, 1:, hd:2 * hd] = -12.5  # the others -25 sqrt(D)
    qkv[0, :, 2 * hd:] = 1.0
    qkv = qkv.to(tdt).cuda()
    bias = torch.zeros(3 * hd, dtype=tdt, device="cuda")
    mask = torch.ones((1, t), device="cuda")
    mask[0, 0] = 0.0
    fa.reset_launch_counts()
    out = fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads)
    ctx, probs = fa.qkv_fwd_probs(qkv, bias, mask, heads)
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    assert (out == 0).all() and (ref == 0).all() and (ctx == 0).all()
    assert (probs == 0).all()
    # row 1 far below zero (q . k / sqrt(D) = -50 sqrt(D) <= -100), row 0
    # random
    rng = np.random.default_rng(17)
    far = rng.normal(size=(2, t, 3 * hd)).astype(np.float32)
    far[1, :, :hd] = 5.0
    far[1, :, hd:2 * hd] = -10.0
    qkv = torch.from_numpy(far).to(tdt).cuda()
    bias = torch.from_numpy(rng.normal(scale=0.5, size=(3 * hd,))
                            .astype(np.float32)).to(tdt).cuda()
    bias[:2 * hd] = 0.0
    mask = torch.from_numpy((rng.random((2, t)) > 0.3).astype(np.float32))
    mask[:, 0] = 1.0
    for km in (None, mask.cuda()):
        row1 = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if km is None
                else fa.exp_mhsa_qkv_bias_masked(qkv, bias, km, heads))
        ctx, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
        ref, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, km,
                                                              heads)
        torch.cuda.synchronize()
        assert torch.isfinite(row1.float()).all() and torch.equal(ctx, row1)
        assert (row1[1] == 0).all() and (ref[1] == 0).all()
        assert (probs[1] == 0).all() and (ref_probs[1] == 0).all()
        np.testing.assert_allclose(row1.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **TOL[dtype])
        np.testing.assert_allclose(probs.cpu().numpy(),
                                   ref_probs.cpu().numpy(), **TOL["float32"])
    assert fa.regime_counts("qkv_fwd") == {regime: 3}
    assert fa.regime_counts("qkv_fwd_probs") == {regime: 3}


def test_fwd_launch_plan_matches_the_kernels():
    """fwd_launch_plan's regime and shared bytes (ops/fused_attention.py)
    equal the C side's (qkv_fwd_regime, qkv_fwd_smem_bytes), which refuses
    a plan its kernel does not take and a regime that is not the shape's;
    the wrapper raises on a launch so refused."""
    for dtype in (torch.float32, torch.bfloat16):
        esize = 2 if dtype == torch.bfloat16 else 4
        for t, d in ((20, 20), (50, 20), (64, 64), (65, 20), (300, 20),
                     (511, 33), (20, 5), (90, 5), (400, 80), (100, 80)):
            for probs in (False, True):
                plan = fa.fwd_launch_plan(64, t, 20, d, dtype, probs=probs)
                reg = fa.FWD_REGIMES.index(plan.regime)
                assert reg == kernels.size_of("qkv_fwd", "qkv_fwd_regime", t,
                                              d, esize)
                smem = kernels.size_of("qkv_fwd", "qkv_fwd_smem_bytes", reg,
                                       t, d, esize, int(probs), *plan.args())
                if plan.regime == "resident":
                    assert smem == plan.resident.smem
                elif plan.regime == "rowwise":  # 0 past shared memory
                    own = 4 * (3 * t * (d | 1) + 4 * t)
                    assert smem == (own if own <= kernels.MAX_SMEM else 0)
                else:
                    assert smem == plan.launch.smem

    def size(*a):
        return kernels.size_of("qkv_fwd", "qkv_fwd_smem_bytes", *a)

    assert size(0, 300, 20, 2, 0, 4, 2, 10) == 0  # resident past T = 64
    assert size(1, 300, 20, 4, 0, 128, 256, 1) == 0  # tensor cores in f32
    assert size(2, 300, 20, 4, 0, 64, 128, 1) == 0  # tiled: 128 threads
    assert size(0, 20, 20, 4, 0, 5, 2, 10) == 0  # five heads an item
    assert size(3, 20, 20, 4, 0, 0, 0, 0) == 0  # row-wise at D = 20
    qkv, bias, _ = _inputs(2, 300, 2, 20, "bfloat16")
    real = fa.fwd_launch_plan
    wrong = fa.FwdPlan("tiled", launch=real(2, 300, 2, 20,
                                            torch.float32).launch)
    fa.fwd_launch_plan = lambda *a, **k: wrong
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.exp_mhsa_qkv_bias(qkv, bias, 2)
    finally:
        fa.fwd_launch_plan = real


BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": BF16_TOL}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 97, 2, 33),
                                            (5, 64, 4, 20), (5, 65, 4, 20),
                                            (4, 300, 20, 20), (6, 40, 3, 5),
                                            (3, 90, 3, 5)])
def test_probs_kernels_match_plain(dtype, masked, n, t, heads, d):
    """Row 2 (ctx bit-equal to row 1's, probs) and row 3 (dqkv from the
    same probs) against their plain versions; rows 1 and 2 in the regime
    of their shape."""
    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=1)
    km = mask if masked else None
    fa.reset_launch_counts()
    variant = "bias_masked_probs" if masked else "bias_probs"
    ctx, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
    ref_ctx, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, km,
                                                              heads)
    row1 = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if km is None
            else fa.exp_mhsa_qkv_bias_masked(qkv, bias, km, heads))
    g = torch.randn((n, t, heads * d), device="cuda").to(qkv.dtype)
    dqkv = fa.qkv_bwd_probs(qkv, bias, ref_probs, g, heads)
    ref_dqkv = fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g, heads)
    torch.cuda.synchronize()
    assert torch.equal(ctx, row1)
    assert probs.dtype == torch.float32 and probs.shape == (n, t, heads * t)
    np.testing.assert_allclose(ctx.float().cpu().numpy(),
                               ref_ctx.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(probs.cpu().numpy(), ref_probs.cpu().numpy(),
                               **TOL["float32"])
    assert dqkv.dtype == qkv.dtype and dqkv.shape == qkv.shape
    np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                               ref_dqkv.float().cpu().numpy(),
                               **BWD_TOL[dtype])
    if masked:
        assert (probs[::3] == 0).all() and (dqkv[::3] == 0).all()
    assert fa.launch_counts("qkv_fwd_probs")[variant] == 1
    assert fa.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    regime = _fwd_regime(t, d, dtype)
    assert fa.regime_counts("qkv_fwd_probs") == {regime: 1}
    assert fa.regime_counts("qkv_fwd") == {regime: 1}


def test_launch_counts_follow_grad_mode():
    """Serving (inference_mode, or nothing requiring grad) launches row 1;
    a forward under differentiation launches row 2, its backward row 3."""
    qkv, bias, mask = _inputs(16, 20, 4, 8, "float32", seed=2)
    fa.reset_launch_counts()
    with torch.inference_mode():
        fa.exp_mhsa_qkv_bias(qkv, bias, 4)
    fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, 4)
    assert fa.launch_counts() == {"bias": 1, "bias_masked": 1}
    q = qkv.clone().requires_grad_()
    out = fa.exp_mhsa_qkv_bias_masked(q, bias, mask, 4)
    assert fa.launch_counts("qkv_fwd_probs") == {"bias_probs": 0,
                                                 "bias_masked_probs": 1}
    assert fa.launch_counts("qkv_bwd_probs") == {"bwd_probs": 0}
    # a strided f32 gradient is made contiguous for the kernel
    g = torch.randn((20, 16, 32), device="cuda").transpose(0, 1)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    assert fa.launch_counts() == {"bias": 1, "bias_masked": 1}
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, mask, 4)
    ref = fa.qkv_bwd_probs_reference(qkv, bias, probs, g.contiguous(), 4)
    np.testing.assert_allclose(q.grad.cpu().numpy(), ref.cpu().numpy(),
                               **BWD_TOL["float32"])


def test_probs_kernels_raise_on_what_they_do_not_take():
    """A CUDA tensor never takes the plain version: what the kernels do not
    take raises, under grad too. Rows 2 and 3 take every T: at T = 700,
    D = 20 row 3 runs its tiled kernel in global slots (f32)."""
    q = torch.randn((1, 300, 3 * 20), device="cuda", requires_grad=True)
    b = torch.zeros(60, device="cuda")
    out = fa.exp_mhsa_qkv_bias(q, b, 1)  # rows 2 and 3 take T=300 at D=20
    g = torch.randn_like(out)
    out.backward(g)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(q.detach(), b, None, 1)
    ref = fa.qkv_bwd_probs_reference(q.detach(), b, probs, g, 1)
    np.testing.assert_allclose(q.grad.cpu().numpy(), ref.cpu().numpy(),
                               **BWD_TOL["float32"])
    q = torch.randn((1, 700, 3 * 20), device="cuda", requires_grad=True)
    out = fa.exp_mhsa_qkv_bias(q, b, 1)  # rows 2-3 at T=700, D=20
    g = torch.randn_like(out)
    out.backward(g)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(q.detach(), b, None, 1)
    ref = fa.qkv_bwd_probs_reference(q.detach(), b, probs, g, 1)
    np.testing.assert_allclose(q.grad.cpu().numpy(), ref.cpu().numpy(),
                               **BWD_TOL["float32"])
    q = torch.randn((1, 512, 24), device="cuda", requires_grad=True)
    out = fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda"), 2)
    out.backward(torch.ones_like(out))  # rows 2-3 at T=512, D=4
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(
        q.detach(), torch.zeros(24, device="cuda"), None, 2)
    ref = fa.qkv_bwd_probs_reference(q.detach(), torch.zeros(24, device="cuda"),
                                     probs, torch.ones_like(out), 2)
    np.testing.assert_allclose(q.grad.cpu().numpy(), ref.cpu().numpy(),
                               **BWD_TOL["float32"])
    probs = torch.zeros((2, 5, 10), device="cuda")
    qkv = torch.zeros((2, 5, 24), device="cuda")
    with pytest.raises(ValueError, match="g must be"):
        fa.qkv_bwd_probs(qkv, torch.zeros(24, device="cuda"), probs,
                         torch.zeros((2, 5, 8), device="cuda",
                                     dtype=torch.bfloat16), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t", [(4, 202), (3, 300), (2, 511)])
def test_bwd_probs_takes_long_sequences(dtype, masked, n, t):
    """Row 3 at the lengths its old design refused (T > 201 at D = 20)."""
    qkv, bias, mask = _inputs(n, t, 20, 20, dtype, seed=7)
    km = mask if masked else None
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, km, 20)
    g = torch.randn((n, t, 400), device="cuda").to(qkv.dtype)
    dqkv = fa.qkv_bwd_probs(qkv, bias, probs, g, 20)
    ref = fa.qkv_bwd_probs_reference(qkv, bias, probs, g, 20)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 97, 2, 33),
                                            (2, 511, 20, 20), (3, 97, 2, 66)])
def test_recompute_kernel_matches_plain_and_row_3(dtype, masked, n, t, heads,
                                                  d):
    """Row 4 against its plain version, and equal bit for bit to row 3 fed
    the probs row 2 wrote where both take the first design's order of
    sums (row 4 on its CUDA-core kernels, row 2 resident or row-wise: T <=
    64 or heads past 64); where either takes another order (row 4 on
    tensor cores, bf16 past its resident kernel; row 2 past T = 64 on
    tensor cores or the tiled kernel, whose den is summed online) row 4's
    a differs from row 2's probs by an ulp here and there, so there the
    two agree within the tolerance."""
    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=3)
    km = mask if masked else None
    g = torch.randn((n, t, heads * d), device="cuda").to(qkv.dtype)
    fa.reset_launch_counts()
    dqkv = fa.qkv_bwd(qkv, bias, km, g, heads)
    ref = fa.qkv_bwd_reference(qkv, bias, km, g, heads)
    _, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
    row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
    torch.cuda.synchronize()
    assert dqkv.dtype == qkv.dtype and dqkv.shape == qkv.shape
    np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **BWD_TOL[dtype])
    if (fa.bwd_launch_plan(n, t, heads, d, qkv.dtype).regime == "mma"
            or fa.fwd_launch_plan(n, t, heads, d, qkv.dtype).regime in (
                "mma", "tiled")):
        np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                                   row3.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
    else:
        assert torch.equal(dqkv, row3)
    if masked:
        assert (dqkv[::3] == 0).all()
    assert fa.launch_counts("qkv_bwd") == {"bwd": int(not masked),
                                           "bwd_masked": int(masked)}


def test_recompute_mode_launches_rows_1_and_4():
    qkv, bias, mask = _inputs(16, 20, 4, 8, "float32", seed=2)
    q = qkv.clone().requires_grad_()
    kernel_config.set_bwd_residuals("recompute")
    try:
        fa.reset_launch_counts()
        out = fa.exp_mhsa_qkv_bias_masked(q, bias, mask, 4)
        g = torch.randn_like(out)
        out.backward(g)
        torch.cuda.synchronize()
    finally:
        kernel_config.set_bwd_residuals("probs")
    assert fa.launch_counts() == {"bias": 0, "bias_masked": 1}
    assert fa.launch_counts("qkv_bwd") == {"bwd": 0, "bwd_masked": 1}
    assert not any(fa.launch_counts("qkv_fwd_probs").values())
    assert not any(fa.launch_counts("qkv_bwd_probs").values())
    ref = fa.qkv_bwd_reference(qkv, bias, mask, g, 4)
    np.testing.assert_allclose(q.grad.cpu().numpy(), ref.cpu().numpy(),
                               **BWD_TOL["float32"])


def _flash_inputs(n, t, heads, d, dtype, seed=0, fused=False):
    qkv, _, mask = _inputs(n, t, heads, d, dtype, seed)
    if fused:  # views of one projection, rows 3*H*D apart
        return (*torch.split(qkv, heads * d, dim=-1), mask)
    return (*(x.contiguous() for x in qkv.chunk(3, dim=-1)), mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d, fused", [
    (4, 512, 20, 20, True), (3, 1000, 4, 8, False), (2, 600, 2, 33, True),
    (5, 513, 3, 16, False), (2, 40, 2, 4, False), (4, 1000, 20, 20, True),
    (2, 513, 4, 20, True), (3, 512, 4, 32, True), (2, 512, 2, 64, False)])
def test_flash_kernels_match_plain(dtype, masked, n, t, heads, d, fused):
    """Rows 9-10 against their plain versions: o, m, den, then dq, dk, dv
    from the same m, den and delta. In bf16 the tensor-core kernels: key
    blocks of 200 (T = 1000), one block of 513 walked in chunks, heads of
    32 and 64 (64: chunks of 128 inside blocks of 256), one and two stage
    buffers; masked, every third row fully masked."""
    q, k, v, mask = _flash_inputs(n, t, heads, d, dtype, seed=4, fused=fused)
    km = mask if masked else None
    bkv = 8 if t == 40 else 256
    fa.reset_launch_counts()
    o, m, den = bw.flash_fwd(q, k, v, km, heads, bkv)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, km, heads, bkv)
    g = torch.randn((n, t, heads * d), device="cuda").to(q.dtype)
    delta = bw.delta_of(g, ro, heads)
    grads = bw.flash_bwd(q, k, v, km, g, rm, rden, delta, heads)
    refs = bw.flash_bwd_reference(q, k, v, km, g, rm, rden, delta, heads,
                                  bkv)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               ro.float().cpu().numpy(), **TOL[dtype])
    for got, want in ((m, rm), (den, rden)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL["float32"])
    for got, want in zip(grads, refs):
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
    if masked:
        assert (o[::3] == 0).all()
        assert all((x[::3] == 0).all() for x in grads)
    variant = "_masked" if masked else ""
    assert fa.launch_counts("flash_fwd")["flash" + variant] == 1
    assert fa.launch_counts("flash_bwd")["flash_bwd" + variant] == 1


def test_flash_launch_plan_matches_the_kernels_layout():
    """launch_plan's shared bytes (ops/blockwise.py) equal the kernel
    source's own layout, its key walk has the source's count of tasks, and
    the source refuses a plan it does not take."""
    for n, t, heads, d in [(128, 512, 20, 20), (32, 2048, 20, 20),
                           (128, 1000, 20, 20), (128, 513, 20, 20),
                           (2, 40, 2, 4), (5, 513, 3, 16), (3, 512, 4, 32),
                           (2, 512, 2, 64), (2, 600, 2, 33),
                           (2, 512, 2, 80), (1, 512, 1, 400)]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = bw.launch_plan(n, t, heads, d, dtype)
            itemsize = torch.empty((), dtype=dtype).element_size()
            for p in plan[1:]:
                assert p.smem == kernels.size_of(
                    "flash_fwd", "flash_smem_bytes", bw.KINDS[p.kind], d,
                    itemsize, p.tile, p.chunk, p.nbuf), (n, t, d, p)
            if plan.regime == "wide":  # no key walk: nothing staged
                continue
            block = bw.kv_block(t)
            assert len(bw.key_walk(t, block, plan.fwd.chunk)) == (
                kernels.size_of("flash_fwd", "flash_walk_task_count", t,
                                block, plan.fwd.chunk))
    for tile, chunk, nbuf in [(96, 256, 1), (128, 200, 1), (128, 272, 1),
                              (128, 256, 3)]:
        assert kernels.size_of("flash_fwd", "flash_smem_bytes", 0, 20, 2,
                               tile, chunk, nbuf) == -1
    # f32 (CUDA cores): the forward's tile of 16 query groups (64 queries
    # up to D = 24, 32 past it), a backward side's 128 rows, chunks of 256
    for kind, d, tile, chunk, nbuf in [(0, 20, 128, 128, 1),
                                       (0, 20, 32, 256, 2),
                                       (0, 32, 64, 256, 1),
                                       (0, 20, 64, 128, 2),
                                       (0, 20, 64, 256, 3),
                                       (1, 20, 256, 256, 1),
                                       (2, 8, 64, 256, 2)]:
        assert kernels.size_of("flash_fwd", "flash_smem_bytes", kind, d, 4,
                               tile, chunk, nbuf) == -1, (kind, d, tile)
    assert kernels.size_of("flash_fwd", "flash_smem_bytes", 0, 20, 4, 64,
                           256, 2) == 4 * (64 * 20 + 2 * (2 * 256 * 20 + 256))
    # past D = 64: the wide kernels' fixed plan, any head
    assert kernels.size_of("flash_fwd", "flash_smem_bytes", 0, 80, 2, 8, 0,
                           0) == 0
    assert kernels.size_of("flash_fwd", "flash_smem_bytes", 0, 80, 2, 128,
                           256, 1) == -1
    assert kernels.size_of("flash_fwd", "flash_smem_bytes", 0, 1100, 4, 8,
                           0, 0) == 0


def test_flash_raises_on_a_plan_the_kernels_refuse(monkeypatch):
    """A plan the C side does not take is refused before any launch: the
    wrapper raises and counts nothing."""
    q, k, v, _ = _flash_inputs(2, 512, 2, 20, "bfloat16")
    plan = bw.launch_plan(2, 512, 2, 20, torch.bfloat16)
    bad = plan._replace(fwd=plan.fwd._replace(tile=96),
                        bwd_query=plan.bwd_query._replace(chunk=200))
    monkeypatch.setattr(bw, "launch_plan", lambda *a, **kw: bad)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        bw.flash_fwd(q, k, v, None, 2)
    m = torch.zeros((2, 512, 2), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        bw.flash_bwd(q, k, v, None, q.contiguous(), m, m + 1, m, 2)
    assert not any(kernels.launch_counts("flash_fwd").values())
    assert not any(kernels.launch_counts("flash_bwd").values())


def test_flash_fully_masked_rows_on_tensor_cores():
    """bf16 rows whose keys are all masked give o = 0 and zero gradients,
    also where the max is so large that 1e-8 exp(-m) underflows and den
    is 0 (rows 0 and 3), as in the plain version."""
    q, k, v, mask = _flash_inputs(6, 512, 4, 20, "bfloat16", seed=9,
                                  fused=True)
    mask[0] = mask[3] = mask[4] = 0.0
    q[0] *= 40.0
    k[0] *= 40.0
    q[3] *= 40.0
    k[3] *= 40.0
    o, m, den = bw.flash_fwd(q, k, v, mask, 4)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, 4)
    g = torch.randn((6, 512, 80), device="cuda").to(q.dtype)
    delta = bw.delta_of(g, ro, 4)
    grads = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, 4)
    torch.cuda.synchronize()
    assert (rden[0] == 0).any() and (rden[3] == 0).any()
    for i in (0, 3, 4):
        assert (o[i] == 0).all() and all((x[i] == 0).all() for x in grads)
    np.testing.assert_allclose(m.cpu().numpy(), rm.cpu().numpy(),
                               **TOL["float32"])
    np.testing.assert_allclose(den.cpu().numpy(), rden.cpu().numpy(),
                               **TOL["float32"])
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               ro.float().cpu().numpy(), **TOL["bfloat16"])


def test_flash_bwd_repeats_bit_for_bit():
    """No atomics: 50 calls of row 10 in bf16 (tensor cores) give the same
    dq, dk and dv to the bit."""
    q, k, v, mask = _flash_inputs(8, 1000, 20, 20, "bfloat16", seed=3,
                                  fused=True)
    g = torch.randn((8, 1000, 400), device="cuda").to(q.dtype)
    _, m, den = bw.flash_fwd(q, k, v, mask, 20)
    o = bw.flash_fwd(q, k, v, mask, 20)[0]
    delta = bw.delta_of(g, o, 20)
    first = bw.flash_bwd(q, k, v, mask, g, m, den, delta, 20)
    for _ in range(50):
        again = bw.flash_bwd(q, k, v, mask, g, m, den, delta, 20)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [
    (4, 512, 20, 20), (3, 513, 4, 8), (2, 1000, 4, 20), (2, 513, 2, 64),
    (2, 1000, 3, 64), (3, 600, 2, 33)])
def test_flash_f32_on_cuda_cores_matches_plain(n, t, heads, d, masked):
    """Rows 9-10 in f32 on CUDA cores (one launch each, in the "cuda_core"
    regime) against their plain versions at the f32 tolerances: ragged T
    (513: one key block walked twice; 1000: key blocks of 200, a chunk
    part-filled), D of 8, 20, 33 (padded to 64) and 64, q, k, v cut from one
    fused projection; masked, every third row fully masked gives 0."""
    q, k, v, mask = _flash_inputs(n, t, heads, d, "float32", seed=6,
                                  fused=True)
    km = mask if masked else None
    kernels.reset_launch_counts()
    o, m, den = bw.flash_fwd(q, k, v, km, heads)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, km, heads)
    g = torch.randn((n, t, heads * d), device="cuda")
    delta = bw.delta_of(g, ro, heads)
    grads = bw.flash_bwd(q, k, v, km, g, rm, rden, delta, heads)
    refs = bw.flash_bwd_reference(q, k, v, km, g, rm, rden, delta, heads)
    torch.cuda.synchronize()
    assert kernels.regime_counts("flash_fwd") == {"cuda_core": 1}
    assert kernels.regime_counts("flash_bwd") == {"cuda_core": 1}
    for got, want in ((o, ro), (m, rm), (den, rden)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL["float32"])
    for got, want in zip(grads, refs):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **BWD_TOL["float32"])
    if masked:
        assert (o[::3] == 0).all()
        assert all((x[::3] == 0).all() for x in grads)


def test_flash_f32_fully_masked_rows_on_cuda_cores():
    """f32 rows whose keys are all masked give o = 0 and zero gradients,
    also where the max is so large that 1e-8 exp(-m) underflows and den is
    0 (rows 0 and 3), as in the plain version."""
    q, k, v, mask = _flash_inputs(6, 513, 4, 20, "float32", seed=9,
                                  fused=True)
    mask[0] = mask[3] = mask[4] = 0.0
    for x in (q, k):
        x[0] *= 40.0
        x[3] *= 40.0
    o, m, den = bw.flash_fwd(q, k, v, mask, 4)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, 4)
    g = torch.randn((6, 513, 80), device="cuda")
    delta = bw.delta_of(g, ro, 4)
    grads = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, 4)
    torch.cuda.synchronize()
    assert (rden[0] == 0).any() and (rden[3] == 0).any()
    for i in (0, 3, 4):
        assert (o[i] == 0).all() and all((x[i] == 0).all() for x in grads)
    for got, want in ((o, ro), (m, rm), (den, rden)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL["float32"])


def test_flash_f32_repeats_bit_for_bit():
    """No atomics: 20 calls of rows 9 and 10 in f32 give the same o, m,
    den and dq, dk, dv to the bit (the forward's 16 key lanes are summed in
    one fixed tree)."""
    q, k, v, mask = _flash_inputs(8, 1000, 20, 20, "float32", seed=3,
                                  fused=True)
    g = torch.randn((8, 1000, 400), device="cuda")
    fwd = bw.flash_fwd(q, k, v, mask, 20)
    delta = bw.delta_of(g, fwd[0], 20)
    bwd = bw.flash_bwd(q, k, v, mask, g, fwd[1], fwd[2], delta, 20)
    for _ in range(20):
        assert all(torch.equal(a, b) for a, b in zip(
            fwd, bw.flash_fwd(q, k, v, mask, 20)))
        assert all(torch.equal(a, b) for a, b in zip(
            bwd, bw.flash_bwd(q, k, v, mask, g, fwd[1], fwd[2], delta, 20)))


def _pinned_inputs(n, t, heads, d, dtype, masked):
    """q, k, v (views of one projection), the mask (every third row fully
    masked) or None, g, and the backward's m, den, delta, from a numpy
    seed: scripts/flash_ab.py's pinned_inputs."""
    rng = np.random.default_rng(17)
    hd = heads * d
    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(rng.normal(size=(n, t, 3 * hd)).astype(
        np.float32)).to(tdt).cuda()
    g = torch.from_numpy(rng.normal(size=(n, t, hd)).astype(
        np.float32)).to(tdt).cuda()
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[::3] = 0.0
    stats = [rng.normal(size=(n, t, heads)) * 0.5 + 3.0,
             rng.uniform(50.0, 300.0, size=(n, t, heads)),
             rng.normal(size=(n, t, heads))]
    m, den, delta = (torch.from_numpy(x.astype(np.float32)).cuda()
                     for x in stats)
    q, k, v = torch.split(qkv, hd, dim=-1)
    return (q, k, v, torch.from_numpy(mask).cuda() if masked else None, g,
            m, den, delta)


# Rows 9-10 on an H100 on _pinned_inputs, as the per-row f32 kernels (one
# query or key a thread, every sum in order) and the bf16 and wide kernels
# gave them (scripts/flash_ab.py): hashes of o, m, den (in f32 m alone: the
# CUDA-core forward sums o and den over its key lanes in a tree) and of dq,
# dk, dv from the pinned m, den, delta, by (N, T, heads, D, dtype, masked).
FLASH_PINNED = {
    (4, 512, 20, 20, "bfloat16", False): (
        '4317d7a9dea1075d', 'a16bceccfcd16a0c', '71088c585f8e1f5e',
        '9f8ce23518375373', 'c070bfcacae95665', 'b9afe7c41a26e201'),
    (4, 512, 20, 20, "bfloat16", True): (
        '0b7bd42cd10edcc6', 'a16bceccfcd16a0c', '6db0cb6bbde3ab94',
        '01fd30a567ae6381', 'e5b7643b005a4229', '02a2d3e538e1e89d'),
    (3, 1000, 4, 20, "bfloat16", True): (
        'b33673084b6ec9c2', 'c926748246e67f97', '4d2bdab81ee8e876',
        'c63aec7e34889b55', '49e0804b21e878c3', '04a6021ddba82062'),
    (2, 513, 4, 64, "bfloat16", True): (
        'a3853eb2c5ec7225', 'ba02292694d903ca', '0a8f57b77353c3cb',
        '1238733a12572397', '1bae11d1e3e3ac09', '8ea7ef2b3ce2534d'),
    (2, 512, 2, 80, "float32", True): (
        '6f2ea1baaeaccf7b', 'a939a9c0022a9b03', '8b85fc089abdea60',
        '6da874b9eb866c9a', '0b2a93899c40366f', '2a775ce14cf17460'),
    (2, 512, 2, 80, "bfloat16", True): (
        'e4015112784ca7e0', 'b446f59e15173172', '7825ee4e42fa2349',
        '3f1f71fd913f51a0', '5db046ed2b2bcbf4', 'efb52adc8d840d66'),
    (4, 512, 20, 20, "float32", False): (
        'c2bb15a8175a45d0', 'c20042fdab6c03b2', '1b5a49d16111ec93',
        '3822a9ceb2927f32'),
    (4, 512, 20, 20, "float32", True): (
        'c2bb15a8175a45d0', '110310e9ed9b3528', 'ae352e011bab4d10',
        '96f29d03ebb5c220'),
    (3, 1000, 4, 8, "float32", True): (
        'c74c9867b09cec0b', 'cae0d4e6e4326afa', 'ba8fb2ec146d0629',
        'b95f689f94d48d59'),
    (2, 513, 2, 64, "float32", True): (
        'b7ae8ef4d8f17357', '797d2a57c7c10dfe', '1af9ec6f906ac909',
        '55deeb75b3d4ec3c'),
}


@pytest.mark.parametrize("key", list(FLASH_PINNED))
def test_flash_keeps_its_pinned_bits(key):
    """The bf16 tensor-core kernels and the wide kernels (D > 64) give the
    pinned o, m, den, dq, dk and dv bit for bit; the f32 CUDA-core kernels
    the pinned m, dq, dk and dv (the backward sums in the per-row order)."""
    n, t, heads, d, dtype, masked = key
    q, k, v, mask, g, m, den, delta = _pinned_inputs(*key)
    fwd = bw.flash_fwd(q, k, v, mask, heads)
    if dtype == "float32" and d <= 64:
        fwd = fwd[1:2]
    grads = bw.flash_bwd(q, k, v, mask, g, m, den, delta, heads)
    assert tuple(_hash(x) for x in (*fwd, *grads)) == FLASH_PINNED[key]


def test_long_sequences_route_to_flash_under_grad():
    """From flash_min_seq keys on, MHSA launches rows 9-10 and no fused-qkv
    kernel; the gradients agree with the plain route's."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(0)
    heads, d, t = 4, 8, 512
    params = {name: {"w": torch.from_numpy(rng.normal(
                         scale=0.2, size=(32, heads * d)).astype(np.float32))
                     .cuda().requires_grad_(),
                     "b": torch.zeros(heads * d, device="cuda",
                                      requires_grad=True)}
              for name in ("wq", "wk", "wv")}
    x = torch.randn((3, t, 32), device="cuda", requires_grad=True)
    mask = torch.ones((3, t), device="cuda")
    mask[0, 100:] = 0.0
    fa.reset_launch_counts()
    out = attention.multi_head_self_attention(params, x, mask, n_heads=heads)
    out.sum().backward()
    torch.cuda.synchronize()
    assert fa.launch_counts("flash_fwd") == {"flash": 0, "flash_masked": 1}
    assert fa.launch_counts("flash_bwd") == {"flash_bwd": 0,
                                             "flash_bwd_masked": 1}
    assert not any(fa.launch_counts().values())
    assert not any(fa.launch_counts("qkv_fwd_probs").values())
    cpu = {n: {k: w.detach().cpu().requires_grad_() for k, w in p.items()}
           for n, p in params.items()}
    xc = x.detach().cpu().requires_grad_()
    ref = attention.multi_head_self_attention(cpu, xc, mask.cpu(),
                                              n_heads=heads)
    ref.sum().backward()
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               ref.detach().numpy(), **TOL["float32"])
    np.testing.assert_allclose(x.grad.cpu().numpy(), xc.grad.numpy(),
                               **BWD_TOL["float32"])


def test_flash_raises_on_what_it_does_not_take():
    # D = 65 and D = 1100 (two slices of the wide kernels) agree
    for width in (130, 2200):
        q = torch.randn((1, 512, width), device="cuda")
        np.testing.assert_allclose(
            bw.flash_exp_mhsa(q, q, q, 2).cpu().numpy(),
            bw.flash_fwd_reference(q, q, q, None, 2)[0].cpu().numpy(),
            **TOL["float32"])
    q = torch.zeros((1, 512, 8), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        bw.flash_exp_mhsa(q, q, q, 2)
    q = torch.zeros((1, 512, 16), device="cuda")[..., :8]
    k = torch.zeros((1, 512, 8), device="cuda")
    with pytest.raises(ValueError, match="row stride"):
        bw.flash_exp_mhsa(q, k, k, 2)


# ---- rows 11-12: the 2-D-I/O attention --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 97, 2, 33)])
def test_qkv2d_kernels_equal_rows_2_3(dtype, n, t, heads, d):
    """Row 11's context and probs and row 12's dqkv equal rows 2-3's on the
    (N, T, 3HD) view in every element, and the plain versions within the
    tolerance."""
    qkv, bias, _ = _inputs(n, t, heads, d, dtype, seed=8)
    qkv2d = qkv.view(n * t, -1)
    g = torch.randn((n, t, heads * d), device="cuda").to(qkv.dtype)
    fa.reset_launch_counts()
    out, probs = q2.qkv2d_fwd(qkv2d, bias, heads, t)
    dqkv = q2.qkv2d_bwd(qkv2d, bias, probs, g, heads, t)
    out3, probs3 = fa.qkv_fwd_probs(qkv, bias, None, heads)
    dqkv3 = fa.qkv_bwd_probs(qkv, bias, probs3, g, heads)
    ref, ref_probs = q2.qkv2d_fwd_reference(qkv2d, bias, heads, t)
    ref_dqkv = q2.qkv2d_bwd_reference(qkv2d, bias, ref_probs, g, heads, t)
    torch.cuda.synchronize()
    assert torch.equal(out, out3) and torch.equal(probs, probs3)
    assert dqkv.shape == qkv2d.shape and torch.equal(dqkv.view_as(qkv),
                                                     dqkv3)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(probs.cpu().numpy(), ref_probs.cpu().numpy(),
                               **TOL["float32"])
    np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                               ref_dqkv.float().cpu().numpy(),
                               **BWD_TOL[dtype])
    assert fa.launch_counts("qkv2d_fwd") == {"fwd2d": 1}
    assert fa.launch_counts("qkv2d_bwd") == {"bwd2d": 1}


def test_attention_io_2d_launches_rows_11_12():
    """With attention_io "2d", unmasked attention under grad launches rows
    11-12 and no row 1-4; masked attention keeps rows 2-3. A strided
    gradient is made contiguous for row 12."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(1)
    heads, d, t = 4, 8, 20
    params = {name: {"w": torch.from_numpy(rng.normal(
                         scale=0.2, size=(32, heads * d)).astype(np.float32))
                     .cuda().requires_grad_(),
                     "b": torch.zeros(heads * d, device="cuda",
                                      requires_grad=True)}
              for name in ("wq", "wk", "wv")}
    x = torch.randn((6, t, 32), device="cuda", requires_grad=True)
    mask = torch.ones((6, t), device="cuda")
    mask[0, 5:] = 0.0
    kernel_config.set_attention_io("2d")
    try:
        fa.reset_launch_counts()
        out = attention.multi_head_self_attention(params, x, n_heads=heads)
        out.backward(torch.randn((t, 6, heads * d),
                                 device="cuda").transpose(0, 1))
        masked = attention.multi_head_self_attention(params, x, mask,
                                                     n_heads=heads)
        masked.sum().backward()
        torch.cuda.synchronize()
    finally:
        kernel_config.set_attention_io("3d")
    assert fa.launch_counts("qkv2d_fwd") == {"fwd2d": 1}
    assert fa.launch_counts("qkv2d_bwd") == {"bwd2d": 1}
    assert fa.launch_counts("qkv_fwd_probs") == {"bias_probs": 0,
                                                 "bias_masked_probs": 1}
    assert fa.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    assert not any(fa.launch_counts().values())


# ---- rows 13-14: the fused encoder tail -------------------------------------


def _tail_inputs(n, t, heads, d, q, dtype, seed=0):
    qkv, _, mask = _inputs(n, t, heads, d, dtype, seed)
    rng = np.random.default_rng(seed + 100)
    tdt = getattr(torch, dtype)
    hd = heads * d

    def arr(shape, scale, to=torch.float32):
        return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(
            np.float32)).to(to).cuda()

    pool = (arr((hd, q), 0.1, tdt), arr((1, q), 0.5), arr((q, 1), 1.0, tdt),
            arr((1, 1), 1.0))
    g = arr((n, hd), 1.0, tdt)
    return qkv, mask, pool, g


def _summed_tol(refs, dtype):
    """The pooling gradients are sums over all N*T positions, so an element
    near 0 is a difference of large terms, and db2 is 0 analytically (alpha
    sums to 1 on a row, or is 0): each element is held within a share of
    the largest element of them all (f32: 1e-5, the order of the sums
    alone; bf16: 2^-8, a rounding flip of a bf16 operand in one term)."""
    share = 1e-5 if dtype == "float32" else 2 ** -8
    rtol = 1e-4 if dtype == "float32" else 2 ** -6
    largest = max(r.abs().max().item() for r in refs)
    return dict(rtol=rtol, atol=share * largest)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d, q", [
    (16, 20, 20, 20, 200), (33, 50, 20, 20, 200), (7, 5, 3, 4, 7),
    (5, 13, 2, 33, 9), (6, 30, 2, 72, 16)])
def test_fused_tail_kernels_match_plain(n, t, heads, d, q, dtype, masked,
                                        dropout):
    """Rows 13-14 against their plain versions, dropout off and at 0.2;
    row 14's outputs equal bit for bit over two runs. Heads of 72 take the
    global regime at any T."""
    qkv, mask, pool, g = _tail_inputs(n, t, heads, d, q, dtype, seed=9)
    km = mask if masked else None
    seed = torch.tensor([2 ** 31 - 7], dtype=torch.int32, device="cuda")
    args = (qkv, km, *pool, seed, heads, 0.2, not dropout)
    kernels.reset_launch_counts()
    out = fe.fused_tail_fwd(*args)
    ref = fe.fused_tail_fwd_reference(*args)
    grads = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    again = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    refs = fe.fused_tail_bwd_reference(*args[:7], g, *args[7:])
    torch.cuda.synchronize()
    assert out.dtype == qkv.dtype and out.shape == (n, heads * d)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(grads[0].float().cpu().numpy(),
                               refs[0].float().cpu().numpy(),
                               **BWD_TOL[dtype])
    tol = _summed_tol(refs[1:], dtype)
    for got, want in zip(grads[1:], refs[1:]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    if masked:
        assert (out[::3] == 0).all() and (grads[0][::3] == 0).all()
    variant = "_masked" if masked else ""
    assert kernels.launch_counts("fused_tail_fwd")["tail" + variant] == 1
    assert kernels.launch_counts("fused_tail_bwd")["tail_bwd" + variant] == 2
    regime = "global" if d > 64 else "resident"
    assert kernels.regime_counts("fused_tail_fwd") == {regime: 1}
    assert kernels.regime_counts("fused_tail_bwd") == {regime: 2}


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_fused_tail_takes_t_up_to_its_smem_limit(which):
    """At H = D = 20, Q = 200 the longest row the per-row kernel once held
    in shared memory (T = 86 in the forward, 85 in the backward), one
    position more (where it kept the row in a global scratch) and T = 512
    (the user encoder over a long history) all agree with the plain
    version, and all run in the tiled regime now."""
    src = f"fused_tail_{which}"
    t_max = 86 if which == "fwd" else 85
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    for t in (t_max, t_max + 1, 512):
        qkv, mask, pool, g = _tail_inputs(3, t, 20, 20, 200, "float32",
                                          seed=10)
        args = (qkv, mask, *pool, seed, 20, 0.0, True)
        kernels.reset_launch_counts()
        if which == "fwd":
            got = fe.fused_tail_fwd(*args)
            want = fe.fused_tail_fwd_reference(*args)
        else:
            got = fe.fused_tail_bwd(*args[:7], g, *args[7:])[0]
            want = fe.fused_tail_bwd_reference(*args[:7], g, *args[7:])[0]
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **BWD_TOL["float32"], err_msg=f"T={t}")
        assert kernels.regime_counts(src) == {"tiled": 1}, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [512, 1000])
def test_fused_tail_takes_long_rows(t, dtype):
    """Rows 13-14 at T = 512 and 1000 with dropout on, masked, against
    their plain versions, in the tiled regime (at 1000 its sub-tile of 16
    queries); row 14's attention part runs on tensor cores in
    bf16 and, past T = 599 in f32, in global slots. The pooling gradients
    are held as in test_fused_tail_kernels_match_plain, and two runs give
    the same bits."""
    qkv, mask, pool, g = _tail_inputs(4, t, 20, 20, 200, dtype, seed=11)
    seed = torch.tensor([77], dtype=torch.int32, device="cuda")
    args = (qkv, mask, *pool, seed, 20, 0.2, False)
    kernels.reset_launch_counts()
    out = fe.fused_tail_fwd(*args)
    grads = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    again = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    ref = fe.fused_tail_fwd_reference(*args)
    refs = fe.fused_tail_bwd_reference(*args[:7], g, *args[7:])
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(grads[0].float().cpu().numpy(),
                               refs[0].float().cpu().numpy(),
                               **BWD_TOL[dtype])
    tol = _summed_tol(refs[1:], dtype)
    for got, want in zip(grads[1:], refs[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert (out[::3] == 0).all() and (grads[0][::3] == 0).all()
    assert kernels.regime_counts("fused_tail_fwd") == {"tiled": 1}
    assert kernels.regime_counts("fused_tail_bwd") == {"tiled": 2}


def test_fused_tail_raises_on_what_it_does_not_take():
    qkv, mask, pool, g = _tail_inputs(4, 6, 2, 4, 5, "float32")
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    w1, b1, w2, b2 = pool
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_tail_fwd(qkv.transpose(0, 1).contiguous().transpose(0, 1),
                          None, w1, b1, w2, b2, seed, 2, 0.0, True)
    with pytest.raises(TypeError, match="w1"):
        fe.fused_tail_fwd(qkv, None, w1.bfloat16(), b1, w2, b2, seed, 2, 0.0,
                          True)
    with pytest.raises(TypeError, match="seed"):
        fe.fused_tail_fwd(qkv, None, w1, b1, w2, b2, seed.long(), 2, 0.0,
                          True)
    with pytest.raises(ValueError, match="g must be"):
        fe.fused_tail_bwd(qkv, None, w1, b1, w2, b2, seed, g[:, :4], 2, 0.0,
                          True)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_tail_launches_rows_13_14(masked):
    """With fused_tail on, the encoder tail under grad launches row 13 and,
    in its backward, row 14, and no attention row (whatever attention_io
    says); a strided gradient is made contiguous. Gradients agree with the
    plain route's on the CPU."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(2)
    heads, d, t, q = 4, 8, 20, 16

    def lin(i, o):
        return {"w": torch.from_numpy(rng.normal(scale=0.3, size=(i, o))
                                      .astype(np.float32)).cuda()
                .requires_grad_(),
                "b": torch.zeros(o, device="cuda", requires_grad=True)}

    mhsa = {k: lin(32, heads * d) for k in ("wq", "wk", "wv")}
    pool = {"fc1": lin(heads * d, q), "fc2": lin(q, 1)}
    x = torch.randn((6, t, 32), device="cuda", requires_grad=True)
    mask = torch.ones((6, t), device="cuda")
    mask[0, 5:] = 0.0
    km = mask if masked else None
    g = torch.randn((heads * d, 6), device="cuda").t()
    kernel_config.set_fused_tail("on")
    kernel_config.set_attention_io("2d")
    try:
        kernels.reset_launch_counts()
        out = attention.mhsa_dropout_pool(mhsa, pool, x, km, n_heads=heads)
        out.backward(g)
        torch.cuda.synchronize()
        launches = {k: kernels.launch_counts(k) for k in kernels.KERNELS}
        cpu = {name: {k: {n: w.detach().cpu().requires_grad_()
                          for n, w in p.items()} for k, p in tree.items()}
               for name, tree in (("mhsa", mhsa), ("pool", pool))}
        xc = x.detach().cpu().requires_grad_()
        ref = attention.mhsa_dropout_pool(
            cpu["mhsa"], cpu["pool"], xc, None if km is None else km.cpu(),
            n_heads=heads)
        ref.backward(g.cpu())
    finally:
        kernel_config.set_fused_tail("auto")
        kernel_config.set_attention_io("3d")
    variant = "_masked" if masked else ""
    assert launches["fused_tail_fwd"]["tail" + variant] == 1
    assert launches["fused_tail_bwd"]["tail_bwd" + variant] == 1
    others = {k: v for k, v in launches.items()
              if not k.startswith("fused_tail")}
    assert not any(any(v.values()) for v in others.values()), others
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               ref.detach().numpy(), **TOL["float32"])
    np.testing.assert_allclose(x.grad.cpu().numpy(), xc.grad.numpy(),
                               **BWD_TOL["float32"])
    pairs = [(f"{k}.{n}", w.grad, cpu[name][k][n].grad)
             for name, tree in (("mhsa", mhsa), ("pool", pool))
             for k, p in tree.items() for n, w in p.items()]
    tol = _summed_tol([ref_g for _, _, ref_g in pairs], "float32")
    for label, got, ref_g in pairs:
        np.testing.assert_allclose(got.cpu().numpy(), ref_g.numpy(), **tol,
                                   err_msg=label)


def _hash(x):
    bits = x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                               else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


# Rows 13-14 in f32 at T <= 64 before the resident regime (the per-row
# kernels, with row 4's kernel for the attention backward), on an H100, the
# inputs of test_fused_tail_kernels_match_plain (seed 9, the dropout seed
# 2^31 - 7): hashes of (out, dqkv, dw1), (db1, dw2, db2), by (N, T, H, D,
# Q, masked, dropout).
TAIL_F32_PINNED = {
    (16, 20, 20, 20, 200, False, False): (
        ('9e1d58a080cfce62', 'e0ed37bdda424225', 'aa12b607e96ab2a7'),
        ('94666d55e4f316fe', 'bcb3537f48e3704e', '7bddfa0768dd25b2')),
    (16, 20, 20, 20, 200, False, True): (
        ('7c32ecf2acb93d64', '2ba91223a8fc8abc', 'b6fea60e7f2ce719'),
        ('30684b534be432f1', '20e6fa8144c987ff', '1a77ba10b5a7b090')),
    (16, 20, 20, 20, 200, True, False): (
        ('971d3316071d7eb9', 'de6af5e21f1f696c', 'f01597d17b44fa83'),
        ('693590d3450f9cd6', 'aa068b25af672966', '5e04c453cc359579')),
    (16, 20, 20, 20, 200, True, True): (
        ('6aee3a25a1387a12', '820259e5ecceb49f', '74f74beb0d28997c'),
        ('ad844ecdb0033cbf', '6bac211b68d50aee', 'e17bd2545b9478c9')),
    (33, 50, 20, 20, 200, False, False): (
        ('55f099ecbb63c8c4', '2723368647bd8da9', '462b1f37e156259b'),
        ('e5088102330eb17a', 'e7eb318510f56e8c', '7f9205f8fad22364')),
    (33, 50, 20, 20, 200, False, True): (
        ('a62e18a8d333b0c0', '906258a7cd228bad', 'e377c660818701d2'),
        ('98cd3a8bcda44527', '929ca4c518e6601b', '75d2566d37f7db5f')),
    (33, 50, 20, 20, 200, True, False): (
        ('e2533fdce7e4b1af', 'a50b4dc67e03f818', 'fa80dcfd42107812'),
        ('b2f6d615a29a552a', 'd8e17a746d5a68ff', '346d55a8f804f84e')),
    (33, 50, 20, 20, 200, True, True): (
        ('e137cae88714344f', '92777aa364e8f8fb', '76d3a57413915eee'),
        ('ef4ee0f66ccf361c', '1ca5f78b94afe5e6', '4be8ced840d146f0')),
    (128, 64, 20, 20, 200, False, False): (
        ('bd15ffaac2f46257', 'a02bdb108556eb70', '893676b7fd7dcf34'),
        ('f5532f61d881053d', 'acfaf22cbc7356ee', '65234be7938da09c')),
    (128, 64, 20, 20, 200, False, True): (
        ('b50dae18fbf547dd', 'd3a22ba1e2c3b1a7', '22cf067d03de6b9e'),
        ('6f9e3bfa779eb7b6', '702cb27f73d5d79b', 'fd6cfebe6f0de34c')),
    (128, 64, 20, 20, 200, True, False): (
        ('94dcecfbc3b63733', 'bd833cefc9283586', '190a9cfe6ddbd668'),
        ('1f7d366208646231', 'c591ffaf07796a56', 'de3e7fdadbcad4ca')),
    (128, 64, 20, 20, 200, True, True): (
        ('182d8b406e264979', '4408cf23e3b584d6', 'fa43d1aafbc1a205'),
        ('7901092aae5628f5', 'd6ef01ff86f09390', 'd51c1f29f1d662ef')),
    (7, 5, 3, 4, 7, False, False): (
        ('6227ca80c7aa1971', '9b9851e502888b96', 'c086ae7822a6e5f8'),
        ('1c3362436ce15373', '764f46ca0eb9982b', '008ee181f96e4d7c')),
    (7, 5, 3, 4, 7, False, True): (
        ('a3a856a49d196a9a', 'abc0de1acf549969', '87e1cbcbbd38c898'),
        ('24a961a4dae3476c', '3be9526c1e121d7d', '155f48390d13a3ad')),
    (7, 5, 3, 4, 7, True, False): (
        ('426b4c747df1744a', 'a2394531adad612c', '4132896fe6fd4243'),
        ('5a6a304a77ab3507', '84d9dd7a5dc358cb', 'e967ee2a309bc81a')),
    (7, 5, 3, 4, 7, True, True): (
        ('adcec8fbb8be23bb', 'dcd8c7d1b9fdaeaf', 'a0f234f38184db0e'),
        ('245e0daf86730fc6', '126109a680d84fa0', '56f25495a9dba15f')),
    (5, 13, 2, 33, 9, False, False): (
        ('7b2159b6b76f756a', 'e3888902bc113abc', 'f45d7ac39bf4d146'),
        ('22e9330481804192', 'ada61370b0af6109', 'c6cb5009f0853731')),
    (5, 13, 2, 33, 9, False, True): (
        ('d1d430345ed3446c', 'a02c70a7e8670dcd', '378efde34f85528b'),
        ('a45a48ccf079507e', '830be17d6af413b9', 'd3f8fade98467f92')),
    (5, 13, 2, 33, 9, True, False): (
        ('b07d55521d12bc0e', '9a19874304bdf420', '3e180bc0be3f87e2'),
        ('d1889917b4a7d783', '2d71c82a9b63a36a', 'acb7a4cfd4c4a700')),
    (5, 13, 2, 33, 9, True, True): (
        ('0e187813147fdd33', '1cdd998bb684dc1f', '84565f971c09230f'),
        ('75c938563b199fa3', '77c2aa9dc3a3e484', '9622032490de43d5')),
}


@pytest.mark.parametrize("key", list(TAIL_F32_PINNED))
def test_fused_tail_f32_keeps_its_bits(key):
    """In f32 the resident regime sums every product in the per-row
    kernels' order and keeps row 4's kernel for the attention backward:
    out, dqkv and the pooling gradients equal the pinned run of the per-row
    kernels bit for bit."""
    n, t, heads, d, q, masked, dropout = key
    qkv, mask, pool, g = _tail_inputs(n, t, heads, d, q, "float32", seed=9)
    seed = torch.tensor([2 ** 31 - 7], dtype=torch.int32, device="cuda")
    args = (qkv, mask if masked else None, *pool, seed, heads, 0.2,
            not dropout)
    kernels.reset_launch_counts()
    got = [fe.fused_tail_fwd(*args)]
    got += fe.fused_tail_bwd(*args[:7], g, *args[7:])
    hashes = tuple(_hash(x) for x in got)
    assert hashes == TAIL_F32_PINNED[key][0] + TAIL_F32_PINNED[key][1]
    assert kernels.regime_counts("fused_tail_fwd") == {"resident": 1}
    assert kernels.regime_counts("fused_tail_bwd") == {"resident": 1}


# Rows 13-14 in f32 past T = 64 before the tiled regime (the per-row
# kernels, "global" at these T), on an H100 80GB HBM3: hashes of (out,
# dqkv, dw1, db1, dw2, db2) on _tail_inputs(N, T, 20, 20, 200, "float32",
# seed=11) with the dropout seed 77, by (N, T, masked, dropout).
TAIL_TILED_PINNED = {
    (4, 512, True, True): (
        'dcf2f1b2d4e8138f', '88937b6a7a77d999', '229982d8db17c09b',
        'ad0fb76b8ef5e397', '9283b01778deb856', '17042b76c512b7df'),
    (3, 87, False, False): (
        'fd986ce9eef473e5', '5933d2399ed29f27', 'e463c1fc9caf98ae',
        '6c06b38c2b8e4261', '8c4962a3f0889aa1', '22a372ac110e7e47'),
    (32, 1000, False, False): (
        'ea90a28f4936c74b', '16fc263f1589dd87', 'e4ee258e23446d09',
        'd05bc271855380ce', '9d7e7a6164d9f62b', '1d1b9fc04f79e497'),
}


@pytest.mark.parametrize("key", list(TAIL_TILED_PINNED))
def test_fused_tail_tiled_keeps_its_bits(key):
    """In f32 the tiled regime sums every product in the per-row kernels'
    order (the scores over d, p V over the keys, fc1 and d_z w1^T in k
    order, out and the row sums over the positions) and reduces as they
    do: out, dqkv and the pooling gradients equal the pinned run of the
    per-row kernels bit for bit, each launch in the tiled regime."""
    n, t, masked, dropout = key
    qkv, mask, pool, g = _tail_inputs(n, t, 20, 20, 200, "float32", seed=11)
    seed = torch.tensor([77], dtype=torch.int32, device="cuda")
    args = (qkv, mask if masked else None, *pool, seed, 20, 0.2,
            not dropout)
    kernels.reset_launch_counts()
    got = [fe.fused_tail_fwd(*args)]
    got += fe.fused_tail_bwd(*args[:7], g, *args[7:])
    assert tuple(_hash(x) for x in got) == TAIL_TILED_PINNED[key]
    assert kernels.regime_counts("fused_tail_fwd") == {"tiled": 1}
    assert kernels.regime_counts("fused_tail_bwd") == {"tiled": 1}


# The per-row kernels' counts of bf16 elements of (out, dqkv) that differ
# from the plain versions, on chip_smoke.py's kernel-fused-tail-long inputs
# (masked, dropout 0.2; the phase's seeds 10 and 11), on an H100 80GB HBM3.
TAIL_LONG_BF16_DIFFER = {(128, 87, 10): (2, 12828),
                         (128, 512, 11): (154, 1961657)}


@pytest.mark.parametrize("key", list(TAIL_LONG_BF16_DIFFER))
def test_fused_tail_tiled_bf16_differs_no_more(key):
    """In bf16 the tiled regime's out and dqkv differ from the plain
    versions in no more elements than the per-row kernels' did on the
    smoke's long cases."""
    import chip_smoke

    n, t, seed = key
    qkv, mask, pool, g = chip_smoke.tail_inputs(n, t, 20, 20, 200,
                                                "bfloat16", True, seed)
    sd = torch.tensor([1234567 + seed], dtype=torch.int32, device="cuda")
    args = (qkv, mask, *pool, sd, 20, 0.2, False)
    bargs = (*args[:7], g, *args[7:])
    out, dqkv = fe.fused_tail_fwd(*args), fe.fused_tail_bwd(*bargs)[0]
    ref, ref_d = (fe.fused_tail_fwd_reference(*args),
                  fe.fused_tail_bwd_reference(*bargs)[0])
    counts = (int((out != ref).sum()), int((dqkv != ref_d).sum()))
    assert all(c <= w for c, w in zip(counts, TAIL_LONG_BF16_DIFFER[key])), (
        counts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [64, 65])
def test_fused_tail_both_sides_of_the_resident_regime(dtype, t):
    """Rows 13-14 at (128, 64), the resident regime's longest row, and
    (128, 65), the tiled regime's shortest, masked, dropout on,
    against their plain versions, each launch counted in its regime."""
    qkv, mask, pool, g = _tail_inputs(128, t, 20, 20, 200, dtype, seed=12)
    seed = torch.tensor([991], dtype=torch.int32, device="cuda")
    args = (qkv, mask, *pool, seed, 20, 0.2, False)
    kernels.reset_launch_counts()
    out = fe.fused_tail_fwd(*args)
    grads = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    again = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    ref = fe.fused_tail_fwd_reference(*args)
    refs = fe.fused_tail_bwd_reference(*args[:7], g, *args[7:])
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(grads[0].float().cpu().numpy(),
                               refs[0].float().cpu().numpy(),
                               **BWD_TOL[dtype])
    tol = _summed_tol(refs[1:], dtype)
    for got, want in zip(grads[1:], refs[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert (out[::3] == 0).all() and (grads[0][::3] == 0).all()
    regime = "resident" if t <= 64 else "tiled"
    assert kernels.regime_counts("fused_tail_fwd") == {regime: 1}
    assert kernels.regime_counts("fused_tail_bwd") == {regime: 2}


def test_tail_launch_plan_matches_the_kernels():
    """tail_launch_plan's regime, resident shared bytes, tiled attention
    block bytes and tiled row scratch are the C side's
    (fused_tail_*_regime, fused_tail_*_smem_bytes,
    fused_tail_tiled_smem_bytes, fused_tail_*_row_floats) at T up to 90
    and across the tiled sub-tiles' and regime's ends in both dtypes, and
    a launch in another regime than the shape's, or with a sub-tile that
    does not fit or is not 16, 32 or 64, is refused."""
    for kind in ("fwd", "bwd"):
        src = f"fused_tail_{kind}"
        for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
            for t in (1, 5, 20, 50, 63, 64, 65, 85, 86, 87, 90, 512, 513,
                      1024, 1025):
                for heads, d in ((20, 20), (2, 33), (3, 64), (1, 65)):
                    want = kernels.size_of(src, f"{src}_regime", t, heads,
                                           d, 200, size)
                    plan = fe.tail_launch_plan(kind, 64, t, heads, d, 200,
                                               dtype)
                    assert fe.TAIL_REGIMES[want] == plan.regime, (kind, t)
                    if plan.regime == "resident":
                        assert plan.smem == kernels.size_of(
                            src, f"{src}_smem_bytes", t, heads, d, 200,
                            size, plan.heads, plan.nbuf)
                    floats = kernels.size_of(src, f"{src}_row_floats", t,
                                             heads, d, 200, size)
                    if plan.regime == "tiled":
                        assert plan.smem == kernels.size_of(
                            "fused_tail_fwd", "fused_tail_tiled_smem_bytes",
                            t, d, plan.tile)
                        # the f32 context and the scores; the scores (then
                        # alpha) and d_alpha
                        assert floats == (t * (heads * d + 1)
                                          if kind == "fwd" else 2 * t)
                    else:
                        assert floats == 0
    qkv, mask, pool, g = _tail_inputs(4, 20, 2, 4, 5, "float32")
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    args = (qkv, None, *pool, seed, 2, 0.0, True)
    real = fe.tail_launch_plan
    try:
        for plan in (fe.TailPlan("global"), fe.TailPlan("tiled", tile=64)):
            fe.tail_launch_plan = lambda *a, **k: plan
            with pytest.raises(RuntimeError, match="launch failed"):
                fe.fused_tail_fwd(*args)
            with pytest.raises(RuntimeError, match="launch failed"):
                fe.fused_tail_bwd(*args[:7], g, *args[7:])
        qkv, mask, pool, g = _tail_inputs(4, 600, 2, 20, 5, "float32")
        args = (qkv, None, *pool, seed, 2, 0.0, True)
        assert real("fwd", 4, 600, 2, 20, 5, torch.float32).tile == 32
        # 48 fits the block at T = 600 (fe.tiled_smem) but is not a
        # sub-tile the kernels take
        assert fe.tiled_smem(600, 20, 48) <= kernels.MAX_SMEM
        for plan in (fe.TailPlan("tiled", tile=64),
                     fe.TailPlan("tiled", tile=24),
                     fe.TailPlan("tiled", tile=48)):
            fe.tail_launch_plan = lambda *a, **k: plan
            with pytest.raises(RuntimeError, match="launch failed"):
                fe.fused_tail_fwd(*args)
            with pytest.raises(RuntimeError, match="launch failed"):
                fe.fused_tail_bwd(*args[:7], g, *args[7:])
    finally:
        fe.tail_launch_plan = real


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t", [(64, 20), (33, 50), (16, 64)])
def test_row_16_against_row_4_at_resident_lengths(dtype, masked, n, t):
    """Row 16's resident kernel (row 14's attention backward in bf16 at
    T <= 64) on the biased qkv against row 4's: the same dqkv bit for bit
    while each lane holds one key (T <= 32); past that row 16 rounds each
    product of r = sum(da a) before adding it, row 4 adds it in one fma, so
    in f32 many elements differ by an ulp or two, and in bf16, where ds is
    rounded, a few in a hundred thousand by at most 2^-8."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    qkv, _, mask = _inputs(n, t, 20, 20, dtype, seed=31)
    km = mask if masked else None
    g = _grad(n, t, 400, dtype, 32)
    got = bl.blanes_bwd(qkv, km, g, 20)
    want = fa.qkv_bwd(qkv, qkv.new_zeros(1200), km, g, 20)
    if t <= 32:
        assert torch.equal(got, want)
    elif dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-6
    else:
        assert int((got != want).sum()) <= 1e-5 * got.numel()
        assert (got.float() - want.float()).abs().max().item() <= 2 ** -8


# Rows 15-16 at T <= 64 before rows 13-14 shared their kernels
# (blanes_resident.cuh), on an H100, inputs _inputs(seed 41) and
# _grad(seed 42): hashes of (out, dqkv) by (dtype, N, T, H, D, masked).
BLANES_PINNED = {
    ("float32", 64, 20, 20, 20, False):
        ('6e33db985ebeb35f', 'abba2555536afa99'),
    ("float32", 64, 20, 20, 20, True):
        ('3b9a5219c0101121', 'ff040166f303b06d'),
    ("float32", 33, 50, 20, 20, False):
        ('210793d3899f6c46', 'ebe8006eb5ec4256'),
    ("float32", 33, 50, 20, 20, True):
        ('53a269410f4abddd', '705adf0036230e9b'),
    ("float32", 16, 64, 20, 20, False):
        ('135d6469f258bd1c', '2516eacf883645f4'),
    ("float32", 16, 64, 20, 20, True):
        ('687acb066721ecf7', '98ec4eb44dbbb401'),
    ("float32", 5, 37, 2, 64, False): ('6b816e0d14d555eb', '6157cb6b78e103f4'),
    ("float32", 5, 37, 2, 64, True): ('57758ca96bdb68a4', '44ba35d89a575408'),
    ("bfloat16", 64, 20, 20, 20, False):
        ('0591cd20da8853af', 'b91779777d461dad'),
    ("bfloat16", 64, 20, 20, 20, True):
        ('b94db94d4d41d873', '4819ea9f19c0ba77'),
    ("bfloat16", 33, 50, 20, 20, False):
        ('aa94ba84e84bdb04', 'e7d7bee77844d88a'),
    ("bfloat16", 33, 50, 20, 20, True):
        ('e69aec5d5e12638c', 'b6f1a3571a3fb48a'),
    ("bfloat16", 16, 64, 20, 20, False):
        ('39a68cfad5ed0f50', '572cf11e4b61c799'),
    ("bfloat16", 16, 64, 20, 20, True):
        ('4d84279039f1cfd0', 'fbc223d99fe1fb33'),
    ("bfloat16", 5, 37, 2, 64, False):
        ('092b4277db51a7ce', 'c0031a2dee7c26d3'),
    ("bfloat16", 5, 37, 2, 64, True): ('2bb022ffa4834164', 'aacb91fbfab75c66'),
}


@pytest.mark.parametrize("key", list(BLANES_PINNED))
def test_blanes_keeps_its_bits(key):
    """Row 15's per-query pass, taken into a function rows 13-14 call, and
    row 16's resident kernel, moved into the shared header, give the
    pinned outputs bit for bit."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    dtype, n, t, heads, d, masked = key
    qkv, _, mask = _inputs(n, t, heads, d, dtype, seed=41)
    km = mask if masked else None
    g = _grad(n, t, heads * d, dtype, 42)
    assert (_hash(bl.blanes_fwd(qkv, km, heads)),
            _hash(bl.blanes_bwd(qkv, km, g, heads))) == BLANES_PINNED[key]

# ---- rows 15-16: batch-in-lanes attention -----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 300, 2, 8),
                                            (40, 511, 1, 33), (5, 37, 2, 64),
                                            (37, 64, 3, 20), (37, 65, 3, 20),
                                            (9, 128, 2, 16), (5, 200, 3, 20),
                                            (3, 20, 2, 33), (6, 65, 2, 33),
                                            (5, 128, 2, 64), (11, 20, 5, 8)])
def test_blanes_kernels_match_plain(dtype, n, t, heads, d):
    """Rows 15-16 against their plain versions, unmasked and masked (every
    third row fully masked): T on both sides of the regime switch (64, 65)
    and past it (128, 200, 300, 511), H = 5 against the four heads of a
    work item, N past and below the blocks of the grid, heads of 33 (rows
    not 16-byte aligned: element copies in bf16) and of 64 (the widest
    the wrapper takes)."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=12)
    qkv = (qkv + bias).contiguous()
    g = torch.randn((n, t, heads * d), device="cuda").to(qkv.dtype)
    kernels.reset_launch_counts()
    for km in (None, mask):
        out = bl.blanes_fwd(qkv, km, heads)
        dqkv = bl.blanes_bwd(qkv, km, g, heads)
        ref = bl.blanes_fwd_reference(qkv, km, heads)
        refg = bl.blanes_bwd_reference(qkv, km, g, heads)
        torch.cuda.synchronize()
        assert out.dtype == qkv.dtype and out.shape == (n, t, heads * d)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **TOL[dtype])
        np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                                   refg.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
    assert (out[::3] == 0).all() and (dqkv[::3] == 0).all()
    assert kernels.launch_counts("blanes_fwd") == {"blanes": 1,
                                                   "blanes_masked": 1}
    assert kernels.launch_counts("blanes_bwd") == {"blanes_bwd": 1,
                                                   "blanes_bwd_masked": 1}


def test_blanes_launch_plan_matches_the_kernels_layout():
    """The launch plan's shared bytes (ops/experimental_blanes.py) equal
    the kernel source's own layout at the shapes the plan tests take."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    for n, t, heads, d in [(7040, 20, 20, 20), (128, 50, 20, 20),
                           (64, 511, 20, 20), (128, 64, 20, 20),
                           (128, 65, 20, 20), (64, 200, 20, 20),
                           (6, 65, 2, 33), (5, 37, 2, 64), (5, 128, 2, 64)]:
        for itemsize in (4, 2):
            plans = bl.launch_plans(n, t, heads, d, itemsize, 132)
            for p in [plans["fwd"], *plans["bwd"]]:
                assert p.smem == kernels.size_of(
                    "blanes", "blanes_smem_bytes", bl.KINDS[p.kind], t, d,
                    itemsize, p.heads, p.rows, p.nbuf), (n, t, d, p)


@pytest.mark.parametrize("masked", [False, True])
def test_blanes_layout_launches_rows_15_16(masked):
    """Under attention_layout "blanes" (and attention_io "2d", which it
    overrides) multi_head_self_attention under grad launches rows 15-16
    only; output and gradients agree with the CPU's plain route."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(3)
    heads, d, t = 4, 8, 20
    params = {k: {"w": torch.from_numpy(rng.normal(scale=0.3, size=(
                      32, heads * d)).astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(scale=0.1, size=(
                      heads * d,)).astype(np.float32))}
              for k in ("wq", "wk", "wv")}
    x = torch.from_numpy(rng.normal(size=(40, t, 32)).astype(np.float32))
    mask = torch.ones((40, t))
    mask[0, 5:] = 0.0
    mask[1] = 0.0
    g = torch.from_numpy(rng.normal(size=(40, t, heads * d)).astype(
        np.float32))
    results = {}
    kernel_config.set_attention_layout("blanes")
    kernel_config.set_attention_io("2d")
    try:
        for dev in ("cuda", "cpu"):
            p = {k: {n: w.to(dev).requires_grad_() for n, w in v.items()}
                 for k, v in params.items()}
            xx = x.to(dev).requires_grad_()
            kernels.reset_launch_counts()
            out = attention.multi_head_self_attention(
                p, xx, mask.to(dev) if masked else None, n_heads=heads)
            out.backward(g.to(dev))
            launches = {k: kernels.launch_counts(k) for k in kernels.KERNELS}
            results[dev] = (out.detach().cpu(), xx.grad.cpu(), launches)
    finally:
        kernel_config.set_attention_layout("headloop")
        kernel_config.set_attention_io("3d")
    variant = "_masked" if masked else ""
    launches = results["cuda"][2]
    assert launches["blanes_fwd"]["blanes" + variant] == 1
    assert launches["blanes_bwd"]["blanes_bwd" + variant] == 1
    others = {k: v for k, v in launches.items() if not k.startswith("blanes")}
    assert not any(any(v.values()) for v in others.values()), others
    assert not any(any(v.values()) for v in results["cpu"][2].values())
    np.testing.assert_allclose(results["cuda"][0].numpy(),
                               results["cpu"][0].numpy(), **TOL["float32"])
    np.testing.assert_allclose(results["cuda"][1].numpy(),
                               results["cpu"][1].numpy(),
                               **BWD_TOL["float32"])


def test_blanes_raises_on_what_it_does_not_take():
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    # D = 65 runs the fused-qkv kernels' templates and agrees
    qkv = torch.randn((4, 6, 3 * 2 * 65), device="cuda")
    np.testing.assert_allclose(
        bl.blanes_fwd(qkv, None, 2).cpu().numpy(),
        bl.blanes_fwd_reference(qkv, None, 2).cpu().numpy(),
        **TOL["float32"])
    qkv = torch.zeros((4, 6, 24), device="cuda")
    with pytest.raises(TypeError, match="key_mask"):
        bl.blanes_fwd(qkv, torch.ones((4, 6), device="cuda",
                                      dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="contiguous"):
        bl.blanes_fwd(qkv.transpose(0, 1).contiguous().transpose(0, 1), None,
                      2)
    with pytest.raises(ValueError, match="g must be"):
        bl.blanes_bwd(qkv, None, torch.zeros((4, 6, 8), device="cuda",
                                             dtype=torch.bfloat16), 2)
    # f32 heads of 64 at T = 511: one head's K and V pass a block's
    # shared memory, and the same entry point takes the fused-qkv kernels'
    # templates
    qkv = torch.randn((2, 511, 3 * 64), device="cuda")
    np.testing.assert_allclose(
        bl.blanes_fwd(qkv, None, 1).cpu().numpy(),
        bl.blanes_fwd_reference(qkv, None, 1).cpu().numpy(),
        **TOL["float32"])


# ---- rows 5-8: separate q, k, v --------------------------------------------


def _sep_regime(t, dk, dv, dtype):
    """Rows 6-8's regime as the kernels' design states it: resident at
    T <= 64, tensor cores past it in bf16, both with heads of up to 64;
    else the wide kernel."""
    if max(dk, dv) > 64:
        return "wide"
    if t <= 64:
        return "resident"
    return "mma" if dtype == "bfloat16" else "wide"


def _sep_fwd_regime(t, dk, dv, dtype):
    """Rows 5 and 7's regime as the kernels' design states it: tensor cores
    past T = 64 in bf16, the tiled CUDA-core kernel past it in f32, both
    with heads of up to 64; else the row-wise kernel."""
    if max(dk, dv) > 64 or t <= 64:
        return "rowwise"
    return "mma" if dtype == "bfloat16" else "tiled"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, dk, dv, pad", [
    (64, 20, 20, 20, 20, 0), (64, 20, 20, 20, 32, 0), (33, 50, 20, 20, 8, 0),
    (7, 5, 3, 4, 6, 0), (2, 300, 2, 8, 12, 0), (2, 900, 1, 20, 20, 0),
    (9, 64, 5, 20, 32, 1), (3, 65, 2, 24, 40, 3), (4, 128, 3, 20, 32, 1),
    (2, 300, 3, 5, 12, 1), (2, 200, 2, 64, 16, 0), (3, 30, 2, 70, 8, 1),
    (2, 100, 1, 72, 20, 0), (3, 65, 2, 5, 12, 1), (2, 900, 1, 80, 8, 0)])
def test_mhsa_sep_kernels_match_plain(dtype, n, t, heads, dk, dv, pad):
    """Rows 5-8 against their plain versions, unmasked and masked, on q, k
    and v cut from one projection (one row stride; ``pad`` extra lanes
    make it odd) at equal and unequal widths, in every regime of rows 5
    and 7 and of rows 6 and 8, whose launches are counted per regime.
    Rows 6 and 8: resident at T <= 64 (d_k = 5 in bf16 is a head row of
    10 bytes, staged element by element), tensor cores past it in bf16
    (T = 65: one partial step of 16 past 64; d_k = 24 beside d_v = 40 at
    the width of 64), the wide kernel in f32 past 64 and for heads wider
    than 64; at T = 300 the wide backward's working set lives in a global
    scratch. Rows 5 and 7: row-wise at T <= 64 and for heads wider than
    64 (at T = 900 in its global scratch), tensor cores past 64 in bf16
    (T = 65 with d_k = 5: rows of 10 bytes copied element by element), the
    tiled kernel past 64 in f32 (T = 900: eight chunks of 128 keys per
    walk, the last partial)."""
    rng = np.random.default_rng(13)
    tdt = getattr(torch, dtype)
    w = heads * (2 * dk + dv) + pad
    qkv = torch.from_numpy(rng.normal(size=(n, t, w)).astype(
        np.float32)).to(tdt).cuda()
    q, k, v, _ = torch.split(qkv, [heads * dk, heads * dk, heads * dv, pad],
                             -1)
    g = torch.from_numpy(rng.normal(size=(n, t, heads * dv)).astype(
        np.float32)).to(tdt).cuda()
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[::3] = 0.0
    mask = torch.from_numpy(mask).cuda()
    kernels.reset_launch_counts()
    for km in (None, mask):
        out = fa.mhsa_sep_fwd(q, k, v, km, heads)
        grads = fa.mhsa_sep_bwd(q, k, v, km, g, heads)
        ref = fa.exp_mhsa_reference(q, k, v, km, heads)
        refs = fa.exp_mhsa_bwd_reference(q, k, v, km, g, heads)
        torch.cuda.synchronize()
        assert out.shape == (n, t, heads * dv) and out.dtype == tdt
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **TOL[dtype])
        for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       **BWD_TOL[dtype], err_msg=name)
    assert (out[::3] == 0).all() and all((x[::3] == 0).all() for x in grads)
    assert kernels.launch_counts("mhsa_fwd") == {"mhsa": 1, "mhsa_masked": 1}
    assert kernels.launch_counts("mhsa_bwd") == {"mhsa_bwd": 1,
                                                 "mhsa_bwd_masked": 1}
    assert kernels.regime_counts("mhsa_bwd") == {
        _sep_regime(t, dk, dv, dtype): 2}
    assert kernels.regime_counts("mhsa_fwd") == {
        _sep_fwd_regime(t, dk, dv, dtype): 2}


def test_sep_fwd_launch_plan_matches_the_kernels():
    """sep_fwd_launch_plan's regime and shared bytes (ops/fused_attention.py)
    equal the C side's (mhsa_sep_fwd_regime, mhsa_sep_fwd_smem_bytes),
    which refuses a plan it does not take and a regime that is not the
    shape's; a refused launch raises in the wrapper and counts nothing."""
    for t, dk, dv in [(20, 20, 20), (20, 20, 32), (64, 20, 32), (65, 20, 32),
                      (300, 20, 32), (511, 20, 32), (50, 5, 12), (64, 64, 8),
                      (100, 24, 40), (100, 64, 64), (30, 70, 8),
                      (128, 20, 72), (900, 80, 8)]:
        for dtype in (torch.float32, torch.bfloat16):
            esize = 2 if dtype == torch.bfloat16 else 4
            plan = fa.sep_fwd_launch_plan(64, t, 20, dk, dv, dtype)
            assert fa.SEP_FWD_REGIMES.index(plan.regime) == (
                kernels.size_of("mhsa_sep", "mhsa_sep_fwd_regime", t, dk, dv,
                                esize))
            if plan.launch is not None:
                assert plan.launch.smem == kernels.size_of(
                    "mhsa_sep", "mhsa_sep_fwd_smem_bytes",
                    fa.SEP_FWD_REGIMES.index(plan.regime), t, dk, dv, esize,
                    *plan.args()), (t, dk, dv, dtype)
    size = lambda *a: kernels.size_of("mhsa_sep", "mhsa_sep_fwd_smem_bytes",
                                      *a)
    assert size(1, 300, 20, 32, 2, 96, 256, 1) == 0  # tile of 96
    assert size(1, 300, 20, 32, 2, 128, 256, 3) == 0  # three buffers
    assert size(2, 300, 20, 32, 4, 256, 128, 1) == 0  # two queries a thread
    assert size(2, 300, 20, 32, 4, 128, 64, 1) == 0  # chunk of 64
    assert size(1, 300, 20, 32, 4, 128, 128, 1) == 0  # not f32's regime
    assert size(0, 300, 20, 32, 2, 0, 0, 0) == 0
    q = torch.zeros((2, 300, 3 * 20), device="cuda", dtype=torch.bfloat16)
    v = torch.zeros((2, 300, 32), device="cuda", dtype=torch.bfloat16)
    good = fa.sep_fwd_launch_plan(2, 300, 1, 20, 32, torch.bfloat16)
    for bad in (good._replace(launch=good.launch._replace(tile=96)),
                good._replace(regime="tiled"),
                good._replace(launch=good.launch._replace(nbuf=3))):
        fa.reset_launch_counts()
        real = fa.sep_fwd_launch_plan
        fa.sep_fwd_launch_plan = lambda *a, **k: bad
        try:
            with pytest.raises(RuntimeError, match="launch failed"):
                fa.mhsa_sep_fwd(q[..., :20], q[..., 20:40], v, None, 1)
        finally:
            fa.sep_fwd_launch_plan = real
        assert not any(fa.launch_counts("mhsa_fwd").values())


@pytest.mark.parametrize("tile, chunk, nbuf", [
    (128, 256, 1), (128, 128, 2), (64, 64, 2), (64, 16, 1)])
def test_mhsa_sep_fwd_plans_agree(tile, chunk, nbuf):
    """Rows 5 and 7 on tensor cores under each form their plan takes
    (blockwise.mma_launch: tiles of 128 or 64 queries, chunks of 16 to 256
    keys, one or two buffers) against the plain version, on q, k, v cut
    from one projection at T = 300, d_k 20, d_v 32, bf16."""
    rng = np.random.default_rng(17)
    n, t, heads, dk, dv = 3, 300, 2, 20, 32
    qkv = torch.from_numpy(rng.normal(size=(n, t, heads * (2 * dk + dv)))
                           .astype(np.float32)).to(torch.bfloat16).cuda()
    q, k, v = torch.split(qkv, [heads * dk, heads * dk, heads * dv], -1)
    mask = torch.from_numpy((rng.random((n, t)) > 0.3).astype(np.float32))
    mask[1] = 0.0
    mask = mask.cuda()
    real = fa.sep_fwd_launch_plan
    base = real(n, t, heads, dk, dv, torch.bfloat16)
    plan = base._replace(launch=base.launch._replace(
        tile=tile, chunk=chunk, nbuf=nbuf, threads=2 * tile,
        grid=(n * heads, -(-t // tile)),
        smem=bw.smem_bytes("fwd", dv, 2, tile, chunk, nbuf)))
    fa.sep_fwd_launch_plan = lambda *a, **kw: plan
    try:
        for km in (None, mask):
            out = fa.mhsa_sep_fwd(q, k, v, km, heads)
            ref = fa.exp_mhsa_reference(q, k, v, km, heads)
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       ref.float().cpu().numpy(),
                                       **TOL["bfloat16"])
    finally:
        fa.sep_fwd_launch_plan = real
    assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [20, 300])
def test_mhsa_sep_fwd_far_below_gives_zero(dtype, t):
    """A row whose scores all lie below about -88.7 has den = inf (1e-8
    exp(-m) overflows) and a = 0, so its output is 0 as the plain version
    gives, unmasked and masked, in every regime of rows 5 and 7 (row-wise
    at T = 20; tensor cores and tiled at T = 300); the other rows match
    the plain version."""
    rng = np.random.default_rng(19)
    n, heads, dk, dv = 3, 2, 20, 32
    tdt = getattr(torch, dtype)
    qkv = rng.normal(size=(n, t, heads * (2 * dk + dv))).astype(np.float32)
    qkv[1, :, :heads * dk] = 5.0  # q . k / sqrt(20) = -500 / 4.47
    qkv[1, :, heads * dk:2 * heads * dk] = -5.0
    qkv = torch.from_numpy(qkv).to(tdt).cuda()
    q, k, v = torch.split(qkv, [heads * dk, heads * dk, heads * dv], -1)
    mask = torch.from_numpy(
        (rng.random((n, t)) > 0.3).astype(np.float32)).cuda()
    for km in (None, mask):
        fa.reset_launch_counts()
        out = fa.mhsa_sep_fwd(q, k, v, km, heads)
        ref = fa.exp_mhsa_reference(q, k, v, km, heads)
        assert torch.isfinite(out).all()
        assert (out[1] == 0).all() and (ref[1] == 0).all()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **TOL[dtype])
        assert kernels.regime_counts("mhsa_fwd") == {
            _sep_fwd_regime(t, dk, dv, dtype): 1}


def test_mhsa_sep_fwd_repeats_bit_for_bit():
    """20 calls of rows 5 and 7 in each regime give the same bits: no
    atomics, every sum in a fixed order."""
    for n, t, dtype in ((64, 20, torch.bfloat16), (8, 300, torch.bfloat16),
                        (8, 300, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(t)
        qkv = torch.randn((n, t, 20 * 72), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = torch.split(qkv, [400, 400, 640], -1)
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        for km in (None, mask):
            first = fa.mhsa_sep_fwd(q, k, v, km, 20)
            for _ in range(20):
                assert torch.equal(fa.mhsa_sep_fwd(q, k, v, km, 20), first)


def test_sep_bwd_launch_plan_matches_the_kernels():
    """sep_bwd_launch_plan's regime and shared bytes (ops/fused_attention.py)
    equal the C side's (mhsa_sep_bwd_regime, mhsa_sep_bwd_smem_bytes), which
    refuses a plan it does not take; a refused plan raises in the wrapper
    and counts nothing."""
    for t, dk, dv in [(20, 20, 20), (20, 20, 32), (64, 20, 32), (65, 20, 32),
                      (300, 20, 32), (511, 20, 32), (50, 5, 12), (64, 64, 8),
                      (100, 24, 40), (30, 70, 8), (128, 20, 72)]:
        for dtype in (torch.float32, torch.bfloat16):
            esize = 2 if dtype == torch.bfloat16 else 4
            plan = fa.sep_bwd_launch_plan(64, t, 20, dk, dv, dtype)
            assert fa.SEP_REGIMES.index(plan.regime) == kernels.size_of(
                "mhsa_sep", "mhsa_sep_bwd_regime", t, dk, dv, esize)
            if plan.regime == "resident":
                r = plan.resident
                assert r.smem == kernels.size_of(
                    "mhsa_sep", "mhsa_sep_bwd_smem_bytes", 0, t, dk, dv,
                    esize, r.heads, 0, r.nbuf), (t, dk, dv, dtype)
            if plan.regime == "mma":
                for side, kind in ((plan.query, 2), (plan.key, 1)):
                    assert side.smem == kernels.size_of(
                        "mhsa_sep", "mhsa_sep_bwd_smem_bytes", kind, t, dk,
                        dv, esize, side.tile, side.chunk, side.nbuf)
    assert kernels.size_of("mhsa_sep", "mhsa_sep_bwd_smem_bytes", 2, 300, 20,
                           32, 2, 96, 256, 1) == 0
    assert kernels.size_of("mhsa_sep", "mhsa_sep_bwd_smem_bytes", 0, 20, 20,
                           32, 2, 5, 0, 1) == 0
    q = torch.zeros((2, 300, 3 * 20), device="cuda", dtype=torch.bfloat16)
    g = torch.zeros((2, 300, 32), device="cuda", dtype=torch.bfloat16)
    v = torch.zeros((2, 300, 32), device="cuda", dtype=torch.bfloat16)
    good = fa.sep_bwd_launch_plan(2, 300, 1, 20, 32, torch.bfloat16)
    bad = good._replace(query=good.query._replace(tile=96))
    fa.reset_launch_counts()
    real = fa.sep_bwd_launch_plan
    fa.sep_bwd_launch_plan = lambda *a, **k: bad
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.mhsa_sep_bwd(q[..., :20], q[..., 20:40], v, None, g, 1)
    finally:
        fa.sep_bwd_launch_plan = real
    assert not any(fa.launch_counts("mhsa_bwd").values())


def test_mhsa_sep_bwd_repeats_bit_for_bit():
    """20 calls of rows 6 and 8 in each regime give the same bits: no
    atomics, every sum in a fixed order."""
    for n, t, dtype in ((64, 20, torch.bfloat16), (8, 300, torch.bfloat16),
                        (8, 100, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(t)
        qkv = torch.randn((n, t, 20 * 72), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = torch.split(qkv, [400, 400, 640], -1)
        g = torch.randn((n, t, 640), generator=gen, device="cuda").to(dtype)
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        for km in (None, mask):
            first = fa.mhsa_sep_bwd(q, k, v, km, g, 20)
            for _ in range(20):
                again = fa.mhsa_sep_bwd(q, k, v, km, g, 20)
                assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("masked", [False, True])
def test_unequal_widths_launch_rows_5_8(masked):
    """multi_head_self_attention at d_v = 6 != d_k = 4 on the card launches
    rows 5-8 only and agrees with the CPU's plain route."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(4)
    heads, t = 3, 12
    width = {"wq": heads * 4, "wk": heads * 4, "wv": heads * 6}
    params = {k: {"w": torch.from_numpy(rng.normal(scale=0.4, size=(
                      10, w)).astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(scale=0.1, size=(
                      w,)).astype(np.float32))}
              for k, w in width.items()}
    x = torch.from_numpy(rng.normal(size=(9, t, 10)).astype(np.float32))
    mask = torch.ones((9, t))
    mask[0, 4:] = 0.0
    g = torch.from_numpy(rng.normal(size=(9, t, heads * 6)).astype(
        np.float32))
    results = {}
    for dev in ("cuda", "cpu"):
        p = {k: {n: w.to(dev).requires_grad_() for n, w in v.items()}
             for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        kernels.reset_launch_counts()
        out = attention.multi_head_self_attention(
            p, xx, mask.to(dev) if masked else None, n_heads=heads)
        out.backward(g.to(dev))
        launches = {k: kernels.launch_counts(k) for k in kernels.KERNELS}
        results[dev] = (out.detach().cpu(), xx.grad.cpu(),
                        p["wv"]["w"].grad.cpu(), launches)
    variant = "_masked" if masked else ""
    launches = results["cuda"][3]
    assert launches["mhsa_fwd"]["mhsa" + variant] == 1
    assert launches["mhsa_bwd"]["mhsa_bwd" + variant] == 1
    others = {k: v for k, v in launches.items() if not k.startswith("mhsa")}
    assert not any(any(v.values()) for v in others.values()), others
    assert results["cuda"][0].shape == (9, t, heads * 6)
    for i, tol in ((0, TOL["float32"]), (1, BWD_TOL["float32"]),
                   (2, BWD_TOL["float32"])):
        np.testing.assert_allclose(results["cuda"][i].numpy(),
                                   results["cpu"][i].numpy(), **tol)


def test_mhsa_sep_raises_on_what_it_does_not_take():
    q = torch.zeros((4, 6, 8), device="cuda")
    with pytest.raises(TypeError, match="dtypes"):
        fa.mhsa_sep_fwd(q, q, q.bfloat16(), None, 2)
    with pytest.raises(ValueError, match="stride"):
        fa.mhsa_sep_fwd(q, q.transpose(0, 1).contiguous().transpose(0, 1), q,
                        None, 2)
    with pytest.raises(ValueError, match="g must be"):
        fa.mhsa_sep_bwd(q, q, q, None, torch.zeros((4, 6, 6), device="cuda"),
                        2)


# ---- rows 3-4 past the resident kernel, and every shape the JAX route runs --


def _grad(n, t, width, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, t, width), generator=gen,
                       device="cuda").to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t", [(64, 511), (128, 300), (2, 1000)])
def test_rows_3_4_take_long_histories(dtype, masked, n, t):
    """Rows 3 and 4 at the long-history shapes (bf16 on tensor cores, f32
    on the tiled kernel, in global slots at T = 1000) against their plain
    versions, with fully masked rows (every third) giving 0."""
    qkv, bias, mask = _inputs(n, t, 20, 20, dtype, seed=21)
    km = mask if masked else None
    g = _grad(n, t, 400, dtype, 22)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, km, 20)
    fa.reset_launch_counts()
    row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, 20)
    row4 = fa.qkv_bwd(qkv, bias, km, g, 20)
    ref = fa.qkv_bwd_probs_reference(qkv, bias, probs, g, 20)
    torch.cuda.synchronize()
    for got in (row3, row4):
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
    if masked:
        assert (row3[::3] == 0).all() and (row4[::3] == 0).all()
    assert fa.launch_counts("qkv_bwd_probs") == {"bwd_probs": 1}
    assert sum(fa.launch_counts("qkv_bwd").values()) == 1


def test_rows_2_3_take_t_1000_with_flash_min_seq_raised():
    """With flash_min_seq raised past T, a 1000-news history under grad
    takes rows 2-3 (no flash launch) and agrees with the CPU's route."""
    from newsrecommendation_tpu_torch.ops import attention

    rng = np.random.default_rng(5)
    params = {k: {"w": torch.from_numpy(rng.normal(scale=0.2, size=(
                      64, 80)).astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(scale=0.1, size=(
                      80,)).astype(np.float32))}
              for k in ("wq", "wk", "wv")}
    x = torch.from_numpy(rng.normal(size=(2, 1000, 64)).astype(np.float32))
    mask = torch.from_numpy((rng.random((2, 1000)) > 0.3).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 1000, 80)).astype(np.float32))
    results = {}
    kernel_config.set_flash_min_seq(2048)
    try:
        for dev in ("cuda", "cpu"):
            p = {k: {n: w.detach().to(dev).requires_grad_()
                     for n, w in v.items()} for k, v in params.items()}
            xx = x.detach().to(dev).requires_grad_()
            kernels.reset_launch_counts()
            out = attention.multi_head_self_attention(p, xx, mask.to(dev),
                                                      n_heads=4)
            out.backward(g.to(dev))
            results[dev] = (out.detach().cpu(), xx.grad.cpu(),
                            {k: kernels.launch_counts(k)
                             for k in ("qkv_fwd_probs", "qkv_bwd_probs",
                                       "flash_fwd")})
    finally:
        kernel_config.set_flash_min_seq(512)
    launches = results["cuda"][2]
    assert launches["qkv_fwd_probs"]["bias_masked_probs"] == 1
    assert launches["qkv_bwd_probs"]["bwd_probs"] == 1
    assert not any(launches["flash_fwd"].values())
    np.testing.assert_allclose(results["cuda"][0].numpy(),
                               results["cpu"][0].numpy(), **TOL["float32"])
    np.testing.assert_allclose(results["cuda"][1].numpy(),
                               results["cpu"][1].numpy(),
                               **BWD_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [300, 400])
def test_rows_1_4_at_d50(dtype, masked, t):
    """8 heads of 50 (examples/demo.sh): rows 1-4 at T = 300 and 400,
    which the kernels once refused for shared memory (rows 1-2 past 370,
    rows 3-4 past 267), against their plain versions."""
    qkv, bias, mask = _inputs(4, t, 8, 50, dtype, seed=23)
    km = mask if masked else None
    g = _grad(4, t, 400, dtype, 24)
    with torch.inference_mode():
        row1 = (fa.exp_mhsa_qkv_bias_masked(qkv, bias, km, 8) if masked
                else fa.exp_mhsa_qkv_bias(qkv, bias, 8))
    ctx, probs = fa.qkv_fwd_probs(qkv, bias, km, 8)
    ref_ctx, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, km,
                                                              8)
    row3 = fa.qkv_bwd_probs(qkv, bias, ref_probs, g, 8)
    row4 = fa.qkv_bwd(qkv, bias, km, g, 8)
    ref = fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g, 8)
    torch.cuda.synchronize()
    assert torch.equal(ctx, row1)
    np.testing.assert_allclose(ctx.float().cpu().numpy(),
                               ref_ctx.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(probs.cpu().numpy(), ref_probs.cpu().numpy(),
                               **TOL["float32"])
    for got in (row3, row4):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, heads, d", [(2, 5, 80), (2, 1, 400),
                                         (2, 1, 1100)])
def test_flash_takes_wide_heads(dtype, masked, n, heads, d):
    """news_dim 400 with 5 heads (D = 80) and 1 head (D = 400) at L = 512,
    and a head of 1100 (two slices): rows 9-10 on the wide kernels against
    their plain versions."""
    q, k, v, mask = _flash_inputs(n, 512, heads, d, dtype, seed=25,
                                  fused=True)
    km = mask if masked else None
    g = _grad(n, 512, heads * d, dtype, 26)
    o, m, den = bw.flash_fwd(q, k, v, km, heads)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, km, heads)
    delta = bw.delta_of(g, ro, heads)
    grads = bw.flash_bwd(q, k, v, km, g, rm, rden, delta, heads)
    refs = bw.flash_bwd_reference(q, k, v, km, g, rm, rden, delta, heads)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               ro.float().cpu().numpy(), **TOL[dtype])
    for got, want in ((m, rm), (den, rden)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL["float32"])
    for got, want in zip(grads, refs):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
    if masked:
        assert (o[::3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [(2, 400, 2, 64), (2, 512, 5, 80),
                                            (2, 1300, 2, 20)])
def test_blanes_takes_every_shape(dtype, masked, n, t, heads, d):
    """Rows 15-16 past their own layouts (f32 D = 64 past T = 318, heads
    past 64, bf16 D = 20 past 1,232) take the fused-qkv kernels' templates
    through the same entry points and agree with their plain versions."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    qkv, _, mask = _inputs(n, t, heads, d, dtype, seed=27)
    km = mask if masked else None
    g = _grad(n, t, heads * d, dtype, 28)
    kernels.reset_launch_counts()
    out = bl.blanes_fwd(qkv, km, heads)
    dqkv = bl.blanes_bwd(qkv, km, g, heads)
    ref = bl.blanes_fwd_reference(qkv, km, heads)
    ref_d = bl.blanes_bwd_reference(qkv, km, g, heads)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(dqkv.float().cpu().numpy(),
                               ref_d.float().cpu().numpy(), **BWD_TOL[dtype])
    variant = "_masked" if masked else ""
    assert kernels.launch_counts("blanes_fwd")["blanes" + variant] == 1
    assert kernels.launch_counts("blanes_bwd")["blanes_bwd" + variant] == 1


def _tail_f64(qkv, mask, w1, b1, w2, b2, g, heads):
    """Row 13's output and row 14's pooling gradients (dw1, db1, dw2, db2)
    in float64 from the same inputs, dropout off: the exp-normalised
    attention per head, then the pooling through autograd (its max
    detached: it carries no gradient in the kernels either)."""
    x = qkv.double()
    n, t, w3 = x.shape
    hd = w3 // 3
    d = hd // heads
    ctx = torch.empty((n, t, hd), dtype=torch.float64, device=x.device)
    for h in range(heads):
        q, k, v = (x[..., i * hd + h * d:i * hd + (h + 1) * d]
                   for i in range(3))
        s = torch.einsum("nid,njd->nij", q, k) / d ** 0.5
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m) * mask[:, None, :].double()
        a = e / (e.sum(-1, keepdim=True) + 1e-8 * torch.exp(-m))
        ctx[..., h * d:(h + 1) * d] = torch.einsum("nij,njd->nid", a, v)
    w1, b1, w2, b2 = (p.double().requires_grad_() for p in (w1, b1, w2, b2))
    score = (torch.tanh(ctx @ w1 + b1[0]) @ w2)[..., 0] + b2[0, 0]
    m = score.amax(-1, keepdim=True).detach()
    num = torch.exp(score - m) * mask.double()
    alpha = num / (num.sum(-1, keepdim=True) + 1e-8 * torch.exp(-m))
    out = torch.einsum("nt,ntc->nc", alpha, ctx)
    return out, torch.autograd.grad((out * g.double()).sum(),
                                    (w1, b1, w2, b2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t, heads", [(5000, 20), (7000, 4)])
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_tail_takes_t_5000_and_7000(dtype, t, heads, scaled):
    """Rows 13-14 at T = 5000 (past the 4470 row 4's tiled kernel once
    held) and at T = 7000 (past the rows the tail kept in shared memory,
    6456 forward and 5771 backward; 4 heads keep the plain version small),
    both past the tiled regime, so in the global one:
    row 14's attention part on tensor cores in bf16, in global slots in
    f32; masked, dropout off; the pooled output, dqkv and the pooling
    gradients against the plain versions. Averaged over thousands of
    positions the pooled output is a few hundredths, where bf16's atol
    cannot tell a kernel 6% off; ``scaled`` multiplies v by sqrt(T / 20),
    so the output grows about as much and the comparison must reject the
    plain output scaled by 1 + 2^-4. In f32 the pooling gradients, sums over 2T positions,
    are held against a float64 reference, within the larger of the usual
    share of the largest gradient and four times the f32 plain version's
    own distance from it: at T = 5000 that distance on db1 passes the
    usual share, and the kernel's is as large."""
    qkv, mask, pool, g = _tail_inputs(2, t, heads, 20, 200, dtype, seed=12)
    if scaled:
        hd = heads * 20
        x = qkv.float()
        x[..., 2 * hd:] *= (t / 20) ** 0.5
        qkv = x.to(qkv.dtype)
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    args = (qkv, mask, *pool, seed, heads, 0.0, True)
    kernels.reset_launch_counts()
    out = fe.fused_tail_fwd(*args)
    grads = fe.fused_tail_bwd(*args[:7], g, *args[7:])
    ref = fe.fused_tail_fwd_reference(*args)
    refs = fe.fused_tail_bwd_reference(*args[:7], g, *args[7:])
    torch.cuda.synchronize()
    got, want = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if scaled:
        assert not np.allclose(got, want * (1 + 2 ** -4), **TOL[dtype])
    np.testing.assert_allclose(grads[0].float().cpu().numpy(),
                               refs[0].float().cpu().numpy(),
                               **BWD_TOL[dtype])
    tol = _summed_tol(refs[1:], dtype)
    if dtype == "bfloat16":
        wants = refs[1:]
    else:
        wants = [w.reshape(r.shape) for w, r in zip(
            _tail_f64(qkv, mask, *pool, g, heads)[1], refs[1:])]
        spread = max((r.double() - w).abs().max().item()
                     for r, w in zip(refs[1:], wants))
        tol["atol"] = max(tol["atol"], 4 * spread)
    for got, want in zip(grads[1:], wants):
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   want.double().cpu().numpy(), **tol)
    # past the T (1024 at 20 wide heads) whose K, V and probs fit a tiled
    # block, the per-row kernel with its rows in global memory
    assert kernels.regime_counts("fused_tail_fwd") == {"global": 1}
    assert kernels.regime_counts("fused_tail_bwd") == {"global": 1}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t", [(64, 511), (128, 300), (2, 1000), (64, 150),
                                  (128, 50)])
def test_row_4_recomputes_row_2s_probs(masked, n, t):
    """Row 4's recomputed a against the f32 probs row 2 wrote, read
    directly: g is 1 at one query per column d of each head's g and 0
    elsewhere, so dv[j, h, d] is round(a[q_d, j]) alone (one product in
    an f32 sum). Row 3 gives round(probs) there exactly; row 4 gives it
    exactly where both kernels take one order of sums (T = 50: row 2 and
    row 4 resident), else within one bf16 ulp, and in at most 1e-4 of the
    elements: past T = 64 row 2 sums s on tensor cores and den online,
    another order than row 4's on its resident kernel (T = 150) and on
    its tensor cores (past it)."""
    heads, d = 20, 20
    qkv, bias, mask = _inputs(n, t, heads, d, "bfloat16", seed=21)
    km = mask if masked else None
    queries = [i * t // d + i % 3 for i in range(d)]
    g = torch.zeros((n, t, heads, d), device="cuda")
    for i, qi in enumerate(queries):
        g[:, qi, :, i] = 1.0
    g = g.reshape(n, t, heads * d).bfloat16()
    _, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
    row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
    row4 = fa.qkv_bwd(qkv, bias, km, g, heads)
    torch.cuda.synchronize()
    hd = heads * d
    dv3 = row3[..., 2 * hd:].reshape(n, t, heads, d)
    dv4 = row4[..., 2 * hd:].reshape(n, t, heads, d)
    a = probs.reshape(n, t, heads, t)  # a[n, q, h, key]
    want = torch.stack([a[:, qi] for qi in queries], -1)  # (n, h, key, d)
    assert torch.equal(dv3, want.permute(0, 2, 1, 3).bfloat16())
    ulps = (dv3.view(torch.int16).int() - dv4.view(torch.int16).int()).abs()
    if (fa.fwd_launch_plan(n, t, heads, d, torch.bfloat16).regime
            == "resident" and fa.bwd_launch_plan(
                n, t, heads, d, torch.bfloat16).regime != "mma"):
        assert torch.equal(dv3, dv4)
    else:
        assert ulps.max().item() <= 1
        assert (ulps > 0).sum().item() <= 1e-4 * ulps.numel()


def test_rows_3_4_repeat_bit_for_bit():
    """50 calls of rows 3 and 4 on tensor cores give the same bits: no
    atomics, every sum in a fixed order."""
    qkv, bias, mask = _inputs(64, 511, 20, 20, "bfloat16", seed=29)
    g = _grad(64, 511, 400, "bfloat16", 30)
    _, probs = fa.qkv_fwd_probs(qkv, bias, mask, 20)
    first3 = fa.qkv_bwd_probs(qkv, bias, probs, g, 20)
    first4 = fa.qkv_bwd(qkv, bias, mask, g, 20)
    for _ in range(50):
        assert torch.equal(fa.qkv_bwd_probs(qkv, bias, probs, g, 20), first3)
        assert torch.equal(fa.qkv_bwd(qkv, bias, mask, g, 20), first4)


def test_bwd_launch_plan_matches_the_kernels():
    """bwd_launch_plan's regime and tensor-core shared bytes (rows 3's and
    4's) equal the C side's (qkv_bwd_regime, qkv_bwd_mma_smem_bytes),
    which refuses a plan it does not take; a refused plan raises in the
    wrapper and counts nothing."""
    for t, d in [(20, 20), (201, 20), (202, 20), (511, 20), (599, 20),
                 (600, 20), (300, 50), (400, 50), (212, 64), (300, 80),
                 (40, 400)]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = fa.bwd_launch_plan(8, t, 4, d, dtype)
            esize = 2 if dtype == torch.bfloat16 else 4
            assert fa.REGIMES.index(plan.regime) == kernels.size_of(
                "qkv_bwd", "qkv_bwd_regime", t, d, esize), (t, d, dtype)
            if plan.regime == "mma":
                probs = fa.bwd_launch_plan(8, t, 4, d, dtype, probs=True)
                for side, kind in ((plan.query, 2), (plan.key, 1),
                                   (probs.query, 4), (probs.key, 3)):
                    assert side.smem == kernels.size_of(
                        "qkv_bwd", "qkv_bwd_mma_smem_bytes", kind, d,
                        side.tile, side.chunk, side.nbuf)
    assert kernels.size_of("qkv_bwd", "qkv_bwd_mma_smem_bytes", 2, 20, 96,
                           256, 1) == 0
    qkv, bias, mask = _inputs(2, 300, 20, 20, "bfloat16")
    g = _grad(2, 300, 400, "bfloat16", 31)
    good = fa.bwd_launch_plan(2, 300, 20, 20, torch.bfloat16)
    bad = good._replace(query=good.query._replace(tile=96))
    fa.reset_launch_counts()
    real = fa.bwd_launch_plan
    fa.bwd_launch_plan = lambda *a, **k: bad
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.qkv_bwd(qkv, bias, mask, g, 20)
    finally:
        fa.bwd_launch_plan = real
    assert not any(fa.launch_counts("qkv_bwd").values())


# ---- rows 3-4's resident regime: the short kernel ---------------------------

# Rows 3, 4 and 12 before the short kernel (the first design's resident
# kernel), on an H100, at 20 heads of 20 on scripts/qkv_bwd_ab.py's inputs
# (_ab_inputs, seed 5): the hash of dqkv, by (dtype, N, T, masked). Row 3
# reads the probs row 2 writes on the same inputs, so rows 3, 4 (and 12,
# unmasked only) give the same bits.
QKV_BWD_PINNED = {
    ("bfloat16", 7040, 20, False): "0e0347ea1c129878",
    ("bfloat16", 7040, 20, True): "165f8deda9c46b6e",
    ("float32", 7040, 20, False): "0fb5c351d9b8de6e",
    ("float32", 7040, 20, True): "67b6602529ca21b4",
    ("bfloat16", 128, 50, False): "47a0aab28749665a",
    ("bfloat16", 128, 50, True): "b9d4d35794ed9faa",
    ("float32", 128, 50, False): "5294e39fd3c8f542",
    ("float32", 128, 50, True): "5f821d6175671c0d",
}


def _ab_inputs(n, t, dtype, masked, seed=5):
    """scripts/qkv_bwd_ab.py's inputs: qkv, bias, g and the key mask (or
    None), 20 heads of 20, from a CUDA generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    qkv = torch.randn((n, t, 1200), generator=gen, device="cuda").to(tdt)
    bias = (0.5 * torch.randn((1200,), generator=gen, device="cuda")).to(tdt)
    g = torch.randn((n, t, 400), generator=gen, device="cuda").to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    return qkv, bias, g, mask


@pytest.mark.parametrize("key", list(QKV_BWD_PINNED))
def test_rows_3_4_12_keep_their_pinned_bits(key):
    """Rows 3, 4 and 12 on the short kernel give the first design's bits
    in both dtypes: every sum in its order, every rounding in its place.
    Each launch in the resident regime."""
    dtype, n, t, masked = key
    qkv, bias, g, mask = _ab_inputs(n, t, dtype, masked)
    _, probs = fa.qkv_fwd_probs(qkv, bias, mask, 20)
    fa.reset_launch_counts()
    got = {"row3": _hash(fa.qkv_bwd_probs(qkv, bias, probs, g, 20)),
           "row4": _hash(fa.qkv_bwd(qkv, bias, mask, g, 20))}
    if not masked:
        got["row12"] = _hash(q2.qkv2d_bwd(qkv.view(n * t, -1), bias, probs,
                                          g, 20, t))
    assert got == {k: QKV_BWD_PINNED[key] for k in got}
    for k in ("qkv_bwd_probs", "qkv_bwd", "qkv2d_bwd"):
        assert set(fa.regime_counts(k)) <= {"resident"}
    assert fa.bwd_launch_plan(n, t, 20, 20, getattr(torch, dtype),
                              probs=True).resident.threads == fa.RES_THREADS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", [
    (9, 64, 4, 20), (9, 65, 4, 20), (11, 20, 3, 32), (11, 20, 3, 33),
    (3, 201, 2, 20), (3, 202, 2, 20), (6, 33, 2, 32), (6, 64, 2, 33)])
def test_rows_3_4_both_sides_of_the_resident_edges(dtype, n, t, heads, d):
    """Both sides of each edge of the resident regime (the short kernel to
    T = 64 and heads of 32, the first design's to T = 201 at D = 20, past
    it tensor cores or the tiled kernel) against the plain versions, both
    masks, each launch in its plan's regime; row 4 equal to row 3 fed row
    2's probs wherever both keep one order (row 2 resident, row 4 not on
    tensor cores)."""
    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=41)
    g = _grad(n, t, heads * d, dtype, 42)
    tdt = getattr(torch, dtype)
    for km in (None, mask):
        _, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
        fa.reset_launch_counts()
        row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
        row4 = fa.qkv_bwd(qkv, bias, km, g, heads)
        ref = fa.qkv_bwd_probs_reference(qkv, bias, probs, g, heads)
        torch.cuda.synchronize()
        for got in (row3, row4):
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       ref.float().cpu().numpy(),
                                       **BWD_TOL[dtype])
        for k, probs_plan in (("qkv_bwd_probs", True), ("qkv_bwd", False)):
            want = fa.bwd_launch_plan(n, t, heads, d, tdt,
                                      probs=probs_plan).regime
            assert fa.regime_counts(k) == {want: 1}
        if (fa.fwd_launch_plan(n, t, heads, d, tdt).regime == "resident"
                and fa.bwd_launch_plan(n, t, heads, d, tdt).regime
                != "mma"):
            assert torch.equal(row3, row4)
        if km is not None:
            assert (row4[::3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", [
    (9, 20, 5, 8), (9, 20, 3, 20), (6, 20, 3, 33), (4, 20, 2, 64),
    (7, 13, 3, 5), (5, 17, 7, 7), (3, 31, 1, 3), (4, 50, 5, 9)])
def test_rows_3_4_at_every_head_width_and_odd_strides(dtype, n, t, heads, d):
    """Rows 3 and 4 at heads of 8, 20, 33 and 64 lanes and at odd widths
    (bf16 rows of an odd count of elements: element copies, no 8-byte
    loads, the pads zero), against the plain versions; row 4 equal to row
    3 there (both resident)."""
    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=43)
    g = _grad(n, t, heads * d, dtype, 44)
    for km in (None, mask):
        _, probs = fa.qkv_fwd_probs(qkv, bias, km, heads)
        row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
        row4 = fa.qkv_bwd(qkv, bias, km, g, heads)
        ref = fa.qkv_bwd_probs_reference(qkv, bias, probs, g, heads)
        torch.cuda.synchronize()
        np.testing.assert_allclose(row3.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **BWD_TOL[dtype])
        assert torch.equal(row3, row4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t, d", [(20, 20), (50, 20), (90, 20), (20, 80)])
def test_resident_regime_takes_a_null_bias(dtype, t, d):
    """A null bias (qkv carrying it, rows 14 and 16 past their own
    kernels) gives row 4's dqkv on the biased qkv bit for bit, on the
    short kernel and on the first design's; other regimes refuse it."""
    n, heads = 6, 3
    qkv, bias, mask = _inputs(n, t, heads, d, dtype, seed=45)
    g = _grad(n, t, heads * d, dtype, 46)
    biased = qkv + bias
    want = fa.qkv_bwd(biased, torch.zeros_like(bias), mask, g, heads)
    got = torch.empty_like(qkv)
    fa._bwd_call("bwd_masked", "qkv_bwd", "qkv_bwd", biased, None, mask, g,
                 got, n, t, heads, d)
    assert torch.equal(got, want)
    plan = fa.bwd_launch_plan(2, 300, 1, 20, torch.bfloat16)
    x = torch.zeros((2, 300, 60), device="cuda", dtype=torch.bfloat16)
    fn = kernels.entry("qkv_bwd", "qkv_bwd", torch.bfloat16)
    stats = torch.empty((3, 2, 300), device="cuda")
    err = fn(x.data_ptr(), None, None, x.data_ptr(), x.data_ptr(),
             x.data_ptr(), stats.data_ptr(), None, 2, 300, 1, 20,
             *plan.args(), 0, torch.cuda.current_stream().cuda_stream)
    assert plan.regime == "mma" and err != 0


def test_resident_plan_matches_the_kernels():
    """The short kernel's shared bytes in Python (resident_smem) equal the C
    side's (qkv_bwd_resident_smem_bytes), which is 0 past the short
    shapes; a plan the C side does not take (shared bytes, heads, buffers
    or threads not its own; the first design's plan not one block of 128
    threads per (row, head)) raises in the wrapper and counts nothing."""
    for t in (1, 5, 20, 33, 50, 64, 65):
        for d in (1, 4, 5, 8, 17, 20, 24, 32, 33):
            for esize in (2, 4):
                for heads in (1, 2, 3, 4):
                    for nbuf in (1, 2):
                        for probs in (False, True):
                            c = kernels.size_of(
                                "qkv_bwd", "qkv_bwd_resident_smem_bytes", t,
                                d, esize, heads, nbuf, int(probs))
                            assert c == (fa.resident_smem(
                                t, d, esize, heads, nbuf, probs)
                                if fa.short_resident(t, d) else 0)
    qkv, bias, mask = _inputs(4, 20, 20, 20, "float32")
    g = _grad(4, 20, 400, "float32", 47)
    good = fa.bwd_launch_plan(4, 20, 20, 20, torch.float32)
    first = fa.bwd_launch_plan(4, 90, 20, 20, torch.float32)
    q90, b90, m90 = _inputs(4, 90, 20, 20, "float32")
    g90 = _grad(4, 90, 400, "float32", 48)
    r, f = good.resident, first.resident
    bad = [(good, r._replace(smem=r.smem + 16), qkv, bias, mask, g),
           (good, r._replace(heads=0), qkv, bias, mask, g),
           (good, r._replace(heads=9), qkv, bias, mask, g),
           (good, r._replace(nbuf=3), qkv, bias, mask, g),
           (good, r._replace(threads=128), qkv, bias, mask, g),
           (first, f._replace(heads=2), q90, b90, m90, g90),
           (first, f._replace(blocks=f.blocks - 1), q90, b90, m90, g90),
           (first, f._replace(threads=256), q90, b90, m90, g90)]
    real = fa.bwd_launch_plan
    for plan, res, x, b, m, gg in bad:
        fa.reset_launch_counts()
        fa.bwd_launch_plan = lambda *a, _p=plan._replace(resident=res), **k: _p
        try:
            with pytest.raises(RuntimeError, match="launch failed"):
                fa.qkv_bwd(x, b, m, gg, 20)
        finally:
            fa.bwd_launch_plan = real
        assert not any(fa.launch_counts("qkv_bwd").values())


# ---- the command-line path on the card: checkpoints, eval, /reload -------

def _cli_setup(tmp_path, **overrides):
    """A synthetic train/dev corpus at small widths, its config and table,
    and params made on the CPU from a seed."""
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        random_word_embeddings,
        read_news,
    )
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.models import nrms

    for name, seed, n in (("train", 1, 200), ("dev", 2, 80)):
        generate_corpus(str(tmp_path / name), num_news=120, num_users=30,
                        num_impressions=n, title_len=8, seed=seed)
    cfg = Config(num_words_title=8, user_log_length=10,
                 word_embedding_dim=32, news_dim=40, num_attention_heads=4,
                 news_query_vector_dim=16, user_query_vector_dim=16,
                 filter_num=0, batch_size=16, drop_rate=0.2, lr=3e-3,
                 user_log_mask=True, max_candidates=32, eval_batch_size=16,
                 train_data_dir=str(tmp_path / "train"),
                 test_data_dir=str(tmp_path / "dev"),
                 model_dir=str(tmp_path / "model"), serve_port=0,
                 serve_max_batch=8, serve_max_delay_ms=2.0,
                 load_ckpt_name="latest").replace(**overrides)
    corpus = read_news(str(tmp_path / "train" / "news.tsv"), cfg)
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    return cfg, corpus, table, nrms


def _trained_state(cfg, table, nrms, device, steps=3):
    from newsrecommendation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    state = create_train_state(cfg, nrms.init(cfg, table, seed=0,
                                              device=device))
    rng = np.random.default_rng(0)
    b, L, k, t = (cfg.batch_size, cfg.user_log_length, cfg.npratio,
                  cfg.num_words_title)
    step = make_train_step(cfg, nrms_model())
    for _ in range(steps):
        batch = {
            "history": rng.integers(0, table.shape[0], (b, L, t)),
            "history_mask": (rng.random((b, L)) > 0.3).astype(np.float32),
            "candidate": rng.integers(0, table.shape[0], (b, 1 + k, t)),
            "label": rng.integers(0, k + 1, (b,)),
            "weight": np.ones(b, np.float32)}
        batch = {key: torch.from_numpy(v).to(device)
                 for key, v in batch.items()}
        batch["label"] = batch["label"].int()
        for key in ("history", "candidate"):
            batch[key] = batch[key].int()
        state, _ = step(state, batch, 0)
    return state


def nrms_model():
    from newsrecommendation_tpu_torch.models import get_model

    return get_model("NRMS")


@pytest.mark.parametrize("freeze", [True, False])
def test_checkpoint_roundtrip_on_cuda(tmp_path, freeze):
    """A state trained on the card, saved and loaded into a fresh state on
    the card: every param and Adam moment bit-equal, on the card, and
    the step restored."""
    from newsrecommendation_tpu_torch.ckpt import (
        load_checkpoint,
        save_checkpoint,
    )
    from newsrecommendation_tpu_torch.train import create_train_state

    cfg, _, table, nrms = _cli_setup(tmp_path, freeze_embedding=freeze,
                                     compute_dtype="bfloat16")
    state = _trained_state(cfg, table, nrms, "cuda")
    torch.cuda.synchronize()
    path = save_checkpoint(cfg.model_dir, "epoch-1.ckpt", state, cfg)
    fresh = create_train_state(cfg, nrms.init(cfg, table, seed=5,
                                              device="cuda"))
    restored, _ = load_checkpoint(path, fresh, cfg)
    assert restored.step == state.step == 3

    def walk(a, b):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key])
            return
        assert a.is_cuda and b.is_cuda and torch.equal(a, b)
        sa, sb = (restored.optimizer.state.get(a),
                  state.optimizer.state.get(b))
        assert bool(sa) == bool(sb)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if sa:
                assert torch.equal(sa[key].cpu(), sb[key].cpu()), key
        if sa:
            assert sa["exp_avg"].is_cuda

    walk(restored.params, state.params)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_evaluate_impressions_on_card_matches_cpu(tmp_path, user_log_mask):
    """Phase 1 and 2 on the card (row 1 launching) against the same params
    on the CPU (plain versions): the same valid count, metrics within
    1e-4."""
    import os

    from newsrecommendation_tpu_torch.data import build_news_features
    from newsrecommendation_tpu_torch.data.loader import EvalSamples
    from newsrecommendation_tpu_torch.data.prepare import (
        prepare_testing_data,
    )
    from newsrecommendation_tpu_torch.eval import (
        compute_news_scoring,
        evaluate_impressions,
    )
    from newsrecommendation_tpu_torch.utils import to_device

    cfg, corpus, table, nrms = _cli_setup(tmp_path,
                                          user_log_mask=user_log_mask)
    state = _trained_state(cfg, table, nrms, "cpu")
    prepare_testing_data(cfg.test_data_dir, 1)
    from newsrecommendation_tpu_torch.data import read_news
    dev = read_news(os.path.join(cfg.test_data_dir, "news.tsv"), cfg,
                    "test", word_dict=corpus.word_dict)
    es = EvalSamples.from_file(os.path.join(cfg.test_data_dir,
                                            "behaviors_0.tsv"),
                               dev.news_index, cfg,
                               max_candidates=cfg.max_candidates)
    feats = build_news_features(dev, cfg)
    out = {}
    for device in ("cuda", "cpu"):
        params = to_device(state.params, device)
        fa.reset_launch_counts()
        scoring = compute_news_scoring(nrms_model(), params, cfg, feats)
        out[device] = evaluate_impressions(nrms_model(), params, cfg, es,
                                           scoring)
        if device == "cuda":
            launches = fa.launch_counts("qkv_fwd")
            assert launches["bias"] >= 1
            assert bool(launches["bias_masked"]) == user_log_mask
    assert out["cuda"]["count"] == out["cpu"]["count"] > 0
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert abs(out["cuda"][key] - out["cpu"][key]) <= 1e-4, key


def test_reload_on_the_card(tmp_path):
    """run_server on the card from the newest checkpoint: /score equal to
    the same params scored on the CPU; a newer checkpoint, POST /reload,
    then the new params' scores; 409 while a reload is in flight."""
    import http.client
    import json

    from newsrecommendation_tpu_torch.ckpt import save_checkpoint
    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.server import run_server

    cfg, corpus, table, nrms = _cli_setup(tmp_path)
    vocabs = dict(category_dict=corpus.category_dict,
                  subcategory_dict=corpus.subcategory_dict,
                  word_dict=corpus.word_dict)

    def save(steps, name):
        state = _trained_state(cfg, table, nrms, "cpu", steps=steps)
        save_checkpoint(cfg.model_dir, name, state, cfg, **vocabs)
        return Recommender.from_checkpoint(
            f"{cfg.model_dir}/{name}", cfg, cfg.test_data_dir, device="cpu")

    def post(srv, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=60)
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
        return resp.status, body

    cpu = save(2, "epoch-1.ckpt")
    docs = list(cpu.news_index)
    req = {"history": docs[:5], "candidates": docs[5:25]}
    srv = run_server(cfg, block=False)
    try:
        assert srv.rec.device.type == "cuda"
        status, body = post(srv, "/score", req)
        assert status == 200
        np.testing.assert_allclose(
            body["scores"], cpu.score(req["history"], req["candidates"]),
            rtol=1e-4, atol=1e-4)
        newer = save(4, "epoch-2.ckpt")
        status, body = post(srv, "/reload", {})
        assert status == 200 and body["status"] == "reloaded"
        status, body = post(srv, "/score", req)
        np.testing.assert_allclose(
            body["scores"], newer.score(req["history"], req["candidates"]),
            rtol=1e-4, atol=1e-4)
        assert srv.reload_lock.acquire(blocking=False)
        try:
            assert post(srv, "/reload", {})[0] == 409
        finally:
            srv.reload_lock.release()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()


# ---- NAML on the card: the title CNN in f32, a bf16 step, no kernel ------

def _naml_setup(compute_dtype="float32", user_log_mask=False, n_news=256):
    """NAML at its published width (300-d words, 400-d news, T = 20,
    category and subcategory views, word ids into a frozen table), CPU
    params from a seed, and (n_news + 1, F) features with id-0 rows."""
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.models import naml

    cfg = Config(model="NAML", use_category=True, use_subcategory=True,
                 freeze_embedding=True, compute_dtype=compute_dtype,
                 user_log_mask=user_log_mask, batch_size=8)
    rng = np.random.default_rng(0)
    table = rng.normal(scale=0.5, size=(500, 300)).astype(np.float32)
    table[0] = 0.0
    params = naml.init(cfg, table, num_category=12, num_subcategory=40,
                       seed=1, device="cpu")
    title = rng.integers(0, 500, size=(n_news + 1, 20))
    title[:, 15:] = 0
    feats = np.concatenate([title, rng.integers(0, 13, (n_news + 1, 1)),
                            rng.integers(0, 41, (n_news + 1, 1))], 1)
    feats[0] = 0
    return cfg, params, feats.astype(np.int32)


def _naml_batch(cfg, feats, device, seed=3):
    rng = np.random.default_rng(seed)
    b, L, k = cfg.batch_size, cfg.user_log_length, cfg.npratio
    batch = {"history": feats[rng.integers(0, len(feats), (b, L))],
             "history_mask": (rng.random((b, L)) > 0.3).astype(np.float32),
             "candidate": feats[rng.integers(0, len(feats), (b, 1 + k))],
             "label": rng.integers(0, k + 1, (b,)).astype(np.int32),
             "weight": np.ones(b, np.float32)}
    return {key: torch.from_numpy(v).to(device) for key, v in batch.items()}


@pytest.fixture
def torch_default_flags():
    """torch's default backend flags (cuDNN may use TF32, matmuls may
    not), whatever the process had; put back afterwards."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def test_naml_news_encoder_f32_under_default_flags(torch_default_flags):
    """The NAML news encoder in f32 on the card, under torch's default
    flags, against the CPU at the f32 tolerance: the title CNN must not
    round to TF32. Control: the same encoder with TF32 allowed in the
    matmuls must miss that tolerance."""
    from newsrecommendation_tpu_torch.models import naml
    from newsrecommendation_tpu_torch.utils import to_device

    cfg, params, feats = _naml_setup(n_news=1024)
    x = torch.from_numpy(feats)
    with torch.inference_mode():
        want = naml.news_encoder(params, cfg, x)
        card = to_device(params, "cuda")
        got = naml.news_encoder(card, cfg, x.cuda())
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = naml.news_encoder(card, cfg, x.cuda())
        torch.backends.cuda.matmul.allow_tf32 = False
    assert got.dtype == torch.float32 and got.shape == (1025, 400)
    torch.testing.assert_close(got.cpu(), want, **TOL["float32"])
    err = (tf32.cpu() - want).abs()
    assert (err > TOL["float32"]["atol"] + TOL["float32"]["rtol"]
            * want.abs()).sum() > 100, float(err.max())


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_naml_bf16_step_on_card_matches_cpu(user_log_mask):
    """One bf16 NAML train step (dropout off) on the card and on the CPU
    from the same params and batch: finite, the loss within 5e-2, each
    leaf's gradient within 5e-2 of the largest gradient."""
    from newsrecommendation_tpu_torch.models import get_model
    from newsrecommendation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from newsrecommendation_tpu_torch.utils import to_device

    cfg, params, feats = _naml_setup("bfloat16", user_log_mask)
    cfg = cfg.replace(deterministic=True, lr=3e-4)
    out = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(cfg, to_device(params, device))
        state, m = make_train_step(cfg, get_model("NAML"))(
            state, _naml_batch(cfg, feats, device), 0)
        grads = {}

        def walk(tree, path=()):
            if isinstance(tree, dict):
                for key in tree:
                    walk(tree[key], path + (key,))
            elif tree.grad is not None:
                grads[path] = tree.grad.float().cpu()

        walk(state.params)
        out[device] = (float(m["loss"]), grads)
    (loss, grads), (cpu_loss, cpu_grads) = out["cuda"], out["cpu"]
    assert np.isfinite(loss) and abs(loss - cpu_loss) <= 5e-2 * abs(cpu_loss)
    assert set(grads) == set(cpu_grads) and ("embedding_table",) not in grads
    largest = max(g.abs().max().item() for g in cpu_grads.values())
    for path, g in grads.items():
        assert torch.isfinite(g).all(), path
        assert (g - cpu_grads[path]).abs().max().item() <= 5e-2 * largest, (
            path)


def test_naml_launches_no_kernel():
    """A NAML train step (bf16, dropout on) and a NAML score_batch on the
    card launch none of the port's kernels."""
    from newsrecommendation_tpu_torch.models import get_model
    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from newsrecommendation_tpu_torch.utils import to_device

    cfg, params, feats = _naml_setup("bfloat16")
    fa.reset_launch_counts()
    state = create_train_state(cfg, to_device(params, "cuda"))
    state, m = make_train_step(cfg, get_model("NAML"))(
        state, _naml_batch(cfg, feats, "cuda"), 0)
    assert torch.isfinite(m["loss"])
    index = {f"N{i}": i for i in range(1, len(feats))}
    rec = Recommender.from_state(cfg.replace(compute_dtype="float32"),
                                 params, index, feats, device="cuda")
    scores = rec.score_batch([["N1", "N2", "N3"], []],
                             [["N4", "N5", "N6"], ["N7", "N8", "N9"]])
    assert scores.shape == (2, 3) and np.isfinite(scores).all()
    assert not any(any(fa.launch_counts(k).values()) for k in fa.KERNELS)


# ---- data parallelism and row-sharded tables on the card ----------------

DDP_VOCAB = 31
DDP_CFG = dict(num_words_title=6, user_log_length=8, word_embedding_dim=16,
               news_dim=24, news_query_vector_dim=10,
               user_query_vector_dim=10, num_attention_heads=4, npratio=3,
               batch_size=4, drop_rate=0.0, deterministic=True, lr=3e-4,
               freeze_embedding=False)
# the leaves whose gradient is 0 analytically: rounding noise, which
# Adam's step turns into updates of either sign of about lr
DDP_ZERO_GRAD = {"news_encoder/mhsa/wk/b", "user_encoder/mhsa/wk/b",
                 "news_encoder/attn/fc2/b", "user_encoder/attn/fc2/b"}


def _ddp_batch(b, seed):
    rng = np.random.default_rng(seed)
    L, k, t = (DDP_CFG["user_log_length"], DDP_CFG["npratio"],
               DDP_CFG["num_words_title"])
    mask = (rng.random((b, L)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    return {"history": rng.integers(0, DDP_VOCAB, (b, L, t)).astype(
                np.int32),
            "history_mask": mask,
            "candidate": rng.integers(0, DDP_VOCAB, (b, 1 + k, t)).astype(
                np.int32),
            "label": rng.integers(0, k + 1, (b,)).astype(np.int32),
            "weight": np.ones(b, np.float32)}


def _ddp_params():
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.models import nrms

    table = np.random.default_rng(0).normal(
        size=(DDP_VOCAB, DDP_CFG["word_embedding_dim"])).astype(np.float32)
    table[0] = 0.0
    return nrms.init(Config(**DDP_CFG), table, seed=0, device="cpu")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.fixture(scope="module")
def ddp_card_run(tmp_path_factory):
    """Two gloo ranks sharing card 0 (tests/torch_mp_worker.py): the row
    gather at ts = 2 and two f32 spmd steps at (2, 1) and (1, 2)."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from newsrecommendation_tpu_torch.config import Config

    d = tmp_path_factory.mktemp("ddp_card")
    np.savez(d / "params.npz", **{k: v.numpy() for k, v in
                                  _flat(_ddp_params()).items()})
    cfg = {k: v for k, v in vars(Config(**DDP_CFG)).items()}
    jobs = []
    for dp, ts in ((2, 1), (1, 2)):
        np.savez(d / f"batches_{dp}x{ts}.npz", **{
            f"{i}/{k}": v for i, s in enumerate((1, 2))
            for k, v in _ddp_batch(4 * dp, s).items()})
        jobs.append({"name": f"step_{dp}x{ts}", "kind": "step", "cfg": cfg,
                     "dp": dp, "ts": ts, "params": "params.npz",
                     "batches": f"batches_{dp}x{ts}.npz",
                     "device": "cuda:0"})
    rng = np.random.default_rng(2)
    np.savez(d / "gather.npz",
             table=rng.normal(size=(32, 8)).astype(np.float32),
             ids=rng.integers(0, 31, (5, 7)).astype(np.int32),
             g=rng.normal(size=(5, 7, 8)).astype(np.float32))
    jobs.append({"name": "gather", "kind": "gather", "cfg": cfg, "ts": 2,
                 "inputs": "gather.npz", "device": "cuda:0"})
    with open(d / "jobs_2.json", "w", encoding="utf-8") as f:
        json.dump(jobs, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "torch_mp_worker.py"),
         str(r), "2", str(d)], stderr=subprocess.PIPE, text=True, env=env,
        cwd=repo) for r in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return d


def _ddp_out(d, name, rank):
    return torch.load(d / "out" / f"{name}.rank{rank}.pt",
                      map_location="cpu", weights_only=False)


def test_gather_rows_sharded_in_a_one_rank_nccl_group(tmp_path):
    """gather_rows_sharded on CUDA in an NCCL group of one rank: the dense
    take, and its backward the dense scatter-add."""
    import datetime

    import torch.distributed as dist

    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.parallel import make_mesh
    from newsrecommendation_tpu_torch.parallel.sharded_embedding import (
        gather_rows_sharded,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(Config(), device="cuda:0")
        rng = np.random.default_rng(1)
        table = torch.from_numpy(rng.normal(size=(40, 16)).astype(
            np.float32)).cuda()
        ids = torch.from_numpy(rng.integers(0, 40, (6, 9))).cuda()
        a = table.clone().requires_grad_(True)
        b = table.clone().requires_grad_(True)
        out = gather_rows_sharded(a, ids, mesh)
        assert torch.equal(out, b[ids])
        g = torch.randn(6, 9, 16, device="cuda")
        out.backward(g)
        b[ids].backward(g)
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_gather_rows_sharded_two_gloo_ranks_on_one_card(ddp_card_run):
    with np.load(ddp_card_run / "gather.npz") as z:
        table, ids, g = z["table"], z["ids"], z["g"]
    want = np.zeros_like(table)
    np.add.at(want, ids.reshape(-1), g.reshape(-1, 8))
    outs = [_ddp_out(ddp_card_run, "gather", r) for r in range(2)]
    for o in outs:
        np.testing.assert_array_equal(o["rows"].numpy(), table[ids])
    grad = np.concatenate([o["grad"].numpy() for o in outs])
    np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dp, ts", [(2, 1), (1, 2)])
def test_ddp_f32_steps_match_the_single_process_step(ddp_card_run, dp, ts):
    """Two f32 spmd steps of two gloo ranks on one card against the
    single-process card step on the concatenated batch: loss and accuracy
    (rel 1e-5), the gradients (rtol 1e-4 / atol 1e-5), every leaf (rtol
    1e-4 / atol 1e-6), the trained table's rows from both ranks at ts =
    2; and the launch counters: rows 2-3 twice a step, no other kernel."""
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg = Config(**DDP_CFG)
    state = create_train_state(cfg, {k: v for k, v in _to_cuda(
        _ddp_params()).items()})
    step = make_train_step(cfg, nrms_model())
    losses, accs = [], []
    for s in (1, 2):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in _ddp_batch(4 * dp, s).items()}
        state, m = step(state, batch, 0)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    outs = [_ddp_out(ddp_card_run, f"step_{dp}x{ts}", r) for r in range(2)]
    np.testing.assert_allclose(outs[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(outs[0]["acc"], accs, rtol=1e-5)
    for key, want in _flat(state.params).items():
        parts = [o["params"][key] for o in outs]
        grads = [o["grads"][key] for o in outs]
        if key == "embedding_table" and ts > 1:  # padded to 2 x 16 rows
            rows = want.shape[0]
            got, grad = torch.cat(parts)[:rows], torch.cat(grads)[:rows]
        else:
            assert torch.equal(parts[0], parts[1]), key
            got, grad = parts[0], grads[0]
        torch.testing.assert_close(grad, want.grad.cpu(), rtol=1e-4,
                                   atol=1e-5, msg=lambda m: f"{key}: {m}")
        if key in DDP_ZERO_GRAD:
            assert float((got - want.detach().cpu()).abs().max()) < (
                4 * cfg.lr)
            continue
        torch.testing.assert_close(got, want.detach().cpu(), rtol=1e-4,
                                   atol=1e-6, msg=lambda m: f"{key}: {m}")
    for o in outs:
        launched = {k: sum(v.values()) for k, v in o["launches"].items()
                    if sum(v.values())}
        assert launched == {"qkv_fwd_probs": 4, "qkv_bwd_probs": 4}, launched


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()
