"""The CUDA kernels (csrc/qkv_fwd.cu, rows 1 and 2; csrc/qkv_bwd_probs.cu,
row 3) against their plain PyTorch versions, on the card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Elsewhere every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from newsrecommendation_tpu_torch.ops import fused_attention as fa

pytestmark = pytest.mark.gpu

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 300, 2, 8),
                                            (2, 511, 1, 33)])
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


def test_kernel_raises_on_what_it_does_not_take():
    q = torch.zeros((1, 512, 24), device="cuda")
    with pytest.raises(NotImplementedError):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda"), 2)
    q = torch.zeros((1, 400, 3 * 64), device="cuda")  # D=64: too much smem
    with pytest.raises(NotImplementedError, match="shared memory"):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(192, device="cuda"), 1)
    q = torch.zeros((2, 5, 24), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda",
                                            dtype=torch.float16), 2)
    q = torch.zeros((2, 5, 48), device="cuda")[..., :24]
    with pytest.raises(ValueError, match="contiguous"):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda"), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_max_underflows_to_zero(dtype):
    """m is the max over ALL keys: a masked key 110 above the others makes
    exp(s - m) underflow on every key left, so the row's output is exactly
    0 (a max over unmasked keys only would give about 1e-14)."""
    heads, d, t = 3, 4, 5
    hd = heads * d
    qkv = torch.zeros((1, t, 3 * hd))
    qkv[0, :, :hd] = 2.0          # every query 2: key c*2 scores 4c
    qkv[0, 0, hd:2 * hd] = 15.0   # key 0 scores 60 (masked)
    qkv[0, 1:, hd:2 * hd] = -12.5  # the others score -50
    qkv[0, :, 2 * hd:] = 1.0
    tdt = getattr(torch, dtype)
    qkv = qkv.to(tdt).cuda()
    bias = torch.zeros(3 * hd, dtype=tdt, device="cuda")
    mask = torch.ones((1, t), device="cuda")
    mask[0, 0] = 0.0
    out = fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads)
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    assert (out == 0).all() and (ref == 0).all()


BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n, t, heads, d", [(64, 20, 20, 20), (33, 50, 20, 20),
                                            (7, 5, 3, 4), (3, 97, 2, 33)])
def test_probs_kernels_match_plain(dtype, masked, n, t, heads, d):
    """Row 2 (ctx bit-equal to row 1's, probs) and row 3 (dqkv from the
    same probs) against their plain versions."""
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
    take raises, under grad too."""
    q = torch.zeros((1, 300, 3 * 20), device="cuda", requires_grad=True)
    b = torch.zeros(60, device="cuda")
    out = fa.exp_mhsa_qkv_bias(q, b, 1)  # row 2 takes T=300 at D=20
    with pytest.raises(NotImplementedError, match="shared memory"):
        out.sum().backward()  # row 3 needs about 467 KB there
    q = torch.zeros((1, 512, 24), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        fa.exp_mhsa_qkv_bias(q, torch.zeros(24, device="cuda"), 2)
    probs = torch.zeros((2, 5, 10), device="cuda")
    qkv = torch.zeros((2, 5, 24), device="cuda")
    with pytest.raises(ValueError, match="g must be"):
        fa.qkv_bwd_probs(qkv, torch.zeros(24, device="cuda"), probs,
                         torch.zeros((2, 5, 8), device="cuda",
                                     dtype=torch.bfloat16), 2)
