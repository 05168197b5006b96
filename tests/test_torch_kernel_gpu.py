"""The CUDA kernel (csrc/qkv_fwd.cu) against its plain PyTorch version, on
the card. Imports no JAX, so it runs where only PyTorch is installed:

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
