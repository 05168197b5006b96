"""Exp-MHSA over a fused [q|k|v] projection: three CUDA kernels behind
two autograd-aware wrappers, and their plain PyTorch versions.

Replaces, in ``newsrecommendation_tpu/ops/pallas/fused_attention.py``:
  - ``_qkv_fwd_call`` (``_qkv_fwd_kernel``): the forward, for serving and
    eval -> ``csrc/qkv_fwd.cu``, kernel "qkv_fwd";
  - ``_qkv_fwd_probs_call``: the same forward that also writes the f32
    probs (N, T, H*T), under differentiation -> ``csrc/qkv_fwd.cu`` with a
    probs pointer, kernel "qkv_fwd_probs";
  - ``_qkv_bwd_probs_call`` (``_qkv_bwd_probs_kernel``): the backward from
    those probs -> ``csrc/qkv_bwd_probs.cu``, kernel "qkv_bwd_probs".
The entry points ``exp_mhsa_qkv_bias`` and ``exp_mhsa_qkv_bias_masked``
choose as the JAX package's custom_vjp does: with grad mode on and qkv or
bias requiring grad, the forward writes probs and the backward reads them;
otherwise (serving under inference_mode) the forward writes none.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.

Build: at first use ``nvcc`` compiles each source for sm_90a into a shared
library with a plain C interface under ``_build/<hash of source and
flags>/`` beside this package, loaded with ctypes. ``build()`` starts one
``nvcc`` per source that is not built yet, all at once. A rerun with the
same source reuses the library; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops.attention import masked_exp_normalize

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = {name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
            for name in ("qkv_fwd", "qkv_bwd_probs")}
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Sequences from this length on go to the key-blocked flash kernel in the
# JAX package (ops/pallas/config.py: flash_min_seq), not yet ported.
MAX_SEQ = 511
# Shared memory one block may use on sm_90 (opt-in, dynamic).
_MAX_SMEM = 232448

# Each kernel's variants, counted apart: row 1 of the kernel table
# ("qkv_fwd"), row 2 ("qkv_fwd_probs") and row 3 ("qkv_bwd_probs").
KERNELS = {"qkv_fwd": ("bias", "bias_masked"),
           "qkv_fwd_probs": ("bias_probs", "bias_masked_probs"),
           "qkv_bwd_probs": ("bwd_probs",)}

_lock = threading.Lock()  # guards the launch counts
_build_lock = threading.Lock()
_libs = {}
_launches = {v: 0 for variants in KERNELS.values() for v in variants}


def launch_counts(kernel: str = "qkv_fwd") -> dict:
    """Launches per variant of one kernel of ``KERNELS`` since the last
    reset_launch_counts()."""
    with _lock:
        return {v: _launches[v] for v in KERNELS[kernel]}


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


def _count(variant: str) -> None:
    with _lock:
        _launches[variant] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                           "CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str) -> str:
    with open(_SOURCES[name], "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_ROOT, key[:16], f"lib{name}.so")


def build(names=None) -> dict:
    """Compile the kernels' sources (all of ``KERNELS``' sources by default)
    that are not built yet, one ``nvcc`` each, all started together.
    Returns {source name: .so path}; raises if any build failed, after
    every ``nvcc`` it started has ended."""
    names = list(_SOURCES) if names is None else list(names)
    out, running = {}, {}
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            out[name] = so
            continue
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on "
                          f"{_SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build never sees half
        out[name] = so
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


# Each source's C entry points (each in an _f32 and a _bf16 form) with
# their count of pointer arguments; then come n, t_len, n_heads, d_head
# and the stream.
_ENTRY_POINTS = {"qkv_fwd": {"qkv_fwd": 4, "qkv_fwd_probs": 5},
                 "qkv_bwd_probs": {"qkv_bwd_probs": 5}}


def _library(name: str):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for entry, n_ptrs in _ENTRY_POINTS[name].items():
                for suffix in ("f32", "bf16"):
                    fn = getattr(lib, f"{entry}_{suffix}")
                    fn.argtypes = [ptr] * n_ptrs + [i32] * 4 + [ptr]
                    fn.restype = i32
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [i32, i32]
            smem.restype = i32
            _libs[name] = lib
        return lib


def _check(qkv, bias, key_mask, n_heads):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)}")
    n, t, w3 = qkv.shape
    if n_heads < 1 or w3 % (3 * n_heads) != 0:
        raise ValueError(f"qkv width {w3} is not 3 * n_heads({n_heads}) * D")
    if bias.shape != (w3,):
        raise ValueError(f"bias must be ({w3},), got {tuple(bias.shape)}")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, w3 // (3 * n_heads)


def _check_bwd(qkv, bias, probs, g, n_heads):
    n, t, d = _check(qkv, bias, None, n_heads)
    if probs.shape != (n, t, n_heads * t) or probs.dtype != torch.float32:
        raise ValueError(f"probs must be float32 ({n}, {t}, {n_heads * t}), "
                         f"got {probs.dtype} {tuple(probs.shape)}")
    if g.shape != (n, t, n_heads * d) or g.dtype != qkv.dtype:
        raise ValueError(f"g must be {qkv.dtype} ({n}, {t}, {n_heads * d}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    return n, t, d


def _check_launch(qkv, bias, key_mask, t, d, lib, *more):
    """What every kernel of library ``lib`` needs of its operands; raises
    on the rest."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        "(float32, bfloat16)")
    if t > MAX_SEQ:
        raise NotImplementedError(
            f"T={t} > {MAX_SEQ}: long sequences need the key-blocked flash "
            "kernel, which is not ported yet")
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    tensors = [qkv, bias, *more] + ([] if key_mask is None else [key_mask])
    for x in tensors:
        if x.device != qkv.device:
            raise ValueError(f"operands on {x.device} and {qkv.device}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if bias.dtype != qkv.dtype:
        raise TypeError(f"bias dtype {bias.dtype} != qkv dtype {qkv.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")
    smem = getattr(_library(lib), f"{lib}_smem_bytes")(t, d)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"T={t}, D={d} needs {smem} bytes of shared memory per block in "
            f"{lib}; the kernel takes at most {_MAX_SMEM}")


def _call(variant, fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{variant} kernel launch failed: CUDA error {err}")
    _count(variant)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(variant, qkv, bias, key_mask, n_heads, with_probs=False):
    """Row 1 (returns ctx) or, with_probs, row 2 (returns ctx, probs)."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    _check_launch(qkv, bias, key_mask, t, d, "qkv_fwd")
    lib = _library("qkv_fwd")
    out = torch.empty((n, t, n_heads * d), dtype=qkv.dtype,
                      device=qkv.device)
    suffix = "f32" if qkv.dtype == torch.float32 else "bf16"
    ptrs = (qkv.data_ptr(), bias.data_ptr(), _ptr(key_mask), out.data_ptr())
    if not with_probs:
        _call(variant, getattr(lib, f"qkv_fwd_{suffix}"), qkv.device, *ptrs,
              n, t, n_heads, d)
        return out
    probs = torch.empty((n, t, n_heads * t), dtype=torch.float32,
                        device=qkv.device)
    _call(variant, getattr(lib, f"qkv_fwd_probs_{suffix}"), qkv.device,
          *ptrs, probs.data_ptr(), n, t, n_heads, d)
    return out, probs


def qkv_fwd_probs(qkv, bias, key_mask, n_heads: int):
    """Kernel row 2 on CUDA tensors: (ctx, probs (N, T, H*T) f32), ctx bit
    for bit row 1's. key_mask may be None. Raises for other devices."""
    variant = "bias_probs" if key_mask is None else "bias_masked_probs"
    return _launch(variant, qkv, bias, key_mask, n_heads, with_probs=True)


def qkv_bwd_probs(qkv, bias, probs, g, n_heads: int):
    """Kernel row 3 on CUDA tensors: dqkv (N, T, 3HD) in qkv's dtype from
    the probs row 2 saved and the context's gradient g (N, T, HD) in qkv's
    dtype. Raises for other devices."""
    n, t, d = _check_bwd(qkv, bias, probs, g, n_heads)
    _check_launch(qkv, bias, None, t, d, "qkv_bwd_probs", probs, g)
    lib = _library("qkv_bwd_probs")
    dqkv = torch.empty_like(qkv)
    suffix = "f32" if qkv.dtype == torch.float32 else "bf16"
    _call("bwd_probs", getattr(lib, f"qkv_bwd_probs_{suffix}"), qkv.device,
          qkv.data_ptr(), bias.data_ptr(), probs.data_ptr(), g.data_ptr(),
          dqkv.data_ptr(), n, t, n_heads, d)
    return dqkv


def _split_heads(qkv, bias, n_heads, d):
    """Biased q, k, v (N, T, H, D) at the input dtype."""
    n, t, _ = qkv.shape
    x = qkv + bias.to(qkv.dtype)
    return [p.reshape(n, t, n_heads, d) for p in x.chunk(3, dim=-1)]


def exp_mhsa_qkv_bias_probs_reference(qkv, bias, key_mask, n_heads: int):
    """Plain PyTorch version of rows 1 and 2: same contract, same rounding
    points (bias added at the input dtype, f32 scores scaled after the dot,
    max over all keys, mask after the exp, a cast to v's dtype before a@v,
    f32 accumulate, output in the input dtype). key_mask may be None.
    Returns (ctx (N, T, H*D), probs (N, T, H*T) f32, head h's a at lanes
    [h*T, (h+1)*T))."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    q, k, v = _split_heads(qkv, bias, n_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    m = None if key_mask is None else key_mask[:, None, None, :]
    a = masked_exp_normalize(s, m, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).float(), v.float())
    probs = a.permute(0, 2, 1, 3).reshape(n, t, n_heads * t)
    return ctx.reshape(n, t, n_heads * d).to(qkv.dtype), probs


def exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads: int):
    """Plain PyTorch version of row 1: the context alone."""
    return exp_mhsa_qkv_bias_probs_reference(qkv, bias, key_mask, n_heads)[0]


def qkv_bwd_probs_reference(qkv, bias, probs, g, n_heads: int):
    """Plain PyTorch version of row 3, with the TPU kernel's rounding
    points: a rounded to g's dtype for dv = a^T g, da = g v^T in f32,
    ds = (da - rowsum(da * a)) * a / sqrt(D) with the f32 a, ds rounded to
    k's dtype before dq = ds k and dk = ds^T q. Returns dqkv in qkv's
    dtype."""
    n, t, d = _check_bwd(qkv, bias, probs, g, n_heads)
    q, k, v = (x.float() for x in _split_heads(qkv, bias, n_heads, d))
    gh = g.reshape(n, t, n_heads, d)
    a = probs.reshape(n, t, n_heads, t).permute(0, 2, 1, 3)  # (N, H, Q, K)
    dv = torch.einsum("bhqk,bqhd->bkhd", a.to(g.dtype).float(), gh.float())
    da = torch.einsum("bqhd,bkhd->bhqk", gh.float(), v)
    ds = (da - (da * a).sum(-1, keepdim=True)) * a * (1.0 / math.sqrt(d))
    ds = ds.to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([x.reshape(n, t, n_heads * d) for x in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


class _ExpMhsaQkvBias(torch.autograd.Function):
    """Row 2 forward (saves qkv, bias and the f32 probs), row 3 backward;
    their plain versions for CPU tensors. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, key_mask, n_heads):
        if qkv.device.type == "cpu":
            out, probs = exp_mhsa_qkv_bias_probs_reference(qkv, bias,
                                                           key_mask, n_heads)
        else:
            out, probs = qkv_fwd_probs(qkv, bias, key_mask, n_heads)
        ctx.save_for_backward(qkv, bias, probs)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, bias, probs = ctx.saved_tensors
        # the gradient arrives in any layout and, under bf16 autocasts, in
        # any float type: the kernel takes it contiguous in qkv's dtype
        g = g.to(qkv.dtype).contiguous()
        if qkv.device.type == "cpu":
            dqkv = qkv_bwd_probs_reference(qkv, bias, probs, g, ctx.n_heads)
        else:
            dqkv = qkv_bwd_probs(qkv, bias, probs, g, ctx.n_heads)
        dbias = (dqkv.sum((0, 1)).to(bias.dtype) if ctx.needs_input_grad[1]
                 else None)
        return dqkv, dbias, None, None


def _attend(variant, qkv, bias, key_mask, n_heads):
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _ExpMhsaQkvBias.apply(qkv, bias, key_mask, n_heads)
    if qkv.device.type == "cpu":
        return exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads)
    return _launch(variant, qkv, bias, key_mask, n_heads)


def exp_mhsa_qkv_bias(qkv, bias, n_heads: int):
    """Exp-MHSA over an un-biased fused projection (N, T, 3HD) plus its bias
    (3HD,). Returns the context (N, T, HD), differentiable in qkv and bias."""
    return _attend("bias", qkv, bias, None, n_heads)


def exp_mhsa_qkv_bias_masked(qkv, bias, key_mask, n_heads: int):
    """Key-masked exp_mhsa_qkv_bias; key_mask (N, T) float32 0/1 over keys.
    A row whose keys are all masked gives 0."""
    return _attend("bias_masked", qkv, bias, key_mask, n_heads)
