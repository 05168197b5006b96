"""Exp-MHSA forward over a fused [q|k|v] projection: the CUDA kernel
``csrc/qkv_fwd.cu`` behind two wrappers, and its plain PyTorch version.

Replaces ``newsrecommendation_tpu/ops/pallas/fused_attention.py``'s
``_qkv_fwd_kernel`` through the entry points ``exp_mhsa_qkv_bias`` and
``exp_mhsa_qkv_bias_masked`` (forward only: the port serves, it does not
train yet). The kernel is memory bound: it reads qkv (N, T, 3HD) once and
writes (N, T, HD) once; see the note at the top of the CUDA source for the
bound and for what the simple design leaves on the table.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.

Build: at first use ``nvcc`` compiles the source for sm_90a into a shared
library with a plain C interface under ``_build/<hash of source and
flags>/`` beside this package, loaded with ctypes. A rerun with the same
source reuses it; a failed build raises.
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

from newsrecommendation_tpu_torch.ops.attention import masked_exp_normalize

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "qkv_fwd.cu")
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Sequences from this length on go to the key-blocked flash kernel in the
# JAX package (ops/pallas/config.py: flash_min_seq), not yet ported.
MAX_SEQ = 511
# Shared memory one block may use on sm_90 (opt-in, dynamic).
_MAX_SMEM = 232448

_lock = threading.Lock()  # guards the launch counts
_build_lock = threading.Lock()
_lib = None
_launches = {"bias": 0, "bias_masked": 0}


def launch_counts() -> dict:
    """Kernel launches per variant since the last reset_launch_counts()."""
    with _lock:
        return dict(_launches)


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


def build() -> str:
    """Compile the kernel (once per source hash) and return the .so path."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out_dir = os.path.join(_BUILD_ROOT, key[:16])
    so = os.path.join(out_dir, "libqkv_fwd.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def _library():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.qkv_fwd_f32, lib.qkv_fwd_bf16):
                fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
                fn.restype = i32
            lib.qkv_fwd_smem_bytes.argtypes = [i32, i32]
            lib.qkv_fwd_smem_bytes.restype = i32
            _lib = lib
        return _lib


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


def _launch(variant, qkv, bias, key_mask, n_heads):
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        "(float32, bfloat16)")
    if t > MAX_SEQ:
        raise NotImplementedError(
            f"T={t} > {MAX_SEQ}: long sequences need the key-blocked flash "
            "kernel, which is not ported yet")
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    tensors = [qkv, bias] + ([] if key_mask is None else [key_mask])
    for x in tensors:
        if x.device != qkv.device:
            raise ValueError(f"operands on {x.device} and {qkv.device}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if bias.dtype != qkv.dtype:
        raise TypeError(f"bias dtype {bias.dtype} != qkv dtype {qkv.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")
    lib = _library()
    smem = lib.qkv_fwd_smem_bytes(t, d)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f"T={t}, D={d} needs {smem} bytes of shared memory per block; "
            f"the kernel takes at most {_MAX_SMEM}")
    out = torch.empty((n, t, n_heads * d), dtype=qkv.dtype,
                      device=qkv.device)
    fn = lib.qkv_fwd_f32 if qkv.dtype == torch.float32 else lib.qkv_fwd_bf16
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), bias.data_ptr(),
                 None if key_mask is None else key_mask.data_ptr(),
                 out.data_ptr(), n, t, n_heads, d, stream)
    if err != 0:
        raise RuntimeError(f"qkv_fwd kernel launch failed: CUDA error {err}")
    _count(variant)
    return out


def exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads: int):
    """Plain PyTorch version of the kernel: same contract, same rounding
    points (bias added at the input dtype, f32 scores scaled after the dot,
    max over all keys, mask after the exp, a cast to v's dtype before a@v,
    f32 accumulate, output in the input dtype). key_mask may be None."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    hd = n_heads * d
    x = qkv + bias.to(qkv.dtype)
    q = x[..., :hd].reshape(n, t, n_heads, d).float()
    k = x[..., hd:2 * hd].reshape(n, t, n_heads, d).float()
    v = x[..., 2 * hd:].reshape(n, t, n_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    m = None if key_mask is None else key_mask[:, None, None, :]
    a = masked_exp_normalize(s, m, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a.float(), v.float())
    return ctx.reshape(n, t, hd).to(qkv.dtype)


def _dispatch(variant, qkv, bias, key_mask, n_heads):
    if qkv.device.type == "cpu":
        return exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads)
    return _launch(variant, qkv, bias, key_mask, n_heads)


def exp_mhsa_qkv_bias(qkv, bias, n_heads: int):
    """Exp-MHSA over an un-biased fused projection (N, T, 3HD) plus its bias
    (3HD,). Returns the context (N, T, HD)."""
    return _dispatch("bias", qkv, bias, None, n_heads)


def exp_mhsa_qkv_bias_masked(qkv, bias, key_mask, n_heads: int):
    """Key-masked exp_mhsa_qkv_bias; key_mask (N, T) float32 0/1 over keys.
    A row whose keys are all masked gives 0."""
    return _dispatch("bias_masked", qkv, bias, key_mask, n_heads)
