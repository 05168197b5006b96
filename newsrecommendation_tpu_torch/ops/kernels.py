"""Build, load, launch and count the port's CUDA kernels.

Every kernel source is ``csrc/<name>.cu`` beside this package, with a plain
C interface. At first use ``nvcc`` compiles it for sm_90a into a shared
library under ``_build/<hash>/`` (the hash covers the source, every
``csrc/*.cuh`` header and the flags), loaded with ctypes. ``build()``
starts one ``nvcc`` per source that is not built yet, all at once. A rerun
with the same sources reuses the libraries; a failed build raises.

Each wrapper counts its launches per variant (``KERNELS``), so a run can
show which kernels its path went through; a wrapper whose launch takes one
of several regimes (rows 1-2 and 11: resident, tensor-core, tiled or
row-wise kernels; rows 3-4 and 12: resident, tensor-core or tiled;
rows 5 and 7: row-wise, tensor-core or tiled; rows 6 and 8: resident,
tensor-core or wide; rows 13-14: resident, tiled or global) also
counts it per regime. A CPU tensor
takes a kernel's plain PyTorch version and counts nothing; a CUDA tensor
launches the kernel or raises; any other device raises ``NoKernelError``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Each source's C entry points, each in an _f32 and a _bf16 form, with the
# types of their arguments ("p" a pointer, "i" an int, "u" an unsigned
# 32-bit int, "f" a float); the stream comes last.
_ENTRY_POINTS = {
    "qkv_fwd": {"qkv_fwd": "p" * 6 + "i" * 9,
                "qkv_fwd_probs": "p" * 7 + "i" * 9},
    "qkv_bwd_probs": {"qkv_bwd_probs": "p" * 8 + "i" * 11},
    "qkv_bwd": {"qkv_bwd": "p" * 8 + "i" * 11},
    "flash_fwd": {"flash_fwd": "p" * 7 + "i" * 9},
    "flash_bwd": {"flash_bwd": "p" * 11 + "i" * 11},
    "fused_tail_fwd": {"fused_tail_fwd": "p" * 9 + "i" * 12 + "uf"},
    "fused_tail_bwd": {"fused_tail_bwd": "p" * 23 + "i" * 23 + "uf"},
    "blanes": {"blanes_fwd": "p" * 3 + "i" * 8,
               "blanes_bwd": "p" * 5 + "i" * 11},
    "mhsa_sep": {"mhsa_sep_fwd": "p" * 6 + "i" * 13,
                 "mhsa_sep_bwd": "p" * 9 + "i" * 16},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint32,
           "f": ctypes.c_float}
# Sources whose block stages whole rows or (T, D) operands export size
# functions (no dtype suffix): the shared bytes a block needs, checked
# against what a block may use, the floats of a scratch slot where a long
# row moves to global memory, the regimes of rows 1-2, 3-4, 5/7 and 6/8
# and their shared bytes, and the flash forward's count of key-walk tasks.
# {source: {function: count of int arguments}}.
_SIZE_FUNCTIONS = {
    "qkv_fwd": {"qkv_fwd_slot_floats": 2, "qkv_fwd_regime": 3,
                "qkv_fwd_smem_bytes": 8},
    "qkv_bwd_probs": {"qkv_bwd_probs_slot_floats": 3},
    "qkv_bwd": {"qkv_bwd_slot_floats": 3, "qkv_bwd_regime": 3,
                "qkv_bwd_resident_smem_bytes": 6,
                "qkv_bwd_mma_smem_bytes": 5},
    "flash_fwd": {"flash_smem_bytes": 6, "flash_walk_task_count": 3},
    "fused_tail_fwd": {"fused_tail_fwd_scratch_floats": 4,
                       "fused_tail_fwd_regime": 5,
                       "fused_tail_fwd_smem_bytes": 7,
                       "fused_tail_fwd_row_floats": 5,
                       "fused_tail_tiled_smem_bytes": 3},
    "fused_tail_bwd": {"fused_tail_bwd_stage_floats": 4,
                       "fused_tail_bwd_row_floats": 5,
                       "fused_tail_bwd_attn_stage_floats": 3,
                       "fused_tail_bwd_regime": 5,
                       "fused_tail_bwd_smem_bytes": 7},
    "blanes": {"blanes_smem_bytes": 7},
    "mhsa_sep": {"mhsa_sep_fwd_scratch_floats": 3,
                 "mhsa_sep_bwd_scratch_floats": 3,
                 "mhsa_sep_fwd_regime": 4, "mhsa_sep_fwd_smem_bytes": 8,
                 "mhsa_sep_bwd_regime": 4, "mhsa_sep_bwd_smem_bytes": 8},
}
# Shared memory one block may use on sm_90 (opt-in, dynamic).
MAX_SMEM = 232448

# Each kernel's variants, counted apart. Rows of PERF.md's kernel table:
# 1 "qkv_fwd", 2 "qkv_fwd_probs", 3 "qkv_bwd_probs", 4 "qkv_bwd",
# 5 and 7 "mhsa_fwd" (unmasked, masked), 6 and 8 "mhsa_bwd", 9 "flash_fwd",
# 10 "flash_bwd", 11 "qkv2d_fwd", 12 "qkv2d_bwd", 13 "fused_tail_fwd",
# 14 "fused_tail_bwd", 15 "blanes_fwd", 16 "blanes_bwd".
KERNELS = {"qkv_fwd": ("bias", "bias_masked"),
           "qkv_fwd_probs": ("bias_probs", "bias_masked_probs"),
           "qkv_bwd_probs": ("bwd_probs",),
           "qkv_bwd": ("bwd", "bwd_masked"),
           "flash_fwd": ("flash", "flash_masked"),
           "flash_bwd": ("flash_bwd", "flash_bwd_masked"),
           "qkv2d_fwd": ("fwd2d",),
           "qkv2d_bwd": ("bwd2d",),
           "fused_tail_fwd": ("tail", "tail_masked"),
           "fused_tail_bwd": ("tail_bwd", "tail_bwd_masked"),
           "mhsa_fwd": ("mhsa", "mhsa_masked"),
           "mhsa_bwd": ("mhsa_bwd", "mhsa_bwd_masked"),
           "blanes_fwd": ("blanes", "blanes_masked"),
           "blanes_bwd": ("blanes_bwd", "blanes_bwd_masked")}

_lock = threading.Lock()  # guards the launch counts
_build_lock = threading.Lock()
_libs = {}
_launches = {v: 0 for variants in KERNELS.values() for v in variants}
_regime_launches = {}  # {(variant, regime): launches}
build_seconds = {}  # {source name: wall seconds of its last nvcc}


class NoKernelError(NotImplementedError, ValueError):
    """A tensor on a device that has neither a kernel (CUDA) nor the plain
    version (CPU)."""


def launch_counts(kernel: str = "qkv_fwd") -> dict:
    """Launches per variant of one kernel of ``KERNELS`` since the last
    reset_launch_counts()."""
    with _lock:
        return {v: _launches[v] for v in KERNELS[kernel]}


def regime_counts(kernel: str) -> dict:
    """Launches of one kernel of ``KERNELS`` per regime of its launch plan
    (summed over its variants) since the last reset_launch_counts(); only
    the regimes launched."""
    out = {}
    with _lock:
        for (variant, regime), count in _regime_launches.items():
            if variant in KERNELS[kernel]:
                out[regime] = out.get(regime, 0) + count
    return out


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0
        _regime_launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                           "CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in [_source(name), *sorted(glob.glob(os.path.join(_CSRC,
                                                               "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def build(names=None) -> dict:
    """Compile the kernels' sources (all of them by default) that are not
    built yet, one ``nvcc`` each, all started together. Returns {source
    name: .so path}; raises if any build failed, after every ``nvcc`` it
    started has ended. Each ``nvcc``'s wall seconds go to
    ``build_seconds``."""
    names = list(_ENTRY_POINTS) if names is None else list(names)
    out, running = {}, {}
    start = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            out[name] = so
            continue
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    logs = {}

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - start

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in running.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for name, (proc, tmp, so) in running.items():
        log = logs[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on "
                          f"{_source(name)}:\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build never sees half
        out[name] = so
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str):
    """The loaded library of source ``name``, built first if need be."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for entry, sig in _ENTRY_POINTS[name].items():
                for suffix in ("f32", "bf16"):
                    fn = getattr(lib, f"{entry}_{suffix}")
                    fn.argtypes = [_CTYPES[c] for c in sig] + [ptr]
                    fn.restype = i32
            for fn_name, n_ints in _SIZE_FUNCTIONS.get(name, {}).items():
                smem = getattr(lib, fn_name)
                smem.argtypes = [i32] * n_ints
                smem.restype = i32
            _libs[name] = lib
        return lib


def entry(name: str, fn: str, dtype: torch.dtype):
    """The C function ``fn`` of source ``name`` for ``dtype``."""
    suffix = "f32" if dtype == torch.float32 else "bf16"
    return getattr(library(name), f"{fn}_{suffix}")


def check_operands(lead, *others, contiguous=True,
                   dtypes=(torch.float32, torch.bfloat16)):
    """What every kernel needs of its operands: ``lead`` on CUDA in one of
    ``dtypes`` and every operand on its device (None skipped); with
    ``contiguous``, every operand contiguous. Raises on the rest."""
    if lead.device.type != "cuda":
        raise NoKernelError(f"no kernel for device {lead.device}")
    if lead.dtype not in dtypes:
        raise TypeError(f"dtype {lead.dtype} not supported (float32, "
                        "bfloat16)")
    for x in (lead, *others):
        if x is None:
            continue
        if x.device != lead.device:
            raise ValueError(f"operands on {x.device} and {lead.device}")
        if contiguous and not x.is_contiguous():
            raise ValueError("operands must be contiguous")


def size_of(name: str, fn: str, *dims) -> int:
    """Size function ``fn`` of source ``name`` (``_SIZE_FUNCTIONS``) at
    ``dims``: bytes of shared memory, or floats of scratch."""
    return getattr(library(name), fn)(*dims)


def scratch(name: str, fn: str, n_items: int, device, *dims):
    """(scratch, slots) for a kernel whose working set moves to global
    memory when a block's shared memory cannot hold it: ``fn`` of source
    ``name`` gives the floats of one slot at ``dims``, 0 when it fits.
    Two slots per SM (a block each, walking the n_items), so the scratch is
    bounded by the card, not by the rows. (None, 0) when it fits."""
    floats = size_of(name, fn, *dims)
    if not floats:
        return None, 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = max(1, min(n_items, 2 * sms))
    return torch.empty((slots, floats), dtype=torch.float32,
                       device=device), slots


def rows_scratch(name: str, fn: str, n_rows: int, device, *dims):
    """An (n_rows, floats) f32 scratch for a kernel that hands a batch
    row's vectors from one launch to the next: ``fn`` of source ``name``
    gives the floats a row takes at ``dims``; None where it takes none."""
    floats = size_of(name, fn, *dims)
    if not floats:
        return None
    return torch.empty((n_rows, floats), dtype=torch.float32, device=device)


def call(variant: str, fn, device, *args, regime: str | None = None) -> None:
    """Launch ``fn(*args, stream)`` on ``device``'s current stream, raise if
    the launch was refused, and count it (also under ``regime``, if
    given)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{variant} kernel launch failed: CUDA error {err}")
    with _lock:
        _launches[variant] += 1
        if regime is not None:
            key = (variant, regime)
            _regime_launches[key] = _regime_launches.get(key, 0) + 1


def ptr(x):
    return None if x is None else x.data_ptr()
