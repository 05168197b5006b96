"""ctypes bridge to the port's native behaviors parser (``csrc/mindio.cpp``).

At first use ``g++ -O3 -shared -fPIC -std=c++17`` builds the source into
``_build/<hash>/libmindio.so`` beside the package, the hash covering the
source's bytes and the flags. The build writes ``{so}.{pid}.tmp`` and
renames it into place, so processes that build at once (test workers, the
CLI's ranks) never load half a library. If ``g++`` is missing or the build
fails, a warning is logged, ``available()`` is False and the loader takes
its pure-Python parser.

Which parser ran is always on record: the loader logs one line per parse
and notes the parser here (``last_parser()``, ``parser_counts()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "mindio.cpp")
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_build_failed = False
# wall seconds of this process's g++ build (None: none ran here)
build_seconds: Optional[float] = None

_counts = {"native": 0, "python": 0}
_last: Optional[str] = None


class ParseError(ValueError):
    """A malformed line: too few fields, no positive, or a candidate
    without ``-<label>``."""


class _TrainResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("history", ctypes.POINTER(ctypes.c_int32)),
        ("history_mask", ctypes.POINTER(ctypes.c_float)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("neg", ctypes.POINTER(ctypes.c_int32)),
    ]


class _EvalResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("history", ctypes.POINTER(ctypes.c_int32)),
        ("history_mask", ctypes.POINTER(ctypes.c_float)),
        ("candidates", ctypes.POINTER(ctypes.c_int32)),
        ("labels", ctypes.POINTER(ctypes.c_float)),
        ("candidate_mask", ctypes.POINTER(ctypes.c_float)),
        ("truncated", ctypes.c_int64),
        ("max_width", ctypes.c_int64),
    ]


def so_path(src: Optional[str] = None, root: Optional[str] = None) -> str:
    """Where the library of ``src`` (default: the port's source) is built
    under ``root`` (default: the package's ``_build``): keyed by the
    source's bytes and the flags."""
    src, root = src or _SRC, root or _BUILD_ROOT
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(root, h.hexdigest()[:16], "libmindio.so")


def build(src: Optional[str] = None,
          root: Optional[str] = None) -> Optional[str]:
    """The built library's path (built now if it is not yet), or None with
    a warning logged when ``g++`` is missing or fails."""
    global build_seconds
    src = src or _SRC
    so = so_path(src, root)
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        logging.warning("mindio: g++ not found; using the Python parser")
        return None
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        logging.warning("mindio: g++ build of %s failed (%s); using the "
                        "Python parser", src, detail)
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, so)  # atomic: a concurrent build never sees half
    build_seconds = time.perf_counter() - t0
    return so


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.mindio_index_create.restype = ctypes.c_void_p
        lib.mindio_index_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int32]
        lib.mindio_index_free.argtypes = [ctypes.c_void_p]
        lib.mindio_parse_train.restype = ctypes.c_int64
        lib.mindio_parse_train.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_TrainResult)]
        lib.mindio_parse_eval.restype = ctypes.c_int64
        lib.mindio_parse_eval.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_EvalResult)]
        lib.mindio_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def record(parser: str) -> None:
    """Note that ``parser`` ("native" or "python") parsed a file."""
    global _last
    with _lock:
        _counts[parser] += 1
        _last = parser


def last_parser() -> Optional[str]:
    """The parser of this process's last parse (None before the first)."""
    return _last


def parser_counts() -> Dict[str, int]:
    """Parses per parser in this process since the last reset."""
    with _lock:
        return dict(_counts)


def reset_parser_counts() -> None:
    global _last
    with _lock:
        _counts.update(native=0, python=0)
        _last = None


def _take(lib, ptr, shape, dtype):
    """A numpy array over a buffer the library malloc'd, without a copy:
    the buffer is freed once no view of it is left."""
    nbytes = max(1, int(np.prod(shape)) * np.dtype(dtype).itemsize)
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    buf = (ctypes.c_char * nbytes).from_address(addr)
    weakref.finalize(buf, lib.mindio_free, addr)
    return np.frombuffer(buf, dtype, count=int(np.prod(shape))).reshape(shape)


def _make_index(lib, news_index: Dict[str, int]):
    handle = lib.mindio_index_create()
    for doc_id, idx in news_index.items():
        lib.mindio_index_add(handle, doc_id.encode("utf-8"), idx)
    return handle


def _check(n: int, res, path: str) -> int:
    if n == -1:
        raise OSError(f"mindio: cannot read {path}")
    if n == -2:
        raise ParseError(f"{path}:{res.n}: malformed behaviors line")
    return n


def parse_train_file(path: str, news_index: Dict[str, int], L: int, K: int):
    """Native equivalent of TrainSamples.from_file's parse.

    Returns (history (N,L) i32, mask (N,L) f32, pos (N,) i32, neg (N,K) i32)
    or None if the native library is unavailable. A malformed line raises
    ParseError naming the file and its line.
    """
    lib = _load()
    if lib is None:
        return None
    handle = _make_index(lib, news_index)
    try:
        res = _TrainResult()
        n = _check(lib.mindio_parse_train(handle, os.fsencode(path), L, K,
                                          ctypes.byref(res)), res, path)
        return (
            _take(lib, res.history, (n, L), np.int32),
            _take(lib, res.history_mask, (n, L), np.float32),
            _take(lib, res.pos, (n,), np.int32),
            _take(lib, res.neg, (n, K), np.int32),
        )
    finally:
        lib.mindio_index_free(handle)


def parse_eval_file(path: str, news_index: Dict[str, int], L: int, C: int):
    """Native equivalent of EvalSamples.from_file's parse (fixed width C).

    Returns (history, mask, candidates, labels, candidate_mask, truncated,
    max_width) where ``truncated`` is the number of impressions with more
    than C candidates and ``max_width`` the widest impression observed:
    the caller decides whether truncation is an error (loader.py guard).
    None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    handle = _make_index(lib, news_index)
    try:
        res = _EvalResult()
        n = _check(lib.mindio_parse_eval(handle, os.fsencode(path), L, C,
                                         ctypes.byref(res)), res, path)
        return (
            _take(lib, res.history, (n, L), np.int32),
            _take(lib, res.history_mask, (n, L), np.float32),
            _take(lib, res.candidates, (n, C), np.int32),
            _take(lib, res.labels, (n, C), np.float32),
            _take(lib, res.candidate_mask, (n, C), np.float32),
            int(res.truncated),
            int(res.max_width),
        )
    finally:
        lib.mindio_index_free(handle)
