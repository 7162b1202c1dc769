"""ctypes wrapper around the C++ scalar golden coder.

The port's copy of ``range_coder_rust_tpu/native/golden.py``, over a
byte-for-byte copy of its ``scalar_coder.cc``.  The shared library is
built with g++ at first use into
``build/range_coder_rust_tpu_torch/native/<source hash>/`` beside the
package (the tree ``kernels/_build.py`` builds into), under a private
name that is then renamed, so that several processes may build it at
once.  It exposes numpy-friendly ``encode`` / ``decode`` / ``step``: the
CPU conformance and throughput anchor that stands in for the Rust crate.
Its errors are the port's own (:mod:`..errors`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..errors import RangeCoderError, TableError, TruncatedStream, ZeroFrequency

_SRC = Path(__file__).resolve().parent / "scalar_coder.cc"
_BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
               / "range_coder_rust_tpu_torch" / "native")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None

#: matches MAX_BYTES_PER_SYMBOL in core/rc64.py
_MAX_BYTES_PER_SYMBOL = 14

_ERRORS = {
    -2: (TableError, "total_freq is zero or alphabet empty"),
    -3: (RangeCoderError, "output capacity exceeded"),
    -4: (ZeroFrequency, "encoded a zero-frequency symbol"),
    -5: (TruncatedStream, "code stream truncated"),
}

_U8 = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_SIZE = ctypes.c_size_t

#: C entry points: name -> argument types (all return int)
_SIGNATURES = {
    # syms, n, c, cum, total, out, cap, out_len
    "rc_encode": [_U32, _SIZE, _U32, _U32, ctypes.c_uint32, _U8, _SIZE,
                  ctypes.POINTER(_SIZE)],
    # code, code_len, n, c, cum, alphabet, total, out
    "rc_decode": [_U8, _SIZE, _SIZE, _U32, _U32, ctypes.c_uint32,
                  ctypes.c_uint32, _U32],
    # low, range, c, cum, total, out, n_bytes
    "rc_step": [_U64, _U64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, _U8, ctypes.POINTER(ctypes.c_int)],
}


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libscalar_coder.so"


def _build(lib: Path) -> None:
    """Compile into a private name in ``lib``'s directory, then rename:
    a concurrent builder never loads a half-written library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(
                proc.returncode, proc.args, proc.stdout, proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(rc: int) -> None:
    if rc != 0:
        cls, msg = _ERRORS.get(rc, (RangeCoderError,
                                    f"native coder error {rc}"))
        raise cls(msg)


def _as_u32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint32)


def encode(syms: np.ndarray, c: np.ndarray, cum: np.ndarray, total: int) -> bytes:
    """Encode symbols with a static table; returns the full stream incl. flush."""
    lib = _load()
    syms = _as_u32(syms)
    c = _as_u32(c)
    cum = _as_u32(cum)
    n = syms.shape[0]
    cap = n * _MAX_BYTES_PER_SYMBOL + 8
    out = np.empty(cap, dtype=np.uint8)
    out_len = ctypes.c_size_t(0)
    _check(lib.rc_encode(
        syms.ctypes.data_as(_U32), n, c.ctypes.data_as(_U32),
        cum.ctypes.data_as(_U32), int(total), out.ctypes.data_as(_U8), cap,
        ctypes.byref(out_len)))
    return out[: out_len.value].tobytes()


def decode(
    code: bytes | np.ndarray, n: int, c: np.ndarray, cum: np.ndarray, total: int
) -> np.ndarray:
    """Decode n symbols; returns uint32 symbol indices."""
    lib = _load()
    buf = np.frombuffer(bytes(code), dtype=np.uint8) if not isinstance(
        code, np.ndarray
    ) else np.ascontiguousarray(code, dtype=np.uint8)
    c = _as_u32(c)
    cum = _as_u32(cum)
    out = np.empty(n, dtype=np.uint32)
    _check(lib.rc_decode(
        buf.ctypes.data_as(_U8), buf.shape[0], n, c.ctypes.data_as(_U32),
        cum.ctypes.data_as(_U32), c.shape[0], int(total),
        out.ctypes.data_as(_U32)))
    return out


def step(
    low: int, range_: int, c: int, cum: int, total: int
) -> tuple[int, int, bytes]:
    """One param_update transition: returns (new_low, new_range, bytes)."""
    lib = _load()
    lo = ctypes.c_uint64(low)
    rg = ctypes.c_uint64(range_)
    buf = (ctypes.c_uint8 * 16)()
    nb = ctypes.c_int(0)
    _check(lib.rc_step(ctypes.byref(lo), ctypes.byref(rg), c, cum, total, buf,
                       ctypes.byref(nb)))
    return lo.value, rg.value, bytes(buf[: nb.value])


def is_available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
