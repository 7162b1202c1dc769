"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), for ``sm_90a`` (Hopper).  The library lands in
``build/range_coder_rust_tpu_torch/<source hash>/`` beside the package, so
a second run with unchanged sources skips the build.  It is loaded with
``ctypes``; every entry point is declared with its argument types (ctypes
would otherwise pass a pointer as a 32-bit int) and returns the
``cudaError_t`` of its launches.

Nothing here runs when the package is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "range_coder_rust_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong

#: C entry points: name -> argument types (all return cudaError_t as int)
SIGNATURES = {
    # sym, cum, states, sizes, offs, park, region, n_groups, group_lanes,
    # block_len, tile, stream
    "rc_rans_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # states, region, region_len, grp_off, cum, out, n_groups, group_lanes,
    # block_len, a_count, out_bytes, stream
    "rc_rans_decode": [_P, _P, _I64, _P, _P, _P, _I, _I, _I64, _I, _I, _P],
    # group_lanes, a_count, out_bytes -> staged, ring_hw, smem, threads
    # (int *)
    "rc_rans_decode_plan": [_I, _I, _I, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if its source hash has no build yet; returns
    the path of the ``.so``.  A failed build raises with nvcc's stderr."""
    out_dir = _BUILD_ROOT / source_hash()
    lib = out_dir / "librc_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           *[str(p) for p in sorted(_CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    (out_dir / "ptxas.txt").write_text(proc.stderr)  # registers, spills
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rc_error_string.argtypes = [ctypes.c_int]
    lib.rc_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().rc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
