"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all started together, and links the objects into one shared
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
_U64 = ctypes.c_ulonglong

#: C entry points: name -> argument types (all return cudaError_t as int)
SIGNATURES = {
    # sym, sym_bytes, cum, cum_stride, states, sizes, offs, syncs,
    # sync_tiles, scratch, scratch_bytes, region, n_groups, group_lanes,
    # block_len, tile, stream
    "rc_rans_encode": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I64, _P, _I,
                       _I, _I, _I, _P],
    # n_groups, group_lanes, block_len, sym_bytes -> scratch_bytes
    # (long long *), chain_threads, chunk_steps (int *)
    "rc_rans_encode_plan": [_I, _I, _I, _I, _P, _P, _P],
    # states, region, region_len, grp_off, cum, cum_stride, out, n_groups,
    # group_lanes, block_len, a_count, out_bytes, stream
    "rc_rans_decode": [_P, _P, _I64, _P, _P, _I, _P, _I, _I, _I64, _I, _I,
                       _P],
    # group_lanes, a_count, out_bytes -> staged, ring_hw, smem, threads
    # (int *)
    "rc_rans_decode_plan": [_I, _I, _I, _P, _P, _P, _P],
    # sym, sym_bytes, c, cum, per_block, a_count, k, total, out, lengths,
    # n_blocks, block_len, capacity, stream -> placement, total form
    # (int *, or null)
    "rc_planar_encode": [_P, _I, _P, _P, _I, _I, _I, _U64, _P, _P, _I64, _I,
                         _I64, _P, _P, _P],
    # code, code_bytes, offsets, lengths, row_bytes, c, cum, per_block,
    # a_count, k, total, out, n_blocks, block_len, stream -> placement,
    # total form (int *, or null)
    "rc_planar_decode": [_P, _I64, _P, _P, _I64, _P, _P, _I, _I, _I, _U64,
                         _P, _I64, _I, _P, _P, _P],
    # sym, sym_bytes, n, a_count, totals, stream -> path (int *, or null)
    "rc_planar_histogram": [_P, _I, _I64, _I, _P, _P, _P],
    # code, row_bytes, lengths, offsets, out, size, n_rows, stream
    "rc_planar_compact": [_P, _I64, _P, _P, _P, _I64, _I64, _P],
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


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    return _BUILD_ROOT / source_hash() / "librc_kernels.so"


def build() -> Path:
    """Compile the library if its source hash has no build yet; returns
    the path of the ``.so``.  A failed build raises with nvcc's stderr."""
    lib = library_path()
    if lib.exists():
        return lib
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # build under private names, then rename: concurrent builders never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        procs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = Path(tmp_dir) / f"{src.stem}.o"
            cmd = [nvcc, *compile_flags, "-Xptxas", "-v", "-c", "-o",
                   str(obj), str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = [proc.communicate()[1] for _, _, proc in procs]
        for (cmd, _, proc), err in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
        tmp = Path(tmp_dir) / lib.name
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(obj) for _, obj, _ in procs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        (out_dir / "ptxas.txt").write_text("".join(logs))  # registers, spills
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
