"""The container's bytes, written and read by the benchmark itself.

A frozen copy of the layout that ``range_coder_rust_tpu_torch/format.py``
writes (magic ``RCT1``, version 2), so that the reference builds whole
containers without the program:

    header (28 B) | u32 lengths[B] | table c[A] (u16 if 0 < k < 16, else
    u32) | u32 CRC32[B] (if flag bit 1) | payloads in block order

:func:`layout` reads back what the roofline count needs from any
container: the payload bytes and, for rans16, the halfwords of the
interleaved regions.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"RCT1"
VERSION = 2
FLAG_CRC32 = 1 << 1
FLAG_RANS16 = 1 << 2
HEADER = struct.Struct("<4sBBBBIIQI")
SYNC_FLAG = 1 << 31


def table_dtype(k: int) -> np.dtype:
    return np.dtype("<u2") if 0 < k < 16 else np.dtype("<u4")


def pack(*, k: int, alphabet: int, block_len: int, n_symbols: int,
         lengths: np.ndarray, payload_bytes, tables_c: np.ndarray,
         with_checksums: bool, group_lanes: int = 0) -> bytes:
    """A shared-table container from its payloads, joined in block order
    (``payload_bytes``, ``lengths[b]`` bytes each).  ``group_lanes > 0``
    marks the rans16 profile."""
    lengths = np.asarray(lengths, np.int64)
    body = memoryview(payload_bytes).cast("B")
    if int(lengths.sum()) != body.nbytes:
        raise ValueError("payload lengths do not add up to the payloads")
    flags = FLAG_CRC32 if with_checksums else 0
    glog = 0
    if group_lanes:
        flags |= FLAG_RANS16
        glog = group_lanes.bit_length() - 1
    parts = [HEADER.pack(MAGIC, VERSION, flags, k, glog, alphabet, block_len,
                         n_symbols, lengths.size),
             lengths.astype("<u4").tobytes(),
             np.asarray(tables_c).astype(table_dtype(k)).tobytes()]
    if with_checksums:
        ends = np.cumsum(lengths)
        crcs = [zlib.crc32(body[e - n : e]) for e, n in
                zip(ends.tolist(), lengths.tolist())]
        parts.append(np.array(crcs, "<u4").tobytes())
    parts.append(body)
    return b"".join(parts)


def layout(blob: bytes) -> dict:
    """What a container holds, from its header and section sizes: its
    profile, alphabet, symbols, payload bytes and, for rans16, the region
    halfwords of all its groups."""
    (magic, _, flags, k, _, alphabet, _, n_symbols,
     b) = HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise ValueError(f"not a container: magic {magic!r}")
    lengths = np.frombuffer(blob, "<u4", b, HEADER.size).astype(np.int64)
    rans16 = bool(flags & FLAG_RANS16)
    per_block = bool(flags & 1)
    off = (HEADER.size + 4 * b
           + table_dtype(k).itemsize * alphabet * (b if per_block else 1)
           + (4 * b if flags & FLAG_CRC32 else 0))
    halfwords = 0
    if rans16:
        starts = off + np.concatenate([[0], np.cumsum(lengths)[:-1]])
        for s in starts.tolist():
            word = int(np.frombuffer(blob, "<u4", 1, s)[0])
            nt = word & ~SYNC_FLAG
            head = s + (8 if word & SYNC_FLAG else 4)
            halfwords += int(np.frombuffer(blob, "<u4", nt, head)
                             .astype(np.int64).sum())
    return {"profile": "rans16" if rans16 else "planar",
            "alphabet": alphabet, "n_symbols": n_symbols,
            "payload_bytes": int(lengths.sum()), "halfwords": halfwords}
