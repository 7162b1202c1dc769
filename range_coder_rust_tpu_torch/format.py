"""The container format, the port's own copy.

A copy of ``range_coder_rust_tpu/format.py`` that raises the port's typed
errors: ``pack`` and ``unpack`` write and read the same bytes as the JAX
package's (``tests/test_torch_import.py`` holds the two equal), so each
package reads the other's containers.

The reference emits a bare byte stream with **no framing at all**: the
caller must carry the symbol count, the model, and stream boundaries
out-of-band (reference examples/sample_impl.rs:113-120 passes the count and
the table by hand; SURVEY.md §3 Stack E).  Block-parallel coding needs a
container: this module defines a compact, versioned, self-describing layout
that records everything the decoder needs, localizes corruption to one
block (per-block CRC32), and makes any block independently decodable (the
checkpoint/resume property, SURVEY.md §5).

Layout (all integers little-endian):

    offset  size  field
    0       4     magic  b"RCT1"
    4       1     version (= 1)
    5       1     flags   bit0 per-block tables, bit1 per-block CRC32,
                          bit2 rans16 profile
    6       1     k       (total_freq = 2**k)
    7       1     log2(lanes per group) for rans16, else 0
    8       4     alphabet size A
    12      4     block length L (symbols per block / per rans16 lane)
    16      8     total symbol count N (last block may be partial)
    24      4     block count B (= ceil(N / L), >= 1; rans16: group count,
                  = ceil(N / (G * L)))
    28      4*B   per-block payload lengths (bytes, incl. 8-byte flush;
                  rans16: per-group stream lengths incl. the 8*G preamble)
    ...     table c values, uint16[A] if k < 16 else uint32[A]:
              shared mode: one table; per-block mode: B tables
    ...     per-block CRC32, uint32[B]            (if flag bit1)
    ...     payloads, concatenated in block order

The pad symbol for a partial last block is the table's most frequent
symbol; N truncates it away on decode.

The rans16 profile (flag bit2) reuses the same container with payload =
one interleaved group stream per "block" (rans.py layout: 8-byte-per-lane
state preamble + halfword region section).  ``k`` must be 16; per-block mode
stores one table PER GROUP (the adaptive rans16 profile).

``unpack`` parses a container in place: the payloads stay where they lie
in the blob, one read-only view of the payload area and the payloads'
offsets in it (:class:`PayloadArea`), and only the public form
(``copy=True``, the default) copies them out as ``bytes``, counted by
:func:`copied_payload_bytes`.  The api's decodes and reads take the
in-place form (``copy=False``) and slice the area only where they need a
payload.

``unpack`` runs in a named profiler region ``format.unpack``, and every
CRC32 pass (``pack``'s checksums, ``unpack``'s verify, a range read's
check of the units it touches: :func:`verify`) in one ``format.crc32``
region a call (:func:`.utils.profiling.annotate`; ``device`` gives them
an NVTX range on CUDA).
"""

from __future__ import annotations

import dataclasses
import operator
import struct
import zlib
from collections.abc import Iterator, Sequence
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .errors import ChecksumMismatch, InvalidHeader
from .utils.profiling import annotate

MAGIC = b"RCT1"
#: container version.  2 = round-3 rans16 payload layout (per-tile region
#: sizes + 48-bit preamble states); version-1 planar/raw containers are
#: still readable (their payload layout never changed), version-1 rans16
#: containers are rejected with a clear error.  NEW containers of every
#: profile write version 2 on purpose: pre-1.0 there is one current
#: writer version, and readers accept both.
VERSION = 2

FLAG_PER_BLOCK_TABLES = 1 << 0
FLAG_CRC32 = 1 << 1
FLAG_RANS16 = 1 << 2
#: raw (un-normalized) u32 table: total_freq = sum(c), any u32 value —
#: the reference's PModel contract (src/pmodel.rs:6-10); k is stored as 0
FLAG_RAW_TOTAL = 1 << 3

_HEADER = struct.Struct("<4sBBBBIIQI")  # through block count B
HEADER_BYTES = _HEADER.size

#: payload bytes ``unpack`` has copied out of blobs (its public form)
_copied_payload_bytes = 0


def copied_payload_bytes() -> int:
    """Payload bytes ``unpack`` has copied out of blobs so far: the
    public form's ``bytes`` payloads; the in-place parse copies none."""
    return _copied_payload_bytes


def reset_copied_payload_bytes() -> None:
    global _copied_payload_bytes
    _copied_payload_bytes = 0


class PayloadArea(Sequence):
    """A container's payloads where they lie: one read-only ``memoryview``
    of the payload area (``area``) and the ``(B + 1,)`` int64 offsets of
    the payloads in it (``offsets``: 0, then the cumulative lengths).

    Indexing gives payload ``i`` as a ``memoryview`` slice; a slice gives
    the area of those payloads, its offsets rebased to its first.  No
    payload byte is copied, and no object is made a payload until one is
    asked for."""

    __slots__ = ("area", "offsets")

    def __init__(self, area: memoryview, offsets: np.ndarray):
        self.area = area
        self.offsets = offsets

    def __len__(self) -> int:
        return self.offsets.size - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                raise ValueError("a payload area slices with step 1 only")
            hi = max(lo, hi)
            a, b = int(self.offsets[lo]), int(self.offsets[hi])
            return PayloadArea(self.area[a:b], self.offsets[lo : hi + 1] - a)
        i = operator.index(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError("payload index out of range")
        return self.area[int(self.offsets[i]) : int(self.offsets[i + 1])]

    def __iter__(self) -> Iterator[memoryview]:
        offs = self.offsets.tolist()
        area = self.area
        return (area[a:b] for a, b in zip(offs, offs[1:]))


@dataclass(frozen=True)
class Container:
    """Parsed container: header fields + raw sections.  ``payloads`` is
    a list of ``bytes`` from the public ``unpack``, a :class:`PayloadArea`
    over the blob from ``unpack(..., copy=False)``."""

    k: int
    alphabet: int
    block_len: int
    n_symbols: int
    lengths: np.ndarray  # (B,) int64
    tables_c: np.ndarray  # shared: (A,) uint32; per-block: (B, A) uint32
    per_block_tables: bool
    checksums: Optional[np.ndarray]  # (B,) uint32 or None
    payloads: Sequence  # bytes; memoryviews in a PayloadArea (copy=False)
    profile: str = "planar"  # "planar" | "rans16"
    group_lanes: int = 0  # lanes per group (rans16 only)

    @property
    def n_blocks(self) -> int:
        return int(self.lengths.shape[0])


def _table_dtype(k: int) -> np.dtype:
    # c values sum to 2**k; a single value can equal 2**16 when k == 16.
    # k == 0 = raw mode: arbitrary u32 counts.
    return np.dtype("<u2") if 0 < k < 16 else np.dtype("<u4")


def pack(
    *,
    k: int,
    alphabet: int,
    block_len: int,
    n_symbols: int,
    payloads: List[bytes],
    tables_c: np.ndarray,
    per_block_tables: bool = False,
    with_checksums: bool = True,
    profile: str = "planar",
    group_lanes: int = 0,
    device=None,
) -> bytes:
    """Assemble a container from per-block payloads and table(s).
    ``device`` names where the caller codes, for the profiler regions."""
    b = len(payloads)
    if b < 1:
        raise ValueError("need at least one block")
    flags = (FLAG_PER_BLOCK_TABLES if per_block_tables else 0) | (
        FLAG_CRC32 if with_checksums else 0
    )
    raw_total = k == 0
    if raw_total:
        if profile != "planar" or per_block_tables:
            raise ValueError("raw-total tables: shared planar mode only")
        flags |= FLAG_RAW_TOTAL
    glog = 0
    if profile == "rans16":
        if k != 16:
            raise ValueError("rans16 profile requires k == 16")
        if group_lanes < 1 or group_lanes & (group_lanes - 1):
            raise ValueError(f"group_lanes {group_lanes} must be a power of 2")
        flags |= FLAG_RANS16
        glog = group_lanes.bit_length() - 1
    elif profile != "planar":
        raise ValueError(f"unknown profile {profile!r}")
    tables_c = np.asarray(tables_c, dtype=np.uint32)
    want_shape = (b, alphabet) if per_block_tables else (alphabet,)
    if tables_c.shape != want_shape:
        raise ValueError(f"tables_c shape {tables_c.shape} != {want_shape}")

    out = bytearray()
    out += _HEADER.pack(
        MAGIC, VERSION, flags, k, glog, alphabet, block_len, n_symbols, b
    )
    lengths = np.array([len(p) for p in payloads], dtype="<u4")
    out += lengths.tobytes()
    out += np.ascontiguousarray(tables_c, dtype=_table_dtype(k)).tobytes()
    if with_checksums:
        out += crc32s(payloads, device).tobytes()
    for p in payloads:
        out += p
    return bytes(out)


def crc32s(payloads, device=None) -> np.ndarray:
    """The CRC32 of each payload (any byte buffers), ``<u4``: the one
    CRC32 loop of the container format, in one ``format.crc32``
    region."""
    with annotate("format.crc32", device):
        return np.array([zlib.crc32(p) for p in payloads], dtype="<u4")


def verify(cont: Container, lo: int = 0, hi: Optional[int] = None,
           device=None) -> None:
    """Check units ``[lo, hi)`` (default: all) of a container with
    checksums against their stored CRC32s; raises
    :class:`ChecksumMismatch` for the first that differs."""
    hi = cont.n_blocks if hi is None else hi
    actual = crc32s(cont.payloads[lo:hi], device)
    bad = np.flatnonzero(actual != cont.checksums[lo:hi])
    if bad.size:
        i = lo + int(bad[0])
        raise ChecksumMismatch(i, int(cont.checksums[i]),
                               int(actual[i - lo]))


def unpack(blob: bytes, *, verify_checksums: bool = True,
           device=None, copy: bool = True) -> Container:
    """Parse + validate a container (typed errors, never panics —
    SURVEY.md §5 failure-detection requirement).  ``device`` names where
    the caller decodes, for the profiler regions.

    ``copy=False`` leaves the payloads in the blob (a
    :class:`PayloadArea`), for a caller that is done with the container
    before the blob changes; the default copies them out as ``bytes``."""
    global _copied_payload_bytes
    with annotate("format.unpack", device):
        cont = _parse(blob)
        if verify_checksums and cont.checksums is not None:
            verify(cont, device=device)
        if copy:
            _copied_payload_bytes += int(cont.payloads.offsets[-1])
            cont = dataclasses.replace(
                cont, payloads=[p.tobytes() for p in cont.payloads])
        return cont


def _parse(blob: bytes) -> Container:
    """The header, lengths, tables and checksums of a container, and its
    payloads where they lie in ``blob``, validated."""
    mv = memoryview(blob).toreadonly()
    size = mv.nbytes
    if size < HEADER_BYTES:
        raise InvalidHeader(f"container too short: {size} bytes")
    magic, version, flags, k, glog, alphabet, block_len, n_symbols, b = (
        _HEADER.unpack_from(mv))
    if magic != MAGIC:
        raise InvalidHeader(f"bad magic {magic!r}")
    if version not in (1, VERSION):
        raise InvalidHeader(f"unsupported version {version}")
    if version == 1 and flags & FLAG_RANS16:
        raise InvalidHeader(
            "version-1 rans16 container: the rans16 payload layout changed "
            "in version 2 (per-tile sizes, 48-bit preamble); re-encode"
        )
    raw_total = bool(flags & FLAG_RAW_TOTAL)
    if raw_total:
        if k != 0:
            raise InvalidHeader(f"raw-total container with k={k}")
    elif not 1 <= k <= 16:
        raise InvalidHeader(f"k={k} out of range [1, 16]")
    if alphabet < 1 or block_len < 1 or b < 1:
        raise InvalidHeader(
            f"bad geometry: alphabet={alphabet} block_len={block_len} blocks={b}"
        )
    per_block = bool(flags & FLAG_PER_BLOCK_TABLES)
    has_crc = bool(flags & FLAG_CRC32)
    is_rans = bool(flags & FLAG_RANS16)
    if raw_total and (per_block or is_rans):
        raise InvalidHeader("raw-total container: shared planar mode only")
    group_lanes = 0
    if is_rans:
        if k != 16:
            raise InvalidHeader("rans16 container with k != 16")
        if not 0 < glog <= 16:
            raise InvalidHeader(f"rans16 container with bad group log {glog}")
        group_lanes = 1 << glog
    span = block_len * (group_lanes if is_rans else 1)
    if n_symbols > b * span:
        raise InvalidHeader(
            f"n_symbols={n_symbols} exceeds {b} units x {span}"
        )
    if (b - 1) * span >= n_symbols > 0:
        raise InvalidHeader(
            f"n_symbols={n_symbols} needs fewer than {b} units of {span}"
        )

    off = HEADER_BYTES

    def take(dtype, count: int, what: str) -> np.ndarray:
        """The next ``count`` items of ``dtype``, read in place."""
        nonlocal off
        n = np.dtype(dtype).itemsize * count
        if off + n > size:
            raise InvalidHeader(f"container truncated in {what}")
        items = np.frombuffer(mv, dtype, count, off)
        off += n
        return items

    lengths = take("<u4", b, "lengths").astype(np.int64)
    n_tables = b if per_block else 1
    tables = take(_table_dtype(k), alphabet * n_tables, "tables").astype(
        np.uint32)
    tables = tables.reshape(b, alphabet) if per_block else tables.reshape(alphabet)
    # validate table sums
    sums = tables.sum(axis=-1, dtype=np.int64)
    if raw_total:
        if not np.all((sums >= 1) & (sums < 1 << 32)):
            raise InvalidHeader(f"raw table total {np.unique(sums)} not in u32")
    elif not np.all(sums == 1 << k):
        raise InvalidHeader(f"table sums {np.unique(sums)} != 2**{k}")

    checksums = None
    if has_crc:
        checksums = take("<u4", b, "checksums").copy()

    # the payloads: bounds checked over the offsets at once, then left
    # where they lie
    offsets = np.zeros(b + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    room = size - off
    if offsets[-1] > room:
        i = int(np.argmax(offsets[1:] > room))
        raise InvalidHeader(f"container truncated in payload {i}")
    if offsets[-1] != room:
        raise InvalidHeader(
            f"{room - int(offsets[-1])} trailing bytes after payloads")
    payloads = PayloadArea(mv[off:], offsets)

    return Container(
        k=k,
        alphabet=alphabet,
        block_len=block_len,
        n_symbols=n_symbols,
        lengths=lengths,
        tables_c=tables,
        per_block_tables=per_block,
        checksums=checksums,
        payloads=payloads,
        profile="rans16" if is_rans else "planar",
        group_lanes=group_lanes,
    )
