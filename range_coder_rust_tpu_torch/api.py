"""High-level one-call API: ``encode(data) -> bytes``, ``decode(blob) -> data``.

The PyTorch counterpart of ``range_coder_rust_tpu/api.py``.  It takes the
same ``CodecConfig``, writes the same container bytes and raises typed
errors of the same names, the port's own (:mod:`.errors`).  Each entry
point takes a ``device`` (default ``"cuda"``): the coder runs its CUDA
kernels there, or their plain PyTorch versions when the device is the CPU.

The rans16 profile is ported whole: one shared order-0 table or one per
group (``per_group_tables``), sync points (``sync_tiles``) with
:func:`decode_range`, and inputs of 2^31 symbols or more.  The paths not
ported yet raise ``NotImplementedError`` naming their ROADMAP.md item:
the planar profile (``CodecConfig``'s default), raw-total tables and the
planar fallback for alphabets over 1023 symbols.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

from . import format as fmt
from . import rans_codec
from .errors import ChecksumMismatch, ConfigError, ZeroFrequency
from .models.table import Pow2Table
from .rans_codec import not_ported


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the codec, as in the reference package."""

    k: int = 16  # total_freq = 2**k
    #: symbols per block (L).  None picks a profile-appropriate default:
    #: 512 for planar, 65536 for rans16.
    block_len: Optional[int] = None
    with_checksums: bool = True
    chunk_symbols: int = 1 << 24
    #: "planar" = block-parallel range coder; "rans16" = interleaved word
    #: rANS (requires k == 16)
    profile: str = "planar"
    #: use the raw symbol histogram as the table (planar only)
    raw_total: bool = False
    #: adaptive rans16: one order-0 table per group
    per_group_tables: bool = False
    #: rans16 group width (lanes per group, a power of two in
    #: [128, 65536]).  None = rans_codec.GROUP_LANES (2048).
    group_lanes: Optional[int] = None
    #: rans16 tile random access: lane states every ``sync_tiles`` tiles
    sync_tiles: int = 0

    def __post_init__(self):
        if not 1 <= self.k <= 16:
            raise ConfigError(f"k={self.k} out of range [1, 16]")
        if self.block_len is None:
            object.__setattr__(
                self, "block_len",
                65536 if self.profile == "rans16" else 512)
        if self.block_len < 1:
            raise ConfigError(f"block_len={self.block_len} must be >= 1")
        if self.profile not in ("planar", "rans16"):
            raise ConfigError(f"unknown profile {self.profile!r}")
        if self.profile == "rans16" and self.k != 16:
            raise ConfigError("rans16 profile requires k == 16")
        if self.raw_total and self.profile != "planar":
            raise ConfigError("raw_total requires the planar profile")
        if self.per_group_tables and self.profile != "rans16":
            raise ConfigError(
                "per_group_tables is the adaptive rans16 mode; for planar "
                "per-block tables use adaptive.encode_adaptive")
        if self.sync_tiles < 0:
            raise ConfigError("sync_tiles must be >= 0")
        if self.sync_tiles and self.profile != "rans16":
            raise ConfigError(
                "sync_tiles is rans16 tile random access; planar blocks "
                "are already independently decodable")
        if self.group_lanes is not None:
            if self.profile != "rans16":
                raise ConfigError("group_lanes applies to rans16 only")
            g = self.group_lanes
            if not (128 <= g <= 65536 and g & (g - 1) == 0):
                raise ConfigError(
                    f"group_lanes {g} must be a power of two in "
                    "[128, 65536]")


def _as_symbols(data, alphabet: Optional[int]) -> tuple[np.ndarray, int]:
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    if arr.size and arr.dtype.kind != "u" and int(arr.min()) < 0:
        raise ConfigError("negative symbol indices")
    inferred = int(arr.max()) + 1 if arr.size else 1
    a = alphabet if alphabet is not None else max(inferred, 1)
    if inferred > a:
        raise ConfigError(f"symbol {inferred - 1} outside alphabet of {a}")
    # keep narrow unsigned dtypes: byte corpora stay 1 B/symbol
    if arr.dtype in (np.uint8, np.uint16):
        return arr, a
    return arr.astype(np.int32), a


def encode(
    data,
    *,
    alphabet: Optional[int] = None,
    config: CodecConfig = CodecConfig(),
    table: Optional[Pow2Table] = None,
    device="cuda",
) -> bytes:
    """Compress ``data`` (bytes or 1-D integer array) into a container.

    A shared order-0 table is built from the data's histogram unless one
    is supplied."""
    symbols, a = _as_symbols(data, alphabet)
    if config.raw_total:
        raise not_ported("raw_total tables")
    if config.profile != "rans16":
        raise not_ported("the planar profile")
    if a > 1023 and config.per_group_tables:
        raise ConfigError(
            f"alphabet {a} exceeds the rans16 limit of 1023 symbols "
            "and per_group_tables has no planar fallback; use an "
            "alphabet <= 1023")
    if a > 1023:
        raise not_ported(
            f"the planar fallback for a {a}-symbol alphabet")
    if table is not None:
        if table.alphabet < a:
            raise ConfigError(
                f"table covers {table.alphabet} symbols, data needs {a}")
        a = table.alphabet
        present = np.zeros(a, bool)
        present[np.unique(symbols)] = True
        if np.any(present & (table.c == 0)):
            raise ZeroFrequency(
                "data contains symbols with zero frequency in the given table")
    return rans_codec.encode(
        symbols,
        alphabet=a,
        table=table,
        block_len=config.block_len,
        with_checksums=config.with_checksums,
        # as in the reference, a supplied table is shared by all groups
        per_group_tables=config.per_group_tables and table is None,
        sync_tiles=config.sync_tiles,
        group_lanes=config.group_lanes,
        device=device,
    )


def decode(blob: bytes, *, verify_checksums: bool = True,
           device="cuda") -> np.ndarray:
    """Decompress a container back to the symbol array, in the narrowest
    unsigned dtype covering the alphabet (uint8 for byte corpora).

    Raises typed errors on malformed input (InvalidHeader,
    ChecksumMismatch)."""
    cont = fmt.unpack(blob, verify_checksums=verify_checksums)
    if cont.profile != "rans16":
        raise not_ported("decoding planar containers")
    return rans_codec.decode(cont, device=device)


def decode_range(blob: bytes, start: int, count: int, *,
                 verify_checksums: bool = True, device="cuda") -> np.ndarray:
    """Decode only symbols ``[start, start + count)`` of a container, as
    int32.

    Touches, and CRC-checks, only the groups of ``group_lanes *
    block_len`` symbols that cover the range; the rest of the container
    is parsed but never decoded.  Within a group it decodes only the step
    intervals the range needs, from the nearest sync point when the
    container has them (``CodecConfig.sync_tiles``)."""
    cont = fmt.unpack(blob, verify_checksums=False)
    n = cont.n_symbols
    if start < 0 or count < 0 or start + count > n:
        raise ConfigError(
            f"range [{start}, {start + count}) outside [0, {n})")
    if count == 0:
        return np.zeros(0, np.int32)
    if cont.profile != "rans16":
        raise not_ported("decode_range of planar containers")
    span = cont.block_len * cont.group_lanes
    b0 = start // span
    b1 = -(-(start + count) // span)
    if verify_checksums and cont.checksums is not None:
        for i in range(b0, b1):
            actual = zlib.crc32(cont.payloads[i])
            if actual != int(cont.checksums[i]):
                raise ChecksumMismatch(i, int(cont.checksums[i]), actual)
    return _decode_range_rans16(cont, start, count, b0, b1, device)


def _decode_range_rans16(cont: fmt.Container, start: int, count: int,
                         b0: int, b1: int, device) -> np.ndarray:
    """Tile random access: per touched group, decode only the step
    intervals its lanes need (``rans_codec.decode_tile_range``), each
    parse and table upload made once per group."""
    g, L = cont.group_lanes, cont.block_len
    span = L * g
    out = np.empty(count, np.int32)
    per_group = cont.per_block_tables
    tables = np.asarray(cont.tables_c)
    # the shared table, or the touched groups' tables, uploaded once
    cums = rans_codec.cum_table(rans_codec._cums_of(
        tables[b0:b1] if per_group else tables), device)
    for bidx in range(b0, b1):
        gbase = bidx * span
        a = max(start, gbase)
        b = min(start + count, gbase + span)
        tc = tables[bidx] if per_group else tables
        cum = cums[bidx - b0] if per_group else cums
        la, sa = divmod(a - gbase, L)
        lb, sb = divmod(b - gbase - 1, L)
        parsed = rans_codec._parse_payload(cont.payloads[bidx], L, g,
                                           full=True)
        if lb > la + 1:
            intervals = [(0, L, None)]  # the middle lanes need every step
        elif lb == la:
            intervals = [(sa, sb + 1, None)]
        elif parsed[3]:  # two adjacent lanes, with sync points
            intervals = [(sa, L, la), (0, sb + 1, lb)]
        else:
            # without sync points the tail interval decodes from step 0
            # anyway: one pass over the whole lane does less work
            intervals = [(0, L, None)]
        ps = np.arange(a, b)
        lanes = (ps - gbase) // L
        steps = (ps - gbase) % L
        for s0, s1, only_lane in intervals:
            rows, step0 = rans_codec.decode_tile_range(
                cont.payloads[bidx], tc, L, s0, s1, g, parsed=parsed,
                cum=cum, device=device)
            sel = (lanes == only_lane if only_lane is not None
                   else np.ones(ps.size, bool))
            out[ps[sel] - start] = rows[lanes[sel], steps[sel] - step0]
    return out


def decode_bytes(blob: bytes, *, device="cuda", **kw) -> bytes:
    """Like :func:`decode` but returns raw bytes (alphabet must be <= 256)."""
    sym = decode(blob, device=device, **kw)
    return sym.astype(np.uint8).tobytes()
