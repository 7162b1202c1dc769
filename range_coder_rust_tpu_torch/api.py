"""High-level one-call API: ``encode(data) -> bytes``, ``decode(blob) -> data``.

The PyTorch counterpart of ``range_coder_rust_tpu/api.py``.  It takes the
same ``CodecConfig``, writes the same container bytes and raises typed
errors of the same names, the port's own (:mod:`.errors`).  Each entry
point takes a ``device`` (default ``"cuda"``): the coder runs there,
each profile through its two CUDA kernels (or their plain PyTorch
versions when the device is the CPU).

Both profiles are ported whole.  rans16: one shared order-0 table or one
per group (``per_group_tables``), sync points (``sync_tiles``) with
:func:`decode_range`, and inputs of 2^31 symbols or more.  planar
(``CodecConfig``'s default): a shared pow2 table, raw-count tables
(``raw_total``), per-block tables (:mod:`.adaptive`), and the fallback
from rans16 for alphabets over 1023 symbols.

Orchestration is host-side and thin.  One planar encode serves the
three table forms (shared, raw total, per block; :func:`_encode_planar`):
it uploads the input once into a device buffer of whole ``(B, L)``
blocks, counts it there for a shared table
(:func:`.kernels.planar_histogram`), pads the last block there, runs the
device coder over chunks of ``chunk_symbols`` of that buffer, joins each
chunk's payloads on the device (:func:`.kernels.planar_compact`), copies
only those bytes into one host payload area, and packs that area; one
planar decode
(:func:`_decode_container`) serves them too.  A block that overflows its
capacity is encoded again with twice the room, never cut silently.
Decodes and reads parse the container in place (``fmt.unpack(...,
copy=False)``): the payloads stay in the blob, and each device call
uploads its slice of the payload area.  The planar
phases run in named profiler regions (``planar.upload``, the input's and
the table's; ``planar.histogram`` with ``planar.table`` inside; in a
decode ``planar.table`` around the int64 table, its prefix sum and their
upload; ``planar.pad``, the device fill of the last block,
``planar.encode_steps`` / ``planar.decode_steps``, ``planar.d2h`` (the
lengths and the joined payloads of an encode, the symbols of a decode),
``planar.compact``, ``planar.payload_bytes``, ``planar.pack``;
:func:`.utils.profiling.annotate`), as rans16's do in :mod:`.rans_codec`
and the container's (``format.unpack``, ``format.crc32``) in
:mod:`.format`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import format as fmt
from . import rans_codec
from .blocks import (decode_payloads, default_capacity, host_rows,
                     payload_buffers)
from .errors import ConfigError, ZeroFrequency
from .kernels import planar_compact, planar_encode_blocks, planar_histogram
from .kernels.histogram import ROW_TYPES
from .kernels.planar import MAX_K
from .models.table import Pow2Table, build_table_pow2
from .utils.profiling import annotate

#: cap on device working memory: symbols per device call
_CHUNK_SYMBOLS = 1 << 24


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the codec, as in the reference package."""

    #: total_freq = 2**k: k in [1, 24] for planar (above 16 the port's
    #: own: the JAX package's CodecConfig stops at 16), 16 for rans16
    k: int = 16
    #: symbols per block (L).  None picks a profile-appropriate default:
    #: 512 for planar, 65536 for rans16.
    block_len: Optional[int] = None
    with_checksums: bool = True
    chunk_symbols: int = _CHUNK_SYMBOLS
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
        if not 1 <= self.k <= MAX_K:
            raise ConfigError(f"k={self.k} out of range [1, {MAX_K}]")
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


def _as_symbols(data, alphabet: Optional[int], device=None
                ) -> tuple[np.ndarray, int]:
    """The input as a 1-D host array the codec takes (uint8, uint16 or
    int32; any other integer dtype copied to int32, in a span
    ``api.widen``) and the alphabet."""
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
    if arr.dtype in (np.uint8, np.uint16, np.int32):
        return arr, a
    with annotate("api.widen", device):
        return arr.astype(np.int32), a


def _row_dtype(symbols: np.ndarray, a: int) -> np.dtype:
    """The dtype planar rows travel at: the symbols' own, or int32 where
    symbol ``a - 1`` (a possible pad) does not fit it."""
    dt = symbols.dtype
    if dt in ROW_TYPES and a - 1 <= np.iinfo(dt).max:
        return dt
    return np.dtype(np.int32)


def _upload_symbols(symbols: np.ndarray, size: int, row_dtype: np.dtype,
                    piece: int, device) -> torch.Tensor:
    """A new ``(size,)`` buffer on ``device`` at ``row_dtype``'s width
    whose first ``symbols.size`` places hold the symbols, uploaded in
    pieces of ``piece`` symbols (the rest is left for :func:`_pad`)."""
    buf = torch.empty(size, dtype=ROW_TYPES[row_dtype][1], device=device)
    for i in range(0, symbols.size, piece):
        part = host_rows(symbols[i : i + piece].astype(row_dtype, copy=False))
        buf[i : i + part.numel()].copy_(part)
    return buf


def _pad(sym: torch.Tensor, n: int, pad_symbol: int) -> None:
    """Fill ``sym`` past its first ``n`` places with ``pad_symbol`` (u16
    rows hold int16 bits)."""
    if sym.dtype == torch.int16 and pad_symbol >= 1 << 15:
        pad_symbol -= 1 << 16
    sym[n:].fill_(pad_symbol)


def _encode_rows(sym: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                 capacity: int, **total
                 ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Encode ``(B, L)`` device rows with a total of ``2**k`` or a raw u32
    ``total`` (one keyword), again with twice the capacity while a block
    overflows; returns the code matrix and the lengths on the device, and
    the lengths on the host."""
    device = sym.device
    while True:
        with annotate("planar.encode_steps", device):
            code, lengths = planar_encode_blocks(sym, c, cum,
                                                 capacity=capacity, **total)
        with annotate("planar.d2h", device):
            lengths_np = lengths.cpu().numpy()
            if int(lengths_np.max()) <= capacity:
                return code, lengths, lengths_np
        capacity *= 2  # rare adversarial blocks


class _HostArea:
    """The payload area of one encode on the host, filled a chunk at a
    time: each chunk's payloads are joined on the device
    (:func:`.kernels.planar_compact`) and copied here in one D2H of just
    their bytes.  Its room is set from the first chunk's bytes a row, a
    quarter more, and grows (the one copy of what is there) only where a
    later chunk codes longer."""

    def __init__(self, n_rows: int):
        self.buf = np.empty(0, np.uint8)
        self.used = 0
        self.lengths = np.empty(n_rows, np.int64)

    def add(self, start: int, code: torch.Tensor, lengths: torch.Tensor,
            lengths_np: np.ndarray) -> None:
        """Rows ``start, start + 1, ...`` of the encode: their code matrix
        and lengths on the device, and the lengths on the host."""
        device, rows = code.device, lengths_np.size
        offsets = np.zeros(rows, np.int64)
        np.cumsum(lengths_np[:-1], out=offsets[1:])
        size = int(offsets[-1] + lengths_np[-1])
        need = self.used + size
        if need > self.buf.size:
            rest = self.lengths.size - start - rows
            room = max(need + rest * -(-5 * size // (4 * rows)),
                       2 * self.buf.size)
            grown = np.empty(room, np.uint8)
            grown[: self.used] = self.buf[: self.used]
            self.buf = grown
        with annotate("planar.compact", device):
            joined = planar_compact(code, lengths,
                                    torch.from_numpy(offsets).to(device),
                                    size=size)
        with annotate("planar.d2h", device):
            torch.from_numpy(self.buf[self.used : need]).copy_(joined)
        self.lengths[start : start + rows] = lengths_np
        self.used = need

    def payloads(self) -> fmt.PayloadArea:
        offsets = np.zeros(self.lengths.size + 1, np.int64)
        np.cumsum(self.lengths, out=offsets[1:])
        return fmt.PayloadArea(memoryview(self.buf)[: self.used], offsets)


def _device_tables(c, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Counts ``c`` (one table, or one a row) as int64 on ``device``, and
    their prefix sums ``cum`` (each table's with a leading 0)."""
    c = np.asarray(c, np.int64)
    cum = np.zeros(c.shape[:-1] + (c.shape[-1] + 1,), np.int64)
    np.cumsum(c, axis=-1, out=cum[..., 1:])
    return torch.from_numpy(c).to(device), torch.from_numpy(cum).to(device)


def _encode_planar(symbols: np.ndarray, a: int, config: CodecConfig, device,
                   *, k: int, c: Optional[np.ndarray] = None,
                   block_tables=None) -> bytes:
    """The planar encode of every table form, with ``config``'s
    ``block_len``, ``chunk_symbols`` and ``with_checksums``: the input
    goes up once into a device buffer of whole ``(B, L)`` rows at its
    row width, is padded there, and is coded in chunks of that buffer
    (:func:`_encode_rows`); each chunk's payloads are joined on the device
    and copied into one host area (:class:`_HostArea`), which is packed.
    The table form is one shared table of total ``2**k`` (its counts
    ``c``, or without ``c`` normalised from the uploaded input's
    :func:`.kernels.planar_histogram`), a raw u32 total (``k == 0``, the
    raw counts ``c``), or one ``2**k`` table a block (``block_tables``:
    a chunk's device rows -> their ``(c, cum)``).  The pad is the shared
    table's most frequent symbol, or 0, which per-block tables count."""
    n, L = int(symbols.size), config.block_len
    n_rows = max(1, math.ceil(n / L))
    with annotate("planar.upload", device):
        sym = _upload_symbols(symbols, n_rows * L, _row_dtype(symbols, a),
                              config.chunk_symbols, device)
    if c is None and block_tables is None:
        with annotate("planar.histogram", device):
            counts = planar_histogram(sym[:n], a).cpu().numpy().astype(
                np.uint64)
            if n == 0:
                counts[0] = 1  # an empty input: any valid table
            with annotate("planar.table", device):
                c = build_table_pow2(counts, k).c
    with annotate("planar.pad", device):
        _pad(sym, n, 0 if c is None else int(np.argmax(c)))
    if c is not None:
        with annotate("planar.upload", device):
            c_dev, cum_dev = _device_tables(c, device)
    total = {"k": k} if k else {"total": int(c.astype(np.int64).sum())}
    # worst case ceil(k/8) + 1 bytes a symbol, ~5 at 32-bit totals; + flush
    capacity = default_capacity(L, k) if k else -(-(6 * L + 8) // 4) * 4
    rows = sym.view(n_rows, L)
    rows_per_chunk = max(1, config.chunk_symbols // L)
    area, tables = _HostArea(n_rows), []
    for start in range(0, n_rows, rows_per_chunk):
        chunk = rows[start : start + rows_per_chunk]
        if block_tables is not None:
            with annotate("planar.table", device):
                c_dev, cum_dev = block_tables(chunk)
                tables.append(c_dev.cpu().numpy())
        area.add(start, *_encode_rows(chunk, c_dev, cum_dev, capacity,
                                      **total))
    with annotate("planar.pack", device):
        return fmt.pack(
            k=k,
            alphabet=a,
            block_len=L,
            n_symbols=n,
            payloads=area.payloads(),
            tables_c=np.concatenate(tables) if c is None else c,
            per_block_tables=c is None,
            with_checksums=config.with_checksums,
            device=device,
        )


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
    is supplied.  The planar profile keeps the whole input on ``device``
    at its row width (1, 2 or 4 bytes a symbol: 4 where the alphabet's
    last symbol does not fit the input's dtype) from its upload to its
    last device call, so an input larger than the device's free memory
    does not encode there; ``chunk_symbols`` bounds the code matrix of
    each call, not the input."""
    symbols, a = _as_symbols(data, alphabet, device)
    if config.raw_total:
        return _encode_raw(symbols, a, config, device)

    if config.profile == "rans16" and a > 1023:
        # the rans16 cum table holds A + 1 <= 1024 entries: wider
        # alphabets fall back to the planar profile
        if config.per_group_tables:
            raise ConfigError(
                f"alphabet {a} exceeds the rans16 limit of 1023 symbols "
                "and per_group_tables has no planar fallback; use "
                "adaptive.encode_adaptive or an alphabet <= 1023")
        config = dataclasses.replace(
            config, profile="planar", sync_tiles=0, group_lanes=None,
            block_len=None if config.block_len == 65536
            else config.block_len)

    if config.profile == "rans16" and table is None:
        return rans_codec.encode(
            symbols, alphabet=a, table=None, block_len=config.block_len,
            with_checksums=config.with_checksums,
            per_group_tables=config.per_group_tables,
            sync_tiles=config.sync_tiles, group_lanes=config.group_lanes,
            device=device)

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
        if config.profile == "rans16":
            # as in the reference, a supplied table is shared by all groups
            return rans_codec.encode(
                symbols, alphabet=a, table=table, block_len=config.block_len,
                with_checksums=config.with_checksums,
                sync_tiles=config.sync_tiles, group_lanes=config.group_lanes,
                device=device)

    # planar: one shared table, counted on the device unless supplied
    if table is None:
        return _encode_planar(symbols, a, config, device, k=config.k)
    return _encode_planar(symbols, a, config, device, k=table.k, c=table.c)


def _encode_raw(symbols: np.ndarray, a: int, config: CodecConfig,
                device) -> bytes:
    """Planar encode with the raw histogram as the table (any u32 total):
    the reference ``FreqTable``'s semantics (examples/sample_impl.rs:58-69),
    coded with exact division."""
    counts = np.bincount(symbols, minlength=a).astype(np.uint64)
    if counts.sum() == 0:
        counts[0] = 1
    if counts.sum() >= 1 << 32:
        raise ConfigError("raw_total: corpus count exceeds u32 total_freq")
    return _encode_planar(symbols, a, config, device, k=0,
                          c=counts.astype(np.uint32))


def decode(blob: bytes, *, verify_checksums: bool = True,
           device="cuda") -> np.ndarray:
    """Decompress a container back to the symbol array: rans16 in the
    narrowest unsigned dtype covering the alphabet (uint8 for byte
    corpora), planar as int32 (as the reference).

    Raises typed errors on malformed input (InvalidHeader,
    ChecksumMismatch)."""
    return _decode_container(
        fmt.unpack(blob, verify_checksums=verify_checksums, device=device,
                   copy=False),
        device)


def decode_range(blob: bytes, start: int, count: int, *,
                 verify_checksums: bool = True, device="cuda") -> np.ndarray:
    """Decode only symbols ``[start, start + count)`` of a container, as
    int32.

    Touches, and CRC-checks, only the independent units that cover the
    range: planar blocks of ``block_len`` symbols, or rans16 groups of
    ``group_lanes * block_len`` symbols; the rest of the container is
    parsed but never decoded.  Within a rans16 group it decodes only the
    step intervals the range needs, from the nearest sync point when the
    container has them (``CodecConfig.sync_tiles``)."""
    cont = fmt.unpack(blob, verify_checksums=False, device=device, copy=False)
    n = cont.n_symbols
    if start < 0 or count < 0 or start + count > n:
        raise ConfigError(
            f"range [{start}, {start + count}) outside [0, {n})")
    if count == 0:
        return np.zeros(0, np.int32)
    span = cont.block_len * (cont.group_lanes or 1)
    b0 = start // span
    b1 = -(-(start + count) // span)
    if verify_checksums and cont.checksums is not None:
        fmt.verify(cont, b0, b1, device)
    if cont.profile == "rans16":
        return _decode_range_rans16(cont, start, count, b0, b1, device)
    sub = dataclasses.replace(
        cont,
        lengths=cont.lengths[b0:b1],
        payloads=cont.payloads[b0:b1],
        checksums=None,
        tables_c=(cont.tables_c[b0:b1] if cont.per_block_tables
                  else cont.tables_c),
        n_symbols=min(n, b1 * span) - b0 * span,
    )
    lo = start - b0 * span
    return _decode_container(sub, device)[lo : lo + count]


def _decode_range_rans16(cont: fmt.Container, start: int, count: int,
                         b0: int, b1: int, device) -> np.ndarray:
    """Tile random access: per touched group, decode only the step
    intervals its lanes need (``rans_codec.decode_tile_range``); the
    touched groups' payloads are parsed, and their tables uploaded, once
    a read."""
    g, L = cont.group_lanes, cont.block_len
    span = L * g
    out = np.empty(count, np.int32)
    per_group = cont.per_block_tables
    tables = np.asarray(cont.tables_c)
    # the shared table, or the touched groups' tables, uploaded once
    with annotate("rans16.table", device):
        cums = rans_codec.cum_table(rans_codec._cums_of(
            tables[b0:b1] if per_group else tables), device)
    with annotate("rans16.parse", device):
        parses = [rans_codec._parse_payload(cont.payloads[bidx], L, g,
                                            full=True)
                  for bidx in range(b0, b1)]
    for bidx, parsed in zip(range(b0, b1), parses):
        gbase = bidx * span
        a = max(start, gbase)
        b = min(start + count, gbase + span)
        tc = tables[bidx] if per_group else tables
        cum = cums[bidx - b0] if per_group else cums
        la, sa = divmod(a - gbase, L)
        lb, sb = divmod(b - gbase - 1, L)
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


def _decode_container(cont: fmt.Container, device) -> np.ndarray:
    """Profile dispatch for a parsed container; the planar decode of every
    table form (shared, raw total, one table a block) in chunks of
    ``_CHUNK_SYMBOLS``."""
    if cont.profile == "rans16":
        return rans_codec.decode(cont, device=device)
    b, L = cont.n_blocks, cont.block_len
    per_block = cont.per_block_tables
    with annotate("planar.table", device):
        c = np.asarray(cont.tables_c, np.int64)
        # a raw-total container (FLAG_RAW_TOTAL) has k = 0
        total = {"k": cont.k} if cont.k else {"total": int(c.sum())}
        if not per_block:
            c_dev, cum_dev = _device_tables(c, device)
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    out = np.empty(b * L, np.int32)
    for start in range(0, b, rows_per_chunk):
        stop = min(start + rows_per_chunk, b)
        if per_block:
            with annotate("planar.table", device):
                c_dev, cum_dev = _device_tables(c[start:stop], device)
        with annotate("planar.payload_bytes", device):
            code, offs, lens = payload_buffers(
                cont.payloads[start:stop], cont.lengths[start:stop], device)
        with annotate("planar.decode_steps", device):
            dec = decode_payloads(code, offs, lens, c_dev, cum_dev,
                                  block_len=L, **total)
        with annotate("planar.d2h", device):
            out[start * L : stop * L] = dec.cpu().numpy().reshape(-1)
    return out[: cont.n_symbols]


def decode_bytes(blob: bytes, *, device="cuda", **kw) -> bytes:
    """Like :func:`decode` but returns raw bytes (alphabet must be <= 256)."""
    sym = decode(blob, device=device, **kw)
    return sym.astype(np.uint8).tobytes()
