"""Host orchestration for the rans16 profile: array <-> container.

The PyTorch counterpart of ``range_coder_rust_tpu/rans_codec.py``: one
shared order-0 table or one table per group (the adaptive mode), sync
points with tile random access (:func:`decode_tile_range`), and the
chunked encode of inputs of 2^31 symbols or more.  It writes the same
container bytes (``format.py``, FLAG_RANS16, container version 2) and
reads the reference's containers.

Symbol order contract: lane ``l`` of group ``g`` encodes the flat segment
``[(g * G + l) * L, (g * G + l + 1) * L)``, i.e. ``reshape(NG * G, L)``
row-major.

Per-group payload layout (container version 2):

    u32 NT | u32 region_hw[NT] (time order) | preamble (6 * G bytes,
    lane l's final state as 48-bit LE at [6l, 6l+6)) | regions 0..NT-1

With sync points (bit 31 of the NT word set; ``sync_tiles``):

    u32 NT|1<<31 | u32 sync_T | u32 region_hw[NT] | preamble |
    sync states ((NT-1)//sync_T x 6*G bytes, the decoder's lane states
    before time-tiles sync_T, 2*sync_T, ...) | regions 0..NT-1

A full decode starts from the preamble and skips the sync states.

The kernels (``kernels/rans_encode.py``, ``kernels/rans_decode.py``) run
whole groups; this module batches groups, moves the data to and from the
device, and assembles and parses the payloads.  Each phase runs in a
named profiler region (``rans16.histogram``, ``rans16.upload``,
``rans16.encode_kernel`` / ``rans16.decode_kernel``, ``rans16.d2h``,
``rans16.payloads``, ``rans16.parse``, ``rans16.pack``;
:func:`.utils.profiling.annotate`).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from . import format as fmt
from .errors import ConfigError, InvalidHeader
from .kernels.rans_decode import rans_decode_tiled
from .kernels.rans_encode import n_syncs, rans_encode_tiled, tile_steps_for
from .kernels.vreg import prep_cum_vreg, prep_cum_vreg_batch
from .models.table import Pow2Table, build_table_pow2
from .rans import GROUP_LANES
from .utils.profiling import annotate

G = GROUP_LANES

#: symbols per device call: bounds the encode's device working set (the
#: symbols at 1 B (u8) or 2 B (int16), the parked halfword 2 B and its
#: ballot bit 1/8 B, and the region capacity 2 B: 5.125 B/symbol at u8,
#: 6.125 B at int16)
_BATCH_SYMBOLS = 1 << 28

#: symbols per slab of the chunked (>= 2^31 symbols) encode, rounded down
#: to whole groups; as in the reference
_SLAB_SYMBOLS = 1 << 30

#: payload NT-word flag: sync-point section present
_SYNC_FLAG = 1 << 31


def _groups_per_call(L: int, g: int) -> int:
    return max(1, _BATCH_SYMBOLS // (g * L))


def _np_dtype(a_count: int) -> np.dtype:
    """The decoded symbols' dtype: the narrowest that holds the alphabet."""
    return np.dtype(np.uint8 if a_count <= 256
                    else np.uint16 if a_count <= 65536 else np.int32)


_TORCH_OUT = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
              np.dtype(np.int32): torch.int32}


def cum_table(cum: np.ndarray, device) -> torch.Tensor:
    """(A+1,) cum -> the kernels' (1024,) int32 padded table, or (NG, A+1)
    cums (one table per group) -> (NG, 1024), on ``device``."""
    cum = np.asarray(cum, np.uint32)
    flat = prep_cum_vreg(cum) if cum.ndim == 1 else prep_cum_vreg_batch(cum)
    return torch.from_numpy(flat.reshape(cum.shape[:-1] + (-1,))
                            .view(np.int32).copy()).to(device)


def _cums_of(tables_c: np.ndarray) -> np.ndarray:
    """(..., A) counts -> (..., A+1) cums."""
    c = np.asarray(tables_c, np.uint64)
    zero = np.zeros(c.shape[:-1] + (1,), np.uint64)
    return np.concatenate([zero, np.cumsum(c, axis=-1)], axis=-1)


def _tile_geometry(block_len: int, group_lanes: int = None
                   ) -> Tuple[int, int]:
    """(tile_steps, n_tiles) for a lane length and group width."""
    ts = tile_steps_for(group_lanes if group_lanes else G)
    tile = min(ts, block_len)
    if block_len % tile:
        raise ConfigError(
            f"rans16 block_len {block_len} must be <= {ts} or a "
            f"multiple of it")
    return tile, block_len // tile


def _shrink_lane_len(n: int, L: int, group_lanes: int = None) -> int:
    """Smallest valid lane length that still covers ``n`` symbols with one
    group, capped at the requested ``L``.  Valid lengths: any value <= the
    tile size, else multiples of it."""
    g = group_lanes if group_lanes else G
    ts = tile_steps_for(g)
    need = max(1, -(-n // g))
    if need >= L:
        return L
    if need <= ts:
        return need
    return min(L, -(-need // ts) * ts)


def _upload_rows(rows, device) -> torch.Tensor:
    """Symbol rows -> rows on ``device`` at the width the encode kernel
    reads: bytes stay ``uint8``, any other host symbols (< 1024) go up as
    ``int16``; rows already in a tensor keep their dtype."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    if rows.dtype != np.uint8:
        rows = rows.astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def _padded_rows(narrow: np.ndarray, pad_symbol: int, n_rows: int,
                 L: int) -> np.ndarray:
    """The symbols padded with ``pad_symbol`` to ``(n_rows, L)``."""
    rows = np.full(n_rows * L, pad_symbol, narrow.dtype)
    rows[: narrow.size] = narrow
    return rows.reshape(n_rows, L)


def _histogram_groups(rows: torch.Tensor, alphabet: int,
                      n_groups: int) -> np.ndarray:
    """Per-group order-0 histograms of padded rows, on their device:
    ``(n_groups, alphabet)`` uint64 counts.  One ``torch.bincount`` over
    ``group * alphabet + symbol`` for at most 2^26 symbols at a time (the
    counterpart of the reference's ``_histogram_groups``; the counts are
    exact either way)."""
    per = rows.numel() // n_groups
    flat = rows.reshape(n_groups, per)
    counts = torch.empty((n_groups, alphabet), dtype=torch.int64,
                         device=rows.device)
    step = max(1, (1 << 26) // per)
    for g0 in range(0, n_groups, step):
        part = flat[g0 : g0 + step].to(torch.int64)
        if rows.dtype == torch.int16:
            part &= 0xFFFF  # u16 bits
        nb = part.shape[0]
        part += torch.arange(nb, device=rows.device)[:, None] * alphabet
        counts[g0 : g0 + nb] = torch.bincount(
            part.view(-1), minlength=nb * alphabet).view(nb, alphabet)
    return counts.cpu().numpy().astype(np.uint64)


def _states6(states: torch.Tensor, nb: int) -> np.ndarray:
    """Lane states (any shape, ``nb`` groups first) -> ``(nb, 6 * lanes)``
    bytes: each state's low 6 bytes, little-endian (states < 2^48)."""
    x = states.cpu().numpy().astype("<u8").view(np.uint8)
    return x.reshape(nb, -1, 8)[:, :, :6].reshape(nb, -1)


def _states_tensor(states6: List, g: int, device) -> torch.Tensor:
    """Groups' 6-byte LE lane states -> (len * g,) int64 on ``device``."""
    x8 = np.zeros((len(states6), g, 8), np.uint8)
    for i, s6 in enumerate(states6):
        x8[i, :, :6] = np.frombuffer(s6, np.uint8).reshape(g, 6)
    return torch.from_numpy(x8.reshape(-1).view("<i8").copy()).to(device)


def encode_groups(symbols, table, block_len: int, group_lanes: int = None,
                  *, sync_tiles: int = 0, device="cuda") -> List[bytes]:
    """Encode (NG*g, L) padded symbol rows into per-group payload bytes.

    ``symbols``: host rows, or rows already on ``device`` (``uint8`` or
    ``int16``).  ``table``: one shared Pow2Table, or a list of NG tables,
    one per group (the adaptive mode).  ``sync_tiles=T > 0`` records each
    group's lane states every T tiles (6 B a lane a sync) for
    :func:`decode_tile_range`."""
    g = group_lanes if group_lanes else G
    n_rows, L = symbols.shape
    if L != block_len or n_rows % g:
        raise ConfigError(f"bad group geometry ({n_rows}, {L})")
    NG = n_rows // g
    tile, NT = _tile_geometry(L, g)
    if not isinstance(table, list):  # Pow2Table is a NamedTuple
        cums = cum_table(table.cum, device)
    else:
        if len(table) != NG:
            raise ConfigError(f"{len(table)} tables for {NG} groups")
        cums = cum_table(np.stack([t.cum for t in table]), device)
    n_sync = n_syncs(NT, sync_tiles)
    hdr = np.uint32(NT | (_SYNC_FLAG if n_sync else 0)).tobytes()
    if n_sync:
        hdr += np.uint32(sync_tiles).tobytes()
    gpc = _groups_per_call(L, g)
    payloads: List[bytes] = []
    for start in range(0, NG, gpc):
        stop = min(start + gpc, NG)
        nb = stop - start
        with annotate("rans16.upload", device):
            rows = _upload_rows(symbols[start * g : stop * g], device)
        with annotate("rans16.encode_kernel", device):
            states, sizes, region, syncs = rans_encode_tiled(
                rows, _batch_tables(cums, start, stop), group_lanes=g,
                tile=tile, sync_tiles=sync_tiles)
        with annotate("rans16.d2h", device):
            sizes_np = sizes.cpu().numpy()
            group_hw = sizes_np.sum(axis=1, dtype=np.int64)
            region_np = region[: int(group_hw.sum())].cpu().numpy().view("<u2")
            pre6 = _states6(states, nb)
            sync6 = (_states6(syncs, nb) if n_sync
                     else np.zeros((nb, 0), np.uint8))
        with annotate("rans16.payloads", device):
            bounds = np.concatenate([[0], np.cumsum(group_hw)])
            for bg in range(nb):
                payloads.append(
                    hdr
                    + sizes_np[bg].astype("<u4").tobytes()
                    + pre6[bg].tobytes()
                    + sync6[bg].tobytes()
                    + region_np[bounds[bg] : bounds[bg + 1]].tobytes()
                )
    return payloads


def _parse_payload(p, block_len: int, group_lanes: int = None,
                   full: bool = False):
    """One group payload -> (sizes (NT,) int64, pre6 bytes, region bytes);
    with ``full=True`` also ``(sync_T, sync6 bytes)`` (sync_T = 0 when the
    payload has no sync section).

    The tile size is derived from the payload's own NT (tile = L / NT), so
    containers written with other group widths or tile sizes parse."""
    g = group_lanes if group_lanes else G
    p = memoryview(p)
    if len(p) < 4:
        raise InvalidHeader("rans16 payload too short")
    nt_word = int(np.frombuffer(p[:4], "<u4")[0])
    nt = nt_word & ~_SYNC_FLAG
    has_sync = bool(nt_word & _SYNC_FLAG)
    if nt < 1 or block_len % nt:
        raise InvalidHeader(
            f"rans16 payload has {nt} tiles for lane length {block_len}")
    tile = block_len // nt
    off = 4
    sync_t = 0
    if has_sync:
        if len(p) < 8:
            raise InvalidHeader("rans16 payload too short for sync header")
        sync_t = int(np.frombuffer(p[4:8], "<u4")[0])
        if sync_t < 1:
            raise InvalidHeader("rans16 sync period must be >= 1")
        off = 8
    head = off + 4 * nt
    if len(p) < head:
        raise InvalidHeader("rans16 payload truncated in the size table")
    sizes = np.frombuffer(p[off:head], "<u4").astype(np.int64)
    if np.any(sizes > tile * g):
        raise InvalidHeader("rans16 tile size exceeds capacity")
    pre6 = p[head : head + 6 * g]
    off2 = head + 6 * g
    n_sync = (nt - 1) // sync_t if has_sync else 0
    sync6 = p[off2 : off2 + 6 * g * n_sync]
    off2 += 6 * g * n_sync
    if (len(pre6) != 6 * g or len(sync6) != 6 * g * n_sync
            or off2 + 2 * int(sizes.sum()) != len(p)):
        raise InvalidHeader("rans16 payload size mismatch")
    if full:
        return sizes, pre6, p[off2:], sync_t, sync6
    return sizes, pre6, p[off2:]


def decode_groups(payloads: List[bytes], table_c: np.ndarray, block_len: int,
                  group_lanes: int = None, *, device="cuda") -> np.ndarray:
    """Decode per-group payload bytes back to (NG*g, L) symbol rows, in
    the narrowest unsigned dtype of the alphabet.

    ``table_c``: (A,) shared counts, or (NG, A) per-group counts (the
    adaptive mode; uploaded as one ``(NG, 1024)`` tensor)."""
    g = group_lanes if group_lanes else G
    NG = len(payloads)
    a_count = int(table_c.shape[-1])
    cums = cum_table(_cums_of(table_c), device)
    out = np.empty((NG * g, block_len), _np_dtype(a_count))
    gpc = _groups_per_call(block_len, g)
    for start in range(0, NG, gpc):
        stop = min(start + gpc, NG)
        out[start * g : stop * g] = _decode_batch(
            payloads[start:stop], _batch_tables(cums, start, stop), a_count,
            block_len, g, device)
    return out


def _batch_tables(cums: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The tables of groups [start, stop): the shared one, or their rows."""
    return cums if cums.dim() == 1 else cums[start:stop]


def _decode_batch(payloads: List[bytes], cum: torch.Tensor, a_count: int,
                  block_len: int, g: int, device) -> np.ndarray:
    """Parse, upload and decode one batch of group payloads."""
    with annotate("rans16.parse", device):
        parsed = [_parse_payload(p, block_len, g) for p in payloads]
        NT = parsed[0][0].shape[0]
        if any(s.shape[0] != NT for s, _, _ in parsed):
            raise InvalidHeader("rans16 payloads disagree on tile count")
        group_hw = np.array([int(s.sum()) for s, _, _ in parsed], np.int64)
        region = np.frombuffer(b"".join(bytes(r) for _, _, r in parsed),
                               "<i2")
    with annotate("rans16.upload", device):
        states = _states_tensor([p6 for _, p6, _ in parsed], g, device)
        grp_off = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(group_hw)]).astype(np.int64)).to(device)
        region_dev = torch.from_numpy(region.copy()).to(device)
    out_np = _np_dtype(a_count)
    with annotate("rans16.decode_kernel", device):
        sym = rans_decode_tiled(
            states, region_dev, grp_off, cum, group_lanes=g,
            block_len=block_len, a_count=a_count,
            out_dtype=_TORCH_OUT[out_np])
    with annotate("rans16.d2h", device):
        return sym.cpu().numpy().view(out_np)


def decode_tile_range(payload, table_c: np.ndarray, block_len: int,
                      step_lo: int, step_hi: int, group_lanes: int = None,
                      *, parsed=None, cum: torch.Tensor = None,
                      device="cuda") -> Tuple[np.ndarray, int]:
    """Decode a step range of one group payload without decoding the rest.

    Starts at the nearest sync point at or before ``step_lo`` (the
    preamble when the payload has no sync section) and stops after the
    tile holding ``step_hi - 1``.  Returns ``(rows (g, steps) int32,
    step0)`` where ``rows[:, s - step0]`` is every lane's symbol at step
    ``s``.

    ``table_c`` is this group's (A,) counts.  ``parsed`` (the
    ``_parse_payload(..., full=True)`` tuple) and ``cum`` (its padded
    table on ``device``) let a caller that reads many ranges of one
    group parse and upload them once."""
    g = group_lanes if group_lanes else G
    if parsed is None:
        parsed = _parse_payload(payload, block_len, g, full=True)
    sizes, pre6, region, sync_t, sync6 = parsed
    NT = sizes.shape[0]
    tile = block_len // NT
    if not 0 <= step_lo < step_hi <= block_len:
        raise ConfigError(
            f"step range [{step_lo}, {step_hi}) outside [0, {block_len})")
    tile_lo = step_lo // tile
    tile_hi = -(-step_hi // tile)
    j = min(tile_lo // sync_t, (NT - 1) // sync_t) if sync_t else 0
    t0 = j * sync_t
    states6 = pre6 if j == 0 else sync6[(j - 1) * 6 * g : j * 6 * g]
    nt_sub = tile_hi - t0
    off_hw = int(sizes[:t0].sum())
    n_hw = int(sizes[t0:tile_hi].sum())
    region_hw = np.frombuffer(region, "<i2")[off_hw : off_hw + n_hw]
    a_count = int(table_c.shape[-1])
    if cum is None:
        cum = cum_table(_cums_of(table_c), device)
    out_np = _np_dtype(a_count)
    sym = rans_decode_tiled(
        _states_tensor([states6], g, device),
        torch.from_numpy(region_hw.copy()).to(device),
        torch.tensor([0, n_hw], dtype=torch.int64, device=device), cum,
        group_lanes=g, block_len=nt_sub * tile, a_count=a_count,
        out_dtype=_TORCH_OUT[out_np])
    rows = sym.cpu().numpy().view(out_np).astype(np.int32)
    return rows, t0 * tile


def encode(
    symbols: np.ndarray,
    *,
    alphabet: int,
    table: Pow2Table | None = None,
    block_len: int,
    with_checksums: bool = True,
    per_group_tables: bool = False,
    sync_tiles: int = 0,
    group_lanes: int = None,
    device="cuda",
) -> bytes:
    """Compress a 1-D integer symbol array into a rans16 container.

    ``block_len`` is the requested lane length; it is shrunk (to a
    multiple of the tile size, or less for tiny inputs) when the input is
    too small to fill one group at that length.  ``table=None`` builds the
    shared order-0 table from a host histogram.  ``per_group_tables=True``
    is the adaptive mode: one order-0 table per group of ``group_lanes *
    L`` symbols, from a histogram of the uploaded rows.  Inputs of 2^31
    symbols or more are encoded in slabs of whole groups
    (:func:`_encode_chunked`) into one container."""
    if table is not None and table.k != 16:
        raise ConfigError("rans16 profile requires k == 16")
    if per_group_tables and table is not None:
        raise ConfigError("per_group_tables builds its own tables")
    if alphabet > 1023:
        raise ConfigError(
            f"alphabet {alphabet} exceeds the rans16 limit of 1023 "
            "symbols (the cum table holds A+1 <= 1024 entries); use the "
            "planar profile")
    n = int(symbols.size)
    g = group_lanes if group_lanes else G
    if not (128 <= g <= 65536 and g & (g - 1) == 0):
        raise ConfigError(
            f"group_lanes {g} must be a power of two in [128, 65536]")
    _tile_geometry(block_len, g)  # validate requested geometry
    if n >= 1 << 31:
        return _encode_chunked(
            symbols, alphabet=alphabet, table=table, block_len=block_len,
            with_checksums=with_checksums,
            per_group_tables=per_group_tables, sync_tiles=sync_tiles, g=g,
            device=device)
    L = _shrink_lane_len(n, block_len, g)
    ng = max(1, math.ceil(n / (g * L)))

    narrow = (symbols if alphabet > 256
              else symbols.astype(np.uint8, copy=False))
    if per_group_tables:
        # pad with the last data symbol: it is in the last group's
        # histogram (a zero-frequency pad would be uncodable)
        pad_symbol = int(symbols[-1]) if n else 0
        with annotate("rans16.upload", device):
            rows = _upload_rows(_padded_rows(narrow, pad_symbol, ng * g, L),
                                device)
        with annotate("rans16.histogram", device):
            counts = _histogram_groups(rows, alphabet, ng)
            if n == 0:
                counts[:] = 1
            tables = [build_table_pow2(c, 16) for c in counts]
        payloads = encode_groups(rows, tables, L, g, sync_tiles=sync_tiles,
                                 device=device)
        tables_c = np.stack([t.c for t in tables])
    else:
        if table is None:
            with annotate("rans16.histogram", device):
                table = build_table_pow2(_host_counts(narrow, alphabet), 16)
        with annotate("rans16.upload", device):  # the host padding
            rows = _padded_rows(narrow, int(np.argmax(table.c)), ng * g, L)
        payloads = encode_groups(rows, table, L, g, sync_tiles=sync_tiles,
                                 device=device)
        tables_c = table.c
    with annotate("rans16.pack", device):
        return fmt.pack(
            k=16,
            alphabet=alphabet,
            block_len=L,
            n_symbols=n,
            payloads=payloads,
            tables_c=tables_c,
            per_block_tables=per_group_tables,
            with_checksums=with_checksums,
            profile="rans16",
            group_lanes=g,
        )


def _host_counts(narrow: np.ndarray, alphabet: int) -> np.ndarray:
    """The shared table's counts: a host histogram over 2^28-symbol
    slices (all ones for an empty input)."""
    n = narrow.size
    if n == 0:
        return np.ones(max(alphabet, 1), np.uint64)
    src = (narrow if narrow.dtype == np.uint8
           else narrow.astype(np.uint16, copy=False))
    counts = np.zeros(alphabet, np.int64)
    step = 1 << 28
    for i in range(0, n, step):
        counts += np.bincount(src[i : i + step],
                              minlength=alphabet)[:alphabet]
    return counts.astype(np.uint64)


def _encode_chunked(
    symbols: np.ndarray, *, alphabet: int, table, block_len: int,
    with_checksums: bool, per_group_tables: bool, sync_tiles: int, g: int,
    device="cuda", slab_symbols: int = None,
) -> bytes:
    """Encode in slabs of whole groups (``slab_symbols``, default
    ``_SLAB_SYMBOLS``, rounded down to whole groups), appending every
    slab's payloads to one container: the path for inputs of 2^31 symbols
    or more.  The lane length is not shrunk; the last slab is padded to
    whole groups.  The container is the single call's: groups are
    independent."""
    n = int(symbols.size)
    L = block_len
    span = g * L
    narrow = (symbols if symbols.dtype == np.uint8
              else symbols.astype(np.uint8) if alphabet <= 256
              else symbols.astype(np.uint16))
    slab = max(1, (slab_symbols or _SLAB_SYMBOLS) // span) * span
    if not per_group_tables and table is None:
        table = build_table_pow2(_host_counts(narrow, alphabet), 16)
    pad_symbol = (int(np.argmax(table.c)) if not per_group_tables
                  else int(narrow[-1]))

    payloads: List[bytes] = []
    tables_per_group: List[np.ndarray] = []
    for s0 in range(0, n, slab):
        part = narrow[s0 : min(s0 + slab, n)]
        ng = -(-part.size // span)
        rows = _padded_rows(part, pad_symbol, ng * g, L)
        if per_group_tables:
            rows = _upload_rows(rows, device)
            slab_tables = [build_table_pow2(c, 16)
                           for c in _histogram_groups(rows, alphabet, ng)]
            payloads += encode_groups(rows, slab_tables, L, g,
                                      sync_tiles=sync_tiles, device=device)
            tables_per_group += [t.c for t in slab_tables]
        else:
            payloads += encode_groups(rows, table, L, g,
                                      sync_tiles=sync_tiles, device=device)
    return fmt.pack(
        k=16,
        alphabet=alphabet,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=(np.stack(tables_per_group) if per_group_tables
                  else table.c),
        per_block_tables=per_group_tables,
        with_checksums=with_checksums,
        profile="rans16",
        group_lanes=g,
    )


def decode(cont: fmt.Container, *, device="cuda") -> np.ndarray:
    """Decompress a parsed rans16 container back to the symbol array."""
    if cont.profile != "rans16":
        raise ConfigError("not a rans16 container")
    gl = cont.group_lanes
    if gl < 128 or gl % 128:
        raise ConfigError(
            f"container group_lanes {gl} is not a multiple of 128")
    rows = decode_groups(cont.payloads, np.asarray(cont.tables_c),
                         cont.block_len, gl, device=device)
    return rows.reshape(-1)[: cont.n_symbols]
