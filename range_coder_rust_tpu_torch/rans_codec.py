"""Host orchestration for the rans16 profile: array <-> container.

The PyTorch counterpart of ``range_coder_rust_tpu/rans_codec.py`` for the
main path, one shared order-0 table.  It writes the same container bytes
(``format.py``, FLAG_RANS16, container version 2) and reads the
reference's containers.

Symbol order contract: lane ``l`` of group ``g`` encodes the flat segment
``[(g * G + l) * L, (g * G + l + 1) * L)``, i.e. ``reshape(NG * G, L)``
row-major.

Per-group payload layout (container version 2):

    u32 NT | u32 region_hw[NT] (time order) | preamble (6 * G bytes,
    lane l's final state as 48-bit LE at [6l, 6l+6)) | regions 0..NT-1

A payload with sync points (bit 31 of the NT word; the reference's
``sync_tiles``) carries ``u32 sync_T`` after the NT word and the sync
states after the preamble.  It decodes here like any other: the decoder
starts from the preamble and skips the sync states.

The kernels (``kernels/rans_encode.py``, ``kernels/rans_decode.py``) run
whole groups; this module batches groups, moves the data to and from the
device, and assembles and parses the payloads.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from . import format as fmt
from .errors import ConfigError, InvalidHeader
from .kernels.rans_decode import rans_decode_tiled
from .kernels.rans_encode import rans_encode_tiled, tile_steps_for
from .kernels.vreg import prep_cum_vreg
from .models.table import Pow2Table, build_table_pow2

#: default lanes per group; equals the reference's ``rans.GROUP_LANES``
GROUP_LANES = 2048
G = GROUP_LANES

#: symbols per device call: bounds the encode's device working set (the
#: symbols at 1 B (u8) or 2 B (int16), the parked halfword 2 B and its
#: ballot bit 1/8 B, and the region capacity 2 B: 5.125 B/symbol at u8,
#: 6.125 B at int16)
_BATCH_SYMBOLS = 1 << 28

#: payload NT-word flag: sync-point section present
_SYNC_FLAG = 1 << 31

#: where each path outside this slice stands in ROADMAP.md
_ROADMAP = {
    "per_group_tables": "Queue A item 6 (adaptive rans16, one table per group)",
    "sync_tiles": "Queue A item 7 (tile random access)",
    "chunked": "Queue A item 8 (chunked encode of >= 2^31 symbols)",
    "planar": "Queue A item 10 (planar profile)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {_ROADMAP[item]}")


def _groups_per_call(L: int, g: int) -> int:
    return max(1, _BATCH_SYMBOLS // (g * L))


def _np_dtype(a_count: int) -> np.dtype:
    """The decoded symbols' dtype: the narrowest that holds the alphabet."""
    return np.dtype(np.uint8 if a_count <= 256
                    else np.uint16 if a_count <= 65536 else np.int32)


_TORCH_OUT = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
              np.dtype(np.int32): torch.int32}


def cum_table(cum: np.ndarray, device) -> torch.Tensor:
    """(A+1,) cum -> the kernels' (1024,) int32 padded table on ``device``."""
    flat = prep_cum_vreg(np.asarray(cum, np.uint32)).reshape(-1)
    return torch.from_numpy(flat.view(np.int32).copy()).to(device)


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


def _upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """Host symbol rows -> rows on ``device`` at the width the encode
    kernel reads: bytes stay ``uint8``, any other symbols (< 1024) go up
    as ``int16``."""
    if rows.dtype != np.uint8:
        rows = rows.astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def encode_groups(symbols: np.ndarray, table: Pow2Table, block_len: int,
                  group_lanes: int = None, *, device="cuda") -> List[bytes]:
    """Encode (NG*g, L) padded symbol rows into per-group payload bytes,
    with one shared table."""
    g = group_lanes if group_lanes else G
    n_rows, L = symbols.shape
    if L != block_len or n_rows % g:
        raise ConfigError(f"bad group geometry ({n_rows}, {L})")
    NG = n_rows // g
    tile, NT = _tile_geometry(L, g)
    cum = cum_table(table.cum, device)
    hdr_nt = np.uint32(NT).tobytes()
    gpc = _groups_per_call(L, g)
    payloads: List[bytes] = []
    for start in range(0, NG, gpc):
        stop = min(start + gpc, NG)
        nb = stop - start
        rows = _upload_rows(symbols[start * g : stop * g], device)
        states, sizes, region = rans_encode_tiled(
            rows, cum, group_lanes=g, tile=tile)
        sizes_np = sizes.cpu().numpy()
        group_hw = sizes_np.sum(axis=1, dtype=np.int64)
        region_np = region[: int(group_hw.sum())].cpu().numpy().view("<u2")
        # 48-bit preamble: the low 6 bytes of each lane's LE u64 state
        pre6 = (states.cpu().numpy().astype("<u8").view(np.uint8)
                .reshape(nb, g, 8)[:, :, :6])
        bounds = np.concatenate([[0], np.cumsum(group_hw)])
        for bg in range(nb):
            payloads.append(
                hdr_nt
                + sizes_np[bg].astype("<u4").tobytes()
                + pre6[bg].tobytes()
                + region_np[bounds[bg] : bounds[bg + 1]].tobytes()
            )
    return payloads


def _parse_payload(p, block_len: int, group_lanes: int = None):
    """One group payload -> (sizes (NT,) int64, pre6 bytes, region bytes).

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
    return sizes, pre6, p[off2:]


def decode_groups(payloads: List[bytes], table_c: np.ndarray, block_len: int,
                  group_lanes: int = None, *, device="cuda") -> np.ndarray:
    """Decode per-group payload bytes back to (NG*g, L) symbol rows, in
    the narrowest unsigned dtype of the alphabet."""
    g = group_lanes if group_lanes else G
    if table_c.ndim != 1:
        raise not_ported("rans16 with one table per group", "per_group_tables")
    NG = len(payloads)
    a_count = int(table_c.shape[0])
    cum = cum_table(np.concatenate([[0], np.cumsum(table_c)]), device)
    out = np.empty((NG * g, block_len), _np_dtype(a_count))
    gpc = _groups_per_call(block_len, g)
    for start in range(0, NG, gpc):
        stop = min(start + gpc, NG)
        out[start * g : stop * g] = _decode_batch(
            payloads[start:stop], cum, a_count, block_len, g, device)
    return out


def _decode_batch(payloads: List[bytes], cum: torch.Tensor, a_count: int,
                  block_len: int, g: int, device) -> np.ndarray:
    """Parse, upload and decode one batch of group payloads."""
    nb = len(payloads)
    parsed = [_parse_payload(p, block_len, g) for p in payloads]
    NT = parsed[0][0].shape[0]
    if any(s.shape[0] != NT for s, _, _ in parsed):
        raise InvalidHeader("rans16 payloads disagree on tile count")
    group_hw = np.array([int(s.sum()) for s, _, _ in parsed], np.int64)
    region = np.frombuffer(b"".join(bytes(r) for _, _, r in parsed), "<i2")
    pre8 = np.zeros((nb, g, 8), np.uint8)
    for i, (_, p6, _) in enumerate(parsed):
        pre8[i, :, :6] = np.frombuffer(p6, np.uint8).reshape(g, 6)
    states = torch.from_numpy(pre8.reshape(-1).view("<i8").copy()).to(device)
    grp_off = torch.from_numpy(
        np.concatenate([[0], np.cumsum(group_hw)]).astype(np.int64)).to(device)
    out_np = _np_dtype(a_count)
    sym = rans_decode_tiled(
        states, torch.from_numpy(region.copy()).to(device), grp_off, cum,
        group_lanes=g, block_len=block_len, a_count=a_count,
        out_dtype=_TORCH_OUT[out_np])
    return sym.cpu().numpy().view(out_np)


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
    shared order-0 table from a host histogram."""
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
    if per_group_tables:
        raise not_ported("rans16 per_group_tables", "per_group_tables")
    if sync_tiles:
        raise not_ported("rans16 sync_tiles", "sync_tiles")
    if n >= 1 << 31:
        raise not_ported("rans16 encode of >= 2^31 symbols", "chunked")
    L = _shrink_lane_len(n, block_len, g)
    ng = max(1, math.ceil(n / (g * L)))

    narrow = (symbols if alphabet > 256
              else symbols.astype(np.uint8, copy=False))
    if table is None:
        if n == 0:
            counts = np.ones(max(alphabet, 1), np.uint64)
        else:
            hist_src = (narrow if narrow.dtype == np.uint8
                        else narrow.astype(np.uint16, copy=False))
            counts = np.zeros(alphabet, np.int64)
            step = 1 << 28
            for i in range(0, n, step):
                counts += np.bincount(
                    hist_src[i : i + step], minlength=alphabet)[:alphabet]
            counts = counts.astype(np.uint64)
        table = build_table_pow2(counts, 16)
    pad_symbol = int(np.argmax(table.c))
    rows_host = np.full(ng * g * L, pad_symbol, narrow.dtype)
    rows_host[:n] = narrow
    payloads = encode_groups(rows_host.reshape(ng * g, L), table, L, g,
                             device=device)
    return fmt.pack(
        k=16,
        alphabet=alphabet,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=table.c,
        per_block_tables=False,
        with_checksums=with_checksums,
        profile="rans16",
        group_lanes=g,
    )


def decode(cont: fmt.Container, *, device="cuda") -> np.ndarray:
    """Decompress a parsed rans16 container back to the symbol array."""
    if cont.profile != "rans16":
        raise ConfigError("not a rans16 container")
    if cont.per_block_tables:
        raise not_ported("rans16 with one table per group", "per_group_tables")
    gl = cont.group_lanes
    if gl < 128 or gl % 128:
        raise ConfigError(
            f"container group_lanes {gl} is not a multiple of 128")
    rows = decode_groups(cont.payloads, np.asarray(cont.tables_c),
                         cont.block_len, gl, device=device)
    return rows.reshape(-1)[: cont.n_symbols]
