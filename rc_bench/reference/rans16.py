"""The rans16 profile's group payloads, plain NumPy.

A frozen copy of the port's executable spec (``rans.py``
``encode_lanes``: interleaved word-renormalised rANS, states in [2^32,
2^48), one halfword emitted at most a step, encoding backward) plus the
payload layout of ``rans_codec.py`` (container version 2):

    u32 NT (| 1 << 31 with sync points) | u32 sync_T (with sync points) |
    u32 region halfwords a tile [NT] | lane states, 6 B LE each |
    sync states ((NT - 1) // sync_T x 6 B a lane) | regions, u16 LE

Lane ``l`` of group ``g`` codes the flat segment ``[(g G + l) L, (g G +
l + 1) L)``.  The sync state ``j`` is the decoder's state before tile
``j sync_T``: the encoder's state right after it coded that tile's first
step.  Every group's lanes run in one array.
"""

from __future__ import annotations

import math

import numpy as np

GROUP_LANES = 2048
CAP_HW = 65536  # halfwords a tile may hold: tile steps = CAP_HW // lanes
SYNC_FLAG = 1 << 31


def lane_len(n: int, block_len: int, g: int) -> int:
    """The lane length the codec uses for ``n`` symbols: ``block_len``,
    or the least valid length that still covers ``n`` with one group."""
    ts = max(1, CAP_HW // g)
    need = max(1, -(-n // g))
    if need >= block_len:
        return block_len
    if need <= ts:
        return need
    return min(block_len, -(-need // ts) * ts)


def _six(x: np.ndarray) -> np.ndarray:
    """(lanes,) states -> (lanes, 6) bytes, little-endian."""
    return x.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]


def encode(symbols: np.ndarray, c: np.ndarray, block_len: int,
           group_lanes: int | None, sync_tiles: int
           ) -> tuple[list[bytes], int]:
    """(group payloads, lane length) of a 1-D symbol array at a shared
    2^16 table ``c``, padded with its most frequent symbol."""
    g = group_lanes or GROUP_LANES
    n = symbols.size
    L = lane_len(n, block_len, g)
    tile = min(max(1, CAP_HW // g), L)
    if L % tile:
        raise ValueError(f"lane length {L} is not whole tiles of {tile}")
    n_tiles = L // tile
    ng = max(1, math.ceil(n / (g * L)))
    rows = np.full(ng * g * L, int(np.argmax(c)), np.uint16)
    rows[:n] = symbols
    steps = np.ascontiguousarray(rows.reshape(ng * g, L).T)  # (L, lanes)

    c64 = c.astype(np.uint64)
    cum64 = np.concatenate([[0], np.cumsum(c64)]).astype(np.uint64)
    top = c64 << np.uint64(32)
    n_sync = (n_tiles - 1) // sync_tiles if sync_tiles > 0 else 0
    sync_at = {j * sync_tiles * tile: j for j in range(1, n_sync + 1)}
    syncs = [None] * n_sync
    x = np.full(ng * g, 1 << 32, np.uint64)
    hw = [None] * L
    counts = np.zeros((L, ng), np.int64)
    s16 = np.uint64(16)
    for t in range(L - 1, -1, -1):
        s = steps[t].astype(np.intp)
        emit = x >= top[s]
        hw[t] = (x[emit] & np.uint64(0xFFFF)).astype("<u2")
        counts[t] = emit.reshape(ng, g).sum(1)
        np.right_shift(x, s16, out=x, where=emit)
        cs = c64[s]
        q = x // cs
        x = (q << s16) | (cum64[s] + (x - q * cs))
        if t in sync_at:
            syncs[sync_at[t] - 1] = x.copy()

    starts = np.zeros((L, ng + 1), np.int64)
    np.cumsum(counts, axis=1, out=starts[:, 1:])
    head = np.uint32(n_tiles | (SYNC_FLAG if n_sync else 0)).tobytes()
    if n_sync:
        head += np.uint32(sync_tiles).tobytes()
    pre = _six(x)
    payloads = []
    for j in range(ng):
        lanes = slice(j * g, (j + 1) * g)
        sizes = counts[:, j].reshape(n_tiles, tile).sum(1).astype("<u4")
        region = b"".join(hw[t][starts[t, j] : starts[t, j + 1]].tobytes()
                          for t in range(L))
        payloads.append(head + sizes.tobytes() + pre[lanes].tobytes()
                        + b"".join(_six(sv)[lanes].tobytes() for sv in syncs)
                        + region)
    return payloads, L
