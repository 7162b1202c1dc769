"""Interleaved word-renormalized rANS: the executable spec of the
"rans16" profile.

The port's copy of ``range_coder_rust_tpu/rans.py`` (NumPy only; the
functions below are the reference's, line for line).  It is the oracle the
CUDA kernels (``csrc/rans_*.cu``) and their plain PyTorch versions
(``kernels/rans_*.py``) are held to, group by group.

Unlike the reference coder (a carryless range coder, reference
src/range_coder.rs), rANS encodes *backward*: the halfwords the encoder
emits at step ``t`` are exactly the halfwords the decoder refills at step
``t``, so many lanes can share one interleaved stream that both sides walk
in order.  The profile does not reproduce the reference's byte streams
(the planar profile does); it keeps its tables and its compressed size.

## The coder (fixed k = 16)

State ``x``: an unsigned integer in ``I = [2^32, 2^48)``.  Tables: the
standard pow2 layout (models/table.py): ``c[s] >= 1``, exclusive prefix
``cum[s]``, ``cum[A] = 2^16``.

Encode one symbol ``s`` (iterating t = L-1 .. 0):

    if x >= c[s] << 32:          # one u32 compare: x.hi >= c[s]
        emit halfword x & 0xFFFF  # u16, little-endian in the stream
        x >>= 16                  # now x < 2^32 <= c << 32
    q, r = divmod(x, c[s])        # q < 2^32, exact
    x = (q << 16) | (cum[s] + r)  # cum + r < 2^16; x back in I

Decode one symbol (iterating t = 0 .. L-1):

    slot = x & 0xFFFF
    s = largest s with cum[s] <= slot
    x = c[s] * (x >> 16) + slot - cum[s]       # no division
    if x < 2^32:
        x = (x << 16) | next_halfword          # refill, at most one

Pre-step ``x in I``; the emit branch leaves ``x in [c·2^16, 2^32)``; the
no-emit branch has ``x in [2^32, c·2^32)``; both give ``q in [2^16,
2^32)``, so the update lands back in ``[2^32, 2^48)``.  Decode inverts
each step exactly, and ``c·(x>>16) >= 2^16`` makes one refill enough.

## Interleaved group stream layout

``G = GROUP_LANES`` lanes per group; lane ``l`` encodes the group's
``l``-th length-``L`` segment.  Group stream bytes:

* preamble: lane ``l``'s final encoder state (= the decoder's initial
  state), 8 bytes little-endian, at ``[8l, 8l+8)``;
* then for step ``t = 0..L-1``: the halfwords (u16 LE) of every lane that
  refills at step ``t``, in flat lane order, written by the encoder at its
  (backward) step ``t``, consumed by the decoder at its step ``t``.

(The container's payload, ``rans_codec.py``, stores the same regions
with 48-bit preamble states and per-tile region sizes.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: default lanes per group; the container records the width, and
#: streams of other widths still decode
GROUP_LANES = 2048

#: table precision — the rans16 profile is specialized to 2^16 totals
K = 16

_LO16 = np.uint64(0xFFFF)
_ST_MIN = np.uint64(1) << np.uint64(32)  # 2^32, bottom of the state interval


def encode_lanes(
    symbols: np.ndarray, c: np.ndarray, cum: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lane-vectorized reference encoder.

    Arguments:
      symbols: (B, L) int array of symbol indices (B lanes in lock-step).
      c / cum: pow2 tables with ``cum[A] == 2**16`` (models/table.py).

    Returns ``(states, regions, counts)``:
      states: (B,) uint64 final states (the decoder's initial states);
      regions: list of L uint16 arrays — regions[t] = halfwords the decoder
        refills at step t, flat-lane-ordered;
      counts: (L,) int32 region sizes (halfwords).
    """
    B, L = symbols.shape
    c64 = c.astype(np.uint64)
    cum64 = cum.astype(np.uint64)
    x = np.full(B, _ST_MIN, np.uint64)
    regions: list[np.ndarray] = [None] * L  # type: ignore[list-item]
    counts = np.zeros(L, np.int32)
    for t in range(L - 1, -1, -1):
        s = symbols[:, t]
        cs = c64[s]
        emit = x >= (cs << np.uint64(32))
        if emit.any():
            regions[t] = (x[emit] & _LO16).astype(np.uint16)
            counts[t] = int(emit.sum())
            x = np.where(emit, x >> np.uint64(16), x)
        else:
            regions[t] = np.zeros(0, np.uint16)
        q = x // cs
        r = x - q * cs
        x = (q << np.uint64(16)) | (cum64[s] + r)
    return x, regions, counts


def decode_lanes(
    states: np.ndarray,
    halfwords: np.ndarray,
    block_len: int,
    c: np.ndarray,
    cum: np.ndarray,
) -> np.ndarray:
    """Lane-vectorized reference decoder (mirror of :func:`encode_lanes`).

    ``halfwords``: the concatenated region section (uint16, in stream
    order).  Returns (B, L) int32 symbols; asserts the end-state invariant
    (every lane returns to 2^32 — the encoder's initial state).
    """
    B = states.shape[0]
    c64 = c.astype(np.uint64)
    cum64 = cum.astype(np.uint64)
    cum_search = cum.astype(np.uint32)
    x = states.astype(np.uint64).copy()
    out = np.empty((B, block_len), np.int32)
    cursor = 0
    for t in range(block_len):
        slot = (x & _LO16).astype(np.uint32)
        s = np.searchsorted(cum_search, slot, side="right") - 1
        out[:, t] = s
        x = c64[s] * (x >> np.uint64(16)) + (slot.astype(np.uint64) - cum64[s])
        refill = x < _ST_MIN
        n = int(refill.sum())
        if n:
            h = halfwords[cursor : cursor + n].astype(np.uint64)
            cursor += n
            xr = x[refill]
            x[refill] = (xr << np.uint64(16)) | h
    assert np.all(x == _ST_MIN), "rans end-state invariant violated"
    return out


def build_group_stream(
    states: np.ndarray, regions, counts
) -> bytes:
    """Assemble one group's stream bytes (preamble + region section)."""
    out = bytearray(states.astype("<u8").tobytes())
    for t in range(len(counts)):
        out += regions[t].astype("<u2").tobytes()
    return bytes(out)


def split_group_stream(
    stream: bytes, n_lanes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`build_group_stream`: (states, halfwords)."""
    pre = 8 * n_lanes
    states = np.frombuffer(stream[:pre], dtype="<u8").astype(np.uint64)
    body = stream[pre:]
    if len(body) % 2:
        raise ValueError("rans16 region section must be halfword-aligned")
    return states, np.frombuffer(body, dtype="<u2").astype(np.uint16)


def roundtrip_group(symbols: np.ndarray, c, cum) -> Tuple[bytes, np.ndarray]:
    """Encode + decode one group of lanes; returns (stream, decoded)."""
    states, regions, counts = encode_lanes(symbols, c, cum)
    stream = build_group_stream(states, regions, counts)
    st2, hw = split_group_stream(stream, symbols.shape[0])
    dec = decode_lanes(st2, hw, symbols.shape[1], c, cum)
    return stream, dec
