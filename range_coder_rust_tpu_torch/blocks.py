"""Block-parallel encode and decode of the planar profile.

The counterpart of ``range_coder_rust_tpu/blocks.py``.  The input is cut
into ``B`` independent blocks of ``L`` symbols; one Python loop over the
``L`` symbol positions advances every block's coder at once with the
closed-form transition (:mod:`.ops.transition`), each step a fixed
sequence of tensor ops on ``(B,)`` tensors on the blocks' device.  Per
block, the payload is byte-identical to the scalar coder's with the same
table (reference src/range_coder.rs:53-92).

Tables are shared (``c (A,)``, ``cum (A+1,)``) or one per block
(``(B, A)``, ``(B, A+1)``, the adaptive mode), int64 tensors on the
symbols' device.  Emissions are kept step-major: ``(L + 1, B)`` tensors,
transition ``L`` being the flush.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .ops import lookup
from .ops.transition import (
    decode_find_rfreq,
    decode_find_rfreq_div,
    flush_state,
    init_state,
    param_update_div,
    param_update_pow2,
)

#: flush length: the final 64-bit lower bound (reference
#: src/encoder.rs:40-46)
FLUSH_BYTES = 8

#: elements of one compaction index (blocks x transitions x 8 bytes):
#: bounds its int64 index and byte tensors to 32 MiB and 4 MiB
_COMPACT_ELEMS = 1 << 22


def default_capacity(block_len: int, k: int) -> int:
    """Worst-case payload bytes of a block: ``ceil(k/8) + 1`` bytes a
    symbol plus the flush, rounded up to a multiple of 4.  Loose on
    purpose; the encoder checks every block's length against it."""
    cap = block_len * ((k + 7) // 8 + 1) + FLUSH_BYTES
    return -(-cap // 4) * 4


def upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """``(B, L)`` host symbols (uint8, uint16 or int32) -> int64 on
    ``device``; they travel at their own width."""
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device).long()


def _scan(cs: torch.Tensor, cums: torch.Tensor, update: Callable
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance every block's coder over its ``(L, B)`` step-major symbol
    frequencies, then flush.  Returns ``(emit, en, pos, lengths)``:
    ``(L + 1, B)`` emitted-low words (int64) and byte counts (int32),
    their exclusive prefix sums over the transitions, and the ``(B,)``
    payload lengths, flush included."""
    L, B = cs.shape
    st = init_state((B,), cs.device)
    emit = torch.empty((L + 1, B), dtype=torch.int64, device=cs.device)
    en = torch.empty((L + 1, B), dtype=torch.int32, device=cs.device)
    for i in range(L):
        st, emit[i], en[i] = update(st, cs[i], cums[i])
    emit[L], en[L] = flush_state(st)
    csum = en.cumsum(0, dtype=torch.int32)
    return emit, en, csum - en, csum[L].long()


def _step_major(table: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    return lookup.table_lookup(table, symbols).T.contiguous()


def encode_scan(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                *, k: int):
    """Stage 1 for total ``2**k``: the emissions of ``(B, L)`` symbols
    (see :func:`_scan`)."""
    return _scan(_step_major(c, symbols), _step_major(cum[..., :-1], symbols),
                 lambda st, cc, cu: param_update_pow2(st, cc, cu, k))


def encode_scan_div(symbols: torch.Tensor, c: torch.Tensor,
                    cum: torch.Tensor, total: int):
    """:func:`encode_scan` for any u32 ``total`` (raw-count tables): the
    exact ``range // total`` of the reference (src/range_coder.rs:38-40)."""
    return _scan(_step_major(c, symbols), _step_major(cum[..., :-1], symbols),
                 lambda st, cc, cu: param_update_div(st, cc, cu, total))


def compact_emissions(emit: torch.Tensor, en: torch.Tensor, pos: torch.Tensor,
                      *, capacity: int) -> torch.Tensor:
    """Stage 2: the ``(B, capacity)`` uint8 byte streams.  Transition
    ``i`` of a block owns bytes ``[pos[i], pos[i] + en[i])`` of its stream,
    the top ``en[i]`` bytes of ``emit[i]`` (zeros past the eighth), so one
    scatter writes each transition's top ``min(en, 8)`` bytes to ``pos +
    r``; bytes past ``capacity`` are dropped (the caller sees the block's
    length exceed it)."""
    L1, B = emit.shape
    dev = emit.device
    dump = B * capacity  # one extra slot takes every write that is dropped
    out = torch.zeros(dump + 1, dtype=torch.uint8, device=dev)
    r = torch.arange(8, device=dev)
    shifts = 56 - 8 * r
    per = max(1, _COMPACT_ELEMS // (L1 * 8))
    for b0 in range(0, B, per):
        b1 = min(B, b0 + per)
        e = emit[:, b0:b1, None]
        dst = pos[:, b0:b1, None].long() + r
        ok = (r < en[:, b0:b1, None]) & (dst < capacity)
        base = torch.arange(b0, b1, device=dev)[None, :, None] * capacity
        out[torch.where(ok, dst + base, dump).view(-1)] = (
            ((e >> shifts) & 0xFF).to(torch.uint8).view(-1))
    return out[:dump].view(B, capacity)


def encode_blocks(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  *, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``(B, L)`` symbol indices into per-block byte streams with a
    total of ``2**k``.  Returns ``(code (B, capacity) uint8, lengths (B,)
    int64)``, the lengths with the 8 flush bytes; a length above
    ``capacity`` means that block was cut and must be encoded again with
    more room."""
    emit, en, pos, lengths = encode_scan(symbols, c, cum, k=k)
    return compact_emissions(emit, en, pos, capacity=capacity), lengths


def encode_blocks_div(symbols: torch.Tensor, c: torch.Tensor,
                      cum: torch.Tensor, total: int, *, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encode_blocks` for any u32 ``total``."""
    emit, en, pos, lengths = encode_scan_div(symbols, c, cum, total)
    return compact_emissions(emit, en, pos, capacity=capacity), lengths


def _decode_scan(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                 block_len: int, find_rfreq: Callable, update: Callable
                 ) -> torch.Tensor:
    """Decode ``block_len`` symbols of each ``(B, C)`` stream: window,
    target value, symbol search, and the encoder's own transition, whose
    byte count advances the cursor (reference src/decoder.rs:38-54)."""
    B = code.shape[0]
    windows = lookup.code_windows(code)
    cum_next = cum[..., 1:].contiguous()
    st = init_state((B,), code.device)
    start = torch.zeros(B, dtype=torch.int64, device=code.device)  # cursor-8
    out = torch.empty((block_len, B), dtype=torch.int32, device=code.device)
    for i in range(block_len):
        rfreq = find_rfreq(st, lookup.window_at(windows, start))
        idx = lookup.find_symbol(cum_next, rfreq)
        st, _, n = update(st, lookup.table_lookup(c, idx),
                          lookup.table_lookup(cum, idx))
        start += n
        out[i] = idx
    return out.T


def decode_blocks(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  *, k: int, block_len: int) -> torch.Tensor:
    """Decode ``(B, C)`` uint8 streams back to ``(B, block_len)`` int32
    symbols (total ``2**k``).  Like the reference, a payload carries no
    end marker: the container gives the symbol count."""
    return _decode_scan(
        code, c, cum, block_len,
        lambda st, w: decode_find_rfreq(st, w, k),
        lambda st, cc, cu: param_update_pow2(st, cc, cu, k))


def decode_blocks_div(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                      total: int, *, block_len: int) -> torch.Tensor:
    """:func:`decode_blocks` for any u32 ``total``."""
    return _decode_scan(
        code, c, cum, block_len,
        lambda st, w: decode_find_rfreq_div(st, w, total),
        lambda st, cc, cu: param_update_div(st, cc, cu, total))
