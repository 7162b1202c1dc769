"""Table lookups and the decoder's code window, in PyTorch's idiom.

The counterpart of ``range_coder_rust_tpu/ops/lookup.py``.  The reference
reformulates every data-dependent access as masked arithmetic because its
TPU stack had no fast gather; here they are what they compute:

* the encoder's ``(c[s], cum[s])``: indexing (:func:`table_lookup`);
* the decoder's symbol search, the largest ``i`` with ``cum[i] <= r``
  (reference examples/sample_impl.rs:33-44): ``searchsorted`` over
  ``cum[1:]``, i.e. ``#{a : cum[a+1] <= r}``, which counts zero-frequency
  symbols as the reference does (:func:`find_symbol`);
* the decoder's 64-bit window, bytes ``[cursor - 8, cursor)`` of the
  block's stream read big-endian (reference src/decoder.rs:27-35): one
  gather from the block's precomputed windows (:func:`code_windows`,
  :func:`window_at`).

A table is shared, ``(A,)``, or one row per block, ``(B, A)``.
"""

from __future__ import annotations

import torch


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a shared ``(A,)`` table, or ``table[b, idx[b]]``
    for one row per block (``(B, A)``, ``idx`` of shape ``(B, ...)``)."""
    idx = idx.long()
    if table.dim() == 1:
        return table[idx]
    return table.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def find_symbol(cum_next: torch.Tensor, rfreq: torch.Tensor) -> torch.Tensor:
    """``#{a : cum[a+1] <= rfreq}`` per block, for ``cum_next = cum[...,
    1:]`` (contiguous; ``(A,)`` shared or ``(B, A)`` per block) and
    ``rfreq (B,)``."""
    if cum_next.dim() == 1:
        return torch.searchsorted(cum_next, rfreq, right=True)
    return torch.searchsorted(cum_next, rfreq[:, None], right=True)[:, 0]


def code_windows(code: torch.Tensor) -> torch.Tensor:
    """``(B, C)`` uint8 streams -> ``(B, C + 1)`` int64: entry ``p`` is
    bytes ``[p, p + 8)`` of the row as a big-endian u64, bytes past the
    row reading 0 (so entry ``C`` is 0)."""
    B, C = code.shape
    padded = torch.zeros((B, C + 8), dtype=torch.uint8, device=code.device)
    padded[:, :C] = code
    win = torch.zeros((B, C + 1), dtype=torch.int64, device=code.device)
    for r in range(8):
        win |= padded[:, r : r + C + 1].long() << (56 - 8 * r)
    return win


def window_at(windows: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Each block's window at byte ``start`` (B,); a start past the row
    reads 0, as the reference's windows do."""
    last = windows.shape[1] - 1
    return windows.gather(1, start.clamp(max=last)[:, None])[:, 0]
