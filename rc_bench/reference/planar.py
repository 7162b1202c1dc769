"""The planar profile's block encoder, plain PyTorch.

A frozen copy of the port's plain step loop (``kernels/planar.py``
``encode_scan``, ``ops/transition.py``, ``ops/u64.py``): every block of
``L`` symbols is coded on its own by the carryless 64-bit range coder
(the scalar coder's ``param_update`` with both renormalisation loops in
closed form), one Python iteration a symbol position over all blocks at
once, u64 values as int64 bit patterns.  The payload of a block is the
bytes its transitions emit plus the 8-byte flush, so a block's bytes
equal the scalar coder's with the same table.

Unlike the program, the bytes are written straight into one flat buffer
of the payloads in block order (no capacity, no retry).
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)
_MASK48 = (1 << 48) - 1


def _shr(a: torch.Tensor, n: int) -> torch.Tensor:
    """Logical a >> n for a static n in [1, 63]."""
    return (a >> n) & ((1 << (64 - n)) - 1)


def _shl(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a << n, 0 where n is outside [0, 63]."""
    return torch.where((n >= 0) & (n < 64), a << n.clamp(0, 63), 0)


def _lzb(a: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Leading zero bytes of a u64 (7 for 0)."""
    return 7 - torch.searchsorted(bounds, a ^ SIGN, right=True)


def _transition(low, rng, c, cum, k, bounds):
    """One symbol at total 2**k: (low', rng', emitted low, byte count).
    The symbol's bytes are the top ``n`` bytes of the emitted low."""
    rpt = _shr(rng, k)
    rng_u = rpt * c
    low_u = low + rpt * cum
    n1 = _lzb(low_u ^ (low_u + rng_u), bounds)
    low1 = low_u << 8 * n1
    rng1 = rng_u << 8 * n1
    need = (rng1 & ~_MASK48) == 0
    n_ff = _lzb(~low1 << 16, bounds).clamp_(max=6)
    n2 = torch.where(need, n_ff + 1, 0)
    last_low = _shl(low1, 8 * (n2 - 1))
    rng2 = torch.where(need, (~last_low & _MASK48) << 8, rng1)
    return low1 << 8 * n2, rng2, low_u, n1 + n2


def encode_blocks(rows: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """``(B, L)`` symbols (int64) with an int64 table ``c (A,)``, ``cum
    (A+1,)`` at total ``2**k`` -> (the payloads joined in block order,
    uint8; their lengths, int64), on the host."""
    B, L = rows.shape
    dev = rows.device
    bounds = torch.tensor([(1 << (8 * j)) + SIGN for j in range(1, 8)],
                          dtype=torch.int64, device=dev)
    cs = c[rows].T.contiguous()
    cums = cum[:-1][rows].T.contiguous()
    low = torch.zeros(B, dtype=torch.int64, device=dev)
    rng = torch.full((B,), -1, dtype=torch.int64, device=dev)  # 2^64 - 1
    emit = torch.empty((L + 1, B), dtype=torch.int64, device=dev)
    en = torch.empty((L + 1, B), dtype=torch.int64, device=dev)
    for i in range(L):
        low, rng, emit[i], en[i] = _transition(low, rng, cs[i], cums[i], k,
                                               bounds)
    emit[L], en[L] = low, 8  # the flush: the 8 bytes of the lower bound
    pos = en.cumsum(0) - en
    lengths = en.sum(0)
    base = lengths.cumsum(0) - lengths
    out = torch.zeros(int(lengths.sum()), dtype=torch.uint8, device=dev)
    dst0 = pos + base
    for r in range(8):  # byte r of each transition; bytes past 8 are 0
        m = en > r
        out[(dst0 + r)[m]] = ((emit[m] >> (56 - 8 * r)) & 0xFF).to(
            torch.uint8)
    return out.cpu().numpy(), lengths.cpu().numpy()


def encode(symbols: np.ndarray, c: np.ndarray, k: int, block_len: int,
           device, chunk_symbols: int = 1 << 25
           ) -> tuple[np.ndarray, np.ndarray]:
    """All blocks of a 1-D symbol array, padded with the most frequent
    symbol to whole blocks: (payloads joined, uint8; lengths, int64)."""
    n = symbols.size
    n_blocks = max(1, -(-n // block_len))
    c_dev = torch.from_numpy(c.astype(np.int64)).to(device)
    cum_dev = torch.from_numpy(
        np.concatenate([[0], np.cumsum(c.astype(np.int64))])).to(device)
    per = max(1, chunk_symbols // block_len)
    pad = int(np.argmax(c))
    payloads, lengths = [], []
    for b0 in range(0, n_blocks, per):
        b1 = min(n_blocks, b0 + per)
        part = np.full((b1 - b0) * block_len, pad, np.int64)
        src = symbols[b0 * block_len : b1 * block_len]
        part[: src.size] = src
        rows = torch.from_numpy(part).to(device).view(b1 - b0, block_len)
        p, ln = encode_blocks(rows, c_dev, cum_dev, k)
        payloads.append(p)
        lengths.append(ln)
    return np.concatenate(payloads), np.concatenate(lengths)
