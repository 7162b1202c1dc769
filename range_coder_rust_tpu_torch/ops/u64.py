"""u64 arithmetic on ``torch.int64`` bit patterns, for the planar coder.

The counterpart of ``range_coder_rust_tpu/ops/u64.py``, with only what
the planar coder needs.  torch has no usable unsigned 64-bit arithmetic
(uint64 ``+ - >> < //`` are not implemented on the CPU), so a u64 is held
as its bit pattern in an int64 tensor:

* ``+``, ``-``, ``*``, ``^``, ``&``, ``|``, ``~`` and ``<<`` act on the bit
  pattern modulo 2^64, as they would on a u64;
* an unsigned compare flips the sign bit of both sides, then compares
  signed (:func:`uge`);
* a logical right shift is an arithmetic shift, then a mask (:func:`shr`);
* a left shift by a count outside [0, 63] is 0 by selection (:func:`shl`),
  never by what the device does with such a count;
* the divisions are exact: the dividend's top 63 bits are divided with
  signed int64 floor division, then its last bit decides one correction
  step (:func:`udivmod`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

#: the int64 whose bit pattern is 2^63 (the sign bit)
SIGN = -(1 << 63)
MASK64 = (1 << 64) - 1


def to_signed(x: int) -> int:
    """A Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    if not 0 <= x <= MASK64:
        raise ValueError(f"{x} out of u64 range")
    return x - (1 << 64) if x >> 63 else x


def from_np(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint64 array -> int64 tensor of the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of bit patterns -> uint64 array."""
    return t.cpu().numpy().view(np.uint64)


def full(shape, x: int, device) -> torch.Tensor:
    """A u64 ``x`` (Python int in [0, 2^64)) broadcast to ``shape``."""
    return torch.full(shape, to_signed(x), dtype=torch.int64, device=device)


def uge(a: torch.Tensor, b) -> torch.Tensor:
    """a >= b as u64."""
    return (a ^ SIGN) >= (b ^ SIGN)


def shr(a: torch.Tensor, n: int) -> torch.Tensor:
    """a >> n (logical) for a static ``n`` in [0, 63]."""
    if n == 0:
        return a
    return (a >> n) & ((1 << (64 - n)) - 1)


def shl(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a << n (mod 2^64) for a dynamic ``n``; 0 where n is outside
    [0, 63]."""
    ok = (n >= 0) & (n < 64)
    return torch.where(ok, a << n.clamp(0, 63), 0)


@functools.lru_cache(maxsize=None)
def _byte_bounds(device: torch.device) -> torch.Tensor:
    """2^8, 2^16, ..., 2^56 with the sign bit flipped (ascending)."""
    return torch.tensor([(1 << (8 * j)) + SIGN for j in range(1, 8)],
                        dtype=torch.int64, device=device)


def lzb(a: torch.Tensor) -> torch.Tensor:
    """Leading zero bytes of a u64, int64; 7 for a == 0 (as the
    reference's ``_lzb``).  One search of the sign-flipped value among the
    sign-flipped powers 2^8 .. 2^56: a value in [2^(8m), 2^(8m+8)) finds
    m of them at or below it."""
    return 7 - torch.searchsorted(_byte_bounds(a.device), a ^ SIGN,
                                  right=True)


def udivmod(a: torch.Tensor, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (a // d, a % d) for a u64 ``a`` and a divisor ``d`` in
    [1, 2^63) (a tensor or a Python int).  It replaces both of the
    reference's divisions: ``divmod_u32`` (the raw-total coder's ``range /
    total``) and ``div_small_q`` (the decoder's ``(window - low) / rpt``,
    an estimate that is exact below 2^24 - 8 only; this is exact for every
    quotient).

    h = a >> 1 is below 2^63, so ``h // d`` is exact in int64; the
    remainder 2 (h % d) + (a & 1) is below 2 d, so one compare (unsigned:
    it can reach 2^64 - 2) and one subtraction finish the quotient."""
    h = shr(a, 1)
    q0 = h // d
    r = (h - q0 * d) * 2 + (a & 1)
    ge = uge(r, d)
    return q0 * 2 + ge, torch.where(ge, r - d, r)
