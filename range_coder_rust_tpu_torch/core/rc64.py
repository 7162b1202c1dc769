"""Scalar golden-model range coder (64-bit carryless).

This is the bit-exact executable specification of the reference core
arithmetic (reference src/range_coder.rs:1-147); the block-parallel planar
coder (``blocks.py``) is tested against it.  The port's copy of
``range_coder_rust_tpu/core/rc64.py``.

Semantics reproduced exactly:

* state ``(lower_bound, range)`` initialized to ``(0, 2**64 - 1)``
  (src/range_coder.rs:13-20);
* constants ``TOP8 = 1 << 56``, ``TOP16 = 1 << 48`` (src/range_coder.rs:23-24);
* ``param_update`` (src/range_coder.rs:53-92): ``rpt = range // total`` (u64
  floor division), ``range = rpt * c_freq``, ``lower += rpt * cum_freq`` with
  overflow surfaced as :class:`LowerBoundOverflow`, then the two
  renormalization loops **in strict order** — all no-carry expansions
  (src/range_coder.rs:110-116), then all range-reduction expansions
  (src/range_coder.rs:126-135) — returning the emitted bytes;
* ``left_shift`` (src/range_coder.rs:95-100) pops the top byte of ``lower``
  and shifts both ``lower`` and ``range`` left by 8 bits.

All arithmetic is modulo 2**64 via explicit masking on Python ints, which is
exact and overflow-checked the same way the reference's ``overflowing_add``
is (src/range_coder.rs:68-70, :139).
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import LowerBoundOverflow, UpperBoundOverflow

MASK64 = (1 << 64) - 1
TOP8 = 1 << (64 - 8)  # reference src/range_coder.rs:23
TOP16 = 1 << (64 - 16)  # reference src/range_coder.rs:24

#: Proven static bound on bytes emitted by one ``param_update``
#: (SURVEY.md §3 invariant 3: no-carry loop ≤ 7, reduction loop ≤ 7).
MAX_BYTES_PER_SYMBOL = 14


class RangeCoder:
    """The coding-interval state machine (reference src/range_coder.rs:7-12)."""

    __slots__ = ("_lower_bound", "_range")

    def __init__(self) -> None:
        # reference src/range_coder.rs:15-18
        self._lower_bound = 0
        self._range = MASK64

    # -- accessors (reference src/range_coder.rs:30-35) ---------------------
    @property
    def lower_bound(self) -> int:
        return self._lower_bound

    @property
    def range(self) -> int:
        return self._range

    def range_par_total(self, total_freq: int) -> int:
        """Range per unit of cumulative frequency (src/range_coder.rs:38-40)."""
        return self._range // total_freq

    def upper_bound(self) -> int:
        """lower + range with checked overflow (src/range_coder.rs:138-146)."""
        ub = self._lower_bound + self._range
        if ub > MASK64:
            raise UpperBoundOverflow(self._lower_bound, self._range)
        return ub

    # -- mutators ------------------------------------------------------------
    def left_shift(self) -> int:
        """Pop the top byte of lower; shift lower and range left by 8
        (src/range_coder.rs:95-100)."""
        top = (self._lower_bound >> (64 - 8)) & 0xFF
        self._range = (self._range << 8) & MASK64
        self._lower_bound = (self._lower_bound << 8) & MASK64
        return top

    def _no_carry_expansion(self) -> int | None:
        """Emit the settled top byte while lower and upper agree on it
        (src/range_coder.rs:110-116)."""
        if (self._lower_bound ^ self.upper_bound()) < TOP8:
            return self.left_shift()
        return None

    def _range_reduction_expansion(self) -> int | None:
        """Carryless underflow handling: when range < 2**48, clamp upper to
        ``lower | 0x0000FFFF_FFFFFFFF`` and force-settle the top byte
        (src/range_coder.rs:126-135)."""
        if self._range < TOP16:
            self._range = ~self._lower_bound & (TOP16 - 1)
            return self.left_shift()
        return None

    def param_update(self, c_freq: int, cum_freq: int, total_freq: int) -> bytes:
        """Advance the interval by one symbol; return the settled bytes
        (src/range_coder.rs:53-92)."""
        rpt = self._range // total_freq
        self._range = (rpt * c_freq) & MASK64
        add_val = rpt * cum_freq
        new_lower = self._lower_bound + add_val
        if new_lower > MASK64:
            raise LowerBoundOverflow(self._lower_bound, add_val, self._range)
        self._lower_bound = new_lower

        out: List[int] = []
        # strict loop order: all no-carry expansions first...
        while (b := self._no_carry_expansion()) is not None:
            out.append(b)
        # ...then all range-reduction expansions (src/range_coder.rs:83-89).
        while (b := self._range_reduction_expansion()) is not None:
            out.append(b)
        return bytes(out)

    # -- introspection -------------------------------------------------------
    def state(self) -> Tuple[int, int]:
        return (self._lower_bound, self._range)

    def set_state(self, lower_bound: int, range_: int) -> None:
        """Restore a saved state (framework extension: checkpoint/resume of a
        streaming coder; the full codec state is 2×u64, SURVEY.md §5)."""
        if not (0 <= lower_bound <= MASK64 and 0 <= range_ <= MASK64):
            raise ValueError("state out of u64 range")
        self._lower_bound = lower_bound
        self._range = range_
