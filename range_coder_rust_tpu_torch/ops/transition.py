"""Closed-form per-symbol coder transition, one coder per tensor element.

The counterpart of ``range_coder_rust_tpu/ops/transition.py``: the
reference's ``param_update`` with its two renormalization loops
(reference src/range_coder.rs:53-92) in closed form, so that one step of
every block's coder is a fixed sequence of elementwise tensor ops.  With
``low'``, ``rng'`` the interval after the multiply and add, and
``up' = low' + rng'``:

* the no-carry loop emits ``n1 = leading zero bytes of (low' ^ up')``
  bytes (at most 7);
* with ``low1 = low' << 8 n1`` and ``rng1 = rng' << 8 n1``, the reduction
  loop runs iff ``rng1 < 2^48``, ``n2 = 1 +`` the 0xFF bytes of ``low1``
  from byte 5 down (at most 7 in all);
* the emitted bytes are the top ``n1 + n2`` bytes of ``low'`` (zeros past
  the eighth);
* ``low2 = low1 << 8 n2``, and ``rng2 = (~(low1 << 8 (n2 - 1)) &
  (2^48 - 1)) << 8`` when the reduction ran, else ``rng1``.

States are u64 bit patterns in int64 tensors (:mod:`.u64`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import u64

#: most bytes one transition emits: n1 <= 7 and n2 <= 7
EMIT_MAX = 14

_TOP16 = 1 << 48
_MASK48 = _TOP16 - 1


class CoderState(NamedTuple):
    """One ``(lower_bound, range)`` interval per element (reference
    src/range_coder.rs:7-12), as u64 bit patterns in int64."""

    low: torch.Tensor
    rng: torch.Tensor


def init_state(shape, device="cpu") -> CoderState:
    """The fresh interval (0, 2^64 - 1) for every element (reference
    src/range_coder.rs:15-18)."""
    return CoderState(
        low=torch.zeros(shape, dtype=torch.int64, device=device),
        rng=u64.full(shape, u64.MASK64, device))


def _renorm(low_u: torch.Tensor, rng_u: torch.Tensor
            ) -> Tuple[CoderState, torch.Tensor, torch.Tensor]:
    """The closed-form renormalization: (state', emit_low, n)."""
    up = low_u + rng_u  # no overflow under the carryless invariant
    n1 = u64.lzb(low_u ^ up)  # 0..7: low ^ up is nonzero (rng > 0)
    low1 = low_u << 8 * n1
    rng1 = rng_u << 8 * n1
    need = (rng1 & ~_MASK48) == 0  # rng1 < 2^48 as u64
    n_ff = u64.lzb(~low1 << 16).clamp_(max=6)
    n2 = torch.where(need, n_ff + 1, 0)
    low2 = low1 << 8 * n2
    # the lower bound at the reduction loop's last iteration; its shift
    # count is -8 where the loop did not run, and that value is selected
    # away below
    last_low = u64.shl(low1, 8 * (n2 - 1))
    rng2 = torch.where(need, (~last_low & _MASK48) << 8, rng1)
    return CoderState(low2, rng2), low_u, n1 + n2


def _step(state: CoderState, rpt: torch.Tensor, c, cum
          ) -> Tuple[CoderState, torch.Tensor, torch.Tensor]:
    """The interval of symbol (c, cum) at ``rpt = range / total``
    (reference src/range_coder.rs:62-68), then the renormalization."""
    rng_u = rpt * c
    low_u = state.low + rpt * cum  # carryless: no u64 overflow
    return _renorm(low_u, rng_u)


def param_update_pow2(state: CoderState, c, cum, k: int
                      ) -> Tuple[CoderState, torch.Tensor, torch.Tensor]:
    """One symbol with total frequency ``2**k``: ``rpt = range >> k``.
    Returns ``(state', emit_low, n)``: this symbol's stream bytes are the
    top ``n`` bytes of ``emit_low`` (zeros past the eighth)."""
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    return _step(state, u64.shr(state.rng, k), c, cum)


def param_update_div(state: CoderState, c, cum, total: int
                     ) -> Tuple[CoderState, torch.Tensor, torch.Tensor]:
    """One symbol with any u32 total frequency: ``rpt = range // total``
    by exact division (reference src/range_coder.rs:38-40)."""
    return _step(state, u64.udivmod(state.rng, total)[0], c, cum)


def decode_find_rfreq(state: CoderState, window: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """The decoder's target cumulative value for total ``2**k``:
    ``(window - low) / (range >> k)`` (reference
    examples/sample_impl.rs:29-30), clamped to ``2**k - 1`` as the
    reference's search never passes the last symbol."""
    rpt = u64.shr(state.rng, k)
    return u64.udivmod(window - state.low, rpt)[0].clamp_(max=(1 << k) - 1)


def decode_find_rfreq_div(state: CoderState, window: torch.Tensor,
                          total: int) -> torch.Tensor:
    """:func:`decode_find_rfreq` for any u32 total: ``min(rfreq, total -
    1)``.  The division is exact at every total, so the reference's
    two-stage divide for totals >= 2^24 - 16 is not needed.  A total of 1
    gives ``rpt = range``, which may pass 2^63 (beyond
    :func:`u64.udivmod`): rfreq is then 0 whatever the quotient."""
    if total == 1:
        return torch.zeros_like(window)
    rpt = u64.udivmod(state.rng, total)[0]
    return u64.udivmod(window - state.low, rpt)[0].clamp_(max=total - 1)


def flush_state(state: CoderState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flush (reference src/encoder.rs:40-46): the 8 bytes of the
    lower bound, shaped as one more transition ``(emit_low, n = 8)``."""
    return state.low, torch.full_like(state.low, 8)
