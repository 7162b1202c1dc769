"""Adaptive order-0 scalar model — model-agnosticism parity demo.

The reference's whole point is that the coder is "agnostic for probability
models ... by PModel(trait)" (reference README.md:4-6): any model driving
``c_freq/cum_freq/total_freq/find_index`` works, including adaptive ones.
Its example only ships a static table; this model demonstrates the adaptive
case against the same scalar ``Encoder``/``Decoder``: counts update after
every coded symbol, encoder and decoder evolving in lock-step so no table
is transmitted at all.

The port's copy of ``range_coder_rust_tpu/models/adaptive_freq.py``.
Uses the arbitrary-total code path (``param_update`` with a true division,
core/rc64.py) — totals grow by 1 per symbol and are never a power of two.
"""

from __future__ import annotations

import numpy as np

from ..errors import TableError
from ..pmodel import PModel


class AdaptiveFreqTable(PModel):
    """Laplace-smoothed adaptive order-0 model: every symbol starts with
    count 1 (zero-frequency symbols are undefined, reference src/pmodel.rs:16-18)
    and gains a count each time it is coded."""

    #: halve counts when the total reaches this (keeps totals < 2^32 and
    #: adapts to drifting statistics; halving preserves counts >= 1)
    RESCALE_AT = 1 << 16

    def __init__(self, alphabet_count: int) -> None:
        if alphabet_count < 1:
            raise TableError("alphabet_count must be >= 1")
        self._c = np.ones(alphabet_count, dtype=np.uint64)
        self._cum = np.arange(alphabet_count, dtype=np.uint64)
        self._total = alphabet_count

    @property
    def alphabet_count(self) -> int:
        return int(self._c.shape[0])

    def c_freq(self, index: int) -> int:
        return int(self._c[index])

    def cum_freq(self, index: int) -> int:
        return int(self._cum[index])

    def total_freq(self) -> int:
        return self._total

    def find_index(self, decoder) -> int:
        rfreq = (
            decoder.data() - decoder.range_coder.lower_bound
        ) // decoder.range_coder.range_par_total(self._total)
        # same binary search as the reference (examples/sample_impl.rs:33-44)
        left, right = 0, self.alphabet_count - 1
        while left < right:
            mid = (left + right) // 2
            if self.cum_freq(mid + 1) <= rfreq:
                left = mid + 1
            else:
                right = mid
        return left

    def update(self, index: int) -> None:
        """Count one coded occurrence.  Caller invokes after every
        ``encode``/``decode`` so both sides stay in lock-step."""
        self._c[index] += 1
        self._cum[index + 1 :] += 1
        self._total += 1
        if self._total >= self.RESCALE_AT:
            self._c = np.maximum(self._c >> np.uint64(1), 1)
            self._cum = np.concatenate([[0], np.cumsum(self._c)[:-1]]).astype(
                np.uint64
            )
            self._total = int(self._c.sum())


def encode_adaptive_scalar(data, alphabet_count: int) -> bytes:
    """Whole-stream adaptive encode with the scalar streaming encoder."""
    from ..core.encoder import Encoder

    model = AdaptiveFreqTable(alphabet_count)
    enc = Encoder()
    for s in data:
        enc.encode(model, int(s))
        model.update(int(s))
    return enc.finish()


def decode_adaptive_scalar(code: bytes, n: int, alphabet_count: int) -> list:
    """Mirror decode: identical model evolution, no transmitted table."""
    from ..core.decoder import Decoder

    model = AdaptiveFreqTable(alphabet_count)
    dec = Decoder(code)
    out = []
    for _ in range(n):
        s = dec.decode(model)
        model.update(s)
        out.append(s)
    return out
