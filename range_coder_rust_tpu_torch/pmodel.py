"""The probability-model contract (reference src/pmodel.rs:1-41).

The port's copy of ``range_coder_rust_tpu/pmodel.py``.

``PModel`` is the model-agnosticism abstraction of the reference (its README
line "Agnostic for probability models ... by PModel(trait)"): any frequency
model — static table, adaptive, context model — drives the same core coder
through four methods plus a default ``ideal_code_length``.

The framework keeps this scalar protocol for API parity and streaming use,
and adds an array-native counterpart (:mod:`.models.table`, :mod:`.blocks`)
for the device path, where ``find_index`` becomes a vectorized search.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .core.decoder import Decoder


class PModel(ABC):
    """Probability model protocol (reference src/pmodel.rs:4-12)."""

    @abstractmethod
    def c_freq(self, index: int) -> int:
        """Frequency of symbol ``index`` (src/pmodel.rs:6)."""

    @abstractmethod
    def cum_freq(self, index: int) -> int:
        """Exclusive cumulative frequency below ``index`` (src/pmodel.rs:8)."""

    @abstractmethod
    def total_freq(self) -> int:
        """Sum of all frequencies (src/pmodel.rs:10)."""

    @abstractmethod
    def find_index(self, decoder: "Decoder") -> int:
        """Locate the symbol the decoder's window points at (src/pmodel.rs:12).

        The search strategy deliberately lives in the model, not the coder
        (SURVEY.md §1) — the model receives the decoder and may use
        ``decoder.data()``, ``decoder.range_coder.lower_bound`` and
        ``range_par_total`` to derive the target cumulative value.
        """

    def ideal_code_length(self, index: int) -> float:
        """Shannon bound for one symbol: log2(total/c) bits
        (reference src/pmodel.rs:14-40).

        Raises ``ValueError`` for zero/NaN/inf/negative probability, matching
        the reference's guarded error strings (src/pmodel.rs:16-31).
        """
        p = float(self.c_freq(index))
        if p == 0.0:
            raise ValueError("code length is undefined when probability is zero")
        if math.isnan(p) or math.isinf(p):
            raise ValueError(
                f"code length is undefined when probability is nan or infinite as {p!r}"
            )
        if p < 0.0:
            raise ValueError(
                f"code length is undefined when probability is negative as {p}"
            )
        total = float(self.total_freq())
        code_length = (math.log(total) - math.log(p)) / math.log(2.0)
        assert math.isfinite(code_length), f"p_sum: {total}, p_collect: {p}"
        return code_length
