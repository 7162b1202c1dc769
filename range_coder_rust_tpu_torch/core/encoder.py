"""Streaming scalar encoder (reference src/encoder.rs:1-55).

Wraps a :class:`RangeCoder` plus a growing code buffer; each ``encode``
appends the bytes settled by one ``param_update`` and returns how many were
emitted; ``finish`` flushes the residual 64-bit lower bound as exactly
8 bytes so that ``Decoder.__init__`` can always prime its window.
"""

from __future__ import annotations

from ..pmodel import PModel
from .rc64 import RangeCoder


class Encoder:
    """Streaming encoder (reference src/encoder.rs:7-11)."""

    __slots__ = ("range_coder", "_code")

    def __init__(self) -> None:
        self.range_coder = RangeCoder()
        self._code = bytearray()

    def peek_code(self) -> bytes:
        """The partial output stream so far (reference src/encoder.rs:18-20)."""
        return bytes(self._code)

    def encode(self, pmodel: PModel, index: int) -> int:
        """Encode one symbol; return the number of bytes emitted
        (reference src/encoder.rs:24-37)."""
        out = self.range_coder.param_update(
            pmodel.c_freq(index), pmodel.cum_freq(index), pmodel.total_freq()
        )
        self._code.extend(out)
        return len(out)

    def finish(self) -> bytes:
        """Flush the final 64-bit lower bound as 8 bytes and return the
        complete code (reference src/encoder.rs:40-46).

        Unlike the reference (which consumes ``self``), the Python encoder
        stays usable as a value; calling ``encode`` after ``finish`` is a
        caller error.
        """
        for _ in range(8):
            self._code.append(self.range_coder.left_shift())
        return bytes(self._code)
