"""Streaming scalar decoder (reference src/decoder.rs:1-55).

Mirror image of :class:`Encoder`: owns its own :class:`RangeCoder` replica,
a 64-bit sliding code window ``data``, and a cursor into the remaining code
bytes.  ``decode`` asks the model to locate the symbol (``find_index``),
replays the *identical* ``param_update`` the encoder ran, and shifts in
exactly as many bytes as the encoder emitted to stay in lock-step
(SURVEY.md §3 invariant 4).
"""

from __future__ import annotations

from ..errors import TruncatedStream
from ..pmodel import PModel
from .rc64 import MASK64, RangeCoder


class Decoder:
    """Lock-step decoder (reference src/decoder.rs:6-12)."""

    __slots__ = ("range_coder", "_data", "_buffer", "_pos")

    def __init__(self, code: bytes) -> None:
        self.range_coder = RangeCoder()
        self._data = 0
        self._buffer = bytes(code)
        self._pos = 0
        # prime the 64-bit window with the first 8 bytes
        # (reference src/decoder.rs:21; panics there on short input —
        # here a typed TruncatedStream, SURVEY.md §5)
        self._shift_left_buffer(8)

    def data(self) -> int:
        """The 64-bit code window aligned with the coder's lower bound
        (reference src/decoder.rs:27-29)."""
        return self._data

    def _shift_left_buffer(self, n: int) -> None:
        """Shift ``n`` fresh bytes into the window (reference src/decoder.rs:31-35)."""
        end = self._pos + n
        if end > len(self._buffer):
            raise TruncatedStream(
                f"need {n} more code byte(s) at offset {self._pos}, "
                f"stream has {len(self._buffer)}"
            )
        for b in self._buffer[self._pos : end]:
            self._data = ((self._data << 8) | b) & MASK64
        self._pos = end

    def decode(self, pmodel: PModel) -> int:
        """Decode one symbol index (reference src/decoder.rs:38-54)."""
        index = pmodel.find_index(self)
        n = len(
            self.range_coder.param_update(
                pmodel.c_freq(index), pmodel.cum_freq(index), pmodel.total_freq()
            )
        )
        self._shift_left_buffer(n)
        return index
