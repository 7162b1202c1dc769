"""Typed error hierarchy of the PyTorch port.

The port's own copy of ``range_coder_rust_tpu/errors.py``: the same class
names and the same hierarchy, so the port raises what the JAX package
raises, but as its own classes (``except range_coder_rust_tpu.errors.X``
does not catch the port's ``X``).  ``tests/test_torch_import.py`` holds
the two hierarchies equal.

The reference exposes exactly two overflow variants
(``RangeCoderError::{LowerBoundOverflow, UpperBoundOverflow}``,
reference src/error.rs:4-13) and lets the decoder panic on truncated input
(src/decoder.rs:33).  Per SURVEY.md §5 the framework replaces panics with
explicit validation errors and extends the hierarchy with container/stream
validation (truncated stream, bad header, table mismatch, zero-frequency
symbol, checksum mismatch) so corruption is localized and reportable.
"""

from __future__ import annotations


class RangeCoderError(Exception):
    """Base class for all framework errors (reference src/error.rs:4)."""


class LowerBoundOverflow(RangeCoderError):
    """Overflow while updating the lower bound (reference src/error.rs:5-10).

    Practically unreachable under the carryless invariant (SURVEY.md §3
    invariant 1) — kept for API parity and as a safety net in the scalar
    golden model.
    """

    def __init__(self, lower_bound: int, add_val: int, range_: int):
        self.lower_bound = lower_bound
        self.add_val = add_val
        self.range = range_
        super().__init__(
            f"Overflow happened while lower_bound updating "
            f"{lower_bound} + {add_val} , {range_}"
        )


class UpperBoundOverflow(RangeCoderError):
    """Overflow while computing the upper bound (reference src/error.rs:11-12)."""

    def __init__(self, lower_bound: int, range_: int):
        self.lower_bound = lower_bound
        self.range = range_
        super().__init__(
            f"Overflow happened when calc upper_bound {lower_bound} + {range_}"
        )


class TruncatedStream(RangeCoderError):
    """Decoder ran out of code bytes (reference panics here: src/decoder.rs:33)."""


class InvalidHeader(RangeCoderError):
    """Container header failed validation (magic / version / field range)."""


class ChecksumMismatch(RangeCoderError):
    """A per-block checksum did not match; names the offending block."""

    def __init__(self, block_index: int, expected: int, actual: int):
        self.block_index = block_index
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"block {block_index}: checksum mismatch "
            f"(expected {expected:#010x}, got {actual:#010x})"
        )


class TableError(RangeCoderError):
    """Invalid probability table (zero total, non-monotone cum, freq overflow)."""


class ZeroFrequency(TableError):
    """A symbol with zero frequency was encoded (undefined in the reference:
    src/pmodel.rs:16-18)."""


class ConfigError(RangeCoderError):
    """Invalid framework configuration (block size, lanes, precision...)."""
