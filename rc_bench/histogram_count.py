"""The least time one H100 could take for an encode's order-0 histogram.

Frozen here, beside ``roofline.py``, so that it reads the same work
whatever path counts it: shared sub-histograms, atomics on the totals or
a later design.

bound = (n_symbols x symbol bytes + alphabet x 8) / 3.35 TB/s

* Bytes: each input symbol read once at the width its alphabet needs (1
  byte up to 256 symbols, 2 up to 65536, else 4: ``roofline.symbol_bytes``)
  and one u64 total a symbol of the alphabet written once.
* No operation term: the adds are one a symbol, far below what the bytes
  take at 16.7 TOP/s.
"""

from __future__ import annotations

from .roofline import PEAK_BYTES_PER_S, symbol_bytes


def histogram_bytes(layout: dict) -> int:
    """Bytes of one histogram of a container's input, from its
    :func:`rc_bench.reference.container.layout`."""
    a = layout["alphabet"]
    return layout["n_symbols"] * symbol_bytes(a) + a * 8


def bound_s(layout: dict) -> float:
    return histogram_bytes(layout) / PEAK_BYTES_PER_S
