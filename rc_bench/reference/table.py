"""The order-0 table of a data array, plain NumPy.

A frozen copy of the shared table build that both packages use: a
histogram, totals at or above 2^31 halved (present symbols kept at 1 or
more), then the exact largest-remainder apportionment to ``2**k``
(``normalize_pow2_np`` of the JAX package's ``models/table.py``, which
the port's batched ``normalize_pow2`` equals on one row).
"""

from __future__ import annotations

import numpy as np


def histogram(data: np.ndarray, alphabet: int) -> np.ndarray:
    """``(alphabet,)`` uint64 counts of a 1-D symbol array."""
    src = data if data.dtype in (np.uint8, np.uint16) else data.astype(np.int64)
    return np.bincount(src, minlength=alphabet)[:alphabet].astype(np.uint64)


def normalize_pow2(counts: np.ndarray, k: int) -> np.ndarray:
    """Counts rescaled to sum exactly ``2**k``, every present symbol at 1
    or more: base shares, +1 to the largest remainders (ties to the
    smaller symbol), and any overshoot of the clamps taken from the
    largest shares first."""
    counts = counts.astype(np.uint64)
    a = counts.shape[0]
    total = int(counts.sum())
    present = counts > 0
    prod = counts * np.uint64(1 << k)
    q = (prod // max(total, 1)).astype(np.int64)
    r = (prod % max(total, 1)).astype(np.int64)
    base = np.where(present, np.maximum(q, 1), 0).astype(np.int64)
    diff = (1 << k) - int(base.sum())

    order = np.argsort(np.where(present, -(r + 1), 0), kind="stable")
    rank = np.empty(a, np.int64)
    rank[order] = np.arange(a)
    bump = (present & (rank < max(diff, 0))).astype(np.int64)

    surplus = np.where(base > 0, base - 1, 0)
    order_d = np.argsort(-(base + 1), kind="stable")
    surplus_sorted = surplus[order_d]
    before = np.concatenate([[0], np.cumsum(surplus_sorted)[:-1]])
    give_sorted = np.clip(max(-diff, 0) - before, 0, surplus_sorted)
    give = np.empty(a, np.int64)
    give[order_d] = give_sorted
    return (base + bump - give).astype(np.uint32)


def build(counts: np.ndarray, k: int) -> np.ndarray:
    """The table's ``c`` (uint32, sum ``2**k``) from raw counts."""
    counts = counts.astype(np.uint64)
    if int(counts.sum()) == 0:
        counts[0] = 1  # an empty input: any valid table
    while int(counts.sum()) >= 1 << 31:
        counts = np.maximum(counts >> np.uint64(1),
                            (counts > 0).astype(np.uint64))
    c = normalize_pow2(counts, k)
    if int(c.sum()) != 1 << k or np.any((counts > 0) & (c == 0)):
        raise ValueError("table lost a symbol or its total")
    return c
