"""Host-side pow2 frequency tables for the rans16 profile (NumPy only).

A copy of the NumPy half of ``range_coder_rust_tpu/models/table.py``
(``normalize_pow2_np``, ``Pow2Table``, ``build_table_pow2``,
``table_from_data_pow2``).  That module also holds the device builder of
the reference and cannot be imported without its array framework, so the
port keeps its own copy of the host builder; ``tests/test_torch_table.py``
holds the two equal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..errors import TableError


def normalize_pow2_np(counts: np.ndarray, k: int) -> np.ndarray:
    """Rescale ``counts`` to sum exactly ``2**k``, keeping every nonzero
    count >= 1: exact integer largest-remainder apportionment.

    1. ``base = max(floor(counts * 2^k / total), 1)`` for present symbols;
    2. a positive deficit gives +1 to the present symbols with the largest
       division remainders (ties to the smaller symbol index);
    3. a negative deficit (the min-1 clamps overshot) is taken from the
       largest allocations first, never below 1.
    """
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    counts = counts.astype(np.uint64)
    a = counts.shape[0]
    total = int(counts.sum())
    present = counts > 0

    prod = counts * np.uint64(1 << k)
    q = (prod // max(total, 1)).astype(np.int64)
    r = (prod % max(total, 1)).astype(np.int64)
    base = np.where(present, np.maximum(q, 1), 0).astype(np.int64)
    diff = (1 << k) - int(base.sum())

    key = np.where(present, -(r + 1), 0)
    order = np.argsort(key, kind="stable")
    rank = np.empty(a, np.int64)
    rank[order] = np.arange(a)
    bump = (present & (rank < max(diff, 0))).astype(np.int64)

    surplus = np.where(base > 0, base - 1, 0)
    order_d = np.argsort(-(base + 1), kind="stable")
    surplus_sorted = surplus[order_d]
    before = np.concatenate([[0], np.cumsum(surplus_sorted)[:-1]])
    need = max(-diff, 0)
    give_sorted = np.clip(need - before, 0, surplus_sorted)
    give = np.empty(a, np.int64)
    give[order_d] = give_sorted

    return (base + bump - give).astype(np.uint32)


class Pow2Table(NamedTuple):
    """A validated pow2-normalized table."""

    c: np.ndarray  # (A,) uint32, sum == 2**k
    cum: np.ndarray  # (A+1,) uint32
    k: int

    @property
    def alphabet(self) -> int:
        return int(self.c.shape[0])


def build_table_pow2(counts: np.ndarray, k: int) -> Pow2Table:
    """Build and validate a pow2 table from raw counts."""
    counts_np = np.asarray(counts).astype(np.uint64)
    if counts_np.ndim != 1 or counts_np.shape[0] < 1:
        raise TableError("counts must be a 1-D array with >= 1 symbol")
    total = int(counts_np.sum())
    if total == 0:
        raise TableError("total_freq is zero: table has no counts")
    # the apportionment's sort keys assume sum < 2^31: halve proportionally,
    # keeping present symbols >= 1 (sub-ulp effect on the final 2^k shares)
    while total >= 1 << 31:
        counts_np = np.maximum(counts_np >> np.uint64(1), (counts_np > 0))
        total = int(counts_np.sum())
    nnz = int((counts_np > 0).sum())
    if nnz > (1 << k):
        raise TableError(
            f"{nnz} present symbols cannot share total 2**{k}; raise k"
        )
    c = normalize_pow2_np(counts_np, k)
    if int(c.sum()) != 1 << k or np.any((counts_np > 0) & (c == 0)):
        raise TableError("pow2 normalization lost a symbol or the total")
    cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
    return Pow2Table(c=c, cum=cum, k=k)


def table_from_data_pow2(data: np.ndarray, alphabet: int, k: int) -> Pow2Table:
    """Histogram ``data`` then normalize (all NumPy)."""
    counts = np.bincount(np.asarray(data).reshape(-1), minlength=alphabet)
    if counts.shape[0] > alphabet:
        raise TableError(
            f"data contains symbol {counts.shape[0] - 1} >= alphabet {alphabet}"
        )
    return build_table_pow2(counts, k)
