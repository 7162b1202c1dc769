"""Pow2 frequency tables.

The counterpart of ``range_coder_rust_tpu/models/table.py``
(``TableArrays``, ``counts_from_data``, ``cumulative``, ``find_index``,
``decode_lut``, ``ideal_bits``, ``normalize_pow2``, ``Pow2Table``,
``build_table_pow2``, ``table_from_data_pow2``).  That module cannot be
imported without its array framework, so the port keeps its own copy.
The tensor helpers run on the device of their inputs and return the
reference's values: u32 counts and sums as int64, symbol indices as
int32.  The reference has a
host and a device apportionment; the port has one, :func:`normalize_pow2`,
batched over rows: it builds the host tables (one row on the CPU) and the
planar per-block tables (one row a block, on their device).
``tests/test_torch_table.py`` holds it equal to the reference's
``normalize_pow2_np``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import TableError

_MASK32 = 0xFFFFFFFF


class TableArrays(NamedTuple):
    """A table as tensors: ``c (A,)`` frequencies and ``cum (A+1,)``
    exclusive prefix sums with ``cum[A] == total``."""

    c: torch.Tensor
    cum: torch.Tensor


def counts_from_data(data: torch.Tensor, alphabet: int) -> torch.Tensor:
    """Histogram of symbol occurrences (the vectorized
    ``add_alphabet_freq``, reference examples/sample_impl.rs:58-60):
    ``(alphabet,)`` int64.  Symbols at or above ``alphabet`` are dropped,
    as the reference's scatter drops them."""
    counts = torch.bincount(data.reshape(-1).long(), minlength=alphabet)
    return counts[:alphabet] & _MASK32


def cumulative(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum with the total appended (``calc_cum``,
    reference examples/sample_impl.rs:61-69): ``(A+1,)`` int64 holding
    the reference's u32 sums."""
    csum = (counts.long() & _MASK32).cumsum(0) & _MASK32
    return torch.cat([csum.new_zeros(1), csum])


def find_index(cum: torch.Tensor, rfreq: torch.Tensor) -> torch.Tensor:
    """Largest ``i`` with ``cum[i] <= rfreq``: the reference's binary
    search (examples/sample_impl.rs:33-44) as a vectorized searchsorted,
    int32.  ``rfreq`` must be below the total (``cum[-1]``)."""
    return torch.searchsorted(cum[1:].long().contiguous(), rfreq.long(),
                              right=True).to(torch.int32)


def decode_lut(cum: torch.Tensor, k: int) -> torch.Tensor:
    """The ``2**k`` rfreq -> symbol table of a pow2-total table: the
    decoder's search as one gather.  int32."""
    return find_index(cum, torch.arange(1 << k, device=cum.device))


def ideal_bits(c: torch.Tensor, total: int) -> torch.Tensor:
    """Per-symbol Shannon bound ``log2(total / c)`` (the vectorized
    ``ideal_code_length``, reference src/pmodel.rs:14-40): float32, inf
    for zero-frequency symbols (undefined there, src/pmodel.rs:16-18)."""
    bits = (torch.log2(torch.tensor(float(total), device=c.device))
            - torch.log2(c.to(torch.float32)))
    return torch.where(c > 0, bits, torch.inf)


def normalize_pow2(counts: torch.Tensor, k: int) -> torch.Tensor:
    """Rescale every row of ``(..., A)`` counts to sum exactly ``2**k``,
    keeping every nonzero count >= 1: exact integer largest-remainder
    apportionment, on the counts' device; int64.

    1. ``base = max(floor(counts * 2^k / total), 1)`` for present symbols;
    2. a positive deficit gives +1 to the present symbols with the largest
       division remainders (ties to the smaller symbol index);
    3. a negative deficit (the min-1 clamps overshot) is taken from the
       largest allocations first, never below 1.

    The reference's ``normalize_pow2`` (``models/table.py:61-115``) mapped
    over rows, and its ``normalize_pow2_np`` on one row: their sorts are
    stable, and so are these.  Each row needs a total below 2^31 and at
    most ``2**k`` present symbols."""
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    counts = counts.long()
    a = counts.shape[-1]
    total = counts.sum(-1, keepdim=True).clamp(min=1)
    present = counts > 0
    q = (counts << k) // total
    r = (counts << k) - q * total
    base = torch.where(present, q.clamp(min=1), 0)
    diff = (1 << k) - base.sum(-1, keepdim=True)

    # +1 to the `diff` present symbols with the largest remainders, ties
    # to the smaller index; absent symbols sort last
    order = torch.argsort(torch.where(present, -(r + 1), 0), dim=-1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(a, device=counts.device).expand_as(order))
    bump = present & (rank < diff.clamp(min=0))

    # take -diff from the largest allocations first, never below 1
    surplus = torch.where(base > 0, base - 1, 0)
    order_d = torch.argsort(-(base + 1), dim=-1, stable=True)
    surplus_sorted = surplus.gather(-1, order_d)
    before = surplus_sorted.cumsum(-1) - surplus_sorted
    give_sorted = torch.minimum(((-diff).clamp(min=0) - before).clamp(min=0),
                                surplus_sorted)
    give = torch.empty_like(give_sorted).scatter_(-1, order_d, give_sorted)
    return base + bump - give


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
    c = normalize_pow2(torch.from_numpy(counts_np.astype(np.int64))[None],
                       k)[0].numpy().astype(np.uint32)
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
