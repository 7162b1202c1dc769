"""The cum-table layout both rans16 kernels read.

``prep_cum_vreg`` and ``prep_cum_vreg_batch`` are copied from
``range_coder_rust_tpu/kernels/vreg.py``.
On the TPU the (8, 128) shape is one vector register; here the same 1024
entries are one flat table that each CUDA block stages in shared memory.
The padding sentinel is larger than any 16-bit slot, so the decoder's
binary search never selects a padding entry.
"""

from __future__ import annotations

import numpy as np

#: entries of the padded cum table (alphabets up to 1023 symbols)
CUM_ENTRIES = 1024
#: padding sentinel, larger than any slot value
CUM_PAD = 0x7FFFFFFF


def prep_cum_vreg(cum: np.ndarray) -> np.ndarray:
    """Lay a (A+1,) cum table out as (8, 128) uint32, padded with
    ``CUM_PAD``.  Alphabets up to 1023 symbols fit."""
    if cum.shape[0] > CUM_ENTRIES:
        raise ValueError(f"alphabet {cum.shape[0] - 1} exceeds 1023 symbols")
    flat = np.full(CUM_ENTRIES, CUM_PAD, np.uint32)
    flat[: cum.shape[0]] = cum
    return flat.reshape(8, 128)


def prep_cum_vreg_batch(cums: np.ndarray) -> np.ndarray:
    """:func:`prep_cum_vreg` for a (NG, A+1) batch of cum tables (one per
    group, the adaptive mode) -> (NG, 8, 128) uint32."""
    ng, a1 = cums.shape
    if a1 > CUM_ENTRIES:
        raise ValueError(f"alphabet {a1 - 1} exceeds 1023 symbols")
    flat = np.full((ng, CUM_ENTRIES), CUM_PAD, np.uint32)
    flat[:, :a1] = cums
    return flat.reshape(ng, 8, 128)
