"""Per-block adaptive tables for the planar profile.

The counterpart of ``range_coder_rust_tpu/adaptive.py``.  Each block gets
its own table fitted to its contents:

  pass 1: per-block histograms (one ``bincount`` over ``block * A +
          symbol``) and the batched pow2 normalization
          (:func:`.models.table.normalize_pow2`);
  pass 2: the planar block coder with one table row per block
          (the planar kernels take ``(B, A)`` tables).

Both passes run a chunk at a time inside the api's one planar encode
(``api._encode_planar``: the input uploaded once and padded on the
device), so the ``(B, A)`` tables never exist for the whole input; the
decode is the api's planar decode.  The container stores one table per block (FLAG_PER_BLOCK_TABLES), so any
block stays independently decodable.  As in the reference, this path is
for conformance; the adaptive mode for throughput is rans16's
``CodecConfig(per_group_tables=True)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import format as fmt
from .api import CodecConfig, _as_symbols, _decode_container, _encode_planar
from .errors import ConfigError
from .models.table import normalize_pow2


def block_tables(symbols: torch.Tensor, *, alphabet: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: ``(c (B, A), cum (B, A+1))`` int64, each block's pow2
    table from its own histogram."""
    B = symbols.shape[0]
    sym = symbols.long()
    if symbols.dtype == torch.int16:
        sym &= 0xFFFF  # u16 bits
    flat = (sym + torch.arange(B, device=symbols.device)[:, None]
            * alphabet).view(-1)
    counts = torch.bincount(flat, minlength=B * alphabet).view(B, alphabet)
    c = normalize_pow2(counts, k)
    return c, torch.nn.functional.pad(c.cumsum(1), (1, 0))


def encode_adaptive(
    data,
    *,
    alphabet: Optional[int] = None,
    k: int = 12,
    block_len: int = 512,
    with_checksums: bool = True,
    device="cuda",
) -> bytes:
    """One-call adaptive encode: per-block tables, then the container.
    ``k`` in [1, 16]: the wider totals of the shared planar table
    (``CodecConfig(k=...)`` up to 24) are refused here, where each block
    stores its own table."""
    if not 1 <= k <= 16:
        raise ConfigError(f"per-block tables take k in [1, 16], got {k}")
    symbols, a = _as_symbols(data, alphabet, device)
    if a > 1 << k:
        raise ConfigError(
            f"alphabet {a} cannot get nonzero frequencies under total 2**{k}")
    config = CodecConfig(block_len=block_len, with_checksums=with_checksums)
    return _encode_planar(
        symbols, a, config, device, k=k,
        block_tables=lambda rows: block_tables(rows, alphabet=a, k=k))


def decode_adaptive(blob: bytes, *, verify_checksums: bool = True,
                    device="cuda") -> np.ndarray:
    """Decode a per-block-tables container (int32 symbols)."""
    return decode_adaptive_container(
        fmt.unpack(blob, verify_checksums=verify_checksums, device=device,
                   copy=False),
        device=device)


def decode_adaptive_container(cont: fmt.Container, device="cuda"
                              ) -> np.ndarray:
    """Decode an already-parsed per-block-tables container."""
    if not cont.per_block_tables:
        raise ConfigError("container has a shared table; use api.decode")
    return _decode_container(cont, device)
