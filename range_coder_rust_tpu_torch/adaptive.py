"""Per-block adaptive tables for the planar profile.

The counterpart of ``range_coder_rust_tpu/adaptive.py``.  Each block gets
its own table fitted to its contents:

  pass 1: per-block histograms (one ``bincount`` over ``block * A +
          symbol``) and the batched pow2 normalization
          (:func:`.models.table.normalize_pow2`);
  pass 2: the planar block coder with one table row per block
          (:func:`.blocks.encode_blocks` takes ``(B, A)`` tables; the
          planar kernels on a card).

The container stores one table per block (FLAG_PER_BLOCK_TABLES), so any
block stays independently decodable.  As in the reference, this path is
for conformance; the adaptive mode for throughput is rans16's
``CodecConfig(per_group_tables=True)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import format as fmt
from .api import _CHUNK_SYMBOLS, _as_symbols
from .blocks import (decode_payloads, default_capacity, encode_blocks,
                     payload_buffers, upload_rows)
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
    """One-call adaptive encode: per-block tables, then the container."""
    symbols, a = _as_symbols(data, alphabet)
    if a > 1 << k:
        raise ConfigError(
            f"alphabet {a} cannot get nonzero frequencies under total 2**{k}")
    n = int(symbols.size)
    L = block_len
    b = max(1, math.ceil(n / L))
    padded = np.zeros(b * L, symbols.dtype)
    padded[:n] = symbols
    rows = padded.reshape(b, L)

    payloads, tables = [], []
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    for start in range(0, b, rows_per_chunk):
        chunk = upload_rows(rows[start : start + rows_per_chunk], device)
        c, cum = block_tables(chunk, alphabet=a, k=k)
        cap = default_capacity(L, k)
        while True:
            code, lengths = encode_blocks(chunk, c, cum, k=k, capacity=cap)
            lengths_np = lengths.cpu().numpy()
            if int(lengths_np.max()) <= cap:
                break
            cap *= 2  # rare adversarial blocks
        code = code.cpu().numpy()
        tables.append(c.cpu().numpy().astype(np.uint32))
        payloads += [code[i, : lengths_np[i]].tobytes()
                     for i in range(code.shape[0])]

    return fmt.pack(
        k=k,
        alphabet=a,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=np.concatenate(tables),
        per_block_tables=True,
        with_checksums=with_checksums,
        device=device,
    )


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
    b, L, n = cont.n_blocks, cont.block_len, cont.n_symbols
    c_all = torch.from_numpy(np.asarray(cont.tables_c, np.int64))
    cum_all = torch.nn.functional.pad(c_all.cumsum(1), (1, 0))
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    out = np.empty(b * L, np.int32)
    for start in range(0, b, rows_per_chunk):
        stop = min(start + rows_per_chunk, b)
        code, offs, lens = payload_buffers(
            cont.payloads[start:stop], cont.lengths[start:stop], device)
        dec = decode_payloads(code, offs, lens, c_all[start:stop].to(device),
                              cum_all[start:stop].to(device), k=cont.k,
                              block_len=L)
        out[start * L : stop * L] = dec.cpu().numpy().reshape(-1)
    return out[:n]
