"""Block-parallel encode and decode of the planar profile.

The counterpart of ``range_coder_rust_tpu/blocks.py``.  The input is cut
into ``B`` independent blocks of ``L`` symbols, each coded on its own
(per block, the payload is byte-identical to the scalar coder's with the
same table, reference src/range_coder.rs:53-92).  The coder is two CUDA
kernels, one thread a block, behind the wrappers of
:mod:`.kernels.planar`, which run their plain PyTorch versions (a step
loop over every block at once) for CPU tensors.

Tables are shared (``c (A,)``, ``cum (A+1,)``) or one per block
(``(B, A)``, ``(B, A+1)``, the adaptive mode), int64 tensors on the
symbols' device.  ``encode_scan``, ``encode_scan_div`` and
``compact_emissions``, the plain encode's two stages, are re-exported
from :mod:`.kernels.planar` under their reference names.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .format import PayloadArea
from .kernels.planar import (compact_emissions, encode_scan, encode_scan_div,
                             planar_decode_blocks, planar_encode_blocks)

#: flush length: the final 64-bit lower bound (reference
#: src/encoder.rs:40-46)
FLUSH_BYTES = 8

__all__ = ["FLUSH_BYTES", "compact_emissions", "decode_blocks",
           "decode_blocks_div", "decode_payloads", "default_capacity",
           "encode_blocks", "encode_blocks_div", "encode_scan",
           "encode_scan_div", "payload_buffers", "upload_rows"]


def default_capacity(block_len: int, k: int) -> int:
    """Worst-case payload bytes of a block: ``ceil(k/8) + 1`` bytes a
    symbol plus the flush, rounded up to a multiple of 4.  Loose on
    purpose; the encoder checks every block's length against it."""
    cap = block_len * ((k + 7) // 8 + 1) + FLUSH_BYTES
    return -(-cap // 4) * 4


def upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """``(B, L)`` host symbols -> a tensor on ``device`` at their own
    width: uint8 stays uint8, uint16 travels as int16 bits, int32 stays
    int32 (any other integer type goes as int32)."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == np.uint16:
        rows = rows.view(np.int16)
    elif rows.dtype not in (np.uint8, np.int32):
        rows = rows.astype(np.int32)
    return torch.from_numpy(rows).to(device)


def encode_blocks(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  *, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``(B, L)`` symbol indices into per-block byte streams with a
    total of ``2**k``.  Returns ``(code (B, capacity) uint8, lengths (B,)
    int64)``, the lengths with the 8 flush bytes; a length above
    ``capacity`` means that block was cut and must be encoded again with
    more room."""
    return planar_encode_blocks(symbols, c, cum, k=k, capacity=capacity)


def encode_blocks_div(symbols: torch.Tensor, c: torch.Tensor,
                      cum: torch.Tensor, total: int, *, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encode_blocks` for any u32 ``total``."""
    return planar_encode_blocks(symbols, c, cum, total=total,
                                capacity=capacity)


def decode_blocks(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                  *, k: int, block_len: int) -> torch.Tensor:
    """Decode ``(B, C)`` uint8 streams back to ``(B, block_len)`` int32
    symbols (total ``2**k``).  Like the reference, a payload carries no
    end marker: the container gives the symbol count."""
    return planar_decode_blocks(code, c, cum, k=k, block_len=block_len)


def decode_blocks_div(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                      total: int, *, block_len: int) -> torch.Tensor:
    """:func:`decode_blocks` for any u32 ``total``."""
    return planar_decode_blocks(code, c, cum, total=total,
                                block_len=block_len)


def payload_buffers(payloads, lengths, device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A container's payloads as the decode takes them where they lie:
    ``(code, offsets, lengths)`` on ``device``, one flat uint8 buffer
    (one upload) and each block's offset and length in it (int64).

    ``payloads`` is a :class:`.format.PayloadArea` (the api's in-place
    parse: its area is the buffer, uploaded as it lies in the blob) or a
    list of byte strings (joined into the buffer, one host copy)."""
    lens = np.asarray(lengths, np.int64)
    if isinstance(payloads, PayloadArea):
        offs = payloads.offsets[:-1]
        with warnings.catch_warnings():
            # the area is a read-only view of the blob: the tensor over it
            # is only read, by the H2D copy or the plain decode
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable", UserWarning)
            flat = torch.from_numpy(np.frombuffer(payloads.area, np.uint8))
    else:
        offs = np.zeros(lens.size, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        flat = torch.from_numpy(
            np.frombuffer(bytearray().join(payloads), np.uint8))
    return (flat.to(device), torch.from_numpy(offs).to(device),
            torch.from_numpy(lens).to(device))


def decode_payloads(code: torch.Tensor, offsets: torch.Tensor,
                    lengths: torch.Tensor, c: torch.Tensor,
                    cum: torch.Tensor, *, block_len: int,
                    k: Optional[int] = None, total: Optional[int] = None
                    ) -> torch.Tensor:
    """Decode payloads where they lie (block ``b`` is ``lengths[b]`` bytes
    at ``offsets[b]`` of the flat uint8 ``code``; :func:`payload_buffers`)
    into ``(B, block_len)`` int32 symbols, with a total of ``2**k`` or a
    raw u32 ``total``."""
    return planar_decode_blocks(code, c, cum, k=k, total=total,
                                block_len=block_len, offsets=offsets,
                                lengths=lengths)
