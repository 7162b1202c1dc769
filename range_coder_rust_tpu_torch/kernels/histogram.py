"""Order-0 histogram: the CUDA kernel's wrapper and its plain PyTorch
version.

The planar encode's shared table is built from the counts of its input.
The api uploads the input once and counts it where it lies
(``csrc/planar_histogram.cu``, whose header says what bounds it), not in
a widened host copy.  The wrapper takes ``(n,)`` symbols at one of the
widths of :data:`ROW_TYPES` and returns ``(a_count,)`` int64 counts on
their device; a symbol outside ``[0, a_count)`` is not counted.  Integer
counts are exact in any order, so both versions equal
``np.bincount(symbols, minlength=a_count)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: the widths planar symbols travel at, by host dtype: the host view that
#: fills a tensor and the tensor's dtype (u16 as int16 bits).  The api's
#: device rows, ``blocks.upload_rows`` and this kernel share it.
ROW_TYPES = {np.dtype(np.uint8): (np.uint8, torch.uint8),
             np.dtype(np.uint16): (np.int16, torch.int16),
             np.dtype(np.int32): (np.int32, torch.int32)}

#: where a launch keeps its sub-histograms, by the number the kernel
#: reports (``planar_histogram::Path`` of
#: ``csrc/planar_histogram_path.cuh``, which also holds the rule): one u32
#: copy a warp in shared memory, one copy a CTA in shared memory, or none
#: (u64 atomics on the totals in device memory)
HISTOGRAM_PATHS = ("warp_private", "block_smem", "global")

_DTYPES = tuple(t for _, t in ROW_TYPES.values())


def _check(symbols: torch.Tensor, a_count: int) -> None:
    if symbols.dim() != 1 or symbols.dtype not in _DTYPES:
        raise ValueError(f"symbols must be 1-D uint8, int16 or int32, got "
                         f"{symbols.dtype} {tuple(symbols.shape)}")
    if not 1 <= a_count < 1 << 31:
        raise ValueError(f"a_count {a_count} must be in [1, 2^31)")


def histogram_plain(symbols: torch.Tensor, a_count: int) -> torch.Tensor:
    """The counts in plain PyTorch: ``torch.bincount`` of the symbols in
    ``[0, a_count)``."""
    _check(symbols, a_count)
    x = symbols
    if x.dtype == torch.int16:
        x = x.to(torch.int32) & 0xFFFF  # u16 bits
    elif x.dtype == torch.int32:
        x = x[(x >= 0) & (x < a_count)]
    return torch.bincount(x, minlength=a_count)[:a_count]


def planar_histogram(symbols: torch.Tensor, a_count: int) -> torch.Tensor:
    """The ``(a_count,)`` int64 counts of ``symbols``: the CUDA kernel for
    a CUDA tensor, on the path the kernel picks from the alphabet, the
    width and the card; the plain version for a CPU tensor."""
    if symbols.device.type == "cpu":
        return histogram_plain(symbols, a_count)
    if symbols.device.type != "cuda":
        raise ValueError(f"no histogram for device {symbols.device}")
    _check(symbols, a_count)
    symbols = symbols.contiguous()
    dev = symbols.device
    counts = torch.empty(a_count, dtype=torch.int64, device=dev)
    from ._build import check, library

    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rc_planar_histogram(
            symbols.data_ptr(), symbols.element_size(), symbols.numel(),
            a_count, counts.data_ptr(), stream, ctypes.byref(path))
    check(err, "planar histogram kernel")
    planar_histogram.placements[HISTOGRAM_PATHS[path.value]] += 1
    return counts


#: launches of the CUDA kernel (the plain version does not count), by the
#: path each launch reported
planar_histogram.placements = dict.fromkeys(HISTOGRAM_PATHS, 0)
