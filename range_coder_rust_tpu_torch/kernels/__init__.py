"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
rans16 profile's encode and decode, and the planar profile's block coder,
the histogram of its shared table and the compaction of its payloads.

Each wrapper runs the plain version for a CPU tensor and launches its
kernel (``csrc/*.cu``, built at first use by ``_build.py``) for a CUDA
tensor.  It counts its kernel launches: the rans16 wrappers and the
compaction in ``<wrapper>.launches``, the planar coder's by the table
placement the kernel reported and the histogram's by its path, in
``<wrapper>.placements``; the planar coder's calls also by the form of
their total, in ``<wrapper>.totals`` (there the plain versions count
too).
"""

from .histogram import HISTOGRAM_PATHS, histogram_plain, planar_histogram
from .planar import (PLACEMENTS, TOTAL_FORMS, planar_compact,
                     planar_compact_plain, planar_decode_blocks,
                     planar_decode_plain, planar_encode_blocks,
                     planar_encode_plain)
from .rans_decode import decode_plan, rans_decode_plain, rans_decode_tiled
from .rans_encode import (encode_plan, rans_encode_plain, rans_encode_tiled,
                          tile_steps_for)
from .vreg import prep_cum_vreg

#: the kernel wrappers whose launches are counted, by kernel name
WRAPPERS = {"rans_encode": rans_encode_tiled, "rans_decode": rans_decode_tiled,
            "planar_encode": planar_encode_blocks,
            "planar_decode": planar_decode_blocks,
            "planar_histogram": planar_histogram,
            "planar_compact": planar_compact}


#: the wrappers that count their launches by table placement or path
PLACED = {name: fn for name, fn in WRAPPERS.items()
          if hasattr(fn, "placements")}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: sum(fn.placements.values()) if name in PLACED
            else fn.launches for name, fn in WRAPPERS.items()}


def launch_placements() -> dict:
    """The planar kernels' launches so far, as each launch reported
    them: the coder's by the placement of its table (over
    :data:`PLACEMENTS`), the histogram's by its path (over
    :data:`HISTOGRAM_PATHS`):
    ``{kernel: {placement or path: count}}``."""
    return {name: dict(fn.placements) for name, fn in PLACED.items()}


#: the wrappers that count their calls by the form of their total
TOTALED = {name: fn for name, fn in WRAPPERS.items() if hasattr(fn, "totals")}


def launch_totals() -> dict:
    """The planar coder's calls so far by the form of their total (over
    :data:`TOTAL_FORMS`: ``pow2``, ``pow2_wide``, ``raw``), a kernel's
    launch as it reported it and a plain version's call by the same rule:
    ``{kernel: {form: count}}``."""
    return {name: dict(fn.totals) for name, fn in TOTALED.items()}


def reset_launch_counts() -> None:
    """Zero :func:`launch_counts`, :func:`launch_placements` and
    :func:`launch_totals`."""
    for name, fn in WRAPPERS.items():
        if name in PLACED:
            fn.placements = dict.fromkeys(fn.placements, 0)
        else:
            fn.launches = 0
        if name in TOTALED:
            fn.totals = dict.fromkeys(fn.totals, 0)


__all__ = [
    "HISTOGRAM_PATHS",
    "PLACED",
    "PLACEMENTS",
    "TOTALED",
    "TOTAL_FORMS",
    "WRAPPERS",
    "decode_plan",
    "encode_plan",
    "histogram_plain",
    "launch_counts",
    "launch_placements",
    "launch_totals",
    "planar_compact",
    "planar_compact_plain",
    "planar_decode_blocks",
    "planar_decode_plain",
    "planar_encode_blocks",
    "planar_encode_plain",
    "planar_histogram",
    "prep_cum_vreg",
    "rans_decode_plain",
    "rans_decode_tiled",
    "rans_encode_plain",
    "rans_encode_tiled",
    "reset_launch_counts",
    "tile_steps_for",
]
