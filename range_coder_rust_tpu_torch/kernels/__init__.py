"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
rans16 profile's encode and decode, and the planar profile's block coder.

Each wrapper runs the plain version for a CPU tensor and launches its
kernel (``csrc/*.cu``, built at first use by ``_build.py``) for a CUDA
tensor.  It counts its kernel launches: the rans16 wrappers in
``<wrapper>.launches``, the planar ones by the table placement the kernel
reported, in ``<wrapper>.placements``.
"""

from .planar import (PLACEMENTS, planar_decode_blocks, planar_decode_plain,
                     planar_encode_blocks, planar_encode_plain)
from .rans_decode import decode_plan, rans_decode_plain, rans_decode_tiled
from .rans_encode import (encode_plan, rans_encode_plain, rans_encode_tiled,
                          tile_steps_for)
from .vreg import prep_cum_vreg

#: the kernel wrappers whose launches are counted, by kernel name
WRAPPERS = {"rans_encode": rans_encode_tiled, "rans_decode": rans_decode_tiled,
            "planar_encode": planar_encode_blocks,
            "planar_decode": planar_decode_blocks}


#: the wrappers that count their launches by table placement
PLACED = {name: fn for name, fn in WRAPPERS.items()
          if hasattr(fn, "placements")}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: sum(fn.placements.values()) if name in PLACED
            else fn.launches for name, fn in WRAPPERS.items()}


def launch_placements() -> dict:
    """The planar kernels' launches so far by the placement of their
    table, as each launch reported it: ``{kernel: {placement: count}}``
    over :data:`PLACEMENTS`."""
    return {name: dict(fn.placements) for name, fn in PLACED.items()}


def reset_launch_counts() -> None:
    """Zero :func:`launch_counts` and :func:`launch_placements`."""
    for name, fn in WRAPPERS.items():
        if name in PLACED:
            fn.placements = dict.fromkeys(PLACEMENTS, 0)
        else:
            fn.launches = 0


__all__ = [
    "PLACED",
    "PLACEMENTS",
    "WRAPPERS",
    "decode_plan",
    "encode_plan",
    "launch_counts",
    "launch_placements",
    "planar_decode_blocks",
    "planar_decode_plain",
    "planar_encode_blocks",
    "planar_encode_plain",
    "prep_cum_vreg",
    "rans_decode_plain",
    "rans_decode_tiled",
    "rans_encode_plain",
    "rans_encode_tiled",
    "reset_launch_counts",
    "tile_steps_for",
]
