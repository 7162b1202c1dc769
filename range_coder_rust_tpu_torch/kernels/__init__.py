"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
rans16 profile's encode and decode, and the planar profile's block coder.

Each wrapper runs the plain version for a CPU tensor and launches its
kernel (``csrc/*.cu``, built at first use by ``_build.py``) for a CUDA
tensor; it counts its kernel launches in ``<wrapper>.launches``.
"""

from .planar import (planar_decode_blocks, planar_decode_plain,
                     planar_encode_blocks, planar_encode_plain)
from .rans_decode import decode_plan, rans_decode_plain, rans_decode_tiled
from .rans_encode import (encode_plan, rans_encode_plain, rans_encode_tiled,
                          tile_steps_for)
from .vreg import prep_cum_vreg

#: the kernel wrappers whose launches are counted, by kernel name
WRAPPERS = {"rans_encode": rans_encode_tiled, "rans_decode": rans_decode_tiled,
            "planar_encode": planar_encode_blocks,
            "planar_decode": planar_decode_blocks}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "WRAPPERS",
    "decode_plan",
    "encode_plan",
    "launch_counts",
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
