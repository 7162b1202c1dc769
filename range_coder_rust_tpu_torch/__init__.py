"""range_coder_rust_tpu_torch — the rans16 coder on PyTorch and CUDA.

The port of ``range_coder_rust_tpu`` (written in Pallas for a TPU) to
PyTorch with hand-written CUDA kernels for Hopper (H100).  It writes and
reads the same containers as ``range_coder_rust_tpu``, which stays the
reference.  It imports nothing of that package: it keeps its own copies of
what it needs (``format``, ``errors``, the NumPy table builder).

* :mod:`.api` — ``CodecConfig``, ``encode``, ``decode``, ``decode_range``,
  ``decode_bytes``;
* :mod:`.rans_codec` — host orchestration of the rans16 profile;
* :mod:`.format`, :mod:`.errors` — the container format and the typed
  errors (same bytes, same class names as the reference);
* :mod:`.kernels` — the CUDA kernels' wrappers, their plain PyTorch
  versions and their launch counts;
* :mod:`.models.table` — the host-side pow2 table builder.
"""

from . import api
from .api import CodecConfig, decode, decode_bytes, encode
from .kernels import launch_counts, reset_launch_counts

__version__ = "0.1.0"

__all__ = [
    "api",
    "CodecConfig",
    "decode",
    "decode_bytes",
    "encode",
    "launch_counts",
    "reset_launch_counts",
    "__version__",
]
