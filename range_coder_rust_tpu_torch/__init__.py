"""range_coder_rust_tpu_torch — the range coder on PyTorch and CUDA.

The port of ``range_coder_rust_tpu`` (written in JAX and Pallas for a TPU)
to PyTorch with hand-written CUDA kernels for Hopper (H100).  It writes
and reads the same containers as ``range_coder_rust_tpu``, which stays the
reference.  It imports nothing of that package: it keeps its own copies
of what it needs (``format``, ``errors``, the table builders, the scalar
coder).

* :mod:`.api` — ``CodecConfig``, ``encode``, ``decode``, ``decode_range``,
  ``decode_bytes``;
* :mod:`.rans_codec` — host orchestration of the rans16 profile, and
  :mod:`.kernels`, its CUDA kernels' wrappers, their plain PyTorch
  versions and their launch counts;
* :mod:`.blocks`, :mod:`.adaptive`, :mod:`.ops` — the planar profile:
  block-parallel coding as PyTorch ops, with shared, raw-count or
  per-block tables;
* :mod:`.format`, :mod:`.errors` — the container format and the typed
  errors (same bytes, same class names as the reference);
* :mod:`.models` — the pow2 table builders and ``FreqTable``;
* the scalar streaming API of the reference (``RangeCoder``,
  ``Encoder``, ``Decoder``, ``PModel``, ``FreqTable``): pure Python, no
  device;
* :mod:`.rans` — the rans16 profile's NumPy spec, the oracle of its
  kernels;
* :mod:`.parallel` — scale-out: sharded coding over several devices
  (:mod:`.parallel.dist`) and several processes over
  ``torch.distributed`` that gather their payloads into one container
  (:mod:`.parallel.multihost`);
* :mod:`.native` — the C++ scalar golden coder (built with g++ at first
  use), the CPU conformance and throughput anchor;
* :mod:`.utils` — profiler regions and traces, compression metrics;
* ``python -m range_coder_rust_tpu_torch`` — the command line
  (:mod:`.__main__`: encode, decode, inspect, selftest; ``--device``).

:mod:`.parallel` and :mod:`.native` are imported on demand.
"""

from . import api, errors
from .api import CodecConfig, decode, decode_bytes, encode
from .core.decoder import Decoder
from .core.encoder import Encoder
from .core.rc64 import MASK64, MAX_BYTES_PER_SYMBOL, TOP8, TOP16, RangeCoder
from .kernels import launch_counts, reset_launch_counts
from .models.freq_table import FreqTable
from .pmodel import PModel

__version__ = "0.1.0"

__all__ = [
    "api",
    "CodecConfig",
    "decode",
    "decode_bytes",
    "encode",
    "launch_counts",
    "reset_launch_counts",
    "RangeCoder",
    "Encoder",
    "Decoder",
    "PModel",
    "FreqTable",
    "errors",
    "MASK64",
    "TOP8",
    "TOP16",
    "MAX_BYTES_PER_SYMBOL",
    "__version__",
]
