"""Scalar golden-model core: the bit-exact executable specification that the
port's device paths are held to (the port's copy of
``range_coder_rust_tpu/core``)."""

from .decoder import Decoder
from .encoder import Encoder
from .rc64 import MASK64, MAX_BYTES_PER_SYMBOL, TOP8, TOP16, RangeCoder

__all__ = [
    "RangeCoder",
    "Encoder",
    "Decoder",
    "MASK64",
    "TOP8",
    "TOP16",
    "MAX_BYTES_PER_SYMBOL",
]
