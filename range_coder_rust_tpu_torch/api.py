"""High-level one-call API: ``encode(data) -> bytes``, ``decode(blob) -> data``.

The PyTorch counterpart of ``range_coder_rust_tpu/api.py``.  It takes the
same ``CodecConfig``, writes the same container bytes and raises typed
errors of the same names, the port's own (:mod:`.errors`).  Each entry
point takes a ``device`` (default ``"cuda"``): the coder runs its CUDA
kernels there, or their plain PyTorch versions when the device is the CPU.

This slice ports the rans16 profile with one shared order-0 table.  The
paths it does not cover raise ``NotImplementedError`` naming their
ROADMAP.md item: the planar profile (``CodecConfig``'s default), raw-total
tables, the planar fallback for alphabets over 1023 symbols,
``per_group_tables``, ``sync_tiles > 0`` and ``decode_range``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import format as fmt
from . import rans_codec
from .errors import ConfigError, ZeroFrequency
from .models.table import Pow2Table
from .rans_codec import not_ported


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the codec, as in the reference package."""

    k: int = 16  # total_freq = 2**k
    #: symbols per block (L).  None picks a profile-appropriate default:
    #: 512 for planar, 65536 for rans16.
    block_len: Optional[int] = None
    with_checksums: bool = True
    chunk_symbols: int = 1 << 24
    #: "planar" = block-parallel range coder; "rans16" = interleaved word
    #: rANS (requires k == 16)
    profile: str = "planar"
    #: use the raw symbol histogram as the table (planar only)
    raw_total: bool = False
    #: adaptive rans16: one order-0 table per group
    per_group_tables: bool = False
    #: rans16 group width (lanes per group, a power of two in
    #: [128, 65536]).  None = rans_codec.GROUP_LANES (2048).
    group_lanes: Optional[int] = None
    #: rans16 tile random access: lane states every ``sync_tiles`` tiles
    sync_tiles: int = 0

    def __post_init__(self):
        if not 1 <= self.k <= 16:
            raise ConfigError(f"k={self.k} out of range [1, 16]")
        if self.block_len is None:
            object.__setattr__(
                self, "block_len",
                65536 if self.profile == "rans16" else 512)
        if self.block_len < 1:
            raise ConfigError(f"block_len={self.block_len} must be >= 1")
        if self.profile not in ("planar", "rans16"):
            raise ConfigError(f"unknown profile {self.profile!r}")
        if self.profile == "rans16" and self.k != 16:
            raise ConfigError("rans16 profile requires k == 16")
        if self.raw_total and self.profile != "planar":
            raise ConfigError("raw_total requires the planar profile")
        if self.per_group_tables and self.profile != "rans16":
            raise ConfigError(
                "per_group_tables is the adaptive rans16 mode; for planar "
                "per-block tables use adaptive.encode_adaptive")
        if self.sync_tiles < 0:
            raise ConfigError("sync_tiles must be >= 0")
        if self.sync_tiles and self.profile != "rans16":
            raise ConfigError(
                "sync_tiles is rans16 tile random access; planar blocks "
                "are already independently decodable")
        if self.group_lanes is not None:
            if self.profile != "rans16":
                raise ConfigError("group_lanes applies to rans16 only")
            g = self.group_lanes
            if not (128 <= g <= 65536 and g & (g - 1) == 0):
                raise ConfigError(
                    f"group_lanes {g} must be a power of two in "
                    "[128, 65536]")


def _as_symbols(data, alphabet: Optional[int]) -> tuple[np.ndarray, int]:
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    if arr.size and arr.dtype.kind != "u" and int(arr.min()) < 0:
        raise ConfigError("negative symbol indices")
    inferred = int(arr.max()) + 1 if arr.size else 1
    a = alphabet if alphabet is not None else max(inferred, 1)
    if inferred > a:
        raise ConfigError(f"symbol {inferred - 1} outside alphabet of {a}")
    # keep narrow unsigned dtypes: byte corpora stay 1 B/symbol
    if arr.dtype in (np.uint8, np.uint16):
        return arr, a
    return arr.astype(np.int32), a


def encode(
    data,
    *,
    alphabet: Optional[int] = None,
    config: CodecConfig = CodecConfig(),
    table: Optional[Pow2Table] = None,
    device="cuda",
) -> bytes:
    """Compress ``data`` (bytes or 1-D integer array) into a container.

    A shared order-0 table is built from the data's histogram unless one
    is supplied."""
    symbols, a = _as_symbols(data, alphabet)
    if config.raw_total:
        raise not_ported("raw_total tables", "planar")
    if config.profile != "rans16":
        raise not_ported("the planar profile", "planar")
    if a > 1023:
        raise not_ported(
            f"the planar fallback for a {a}-symbol alphabet", "planar")
    if table is not None:
        if table.alphabet < a:
            raise ConfigError(
                f"table covers {table.alphabet} symbols, data needs {a}")
        a = table.alphabet
        present = np.zeros(a, bool)
        present[np.unique(symbols)] = True
        if np.any(present & (table.c == 0)):
            raise ZeroFrequency(
                "data contains symbols with zero frequency in the given table")
    return rans_codec.encode(
        symbols,
        alphabet=a,
        table=table,
        block_len=config.block_len,
        with_checksums=config.with_checksums,
        per_group_tables=config.per_group_tables,
        sync_tiles=config.sync_tiles,
        group_lanes=config.group_lanes,
        device=device,
    )


def decode(blob: bytes, *, verify_checksums: bool = True,
           device="cuda") -> np.ndarray:
    """Decompress a container back to the symbol array, in the narrowest
    unsigned dtype covering the alphabet (uint8 for byte corpora).

    Raises typed errors on malformed input (InvalidHeader,
    ChecksumMismatch)."""
    cont = fmt.unpack(blob, verify_checksums=verify_checksums)
    if cont.profile != "rans16":
        raise not_ported("decoding planar containers", "planar")
    return rans_codec.decode(cont, device=device)


def decode_range(blob: bytes, start: int, count: int, *,
                 verify_checksums: bool = True, device="cuda") -> np.ndarray:
    """Decode only symbols ``[start, start + count)`` of a container."""
    raise not_ported("decode_range", "sync_tiles")


def decode_bytes(blob: bytes, *, device="cuda", **kw) -> bytes:
    """Like :func:`decode` but returns raw bytes (alphabet must be <= 256)."""
    sym = decode(blob, device=device, **kw)
    return sym.astype(np.uint8).tobytes()
