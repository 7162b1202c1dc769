"""The least time one H100 could take for a codec call's device work.

Frozen here, so that it reads the same work whatever implements it: a
later kernel that skips a step, changes a search for a table or writes
wider symbols does not change the count, only the time it is held to.

bound = max(bytes / 3.35 TB/s, int32 operations / 16.7 TOP/s)

* Peaks of the H100 SXM at its 700 W limit.  3.35 TB/s is the data
  sheet's HBM3 bandwidth.  16.7 TOP/s is derived, not published: 64
  INT32 lanes a SM (Hopper's white paper: half the 128 FP32 lanes behind
  the data sheet's 67 TFLOP/s float32) x 132 SMs x 1.98 GHz boost clock.
  The run prints the card's power limit beside every share.
* Bytes: each input byte once and each output byte once.  Symbols count
  at the width their alphabet needs (1 byte up to 256 symbols, 2 up to
  65536, else 4), whatever width a kernel reads or writes; the coded side
  counts the container's payload bytes.
* Operations: ``chip_smoke.py``'s constants, each u64 operation counted
  as one.  Planar: the encode 26 a symbol (symbol and table reads 3,
  ``range >> k`` 1, the interval 4, the renormalisation 18), the decode
  29 (adds the target: subtract, divide, clamp; the symbol write; reads
  no symbol), 3 a payload byte (shift, or, byte read or store).  The
  decode's symbol search is not counted: a slot table replaces it.
  rans16: 6 a symbol (encode: divide, multiply, subtract, shift, add,
  flag; decode: mask, lookup, multiply, add, subtract, flag) and 2 an
  emitted or refilled halfword (shift, or).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 64 * 1.98e9

OPS_PER_SYMBOL = {"planar": {"encode": 26, "decode": 29},
                  "rans16": {"encode": 6, "decode": 6}}
#: operations a coded unit: a payload byte (planar), a halfword (rans16)
OPS_PER_UNIT = {"planar": 3, "rans16": 2}


def symbol_bytes(alphabet: int) -> int:
    return 1 if alphabet <= 256 else 2 if alphabet <= 65536 else 4


def work(layout: dict, direction: str) -> tuple[int, int]:
    """(bytes, operations) of one encode or decode of a container whose
    :func:`rc_bench.reference.container.layout` is ``layout``."""
    profile = layout["profile"]
    n = layout["n_symbols"]
    nbytes = n * symbol_bytes(layout["alphabet"]) + layout["payload_bytes"]
    units = (layout["payload_bytes"] if profile == "planar"
             else layout["halfwords"])
    ops = OPS_PER_SYMBOL[profile][direction] * n + OPS_PER_UNIT[profile] * units
    return nbytes, ops


def bound_s(nbytes: int, ops: int) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
