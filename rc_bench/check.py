"""How ``correct`` is decided: every output of the run against the
reference, after the window.

* every container that ``api.encode`` wrote (set-up, warm-up and window)
  against :func:`rc_bench.reference.encode` of the same data, byte for
  byte: header, lengths, table, CRC32s and payloads;
* every array ``api.decode`` gave back against the data, symbol for
  symbol;
* every ``api.decode_range`` read against the data's slice;
* every call that raised instead of answering.

Each number is a count of wrong bytes, symbols or calls, so each is an
exact comparison with the limit 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LIMIT = 0


def _diff(a: np.ndarray, b: np.ndarray) -> int:
    """Elements that differ, a missing or extra element counting as one."""
    m = min(a.size, b.size)
    return int(np.count_nonzero(a[:m] != b[:m])) + abs(a.size - b.size)


def compare(calls, data: np.ndarray, reference_blob: bytes
            ) -> List[Tuple[str, int, int]]:
    """[(name, value, limit)] for the ops the run made."""
    ref = np.frombuffer(reference_blob, np.uint8)
    worst: Dict[str, int] = {}
    failed = 0
    for c in calls:
        if c.output is None:
            failed += 1
            continue
        if c.op == "encode":
            name = "container_wrong_bytes"
            value = _diff(np.frombuffer(c.output, np.uint8), ref)
        elif c.op == "decode":
            name = "decode_wrong_symbols"
            value = _diff(np.asarray(c.output).reshape(-1), data)
        else:
            name = "range_wrong_symbols"
            value = _diff(np.asarray(c.output).reshape(-1),
                          data[c.start : c.start + c.count])
        worst[name] = max(worst.get(name, 0), value)
    out = [(name, worst[name], LIMIT) for name in sorted(worst)]
    return out + [("calls_failed", failed, LIMIT)]
