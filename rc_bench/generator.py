"""The one traffic generator: a closed loop of api calls, read from a mix.

A mix is a JSON file under ``traffic/`` (see ``README.md``)::

    {"clients": 1,
     "setup": ["encode"],
     "sequence": [{"op": "decode_range", "count": 1024,
                   "start": "uniform"}]}

``setup`` lists the calls made before the window, such as the container
that reads are served from.  Then every op of ``sequence`` is called once
as warm-up, and the window repeats the whole sequence, one call after
the other, until ``--seconds`` have passed.  Ops:

* ``encode``: ``api.encode`` of the whole data array; its container is the
  one later ops read;
* ``decode``: ``api.decode`` of the newest container;
* ``decode_range``: ``api.decode_range(container, start, count)``, with
  ``start`` drawn uniformly from the seed (``"uniform"``).

Every call runs inside a profiler span ``rc_bench.<op>`` and is timed on
the host clock; every output is kept for the comparison after the
window.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, List

import numpy as np
import torch

OPS = ("encode", "decode", "decode_range")

#: read offsets drawn a run; the window takes them in order, cycling
_POOL = 1 << 16


@dataclasses.dataclass
class Call:
    op: str
    t0: float
    t1: float
    nbytes: int  # bytes of symbols the call takes in or gives back
    output: Any = None  # None when the call raised
    start: int = 0
    count: int = 0
    in_window: bool = False


class Driver:
    """Drives one cell's api calls on ``device``."""

    def __init__(self, api, codec, data: np.ndarray, alphabet: int,
                 mix: dict, seed: int, device):
        for spec in mix["sequence"]:
            if spec["op"] not in OPS:
                raise ValueError(f"unknown op {spec['op']!r}")
        if mix.get("clients", 1) != 1:
            raise ValueError("the generator drives one client")
        self.api, self.codec, self.data = api, codec, data
        self.alphabet, self.mix, self.device = alphabet, mix, device
        self.rng = np.random.default_rng([seed % (1 << 64), 0xC0])
        self.starts = {}
        self.blob = None
        self.calls: List[Call] = []

    def _start(self, spec: dict) -> int:
        """The next read offset for reads of ``spec["count"]`` symbols."""
        count = spec["count"]
        if spec.get("start") != "uniform":
            raise ValueError(f"unknown start {spec.get('start')!r}")
        if count not in self.starts:
            self.starts[count] = (self.rng.integers(
                0, self.data.size - count + 1, size=_POOL), 0)
        pool, i = self.starts[count]
        self.starts[count] = (pool, i + 1)
        return int(pool[i % _POOL])

    def call(self, spec: dict, in_window: bool) -> Call:
        op = spec["op"]
        start, count = 0, 0
        if op == "decode_range":
            start, count = self._start(spec), spec["count"]
        with torch.profiler.record_function(f"rc_bench.{op}"):
            t0 = time.perf_counter()
            try:
                if op == "encode":
                    out = self.api.encode(self.data, alphabet=self.alphabet,
                                          config=self.codec,
                                          device=self.device)
                elif op == "decode":
                    out = self.api.decode(self.blob, device=self.device)
                else:
                    out = self.api.decode_range(self.blob, start, count,
                                                device=self.device)
            except Exception as exc:  # a call that never answers
                print(f"rc_bench: {op} raised {exc!r}", file=sys.stderr,
                      flush=True)
                out = None
            t1 = time.perf_counter()
        if op == "encode" and out is not None:
            self.blob = out
        nbytes = (self.data.nbytes if op != "decode_range"
                  else count * self.data.itemsize)
        c = Call(op, t0, t1, nbytes, out, start, count, in_window)
        self.calls.append(c)
        return c

    def setup(self) -> None:
        """The mix's set-up calls, then one warm-up call of each op."""
        for op in self.mix.get("setup", []):
            self.call({"op": op}, False)
        for spec in self.mix["sequence"]:
            self.call(spec, False)

    def window(self, seconds: float) -> None:
        """Repeat the whole sequence until ``seconds`` have passed."""
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for spec in self.mix["sequence"]:
                self.call(spec, True)
