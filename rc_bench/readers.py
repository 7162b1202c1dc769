"""Arithmetic the metric readers share (``metrics/<name>.py``).

Each reader is ``read(run) -> float | None`` over a
:class:`rc_bench.harness.RunView`; ``None`` (nothing to read) leaves the
metric out of the line.  A share of a roofline is never given as 0: with
no device time there is nothing to share.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from .roofline import bound_s, work
from .trace import union


def rate_GBps(run, op: str) -> Optional[float]:
    """Bytes of every ``op`` call in the window over the seconds spent
    in those calls, in GB/s."""
    calls = [c for c in run.calls if c.op == op]
    seconds = sum(c.t1 - c.t0 for c in calls)
    if not calls or seconds <= 0:
        return None
    return sum(c.nbytes for c in calls) / seconds / 1e9


def latency_ms(run, op: str, q: float) -> Optional[float]:
    """The ``q`` quantile (nearest rank) of the latency of every ``op``
    call in the window, in ms."""
    lat = sorted(c.t1 - c.t0 for c in run.calls if c.op == op)
    if not lat:
        return None
    return lat[max(0, math.ceil(q * len(lat)) - 1)] * 1e3


def span_ms(run, op: str, names: Sequence[str]) -> Optional[float]:
    """Host wall of the program's spans ``names`` inside the benchmark's
    ``op`` calls, a call, in ms."""
    tl = run.timeline
    if tl is None:
        return None
    calls = tl.calls(op)
    spans = tl.inside(calls, names)
    if not calls or not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(calls) * 1e3


def kernel_ms(run, op: str) -> Optional[float]:
    """Device time of the kernels inside the ``op`` calls, a call, in
    ms (copies and sets left out)."""
    tl = run.timeline
    if tl is None or not tl.calls(op):
        return None
    calls = tl.calls(op)
    busy = union((d.start, d.end) for d in tl.device_inside(calls, ["kernel"]))
    return busy / len(calls) * 1e3 if busy > 0 else None


def roofline_pct(run, op: str) -> Optional[float]:
    """The frozen bound of the ``op`` calls' work over the device time of
    their kernels, in %."""
    per_call = kernel_ms(run, op)
    if per_call is None:
        return None
    bound, _ = bound_s(*work(run.layout, op))
    return 100 * bound / (per_call / 1e3)


def idle_pct(run, op: str) -> Optional[float]:
    """100 (1 - union of device operations / wall) over the ``op``
    calls."""
    tl = run.timeline
    if tl is None or not tl.calls(op):
        return None
    calls = tl.calls(op)
    wall = sum(c.end - c.start for c in calls)
    if wall <= 0 or not tl.device:
        return None
    busy = union((d.start, d.end) for d in tl.device_inside(calls))
    return 100 * (1 - busy / wall)
