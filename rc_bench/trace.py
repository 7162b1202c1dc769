"""The traced run's timeline: host spans and device operations.

``torch.profiler`` records the window with CPU and CUDA activity; the
trace is read in memory (no trace file is written).  Host spans are the
named regions: the benchmark's own (``rc_bench.<op>``, around each api
call) and the program's (``planar.*``, ``rans16.*``; its
``utils.profiling.annotate``).  Device operations are kernels, copies
and sets, each with its interval on the same clock.

The readers under ``metrics/`` take what they need from a
:class:`Timeline`: the spans of one name inside the benchmark's spans of
an op, the device operations inside them, and the union of intervals
(busy time).  The arithmetic of busy and idle shares is that of
``scripts_torch/profile_main_path.py``: the union of device intervals
over the wall of the enclosing spans.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


@dataclasses.dataclass
class Op:
    name: str
    start: float  # seconds on the profiler's clock
    end: float
    kind: str  # "kernel", "memcpy", "memset" (device) or "span" (host)


def union(intervals: Iterable[Interval]) -> float:
    """Seconds covered by at least one interval."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _device_kind(name: str, activity: str) -> str:
    text = f"{activity} {name}".lower()
    if "memcpy" in text:
        return "memcpy"
    if "memset" in text:
        return "memset"
    return "kernel"


@dataclasses.dataclass
class Timeline:
    spans: List[Op]  # host spans, by start
    device: List[Op]  # device operations, by start
    window: Interval

    @classmethod
    def from_profiler(cls, prof) -> "Timeline":
        from torch.autograd import DeviceType

        host, dev = [], []
        for e in prof.events():
            t0, t1 = e.time_range.start / 1e6, e.time_range.end / 1e6
            annotation = getattr(e, "is_user_annotation", None)
            if e.device_type == DeviceType.CPU:
                if annotation or (annotation is None and "::" not in e.name
                                  and not e.name.startswith("cu")):
                    host.append(Op(e.name, t0, t1, "span"))
            elif e.device_type == DeviceType.CUDA and not annotation:
                dev.append(Op(e.name, t0, t1, _device_kind(
                    e.name, str(getattr(e, "activity_type", "")))))
        names = {s.name for s in host}
        dev = [d for d in dev if d.name not in names]  # device-side ranges
        host.sort(key=lambda o: o.start)
        dev.sort(key=lambda o: o.start)
        spans = [s for s in host if s.name.startswith("rc_bench.")]
        lo = min((s.start for s in spans), default=0.0)
        hi = max((s.end for s in spans), default=0.0)
        return cls(host, dev, (lo, hi))

    def named(self, names: Sequence[str]) -> List[Op]:
        return [s for s in self.spans if s.name in names]

    def calls(self, op: str) -> List[Op]:
        """The benchmark's spans of one api op in the window."""
        return self.named([f"rc_bench.{op}"])

    def inside(self, outer: Sequence[Op], names: Sequence[str]) -> List[Op]:
        """Host spans named ``names`` that lie inside one of ``outer``."""
        starts = [o.start for o in outer]
        return [s for s in self.named(names) if _within(s, outer, starts)]

    def device_inside(self, outer: Sequence[Op],
                      kinds: Sequence[str] = ("kernel", "memcpy", "memset")
                      ) -> List[Op]:
        """Device operations of ``kinds`` that start inside one of
        ``outer`` (an api call waits for its device work before it
        returns, so its operations lie inside its span)."""
        starts = [o.start for o in outer]
        return [d for d in self.device if d.kind in kinds
                and _within(d, outer, starts, by_start=True)]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The window's device idle time by what the host was doing: each
        stretch of a gap goes to the innermost host span open over it.
        [(span name, seconds)], most first."""
        lo, hi = self.window
        gaps, end = [], lo
        for d in self.device:
            if d.start > end:
                gaps.append((end, min(d.start, hi)))
            end = max(end, d.end)
        if hi > end:
            gaps.append((end, hi))
        starts = [s.start for s in self.spans]
        by_name = {}
        for a, b in gaps:
            if b <= a:
                continue
            over = [s for s in self.spans[:bisect.bisect_left(starts, b)]
                    if s.end > a]
            cuts = sorted({a, b} | {t for s in over for t in (s.start, s.end)
                                    if a < t < b})
            for x, y in zip(cuts, cuts[1:]):
                mid = (x + y) / 2
                open_ = [s for s in over if s.start <= mid <= s.end]
                name = (min(open_, key=lambda s: s.end - s.start).name
                        if open_ else "(no span)")
                by_name[name] = by_name.get(name, 0.0) + (y - x)
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> List[Tuple[str, float]]:
        """Device seconds by operation name in the window, most first."""
        lo, hi = self.window
        by_name = {}
        for d in self.device:
            if lo <= d.start <= hi:
                by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start)
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def busy(self) -> float:
        lo, hi = self.window
        return union((max(d.start, lo), min(d.end, hi)) for d in self.device
                     if d.end > lo and d.start < hi)


def _within(op: Op, outer: Sequence[Op], starts: Sequence[float],
            by_start: bool = False) -> bool:
    """Whether ``op`` lies inside one of ``outer`` (disjoint, by start;
    ``starts`` their starts), or with ``by_start`` starts inside one."""
    i = bisect.bisect_right(starts, op.start) - 1
    if i < 0:
        return False
    o = outer[i]
    return op.start <= o.end and (by_start or op.end <= o.end)
