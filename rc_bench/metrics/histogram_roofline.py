"""The frozen bound of the histogram's work (``histogram_count.py``) over
the device time, a call, of the kernels named ``planar_histogram`` inside
``api.encode`` (%); nothing where no such kernel ran."""

from rc_bench.histogram_count import bound_s
from rc_bench.trace import union


def read(run):
    tl = run.timeline
    if tl is None or not tl.calls("encode"):
        return None
    calls = tl.calls("encode")
    busy = union((d.start, d.end) for d in tl.device_inside(calls, ["kernel"])
                 if "planar_histogram" in d.name)
    if busy <= 0:
        return None
    return 100 * bound_s(run.layout) / (busy / len(calls))
