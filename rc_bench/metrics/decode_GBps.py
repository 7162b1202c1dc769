"""Bytes of the original array restored by every ``api.decode`` in the
window over the seconds spent in those calls (GB/s)."""

from rc_bench.readers import rate_GBps


def read(run):
    return rate_GBps(run, "decode")
