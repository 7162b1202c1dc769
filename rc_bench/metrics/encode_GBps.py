"""Bytes of the input array of every ``api.encode`` in the window over
the seconds spent in those calls (GB/s)."""

from rc_bench.readers import rate_GBps


def read(run):
    return rate_GBps(run, "encode")
