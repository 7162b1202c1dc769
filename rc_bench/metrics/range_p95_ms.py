"""The 95th percentile (nearest rank) of the latency of every
``api.decode_range`` in the window, closed loop, one client (ms)."""

from rc_bench.readers import latency_ms


def read(run):
    return latency_ms(run, "decode_range", 0.95)
