"""The device's idle share inside ``api.encode``: 1 - the union of device
operations over the calls' wall (%)."""

from rc_bench.readers import idle_pct


def read(run):
    return idle_pct(run, "encode")
