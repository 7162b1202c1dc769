"""The device's idle share inside ``api.decode_range``: 1 - the union of
device operations over the reads' wall (%)."""

from rc_bench.readers import idle_pct


def read(run):
    return idle_pct(run, "decode_range")
