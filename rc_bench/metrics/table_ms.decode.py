"""Host wall of the decode's table work (span ``planar.table``: the int64
table, its prefix sum and their upload) a call of ``api.decode`` (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode", ["planar.table"])
