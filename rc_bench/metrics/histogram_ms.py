"""Host wall of the table's histogram (span ``planar.histogram`` or
``rans16.histogram``) a call of ``api.encode`` (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "encode", ["planar.histogram", "rans16.histogram"])
