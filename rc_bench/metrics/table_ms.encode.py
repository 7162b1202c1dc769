"""Host wall of the shared table's build (span ``planar.table``, inside
``planar.histogram``) a call of ``api.encode`` (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "encode", ["planar.table"])
