"""Host wall of the container's assembly with its CRC32s (span
``planar.pack`` or ``rans16.pack``) a call of ``api.encode`` (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "encode", ["planar.pack", "rans16.pack"])
