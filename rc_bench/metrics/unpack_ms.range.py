"""Host wall of the container's parse (span ``format.unpack``; no CRC32:
a read checks only the units it touches, apart) inside
``api.decode_range``, a read (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode_range", ["format.unpack"])
