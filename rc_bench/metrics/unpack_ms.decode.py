"""Host wall of the container's parse (span ``format.unpack``, with the
CRC32 verify inside it) inside ``api.decode``, a call (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode", ["format.unpack"])
