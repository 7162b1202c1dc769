"""Host wall of the CRC32s of the payloads (span ``format.crc32``, inside
``planar.pack`` or ``rans16.pack``) inside ``api.encode``, a call (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "encode", ["format.crc32"])
