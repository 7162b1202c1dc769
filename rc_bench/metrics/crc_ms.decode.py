"""Host wall of the CRC32s of the payloads (span ``format.crc32``, inside
``format.unpack``) inside ``api.decode``, a call (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode", ["format.crc32"])
