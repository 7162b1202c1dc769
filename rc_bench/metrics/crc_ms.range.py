"""Host wall of the CRC32 of the units a read touches (span
``format.crc32``) inside ``api.decode_range``, a read (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode_range", ["format.crc32"])
