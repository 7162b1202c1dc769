"""Host wall of the copies to the host (span ``planar.d2h`` or
``rans16.d2h``) inside ``api.decode``, a call (ms)."""

from rc_bench.readers import span_ms


def read(run):
    return span_ms(run, "decode", ["planar.d2h", "rans16.d2h"])
