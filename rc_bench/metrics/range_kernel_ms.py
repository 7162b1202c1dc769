"""Device time of the kernels inside ``api.decode_range``, a read
(ms)."""

from rc_bench.readers import kernel_ms


def read(run):
    return kernel_ms(run, "decode_range")
