"""The frozen bound of a decode's work (``roofline.py``) over the device
time of the kernels inside ``api.decode`` (%)."""

from rc_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "decode")
