"""The frozen bound of an encode's work (``roofline.py``) over the device
time of the kernels inside ``api.encode`` (%)."""

from rc_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "encode")
