"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build or load, the data, set-up calls and the
warm-up (s)."""


def read(run):
    return run.setup_s
