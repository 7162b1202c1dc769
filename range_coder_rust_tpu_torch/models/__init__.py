"""Probability models: the host-side pow2 tables the rans16 kernels code with."""

from .table import Pow2Table, build_table_pow2, table_from_data_pow2

__all__ = ["Pow2Table", "build_table_pow2", "table_from_data_pow2"]
