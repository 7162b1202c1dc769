"""Probability models: the scalar ``FreqTable`` and the pow2 tables the
device paths code with."""

from .freq_table import FreqTable
from .table import Pow2Table, build_table_pow2, table_from_data_pow2

__all__ = ["FreqTable", "Pow2Table", "build_table_pow2",
           "table_from_data_pow2"]
