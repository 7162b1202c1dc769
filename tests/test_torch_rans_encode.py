"""The port's rans16 encode: its divide by a reciprocal, its symbol widths.

The CUDA encode kernel (``csrc/rans_encode.cu``) divides the state by a
symbol's frequency ``c`` with a multiply-high by ``m = ceil(2^64 / c)``
from a table it builds per block (``build_table``, ``encode_step``), and
reads its symbol rows at the width the codec uploads them (u8, or int16
for alphabets above 256).  The kernel runs only on a card
(``tests/test_torch_kernels_gpu.py``); here the formula is checked for
every ``c`` the table can hold, and the plain version and the codec for
every row width.
"""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu_torch import kernels
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch.testing import kernel_case, zipf

torch.set_num_threads(1)

_C = np.arange(1, (1 << 16) + 1, dtype=object)  # every frequency of a table


def _kernel_quotient(x, c):
    """The kernel's quotient of states ``x`` by frequencies ``c`` (object
    arrays of Python ints): m = ~0 / c + 1 (64-bit), q = umulhi(x, m), and
    q = x for c = 1 (where m would be 2^64)."""
    m = (2 ** 64 - 1) // np.maximum(c, 2) + 1
    return np.where(c == 1, x, (x * m) >> 64)


def _edge_states(kind):
    """States after renormalisation, x < c * 2^32, for every c."""
    c = _C
    if kind == "random":
        rng = np.random.default_rng(11)
        frac = rng.integers(0, 1 << 62, c.shape[0]).astype(object)
        return frac * (c << 32) >> 62
    return {"0": c * 0, "1": c * 0 + 1, "c-1": c - 1, "c": c,
            "c*2^32-1": (c << 32) - 1, "c*2^32-c": (c << 32) - c,
            "c*2^32-c-1": (c << 32) - c - 1}[kind]


@pytest.mark.parametrize("kind", ["0", "1", "c-1", "c", "c*2^32-1",
                                  "c*2^32-c", "c*2^32-c-1", "random"])
def test_reciprocal_divide_is_exact(kind):
    x = _edge_states(kind)
    assert all(x < _C << 32)
    q = _kernel_quotient(x, _C)
    np.testing.assert_array_equal(q, x // _C)
    assert all(q < 1 << 32)  # the kernel keeps q in 32 bits
    # and the remainder it forms in 32 bits
    r32 = ((x & 0xFFFFFFFF) - (q * _C & 0xFFFFFFFF)) & 0xFFFFFFFF
    np.testing.assert_array_equal(r32, x % _C)


@pytest.mark.parametrize("case", ["odd_tile_G128_L63", "A400",
                                  "c_1_rare_symbols"])
def test_plain_encode_same_output_for_each_row_width(case):
    rows, g, a = kernel_case(case)
    L = rows.shape[1]
    table = table_from_data_pow2(rows, a, 16)
    tile, _ = t_codec._tile_geometry(L, g)
    cum = t_codec.cum_table(table.cum, "cpu")
    widths = ([np.uint8] if a <= 256 else []) + [np.int16, np.int32]
    outs = [kernels.rans_encode_plain(torch.from_numpy(rows.astype(w)), cum,
                                      group_lanes=g, tile=tile)
            for w in widths]
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,want", [(np.uint8, torch.uint8),
                                        (np.int32, torch.int16),
                                        (np.uint16, torch.int16),
                                        (np.int64, torch.int16)])
def test_upload_rows_keeps_the_symbol_width(dtype, want):
    rows = zipf(128 * 4, 256 if dtype == np.uint8 else 1023, 12,
                dtype=dtype).reshape(128, 4)
    up = t_codec._upload_rows(rows, "cpu")
    assert up.dtype == want and up.shape == rows.shape
    np.testing.assert_array_equal(up.numpy().astype(np.int64), rows)


def test_c_1_case_has_symbols_of_frequency_1():
    rows, g, a = kernel_case("c_1_rare_symbols")
    table = table_from_data_pow2(rows, a, 16)
    assert rows.size == 1 << 16
    np.testing.assert_array_equal(table.c[250:], [0, 0, 0, 0, 1, 1])


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32, torch.uint16])
def test_encode_refuses_other_row_dtypes(dtype):
    rows = torch.zeros((128, 4), dtype=dtype)
    cum = t_codec.cum_table(np.array([0, 1 << 16]), "cpu")
    with pytest.raises(ValueError, match="uint8, int16 or int32"):
        kernels.rans_encode_tiled(rows, cum, group_lanes=128, tile=4)
