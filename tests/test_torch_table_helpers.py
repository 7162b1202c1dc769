"""The port's table helpers (``models/table.py``: ``TableArrays``,
``counts_from_data``, ``cumulative``, ``find_index``, ``decode_lut``,
``ideal_bits``) against the JAX package's on the cases of
``tests/test_table.py``: exact equality, ``ideal_bits`` to rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_coder_rust_tpu.models import table as jt
from range_coder_rust_tpu.models.freq_table import FreqTable
from range_coder_rust_tpu_torch.models import table as tt

torch.set_num_threads(1)

RNG = np.random.default_rng(11)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _equal(port: torch.Tensor, ref, dtype: torch.dtype) -> None:
    assert port.dtype == dtype
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_counts_from_data_equals_reference():
    data = RNG.integers(0, 50, size=10_000)
    got = tt.counts_from_data(_t(data), 50)
    _equal(got, jt.counts_from_data(jnp.asarray(data), 50), torch.int64)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(data, minlength=50))


def test_cumulative_equals_reference():
    counts = RNG.integers(0, 100, size=30).astype(np.uint32)
    counts[5] = 0
    got = tt.cumulative(_t(counts))
    _equal(got, jt.cumulative(jnp.asarray(counts)), torch.int64)
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate([[0], np.cumsum(counts)]))


def test_find_index_equals_reference_and_binary_search():
    counts = np.array([5, 0, 3, 9, 1, 0, 2], np.uint32)
    counts_nz = counts + (counts == 0)
    ft = FreqTable.from_counts(counts_nz)
    cum = tt.cumulative(_t(counts_nz))
    total = int(counts_nz.sum())

    def ref_search(rfreq):
        left, right = 0, len(counts_nz) - 1
        while left < right:
            mid = (left + right) // 2
            if ft.cum_freq(mid + 1) <= rfreq:
                left = mid + 1
            else:
                right = mid
        return left

    rfreqs = np.arange(total, dtype=np.uint32)
    got = tt.find_index(cum, _t(rfreqs))
    _equal(got, jt.find_index(jnp.asarray(cum.numpy().astype(np.uint32)),
                              jnp.asarray(rfreqs)), torch.int32)
    np.testing.assert_array_equal(got.numpy(),
                                  [ref_search(int(r)) for r in rfreqs])


def test_decode_lut_equals_reference():
    t = jt.table_from_data_pow2(RNG.integers(0, 40, size=5000), 40, 10)
    lut = tt.decode_lut(_t(t.cum), 10)
    _equal(lut, jt.decode_lut(jnp.asarray(t.cum), 10), torch.int32)
    _equal(lut, tt.find_index(_t(t.cum), torch.arange(1 << 10)).numpy(),
           torch.int32)
    for r in [0, 1, 511, 1023]:
        s = int(lut[r])
        assert t.cum[s] <= r < t.cum[s + 1]


@pytest.mark.parametrize("counts,total", [
    ([1, 2, 0, 512], 1024),  # test_ideal_bits
    ([3, 1, 4, 1, 5], 14),  # test_ideal_bits_matches_scalar_pmodel
], ids=["pow2_total_with_zero", "scalar_pmodel"])
def test_ideal_bits_equals_reference(counts, total):
    c = np.array(counts, np.uint32)
    got = tt.ideal_bits(_t(c), total)
    assert got.dtype == torch.float32
    ref = np.asarray(jt.ideal_bits(jnp.asarray(c), total))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert np.array_equal(np.isinf(got.numpy()), c == 0)
    if c.all():  # the scalar model needs every count nonzero
        ft = FreqTable.from_counts(c)
        np.testing.assert_allclose(
            got.numpy(), [ft.ideal_code_length(i) for i in range(c.size)],
            rtol=1e-6)


def test_table_arrays_equal_reference_pow2_table():
    """``TableArrays`` from the helpers holds the reference's
    ``Pow2Table.arrays()`` of the same data."""
    data = RNG.integers(0, 40, size=5000)
    ref = jt.table_from_data_pow2(data, 40, 12)
    port = tt.table_from_data_pow2(data, 40, 12)
    arrays = tt.TableArrays(_t(port.c), tt.cumulative(_t(port.c)))
    ref_arrays = ref.arrays()
    _equal(arrays.c, ref_arrays.c, torch.int64)
    _equal(arrays.cum, ref_arrays.cum, torch.int64)
    assert int(arrays.cum[-1]) == 1 << 12
