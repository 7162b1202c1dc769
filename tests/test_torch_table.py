"""The port's copies of the table builders equal the originals."""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu.kernels import rans_encode as jax_enc
from range_coder_rust_tpu.kernels import vreg as jax_vreg
from range_coder_rust_tpu.models import table as jax_table
from range_coder_rust_tpu_torch.kernels import rans_encode as t_enc
from range_coder_rust_tpu_torch.kernels import vreg as t_vreg
from range_coder_rust_tpu_torch.models import table as t_table
from range_coder_rust_tpu import errors as jerr
from range_coder_rust_tpu_torch.errors import TableError

torch.set_num_threads(1)


def _counts(seed: int, a: int, zero_frac: float, scale: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, scale, a).astype(np.uint64)
    c[rng.random(a) < zero_frac] = 0
    if not c.any():
        c[a // 2] = 1
    return c


CASES = [
    (1, 256, 0.0, 1000),
    (2, 256, 0.5, 10),
    (3, 129, 0.1, 1 << 20),
    (4, 400, 0.3, 7),
    (5, 1023, 0.2, 100000),
    (6, 1, 0.0, 5),
    (7, 64, 0.9, 1 << 40),  # total >= 2^31: the proportional halving
    (8, 700, 0.0, 2),
]


@pytest.mark.parametrize("seed,a,zero_frac,scale", CASES)
def test_build_table_pow2_equal(seed, a, zero_frac, scale):
    counts = _counts(seed, a, zero_frac, scale)
    want = jax_table.build_table_pow2(counts, 16)
    got = t_table.build_table_pow2(counts, 16)
    np.testing.assert_array_equal(got.c, want.c)
    np.testing.assert_array_equal(got.cum, want.cum)
    assert got.c.dtype == want.c.dtype and got.cum.dtype == want.cum.dtype
    assert got.k == want.k and got.alphabet == want.alphabet


def test_build_table_pow2_equal_at_a_gpt2_shards_counts():
    """GPT-2's 50257 tokens at the Zipf(1.0) law's counts over a 10^8-token
    shard: the clamps of the rare tokens to 1 overshoot 2^16, and the
    overshoot taken from the largest shares leaves the most frequent
    tokens at 1.  The port's table is the JAX package's all the same."""
    law = 1.0 / np.arange(1, 50258)
    counts = np.ceil(1e8 * law / law.sum()).astype(np.uint64)
    want = jax_table.build_table_pow2(counts, 16)
    got = t_table.build_table_pow2(counts, 16)
    np.testing.assert_array_equal(got.c, want.c)
    np.testing.assert_array_equal(got.cum, want.cum)
    assert (got.c[:8] == 1).all() and int(got.c.argmax()) == 100


@pytest.mark.parametrize("k", [8, 12, 16])
def test_normalize_pow2_np_equal(k):
    counts = _counts(k, 200, 0.2, 5000)
    np.testing.assert_array_equal(
        t_table.normalize_pow2(torch.from_numpy(counts.astype(np.int64))[None],
                               k)[0].numpy(),
        jax_table.normalize_pow2_np(counts, k))


def test_table_from_data_and_errors_equal():
    rng = np.random.default_rng(9)
    data = rng.integers(3, 90, 5000)
    want = jax_table.table_from_data_pow2(data, 100, 16)
    got = t_table.table_from_data_pow2(data, 100, 16)
    np.testing.assert_array_equal(got.c, want.c)
    np.testing.assert_array_equal(got.cum, want.cum)
    for fn, err in ((t_table.table_from_data_pow2, TableError),
                    (jax_table.table_from_data_pow2, jerr.TableError)):
        with pytest.raises(err):
            fn(data, 50, 16)  # symbol outside the alphabet
    for fn, err in ((t_table.build_table_pow2, TableError),
                    (jax_table.build_table_pow2, jerr.TableError)):
        with pytest.raises(err):
            fn(np.zeros(4, np.uint64), 16)


@pytest.mark.parametrize("seed,a,zero_frac,scale", CASES[:5])
def test_prep_cum_vreg_equal(seed, a, zero_frac, scale):
    t = jax_table.build_table_pow2(_counts(seed, a, zero_frac, scale), 16)
    got = t_vreg.prep_cum_vreg(t.cum)
    np.testing.assert_array_equal(got, jax_vreg.prep_cum_vreg(t.cum))
    assert got.dtype == np.uint32 and got.shape == (8, 128)


def test_prep_cum_vreg_rejects_wide_alphabet():
    with pytest.raises(ValueError):
        t_vreg.prep_cum_vreg(np.zeros(1025, np.uint32))


def test_tile_steps_for_equal():
    for log_g in range(7, 17):
        g = 1 << log_g
        assert t_enc.tile_steps_for(g) == jax_enc.tile_steps_for(g)
    assert t_enc.CAP_HW == jax_enc.CAP_HW
