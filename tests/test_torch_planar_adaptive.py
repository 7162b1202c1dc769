"""The port's planar per-block tables (``adaptive.py``) against the JAX
package's, on the CPU: the per-block tables, byte-equal containers from
``encode_adaptive``, decoding both ways (``api.decode`` and
``decode_adaptive``), ``decode_range`` and the alphabet guard.  Each JAX
container is made once."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import adaptive as jad
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import errors as jerr
from range_coder_rust_tpu_torch import adaptive as tad
from range_coder_rust_tpu_torch.errors import ConfigError
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

#: name -> (data, alphabet, encode_adaptive keywords)
CASES = {
    # statistics that drift between blocks: Zipf, then flat, then runs
    "default_k12_L512": (np.concatenate([
        zipf(1300, 256, 8), np.random.default_rng(8).integers(0, 256, 1000),
        np.repeat([3, 200, 7], 93)]).astype(np.uint8), None, {}),
    "A400_k10_L64": (zipf(1000, 400, 9).astype(np.int32), 400,
                     {"k": 10, "block_len": 64}),
}
_CACHE = {}


def _blobs(name: str):
    if name not in _CACHE:
        data, a, kw = CASES[name]
        _CACHE[name] = (data, jad.encode_adaptive(data, alphabet=a, **kw),
                        tad.encode_adaptive(data, alphabet=a, device="cpu",
                                            **kw))
    return _CACHE[name]


def test_block_tables_match_reference():
    """Skewed, flat and single-symbol rows, and rows whose min-1 clamps
    overshoot the total (many symbols under a small k)."""
    rng = np.random.default_rng(11)
    rows = np.concatenate([
        rng.integers(0, 3, (2, 96)), rng.integers(0, 64, (2, 96)),
        np.full((1, 96), 7), np.arange(96)[None, :] % 64,
        (rng.zipf(1.5, (2, 96)) % 64)]).astype(np.int32)
    for k in (6, 8, 12):
        jc, jcum = jad.block_tables(jnp.asarray(rows), alphabet=64, k=k)
        c, cum = tad.block_tables(torch.from_numpy(rows), alphabet=64, k=k)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(cum.numpy(), np.asarray(jcum))
        assert (c.sum(1) == 1 << k).all()


@pytest.mark.parametrize("name", list(CASES))
def test_encode_adaptive_bytes_equal(name):
    data, jblob, tblob = _blobs(name)
    assert tblob == jblob


def test_decode_both_ways():
    for name in CASES:
        data, jblob, tblob = _blobs(name)
        for got in (rt.decode(jblob, device="cpu"),
                    tad.decode_adaptive(jblob, device="cpu")):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(japi.decode(tblob), data)


def test_decode_range_of_per_block_tables():
    data, jblob, _ = _blobs("A400_k10_L64")
    np.testing.assert_array_equal(
        rt.api.decode_range(jblob, 100, 500, device="cpu"),
        japi.decode_range(jblob, 100, 500))
    for start, count in [(0, 64), (63, 2), (100, 500), (999, 1)]:
        got = rt.api.decode_range(jblob, start, count, device="cpu")
        np.testing.assert_array_equal(got, data[start : start + count])


def test_alphabet_guard_and_shared_container():
    with pytest.raises(jerr.ConfigError):
        jad.encode_adaptive(np.arange(300), k=8)
    with pytest.raises(ConfigError):
        tad.encode_adaptive(np.arange(300), k=8, device="cpu")
    shared = rt.encode(np.arange(10), device="cpu")
    with pytest.raises(ConfigError):
        tad.decode_adaptive(shared, device="cpu")
