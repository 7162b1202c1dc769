"""The chunked (slab-appended) rans16 encode, the path for inputs of 2^31
symbols or more, in the port against the JAX package, on the CPU.

Run at test scale by cutting the slab (the JAX package's
``_SLAB_SYMBOLS`` patched, the port's ``slab_symbols``): the port's
chunked container must be byte-equal to the JAX package's chunked one and
to the port's single call, and must decode.  Each JAX container is made
once per module and shared.
"""

import functools

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import rans_codec as jax_codec
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch import rans_codec as t_codec
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

#: name -> (group lanes, lane length, slab in groups, n symbols, alphabet,
#: shared table given, per-group tables, sync period)
CASES = {
    "table_one_group_slabs": (128, 64, 1, 3 * 128 * 64, 256, True, False, 0),
    "table_tail": (128, 64, 1, 3 * 128 * 64 + 1234, 256, True, False, 0),
    "shared_table_built": (128, 64, 2, 5 * 128 * 64 + 99, 256, False, False,
                           0),
    "per_group_tables": (128, 64, 2, 3 * 128 * 64 + 500, 64, False, True, 0),
    "sync_tiles_u16": (128, 1024, 1, 2 * 128 * 1024 + 777, 300, True, False,
                       1),
}


def _kw(name):
    g, L, slab, n, a, given, per_group, sync = CASES[name]
    data = zipf(n, a, n % 97)
    # the JAX package's table type (its codec checks the type; the port
    # reads any table with ``c`` and ``cum``)
    table = table_from_data_pow2(data, a, 16) if given else None
    return data, dict(alphabet=a, table=table, block_len=L,
                      with_checksums=True, per_group_tables=per_group,
                      sync_tiles=sync, g=g), slab * g * L


@functools.lru_cache(maxsize=None)
def _jax_chunked(name):
    """The JAX package's chunked container, its slab cut to size."""
    data, kw, slab = _kw(name)
    saved = jax_codec._SLAB_SYMBOLS
    jax_codec._SLAB_SYMBOLS = slab
    try:
        return jax_codec._encode_chunked(data, **kw)
    finally:
        jax_codec._SLAB_SYMBOLS = saved


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_matches_jax_chunked(name):
    data, kw, slab = _kw(name)
    blob = t_codec._encode_chunked(data, device="cpu", slab_symbols=slab,
                                   **kw)
    assert blob == _jax_chunked(name)
    out = t_codec.decode(fmt.unpack(blob), device="cpu")
    np.testing.assert_array_equal(out.astype(np.int32), data)


@pytest.mark.parametrize("name", ["table_tail", "per_group_tables"])
def test_chunked_matches_single_call(name):
    data, kw, slab = _kw(name)
    g = kw.pop("g")
    chunked = t_codec._encode_chunked(data, device="cpu", slab_symbols=slab,
                                      g=g, **kw)
    assert chunked == t_codec.encode(data, group_lanes=g, device="cpu", **kw)


def test_chunked_slab_default_and_range(monkeypatch):
    """The slab defaults to ``_SLAB_SYMBOLS``; the chunked container keeps
    tile random access."""
    data, kw, slab = _kw("sync_tiles_u16")
    monkeypatch.setattr(t_codec, "_SLAB_SYMBOLS", slab)
    blob = t_codec._encode_chunked(data, device="cpu", **kw)
    assert blob == _jax_chunked("sync_tiles_u16")
    span = 128 * 1024
    got = rt.api.decode_range(blob, span + 100, 300, device="cpu")
    np.testing.assert_array_equal(got, data[span + 100 : span + 400])


def test_encode_takes_the_chunked_path_from_2_31_symbols(monkeypatch):
    """``encode`` hands inputs of 2^31 symbols or more to the chunked
    path (a broadcast view: no memory behind it)."""
    seen = {}

    def chunked(symbols, **kw):
        seen.update(kw, n=symbols.size)
        return b"chunked"

    monkeypatch.setattr(t_codec, "_encode_chunked", chunked)
    big = np.broadcast_to(np.uint8(3), (1 << 31,))
    assert t_codec.encode(big, alphabet=256, block_len=65536,
                          sync_tiles=2, device="cpu") == b"chunked"
    assert seen["n"] == 1 << 31 and seen["sync_tiles"] == 2
    assert seen["g"] == t_codec.GROUP_LANES and seen["block_len"] == 65536
    seen.clear()
    small = zipf(5000, 256, 3)
    assert t_codec.encode(small, alphabet=256, block_len=64,
                          device="cpu") != b"chunked"
    assert not seen
