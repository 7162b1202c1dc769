"""The port's planar api against the JAX package's, on the CPU.

Containers must be byte-equal to ``range_coder_rust_tpu.api.encode``'s
for the default ``CodecConfig()``, a partial last block over several
device chunks, an empty input, a supplied table, raw-count tables, a
4096-symbol alphabet under a rans16 config (which falls back to planar),
and uint16 tokens over GPT-2's 50257-symbol vocabulary;
each package decodes the other's containers to int32 symbols, and planar
``decode_range`` equals the reference's.  Each JAX container is made once.
"""

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu.models.table import build_table_pow2 as j_build
from range_coder_rust_tpu_torch.errors import ChecksumMismatch
from range_coder_rust_tpu_torch.models.table import build_table_pow2
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)


def _table_counts() -> np.ndarray:
    """Counts over 300 symbols whose most frequent symbol (the pad) does
    not fit the byte data's dtype."""
    counts = np.ones(300, np.uint64)
    counts[280] = 5000
    return counts


#: name -> (data, alphabet, CodecConfig keywords, table counts and k)
CASES = {
    "default": (zipf(3 * 512 + 100, 256, 1, dtype=np.uint8), None, {}, None),
    "partial_chunks": (zipf(2000, 40, 2, dtype=np.uint8), None,
                       {"block_len": 64, "chunk_symbols": 256}, None),
    "empty": (np.zeros(0, np.uint8), None, {}, None),
    "table": (zipf(1500, 256, 3, dtype=np.uint8), None, {"block_len": 128},
              (_table_counts(), 12)),
    "raw_total": (zipf(2100, 200, 4).astype(np.int32), None,
                  {"raw_total": True, "block_len": 128}, None),
    "fallback_4096": (zipf(3000, 4096, 5).astype(np.int32), 4096,
                      {"profile": "rans16"}, None),
    "gpt2_tokens": (zipf(5 * 512 + 440, 50257, 6, alpha=1.0, dtype=np.uint16),
                    50257, {}, None),
}
_CACHE = {}


def _blobs(name: str):
    """(data, JAX container, port container), each made once."""
    if name not in _CACHE:
        data, a, kw, tab = CASES[name]
        jkw = dict(alphabet=a, config=japi.CodecConfig(**kw))
        tkw = dict(alphabet=a, config=rt.CodecConfig(**kw))
        if tab is not None:
            jkw["table"], tkw["table"] = j_build(*tab), build_table_pow2(*tab)
        _CACHE[name] = (data, japi.encode(data, **jkw),
                        rt.encode(data, device="cpu", **tkw))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(CASES))
def test_container_bytes_equal(name):
    data, jblob, tblob = _blobs(name)
    assert tblob == jblob
    if name == "fallback_4096":
        assert rt.format.unpack(tblob).profile == "planar"


def test_each_package_decodes_the_others_containers_as_int32():
    for name in CASES:
        data, jblob, tblob = _blobs(name)
        got = rt.decode(jblob, device="cpu")
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(japi.decode(tblob), data)


def test_planar_decode_range_matches_reference():
    """Slices inside one block, across blocks, at both ends and empty, on
    the pow2 and the raw-total containers, each the data's slice (and, on
    one slice a container, the reference's result: each JAX slice
    compiles a decode of its own block count); a corrupt payload is
    caught only when the range touches its block."""
    for name in ("partial_chunks", "raw_total"):
        data, jblob, _ = _blobs(name)
        n = data.size
        np.testing.assert_array_equal(
            rt.api.decode_range(jblob, 100, 700, device="cpu"),
            japi.decode_range(jblob, 100, 700))
        for start, count in [(0, 5), (60, 10), (100, 700), (n - 3, 3),
                             (n, 0), (0, n)]:
            got = rt.api.decode_range(jblob, start, count, device="cpu")
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, data[start : start + count])
    data, jblob, _ = _blobs("partial_chunks")
    cont = rt.format.unpack(jblob)
    bad = bytearray(jblob)
    bad[len(jblob) - len(cont.payloads[-1])] ^= 0xFF  # the last block
    np.testing.assert_array_equal(
        rt.api.decode_range(bytes(bad), 0, 64, device="cpu"), data[:64])
    with pytest.raises(ChecksumMismatch):
        rt.api.decode_range(bytes(bad), data.size - 1, 1, device="cpu")
