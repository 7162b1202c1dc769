"""GPT-2 token shards through the default codec, on the CPU.

The ``tokens_planar`` configuration of the benchmark (``rc_bench``): uint16
token ids over GPT-2's 50257-symbol vocabulary, ``CodecConfig()`` (planar,
k 16, L 512).  Here a few thousand seeded Zipf(1.0) tokens with a partial
last block, coded by the plain versions of the planar kernels: the
container equals the benchmark's frozen reference byte for byte, and
``decode`` and ``decode_range`` give the tokens back.  Imports no JAX.
"""

import functools

import numpy as np
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch.testing import zipf
from rc_bench import harness, reference

torch.set_num_threads(1)

VOCAB = 50257  # GPT-2's vocab_size
N = 5 * 512 + 440  # five whole blocks and a partial one
SEED = (1 << 31) + 17  # past 32 signed bits, as the benchmark's seeds are
CELL = "tokens_planar.bulk"


@functools.lru_cache(maxsize=None)
def tokens() -> np.ndarray:
    return zipf(N, VOCAB, 17, alpha=1.0, dtype=np.uint16)


@functools.lru_cache(maxsize=None)
def blob() -> bytes:
    return rt.encode(tokens(), alphabet=VOCAB, config=rt.CodecConfig(),
                     device="cpu")


def codec() -> dict:
    bench = harness.load_bench()
    return harness.config_of(bench, harness.cell_of(bench, CELL))["codec"]


def test_encode_equals_the_benchmark_reference():
    assert codec() == {"profile": "planar", "k": 16, "block_len": 512,
                       "with_checksums": True}
    assert blob() == reference.encode(tokens(), codec(), VOCAB, "cpu")


def test_decode_gives_the_tokens_back():
    out = rt.decode(blob(), device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, tokens())


def test_decode_range_across_a_block_boundary():
    start, count = 2 * 512 - 37, 100
    got = rt.api.decode_range(blob(), start, count, device="cpu")
    np.testing.assert_array_equal(got, tokens()[start : start + count])


def test_the_cell_runs_correct():
    r = harness.run(harness.load_bench(), CELL, SEED, 0.01, False,
                    device="cpu", n_symbols=N, log=lambda *a, **k: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_the_data_kind_gives_uint16_below_the_vocabulary():
    bench = harness.load_bench()
    spec = dict(harness.config_of(bench, harness.cell_of(bench, CELL))["data"])
    assert spec["alphabet"] == VOCAB and spec["n_symbols"] == 10 ** 8
    spec["n_symbols"] = 1 << 16
    maker = harness._load(harness.HERE / "data" / f"{spec['kind']}.py")
    data = maker.make(spec, SEED, "cpu")
    assert data.dtype == np.uint16 and data.size == 1 << 16
    assert int(data.max()) < VOCAB
    # Zipf(1.0): token 0 is the most frequent, p = 1 / H(50257) = 0.0884
    counts = np.bincount(data, minlength=VOCAB)
    assert counts.argmax() == 0 and 0.080 < counts[0] / data.size < 0.097
