"""The port's planar block coder (pow2 tables) against the JAX package's
``blocks.py`` and the scalar C++ golden coder, on the CPU.

Each block's payload must equal the JAX ``encode_blocks``' and the golden
coder's stream byte for byte; the port decodes the JAX code matrices and
the JAX package decodes the port's; a capacity too small gives the same
cut streams and lengths as the reference, and the api's retry gives the
full payloads.  Each JAX output is computed once per geometry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from range_coder_rust_tpu import blocks as jblocks
from range_coder_rust_tpu.native import golden
from range_coder_rust_tpu_torch import api, blocks
from range_coder_rust_tpu_torch.models.table import (build_table_pow2,
                                                     table_from_data_pow2)
from range_coder_rust_tpu_torch.ops import lookup

torch.set_num_threads(1)


def _case(name: str):
    """(rows (B, L) int32, Pow2Table)."""
    rng = np.random.default_rng(len(name))
    if name == "zipf_k16_B16_L64":
        rows = (rng.zipf(1.3, (16, 64)) % 200).astype(np.int32)
        return rows, table_from_data_pow2(rows, 200, 16)
    if name == "uniform_k8_B8_L40":
        rows = rng.integers(0, 256, (8, 40)).astype(np.int32)
        return rows, build_table_pow2(np.ones(256, np.uint64), 8)
    if name == "c1_runs_k16_B4_L64":
        # runs of c = 1 symbols: the reduction loop on every step, lower
        # bounds near 2^64 and emissions of up to 14 bytes
        counts = np.concatenate([[100_000], np.ones(15)]).astype(np.uint64)
        rows = np.full((4, 64), 5, np.int32)
        rows[1, ::2] = 0
        rows[2] = rng.integers(1, 16, 64)
        rows[3, :32] = 15
        return rows, build_table_pow2(counts, 16)
    if name == "L512_k12_B3":
        rows = rng.integers(0, 20, (3, 512)).astype(np.int32)
        rows[2, :100] = 0
        return rows, table_from_data_pow2(rows, 20, 12)
    raise KeyError(name)


CASES = ["zipf_k16_B16_L64", "uniform_k8_B8_L40", "c1_runs_k16_B4_L64",
         "L512_k12_B3"]
_CACHE = {}


def _coded(name: str):
    """name -> (rows, table, capacity, JAX (code, lengths), port (code,
    lengths)), each computed once."""
    if name not in _CACHE:
        rows, t = _case(name)
        cap = blocks.default_capacity(rows.shape[1], t.k)
        jcode, jlen = jblocks.encode_blocks(
            jnp.asarray(rows), jnp.asarray(t.c), jnp.asarray(t.cum), k=t.k,
            capacity=cap)
        tcode, tlen = blocks.encode_blocks(
            torch.from_numpy(rows), torch.from_numpy(t.c.astype(np.int64)),
            torch.from_numpy(t.cum.astype(np.int64)), k=t.k, capacity=cap)
        _CACHE[name] = (rows, t, cap, (np.asarray(jcode), np.asarray(jlen)),
                        (tcode.numpy(), tlen.numpy()))
    return _CACHE[name]


@pytest.mark.parametrize("name", CASES)
def test_payloads_equal_reference_and_golden(name):
    rows, t, cap, (jcode, jlen), (tcode, tlen) = _coded(name)
    np.testing.assert_array_equal(tlen, jlen)
    assert int(tlen.max()) <= cap
    np.testing.assert_array_equal(tcode, jcode)
    for b in range(rows.shape[0]):
        assert tcode[b, : tlen[b]].tobytes() == golden.encode(
            rows[b], t.c, t.cum[:-1], 1 << t.k), f"block {b}"


def test_decode_both_ways():
    """The port decodes the JAX package's code matrices and the JAX
    package decodes the port's, to the rows (int32)."""
    for name in CASES:
        rows, t, cap, (jcode, _), (tcode, _) = _coded(name)
        L = rows.shape[1]
        c = torch.from_numpy(t.c.astype(np.int64))
        cum = torch.from_numpy(t.cum.astype(np.int64))
        got = blocks.decode_blocks(torch.from_numpy(jcode.copy()), c, cum,
                                   k=t.k, block_len=L)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), rows)
        back = jblocks.decode_blocks(jnp.asarray(tcode), jnp.asarray(t.c),
                                     jnp.asarray(t.cum), k=t.k, block_len=L)
        np.testing.assert_array_equal(np.asarray(back), rows)


def test_cut_capacity_matches_reference_and_retry_restores():
    """A capacity below the longest block: the same cut streams and true
    lengths as the reference (bytes past the capacity dropped, none
    written out of bounds); the api's retry doubles it until every block
    fits and gives the full payloads."""
    rows, t, cap, _, (tcode, tlen) = _coded("c1_runs_k16_B4_L64")
    small = 64
    assert int(tlen.max()) > small
    jcode, jlen = jblocks.encode_blocks(
        jnp.asarray(rows), jnp.asarray(t.c), jnp.asarray(t.cum), k=t.k,
        capacity=small)
    code, lengths = blocks.encode_blocks(
        torch.from_numpy(rows), torch.from_numpy(t.c.astype(np.int64)),
        torch.from_numpy(t.cum.astype(np.int64)), k=t.k, capacity=small)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    rcode, rlen = api._encode_rows(rows, t, small, "cpu")
    assert rcode.shape[1] >= int(tlen.max()) and rcode.shape[1] % small == 0
    np.testing.assert_array_equal(rlen, tlen)
    for b in range(rows.shape[0]):
        assert rcode[b, : rlen[b]].tobytes() == tcode[b, : tlen[b]].tobytes()


def test_windows_read_zero_past_the_row():
    code = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10]], dtype=torch.uint8)
    win = lookup.code_windows(code)
    assert win.shape == (1, 11)
    assert int(win[0, 0]) == 0x0102030405060708
    assert int(win[0, 3]) == 0x0405060708090A00
    assert int(win[0, 10]) == 0
    assert int(lookup.window_at(win, torch.tensor([2]))[0]) == (
        0x030405060708090A)
    assert int(lookup.window_at(win, torch.tensor([99]))[0]) == 0
