"""The port's raw-total block coder (any u32 total, exact division)
against the JAX package's ``encode_blocks_div`` / ``decode_blocks_div``
and the scalar C++ golden coder, on the CPU: odd totals, totals near the
u32 limit, totals of 1 and 3, and the totals around 2^24 where the
reference switches its decode divide."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from range_coder_rust_tpu import blocks as jblocks
from range_coder_rust_tpu.native import golden
from range_coder_rust_tpu_torch import blocks

torch.set_num_threads(1)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _check(syms: np.ndarray, c: np.ndarray, ref_decode: bool = True):
    """Encode with both packages: the same code matrix and lengths, each
    block the golden coder's stream; the port decodes both packages'
    matrices (and the reference the port's, if ``ref_decode``)."""
    c = c.astype(np.uint32)
    cum = np.concatenate([[0], np.cumsum(c.astype(np.uint64))])
    assert cum[-1] < 1 << 32
    cum = cum.astype(np.uint32)
    total = int(cum[-1])
    B, L = syms.shape
    cap = -(-(6 * L + 8) // 4) * 4
    jcode, jlen = jblocks.encode_blocks_div(
        jnp.asarray(syms), jnp.asarray(c), jnp.asarray(cum), total,
        capacity=cap)
    code, lengths = blocks.encode_blocks_div(_t(syms), _t(c), _t(cum), total,
                                             capacity=cap)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    for b in range(B):
        assert code[b, : int(lengths[b])].numpy().tobytes() == golden.encode(
            syms[b], c, cum[:-1], total), f"total {total} block {b}"
    for m in (code, torch.from_numpy(np.asarray(jcode).copy())):
        dec = blocks.decode_blocks_div(m, _t(c), _t(cum), total, block_len=L)
        assert dec.dtype == torch.int32
        np.testing.assert_array_equal(dec.numpy(), syms)
    if ref_decode:
        back = jblocks.decode_blocks_div(jnp.asarray(code.numpy()),
                                         jnp.asarray(c), jnp.asarray(cum),
                                         total, block_len=L)
        np.testing.assert_array_equal(np.asarray(back), syms)


@pytest.mark.parametrize("a_count", [10, 97])
def test_div_blocks_equal_reference_and_golden(a_count):
    rng = np.random.default_rng(a_count)
    c = rng.integers(1, 1000, a_count).astype(np.uint32)
    if int(c.sum()) % 2 == 0:
        c[0] += 1  # an odd total, not a power of two
    syms = rng.choice(a_count, size=(6, 48), p=c / c.sum()).astype(np.int32)
    _check(syms, c)


def test_div_extreme_totals():
    """A total near the u32 limit, and totals of 1 (the range per unit
    is the whole range, past 2^63) and 3, all at one shape (one compile
    of each JAX function; absent symbols have c = 0)."""
    rng = np.random.default_rng(7)
    big = rng.integers(1 << 28, 1 << 29, 4)
    _check(rng.integers(0, 4, (3, 32)).astype(np.int32), big)
    _check(np.zeros((3, 32), np.int32), np.array([1, 0, 0, 0]))
    _check(rng.integers(0, 2, (3, 32)).astype(np.int32),
           np.array([1, 2, 0, 0]))


def test_div_boundary_totals_around_2pow24():
    """Most of the mass on the last symbol, so the decoder's target sits
    near total - 1: the reference's two-stage divide from 2^24 - 16 on."""
    for total in [(1 << 24) - 1, (1 << 24) - 16, (1 << 24) - 17, 1 << 24]:
        c = np.array([1, 2, total - 3], np.uint32)
        rng = np.random.default_rng(total & 0xFFFF)
        syms = rng.choice(3, size=(2, 64), p=c / c.sum()).astype(np.int32)
        syms[0, :4] = 2
        _check(syms, c)


def test_div_flat_table_below_2pow24_decodes_exactly():
    """A flat 4096-symbol table at total 2^24 - 17: the decoder's targets
    spread over [0, total), where the reference's single-stage divide can
    miss the exact quotient (its decode of this input differs from the
    data).  The port's division is exact: its payloads are the golden
    coder's, and it decodes them, and the golden decode agrees."""
    total, a = (1 << 24) - 17, 4096
    c = np.full(a, total // a, np.uint32)
    c[: total - int(c.sum())] += 1
    syms = np.random.default_rng(3).integers(0, a, (16, 256)).astype(np.int32)
    _check(syms, c, ref_decode=False)
    cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
    code, lengths = blocks.encode_blocks_div(_t(syms), _t(c), _t(cum), total,
                                             capacity=6 * 256 + 8)
    for b in range(2):
        np.testing.assert_array_equal(
            golden.decode(code[b, : int(lengths[b])].numpy(), 256, c,
                          cum[:-1], total), syms[b])
