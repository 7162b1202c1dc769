"""The port's u64 helpers (int64 bit patterns) against the JAX package's
``ops/u64.py`` (uint32 limb pairs), on edge values and random values.

Every result is an integer and must be equal: the port's shifts, compares
and leading-zero-byte count, its wrapping add, subtract and multiply, and
its exact divisions.
"""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu.ops import transition as jtr
from range_coder_rust_tpu.ops import u64 as ju
from range_coder_rust_tpu_torch.ops import u64

torch.set_num_threads(1)

EDGES = [0, 1, 2, 0xFF, 0x100, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         (1 << 48) - 1, 1 << 48, (1 << 56) - 1, 1 << 56, (1 << 63) - 1,
         1 << 63, (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1]


def _values() -> np.ndarray:
    """The edge values, then random values of every bit length."""
    rng = np.random.default_rng(64)
    bits = rng.integers(1, 65, 200)
    rand = [int(rng.integers(0, 1 << 62)) * 4 + int(rng.integers(0, 4))
            for _ in bits]
    rand = [r >> (64 - int(b)) for r, b in zip(rand, bits)]
    return np.array(EDGES + rand, np.uint64)


VALS = _values()


def _t(a: np.ndarray) -> torch.Tensor:
    return u64.from_np(a)


def _j(a: np.ndarray):
    return ju.from_np(a)


def test_bit_patterns_round_trip():
    np.testing.assert_array_equal(u64.to_np(_t(VALS)), VALS)
    for x in EDGES:
        assert u64.to_signed(x) % (1 << 64) == x
    with pytest.raises(ValueError):
        u64.to_signed(1 << 64)


def test_add_sub_mul_wrap_as_u64():
    a, b = VALS, np.roll(VALS, 7)
    c32 = (b & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.testing.assert_array_equal(u64.to_np(_t(a) + _t(b)),
                                  ju.to_np(ju.add(_j(a), _j(b))))
    np.testing.assert_array_equal(u64.to_np(_t(a) - _t(b)),
                                  ju.to_np(ju.sub(_j(a), _j(b))))
    np.testing.assert_array_equal(
        u64.to_np(_t(a) * torch.from_numpy(c32.astype(np.int64))),
        ju.to_np(ju.mul_u64_u32(_j(a), c32)))


def test_shifts_match_reference():
    """Static logical right shifts, and dynamic left shifts by any count:
    those outside [0, 63] (as the renormalization's -8) give 0."""
    counts = np.arange(-8, 73, dtype=np.int32)
    a = np.resize(VALS, counts.size)
    got = u64.shl(_t(a), torch.from_numpy(counts.astype(np.int64)))
    np.testing.assert_array_equal(u64.to_np(got),
                                  ju.to_np(ju.shl(_j(a), counts)))
    for n in (0, 1, 8, 12, 16, 32, 48, 63):
        np.testing.assert_array_equal(u64.to_np(u64.shr(_t(VALS), n)),
                                      ju.to_np(ju.shri(_j(VALS), n)))


def test_compares_and_leading_zero_bytes_match_reference():
    a, b = VALS, np.roll(VALS, 3)
    np.testing.assert_array_equal(u64.uge(_t(a), _t(b)).numpy(),
                                  np.asarray(ju.ge(_j(a), _j(b))))
    np.testing.assert_array_equal(u64.lzb(_t(VALS)).numpy(),
                                  np.asarray(jtr._lzb(_j(VALS))))


DIVISORS = [1, 2, 3, 255, 1 << 16, (1 << 16) + 1, (1 << 24) - 17,
            (1 << 24) - 16, 1 << 24, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]


def test_divmod_u32_matches_reference():
    a = np.repeat(VALS, len(DIVISORS))
    d = np.tile(np.array(DIVISORS, np.uint32), VALS.size)
    q, r = u64.udivmod(_t(a), torch.from_numpy(d.astype(np.int64)))
    jq, jr = ju.divmod_u32(_j(a), d)
    np.testing.assert_array_equal(u64.to_np(q), ju.to_np(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(u64.to_np(q), a // d.astype(np.uint64))
    for total in DIVISORS:  # a Python-int divisor, as the raw-total coder
        q, _ = u64.udivmod(_t(VALS), total)
        np.testing.assert_array_equal(u64.to_np(q),
                                      VALS // np.uint64(total))


def test_div_small_q_is_exact():
    """Exact for every u64 dividend and every divisor below 2^63; equal to
    the reference's estimate-and-correct quotient on the quotients a pow2
    decode reaches (below 2^20: its float estimate can miss by more than
    its correction steps near 2^24)."""
    rng = np.random.default_rng(5)
    y = np.array([1, 2, 3, (1 << 24) + 1, (1 << 40) + 3, (1 << 48) - 1,
                  (1 << 62) + 5, (1 << 63) - 1] * (VALS.size // 8 + 1),
                 np.uint64)[: VALS.size]
    y = np.concatenate([y, rng.integers(1, 1 << 63, VALS.size,
                                        dtype=np.uint64)])
    x = np.concatenate([VALS, VALS])
    q = u64.to_np(u64.udivmod(_t(x), _t(y))[0])
    exact = np.array([int(a) // int(b) for a, b in zip(x, y)], dtype=object)
    assert [int(v) for v in q] == list(exact)
    small = np.array([e < 1 << 20 for e in exact])
    jq = np.asarray(ju.div_small_q(_j(x[small]), _j(y[small])))
    np.testing.assert_array_equal(q[small], jq.astype(np.uint64))
