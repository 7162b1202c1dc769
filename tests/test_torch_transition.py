"""The port's closed-form coder transition against the JAX package's,
lane by lane: the pow2 and the exact-division updates, the decoder's
target values and the flush, on states from the fresh interval
(range 2^64 - 1) down to the renormalization floor (range 2^48), with
lower bounds up to the top of the u64 range."""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu.ops import transition as jtr
from range_coder_rust_tpu.ops import u64 as ju
from range_coder_rust_tpu_torch.ops import transition as ttr
from range_coder_rust_tpu_torch.ops import u64

torch.set_num_threads(1)

N = 512
TOP = (1 << 64) - 1


def _states(seed: int):
    """(low, rng) as uint64: valid intervals (rng >= 2^48, low + rng <=
    2^64 - 1) with the extremes first."""
    r = np.random.default_rng(seed)
    rng = [TOP, 1 << 48, (1 << 48) + 1, 1 << 63, TOP - 5, 1 << 48]
    low = [0, TOP - (1 << 48), 0, (1 << 63) - 1, 5, 0xFF_FFFF_FFFF]
    for _ in range(N - len(rng)):
        bits = int(r.integers(49, 65))
        x = int(r.integers(0, 1 << 62)) << 2 | int(r.integers(0, 4))
        x = max(1 << 48, x >> (64 - bits))
        rng.append(x)
        low.append(int(r.integers(0, 1 << 62)) * 4 % (TOP - x + 1))
    return np.array(low, np.uint64), np.array(rng, np.uint64)


def _symbols(seed: int, total: int):
    """(c, cum) with c >= 1 and cum + c <= total, uint32."""
    r = np.random.default_rng(seed)
    c = np.minimum(r.integers(1, total + 1, N), total)
    c[:4] = [1, total, max(1, total // 2), 1]
    cum = r.integers(0, total - c + 1)
    cum[3] = total - 1
    return c.astype(np.uint32), cum.astype(np.uint32)


def _port_state(low, rng):
    return ttr.CoderState(u64.from_np(low), u64.from_np(rng))


def _jax_state(low, rng):
    return jtr.CoderState(ju.from_np(low), ju.from_np(rng))


def _assert_same(port_out, jax_out):
    (st, emit, n), (jst, jemit, jn) = port_out, jax_out
    np.testing.assert_array_equal(u64.to_np(st.low), ju.to_np(jst.low))
    np.testing.assert_array_equal(u64.to_np(st.rng), ju.to_np(jst.rng))
    np.testing.assert_array_equal(u64.to_np(emit), ju.to_np(jemit))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_init_state_and_flush_match_reference():
    st = ttr.init_state((3,))
    assert u64.to_np(st.rng).tolist() == [TOP] * 3
    assert u64.to_np(st.low).tolist() == [0] * 3
    low, rng = _states(1)
    emit, n = ttr.flush_state(_port_state(low, rng))
    jemit, jn = jtr.flush_state(_jax_state(low, rng))
    np.testing.assert_array_equal(u64.to_np(emit), ju.to_np(jemit))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


@pytest.mark.parametrize("k", [1, 8, 12, 16])
def test_param_update_pow2_matches_reference(k):
    low, rng = _states(k)
    c, cum = _symbols(k + 100, 1 << k)
    _assert_same(
        ttr.param_update_pow2(_port_state(low, rng), _t32(c), _t32(cum), k),
        jtr.param_update_pow2(_jax_state(low, rng), c, cum, k))


TOTALS = [1, 3, 1000, (1 << 16) + 1, (1 << 24) - 17, (1 << 24) - 16,
          1 << 24, (1 << 32) - 1]


def test_param_update_div_matches_reference():
    for i, total in enumerate(TOTALS):
        low, rng = _states(200 + i)
        c, cum = _symbols(300 + i, total)
        _assert_same(
            ttr.param_update_div(_port_state(low, rng), _t32(c), _t32(cum),
                                 total),
            jtr.param_update_div(_jax_state(low, rng), c, cum, total))


def _windows(low, rng, seed):
    """Windows inside each interval, at its two ends first."""
    r = np.random.default_rng(seed)
    frac = r.random(N)
    frac[:2] = [0.0, 1.0]
    off = [min(int(float(g) * f), int(g) - 1) for g, f in zip(rng, frac)]
    return np.array([int(lo) + o for lo, o in zip(low, off)], np.uint64)


#: a raw total where the reference's single-stage divide (its float
#: estimate, then five correction steps) misses the exact quotient by up
#: to 4 near 2^24: the port is held to the exact value there
REF_INEXACT = {(1 << 24) - 17}


def test_decode_find_rfreq_matches_reference():
    """pow2 totals, and every raw total (the two-stage branch of the
    reference from 2^24 - 16 on), on windows the decoder can see; each
    raw total's target is also the exact one."""
    for k in (1, 8, 12, 16):
        low, rng = _states(400 + k)
        win = _windows(low, rng, k)
        got = ttr.decode_find_rfreq(_port_state(low, rng), u64.from_np(win),
                                    k)
        want = jtr.decode_find_rfreq(_jax_state(low, rng), ju.from_np(win), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, total in enumerate(TOTALS):
        low, rng = _states(500 + i)
        win = _windows(low, rng, i)
        got = ttr.decode_find_rfreq_div(_port_state(low, rng),
                                        u64.from_np(win), total)
        want = jtr.decode_find_rfreq_div(_jax_state(low, rng),
                                         ju.from_np(win), np.uint32(total))
        if total not in REF_INEXACT:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # and the exact value: the largest r with r * (rng // total) <=
        # win - low, capped at total - 1
        exact = [min((int(w) - int(lo)) // (int(g) // total), total - 1)
                 for w, lo, g in zip(win, low, rng)]
        assert got.tolist() == exact
