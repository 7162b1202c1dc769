"""The planar kernels' C++ (``csrc/planar_step.cuh``) compiled for the host
with g++ and held to the port's plain PyTorch versions, on the CPU.

The header holds everything of the planar kernels but the launch: the
per-symbol arithmetic on native u64, the table reads, the output row's
byte writer and the per-block encode and decode loops.  A small C shim
(``_SHIM`` below) exposes it through ctypes.  Its transitions must
equal ``ops/transition.param_update_pow2`` / ``param_update_div`` and
``decode_find_rfreq*`` lane by lane (state, emitted low, byte count,
target value), on states from range 2^64 - 1 down to 2^48, lower bounds
near 2^64 and runs of c = 1 symbols; its block coder must equal
``kernels/planar.py``'s plain versions byte for byte, with word and byte
stores, a cut capacity and decode rows of widths that are not multiples
of 4.  All outputs are integers: every comparison is exact."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from range_coder_rust_tpu_torch.kernels import planar
from range_coder_rust_tpu_torch.ops import transition as ttr
from range_coder_rust_tpu_torch.ops import u64

torch.set_num_threads(1)

CSRC = Path(planar.__file__).resolve().parent.parent / "csrc"
TOP = (1 << 64) - 1
N = 512

_SHIM = r"""
#include "planar_step.cuh"

using planar::u64;

extern "C" {

void pl_steps(long long n, const u64* low, const u64* rng, const u64* c,
              const u64* cum, int k, u64 total, u64* out_low, u64* out_rng,
              u64* emit, int* nbytes) {
  for (long long i = 0; i < n; ++i) {
    planar::Coder st{low[i], rng[i]};
    const u64 rpt = k ? planar::range_per_total<false>(st.rng, k, total)
                      : planar::range_per_total<true>(st.rng, k, total);
    nbytes[i] = planar::encode_step(&st, rpt, c[i], cum[i], &emit[i]);
    out_low[i] = st.low;
    out_rng[i] = st.rng;
  }
}

void pl_rfreq(long long n, const u64* low, const u64* rng, const u64* window,
              int k, u64 total, u64* out) {
  for (long long i = 0; i < n; ++i) {
    const planar::Coder st{low[i], rng[i]};
    const u64 rpt = k ? planar::range_per_total<false>(st.rng, k, total)
                      : planar::range_per_total<true>(st.rng, k, total);
    out[i] = planar::decode_rfreq(window[i], st, rpt, k ? 1ull << k : total);
  }
}

static planar::GlobalTable table(const long long* c, const long long* cum,
                                 int per_block, int a, long long b) {
  const long long row = per_block ? b : 0;
  return planar::GlobalTable{c + row * a, cum + row * (a + 1), a};
}

void pl_encode(const int* sym, long long n_blocks, int L, const long long* c,
               const long long* cum, int per_block, int a, int k, u64 total,
               unsigned char* out, long long cap, long long* lengths) {
  for (long long b = 0; b < n_blocks; ++b) {
    planar::ByteSink sink = planar::byte_sink(out + b * cap, cap);
    const planar::SymbolRow<int> row{sym + b * L, a};
    if (k)
      planar::encode_block<false>(row, L, table(c, cum, per_block, a, b), k,
                                  total, &sink);
    else
      planar::encode_block<true>(row, L, table(c, cum, per_block, a, b), k,
                                 total, &sink);
    lengths[b] = sink.pos;
  }
}

void pl_decode(const unsigned char* code, long long n_blocks, long long width,
               int L, const long long* c, const long long* cum, int per_block,
               int a, int k, u64 total, int* out) {
  for (long long b = 0; b < n_blocks; ++b) {
    const planar::CodeRow row{code + b * width, width};
    if (k)
      planar::decode_block<false>(row, L, table(c, cum, per_block, a, b), a,
                                  k, total, out + b * L);
    else
      planar::decode_block<true>(row, L, table(c, cum, per_block, a, b), a,
                                 k, total, out + b * L);
  }
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    d = tmp_path_factory.mktemp("planar_step")
    (d / "shim.cc").write_text(_SHIM)
    so = d / "libplanar_step.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wall", "-Werror", f"-I{CSRC}", "-o", str(so),
                    str(d / "shim.cc")], check=True)
    return ctypes.CDLL(str(so))


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _states(seed: int):
    """(low, rng) uint64: range 2^64 - 1 down to 2^48 (and a few below
    it), lower bounds up to 2^64 - 1, the extremes first."""
    r = np.random.default_rng(seed)
    rng = [TOP, 1 << 48, (1 << 48) + 1, 1 << 63, TOP - 5, 1 << 48,
           (1 << 48) - 1, 1 << 40,
           # with c = 1, cum = 0 (_symbols): at k = 12, 16 the reduction
           # runs over six 0xFF bytes (n_ff clamped); at the total 3,
           # rng' = 2^48 - 1 with no leading byte to shift
           1 << 56, 3 * ((1 << 48) - 1) + 2, TOP]
    low = [0, TOP - (1 << 48), 0, (1 << 63) - 1, 5, 0xFF_FFFF_FFFF,
           TOP - (1 << 48) + 1, TOP - (1 << 40),
           0x12FF_FFFF_FFFF_FFFF, 0x12FF_FF00_0000_0000, 0]
    for _ in range(N - len(rng)):
        bits = int(r.integers(49, 65))
        x = int(r.integers(0, 1 << 62)) << 2 | int(r.integers(0, 4))
        x = max(1 << 48, x >> (64 - bits))
        rng.append(x)
        low.append(int(r.integers(0, 1 << 62)) * 4 % (TOP - x + 1))
    return np.array(low, np.uint64), np.array(rng, np.uint64)


def _symbols(seed: int, total: int):
    """(c, cum) with c >= 1 and cum + c <= total, a run of c = 1 first,
    then c = 1 at cum = 0 and one symbol of frequency 0 (the states
    :func:`_states` puts there)."""
    r = np.random.default_rng(seed)
    c = np.minimum(r.integers(1, total + 1, N), total)
    c[:11] = [1, 1, 1, 1, total, max(1, total // 2), 1, 1, 1, 1, 0]
    cum = r.integers(0, total - c + 1)
    cum[3] = total - 1
    cum[8:10] = 0
    return c.astype(np.uint64), cum.astype(np.uint64)


@pytest.mark.parametrize("mode", ["pow2", "div"])
def test_steps_match_transition(mode, lib):
    """(low', rng', emit_low, n) of one transition on every lane, over k
    in [1, 16] or u32 totals (1, 3, odd, near 2^32)."""
    low, rng = _states(7 if mode == "pow2" else 8)
    params = ([(k, 1 << k) for k in (1, 2, 8, 12, 15, 16)] if mode == "pow2"
              else [(0, t) for t in (1, 3, 1_000_003, (1 << 32) - 1)])
    for k, total in params:
        c, cum = _symbols(k * 31 + total % 97, total)
        st = ttr.CoderState(u64.from_np(low), u64.from_np(rng))
        ct, cumt = torch.from_numpy(c.view(np.int64)), torch.from_numpy(
            cum.view(np.int64))
        want = (ttr.param_update_pow2(st, ct, cumt, k) if k
                else ttr.param_update_div(st, ct, cumt, total))
        got = [np.empty(N, np.uint64) for _ in range(3)] + [
            np.empty(N, np.int32)]
        lib.pl_steps(ctypes.c_longlong(N), _p(low), _p(rng), _p(c), _p(cum),
                     k, ctypes.c_ulonglong(total), *map(_p, got))
        (wst, wemit, wn) = want
        np.testing.assert_array_equal(got[0], u64.to_np(wst.low), str(total))
        np.testing.assert_array_equal(got[1], u64.to_np(wst.rng), str(total))
        np.testing.assert_array_equal(got[2], u64.to_np(wemit), str(total))
        np.testing.assert_array_equal(got[3], wn.numpy(), str(total))


def test_rfreq_matches_transition(lib):
    """The decoder's target value: windows inside the interval, at its
    ends and past it (clamped to total - 1); a total of 1 gives 0."""
    low, rng = _states(9)
    r = np.random.default_rng(10)
    off = (r.random(N) * rng.astype(np.float64)).astype(np.uint64)
    off = np.minimum(off, rng - np.uint64(1))
    off[:3] = [0, 1, 2]
    window = low + off
    window[3:6] = [TOP, 0, low[5] + rng[5]]
    st = ttr.CoderState(u64.from_np(low), u64.from_np(rng))
    w = u64.from_np(window)
    for k, total in [(1, 2), (8, 256), (16, 65536), (0, 1), (0, 3),
                     (0, 65537), (0, (1 << 32) - 1)]:
        want = (ttr.decode_find_rfreq(st, w, k) if k
                else ttr.decode_find_rfreq_div(st, w, total))
        got = np.empty(N, np.uint64)
        lib.pl_rfreq(ctypes.c_longlong(N), _p(low), _p(rng), _p(window), k,
                     ctypes.c_ulonglong(total), _p(got))
        np.testing.assert_array_equal(got, u64.to_np(want), str(total))


def _tables(mode: str, rows: np.ndarray):
    """(c, cum int64 arrays, k, total) for a variant."""
    if mode == "per_block":
        c = np.stack([_pow2(np.bincount(r, minlength=32), 12) for r in rows])
        return c, np.pad(c.cumsum(1), ((0, 0), (1, 0))), 12, 1 << 12
    counts = np.bincount(rows.reshape(-1), minlength=32) + (
        np.arange(32) % 3 == 0)
    if mode == "div":
        c = counts.astype(np.int64)
        return c, np.concatenate([[0], c.cumsum()]), 0, int(c.sum())
    c = _pow2(counts, 16)
    return c, np.concatenate([[0], c.cumsum()]), 16, 1 << 16


def _pow2(counts: np.ndarray, k: int) -> np.ndarray:
    """Counts rescaled to sum 2^k, present symbols >= 1 (the remainder to
    the most frequent symbol)."""
    c = np.where(counts > 0, np.maximum(counts * (1 << k) // counts.sum(),
                                        1), 0).astype(np.int64)
    c[np.argmax(c)] += (1 << k) - c.sum()
    return c


@pytest.mark.parametrize("mode", ["pow2", "div", "per_block"])
def test_block_coder_matches_plain(mode, lib):
    """The header's per-block encode and decode loops equal the plain
    versions: code bytes and lengths at a full capacity (word stores), a
    cut capacity that is not a multiple of 4 (byte stores), and decodes of
    rows of widths 4k + 1 and 4k + 3."""
    r = np.random.default_rng({"pow2": 1, "div": 2, "per_block": 3}[mode])
    B, L = 12, 61
    rows = (r.zipf(1.4, (B, L)) % 32).astype(np.int32)
    rows[0, :40] = 31  # a rare symbol in a run: c = 1 under the shared tables
    rows[1] = 0
    c, cum, k, total = _tables(mode, rows)
    kw = {"k": k} if k else {"total": total}
    ct, cumt = torch.from_numpy(c), torch.from_numpy(cum)
    full = -(-(6 * L + 8) // 4) * 4
    want_code, want_len = planar.planar_encode_plain(
        torch.from_numpy(rows), ct, cumt, capacity=full, **kw)
    longest = int(want_len.max())
    for cap in (full, longest - 5 if longest % 4 != 1 else longest - 6):
        if cap != full:
            want_code, _ = planar.planar_encode_plain(
                torch.from_numpy(rows), ct, cumt, capacity=cap, **kw)
        code = np.zeros((B, cap), np.uint8)
        lengths = np.empty(B, np.int64)
        lib.pl_encode(_p(rows), ctypes.c_longlong(B), L, _p(c), _p(cum),
                      int(c.ndim == 2), c.shape[-1], k,
                      ctypes.c_ulonglong(total), _p(code),
                      ctypes.c_longlong(cap), _p(lengths))
        np.testing.assert_array_equal(lengths, want_len.numpy())
        np.testing.assert_array_equal(code, want_code.numpy(), f"cap {cap}")
    full_code = planar.planar_encode_plain(
        torch.from_numpy(rows), ct, cumt, capacity=full, **kw)[0].numpy()
    for width in (longest + 1, longest + 3, longest - 9):
        m = np.ascontiguousarray(full_code[:, :width])
        want = planar.planar_decode_plain(torch.from_numpy(m), ct, cumt,
                                          block_len=L, **kw).numpy()
        got = np.empty((B, L), np.int32)
        lib.pl_decode(_p(m), ctypes.c_longlong(B), ctypes.c_longlong(width),
                      L, _p(c), _p(cum), int(c.ndim == 2), c.shape[-1], k,
                      ctypes.c_ulonglong(total), _p(got))
        np.testing.assert_array_equal(got, want, f"width {width}")
        if width > longest:
            np.testing.assert_array_equal(got, rows)
