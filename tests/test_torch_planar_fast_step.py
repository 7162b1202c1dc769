"""The planar kernels' shipped per-block routines (``csrc/planar_step.cuh``)
compiled for the host with g++ and held to the header's first routines,
to u64 division and to the plain versions, on the CPU.

The kernels run these routines on the card: the decoder's quotient from a
reciprocal estimate and one correction (``quotient``), a raw total's
range by a multiply-high (``Divisor``), the slot table (``fill_slots``),
the code bytes read ahead 16 at a time (``CodeReader``), the byte writer
that stores 8 bytes at a time (``ByteWriter``) and the encode that reads
its symbols 16 bytes at a time.  Each must give exactly what u64 ``/``,
``find_symbol``, ``CodeRow``, ``ByteSink`` and the first loops give,
on payloads whose starts and lengths are not multiples of 4 or 16.  The
plain decode of the flat payload form must equal the matrix form's and
the JAX package's ``decode_blocks``.  All outputs are integers: every
comparison is exact."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_coder_rust_tpu import blocks as jblocks
from range_coder_rust_tpu_torch import blocks
from range_coder_rust_tpu_torch.kernels import planar
from range_coder_rust_tpu_torch.models.table import table_from_data_pow2

torch.set_num_threads(1)

CSRC = Path(planar.__file__).resolve().parent.parent / "csrc"
TOP = (1 << 64) - 1
PAD = 32  # bytes around every host buffer the aligned loads may touch

_SHIM = r"""
#include "planar_step.cuh"

using planar::u64;

static planar::GlobalTable table(const long long* c, const long long* cum,
                                 int per_block, int a, long long b) {
  const long long row = per_block ? b : 0;
  return planar::GlobalTable{c + row * a, cum + row * (a + 1), a};
}

extern "C" {

void fs_quotient(long long n, const u64* d, const u64* r, u64 qmax, int wide,
                 u64* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = wide ? planar::quotient<true>(d[i], r[i], qmax)
                  : planar::quotient<false>(d[i], r[i], qmax);
}

void fs_divide(long long n, u64 t, const u64* x, u64* out) {
  const planar::Divisor dv = planar::make_divisor(t);
  for (long long i = 0; i < n; ++i) out[i] = planar::divide(dv, x[i]);
}

// slots of a 2^k table by fill_slots (u8 or u16), and find_symbol's answer
// for every rfreq; returns slots_valid
int fs_slots(const long long* c, const long long* cum, int a, int k,
             int slot_bytes, int* slots, int* search) {
  const planar::GlobalTable t{c, cum, a};
  const int valid = planar::slots_valid(t, a, 1ull << k, 0, 1);
  unsigned char s8[1 << 16];
  unsigned short s16[1 << 16];
  for (int j = 0; j < (1 << k); ++j) s8[j] = s16[j] = 0xAB;
  if (slot_bytes == 1)
    for (int lane = 0; lane < 4; ++lane)  // lanes and symbols in turns
      planar::fill_slots(s8, t, a, lane & 1, 2, lane >> 1, 2);
  else
    planar::fill_slots(s16, t, a, 0, 1, 0, 1);
  for (int j = 0; j < (1 << k); ++j) {
    slots[j] = slot_bytes == 1 ? planar::SlotFind<unsigned char>{s8}(j)
                               : planar::SlotFind<unsigned short>{s16}(j);
    search[j] = planar::find_symbol(t, a, j);
  }
  return valid;
}

// decode n_blocks payloads at offs / lens of buf: `fast` the shipped loop
// (CodeReader; slot table for slots = 1; vec: four symbols a store), else
// the first loop (CodeRow, decode_block)
void fs_decode(const unsigned char* buf, const long long* offs,
               const long long* lens, long long n_blocks, int L,
               const long long* c, const long long* cum, int per_block,
               int a, int k, u64 total, int fast, int slots, int* out) {
  static unsigned short s16[1 << 16];
  const planar::GlobalTable t0 = table(c, cum, 0, a, 0);
  if (slots) planar::fill_slots(s16, t0, a, 0, 1, 0, 1);
  const planar::SlotFind<unsigned short> by_slot{s16};
  for (long long b = 0; b < n_blocks; ++b) {
    const planar::GlobalTable t = table(c, cum, per_block, a, b);
    const planar::SearchFind<planar::GlobalTable> by_search{t, a};
    int* row = out + b * L;
    const bool vec = (L & 3) == 0;
    if (!fast) {
      const planar::CodeRow code{buf + offs[b], lens[b]};
      if (k)
        planar::decode_block<false>(code, L, t, a, k, total, row);
      else
        planar::decode_block<true>(code, L, t, a, k, total, row);
      continue;
    }
    planar::CodeReader code = planar::code_reader(buf + offs[b], lens[b]);
    if (k && slots)
      planar::decode_block_fast(&code, L, t, a, planar::pow2_total(k),
                                by_slot, row, vec);
    else if (k)
      planar::decode_block_fast(&code, L, t, a, planar::pow2_total(k),
                                by_search, row, vec);
    else
      planar::decode_block_fast(&code, L, t, a, planar::raw_total(total),
                                by_search, row, vec);
  }
}

// one row's stream of n transitions (emit_low, byte count) by ByteWriter
// (fast) or ByteSink; returns the length
long long fs_write(const u64* emit, const int* nbytes, long long n,
                   unsigned char* row, long long cap, int fast) {
  planar::ByteWriter w = planar::byte_writer(row, cap);
  planar::ByteSink s = planar::byte_sink(row, cap);
  for (long long i = 0; i < n; ++i)
    fast ? w.emit(emit[i], nbytes[i]) : s.emit(emit[i], nbytes[i]);
  fast ? w.finish() : s.finish();
  return fast ? w.length() : s.length();
}

// encode n_blocks rows of u8 symbols at `sym` (row stride L) into rows of
// `cap` bytes at `out` (row stride `stride`): the shipped loop (16-byte
// symbol reads where `vec`, ByteWriter) or the first (SymbolRow,
// encode_block, ByteSink)
void fs_encode(const unsigned char* sym, long long n_blocks, int L,
               const long long* c, const long long* cum, int per_block,
               int a, int k, u64 total, unsigned char* out, long long stride,
               long long cap, int fast, int vec, long long* lengths) {
  for (long long b = 0; b < n_blocks; ++b) {
    const planar::GlobalTable t = table(c, cum, per_block, a, b);
    const unsigned char* row = sym + b * L;
    if (!fast) {
      planar::ByteSink sink = planar::byte_sink(out + b * stride, cap);
      const planar::SymbolRow<unsigned char> syms{row, a};
      if (k)
        planar::encode_block<false>(syms, L, t, k, total, &sink);
      else
        planar::encode_block<true>(syms, L, t, k, total, &sink);
      lengths[b] = sink.length();
      continue;
    }
    planar::ByteWriter w = planar::byte_writer(out + b * stride, cap);
    if (k)
      planar::encode_block_fast(row, L, a, t, planar::pow2_total(k), &w, vec);
    else
      planar::encode_block_fast(row, L, a, t, planar::raw_total(total), &w,
                                vec);
    lengths[b] = w.length();
  }
}

}  // extern "C"
"""


def _build(d: Path, name: str, *defines: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    (d / "shim.cc").write_text(_SHIM)
    so = d / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-fno-strict-aliasing", "-std=c++17",
                    "-shared", "-fPIC", "-Wall", "-Werror", *defines,
                    f"-I{CSRC}", "-o", str(so), str(d / "shim.cc")],
                   check=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("planar_fast_step"), "fast_step")


@pytest.fixture(scope="module")
def nudged(tmp_path_factory):
    """The header with its float reciprocal one ulp above and one below
    the correctly rounded one, as the card's rcp.approx.f32 may give it."""
    d = tmp_path_factory.mktemp("planar_fast_step_rcp")
    return [_build(d, f"rcp{u}", f"-DPLANAR_HOST_RCP_ULPS={u}")
            for u in (1, -1)]


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_LL, _U = ctypes.c_longlong, ctypes.c_ulonglong


def _u64(xs) -> np.ndarray:
    return np.array([x & TOP for x in xs], np.uint64)


def _random_u64(r, n: int) -> np.ndarray:
    """u64 values whose bit lengths spread over [1, 64]."""
    hi = r.integers(0, 1 << 32, n, dtype=np.uint64)
    lo = r.integers(0, 1 << 32, n, dtype=np.uint64)
    return (hi << np.uint64(32) | lo) >> r.integers(0, 64, n).astype(
        np.uint64)


@pytest.mark.parametrize("wide", [False, True])
def test_quotient_is_clamped_division(wide, lib, nudged):
    """min(d / r, qmax), r = 0 giving qmax, on edge pairs (r = 0, 1,
    below 2^32, near 2^64 >> k and 2^64; d at multiples of r and one off)
    and about 10^6 random pairs, for each qmax the decoder uses (2^k - 1
    with k in [1, 16] for the float estimate; raw totals up to 2^32 - 1
    for the double one)."""
    r = np.random.default_rng(70 + wide)
    qmaxes = ([(1 << 32) - 2, (1 << 24) - 17, 8192, 2, 0] if wide
              else [(1 << 16) - 1, (1 << 12) - 1, 1, 0])
    rs = [0, 1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, TOP >> 16,
          (TOP >> 16) - 1, TOP >> 12, 1 << 48, TOP >> 1, TOP, TOP - 1,
          (1 << 48) + 12345, 65535, 65536]
    n = 1 << 19
    for qmax in qmaxes:
        dd, rr = [], []
        for rv in rs:
            for q in {0, 1, qmax - 1, qmax, qmax + 1, qmax // 2, 1 << 15}:
                base = q * rv
                for d in (base - 1, base, base + 1, base + rv - 1, TOP, 0):
                    if 0 <= d <= TOP:
                        dd.append(d)
                        rr.append(rv)
        d = np.concatenate([_u64(dd), _random_u64(r, n)])
        rv = np.concatenate([_u64(rr), _random_u64(r, n)])
        # pairs whose quotient lands near qmax, where the estimate matters
        near = r.integers(0, qmax + 2, n // 4, dtype=np.uint64)
        rnear = np.maximum(_random_u64(r, n // 4) >> np.uint64(34),
                           np.uint64(1))
        d = np.concatenate([d, near * rnear + r.integers(
            0, 1 << 30, n // 4, dtype=np.uint64) % rnear])
        rv = np.concatenate([rv, rnear])
        want = np.minimum(np.where(rv > 0, d // np.maximum(rv, np.uint64(1)),
                                   np.uint64(TOP)), np.uint64(qmax))
        for one in [lib] + ([] if wide else nudged):
            got = np.empty(d.size, np.uint64)
            one.fs_quotient(_LL(d.size), _p(d), _p(rv), _U(qmax), int(wide),
                            _p(got))
            np.testing.assert_array_equal(got, want, f"qmax {qmax}")


def test_divisor_is_division(lib):
    """The raw total's multiply-high by floor(2^64 / t) and one correction
    equals u64 division for every dividend tried: edges (0, 1, t - 1, t,
    multiples of t and one off, 2^64 - 1) and random ones, at totals 1,
    2, 3, 2^24 - 17, 2^24, 2^32 - 1 and random u32 totals."""
    r = np.random.default_rng(80)
    totals = [1, 2, 3, (1 << 24) - 17, 1 << 24, (1 << 32) - 1,
              *r.integers(1, 1 << 32, 8).tolist()]
    for t in totals:
        edges = [0, 1, t - 1, t, t + 1, TOP, TOP - 1, TOP // t * t,
                 TOP // t * t - 1, (1 << 48) + 7, 1 << 63]
        x = np.concatenate([_u64(edges), _random_u64(r, 1 << 17)])
        got = np.empty(x.size, np.uint64)
        lib.fs_divide(_LL(x.size), _U(t), _p(x), _p(got))
        np.testing.assert_array_equal(got, x // np.uint64(t), f"total {t}")


def _table(a: int, k: int, r, zeros: int):
    """(c, cum) int64 of a 2^k table over A <= 2^k symbols, `zeros` of
    them (the first, the last and scattered ones) of frequency 0: one for
    every other symbol, the rest of 2^k spread by Zipf counts."""
    live = np.ones(a, bool)
    if zeros and a > 2:
        dead = np.concatenate([[0, a - 1], r.choice(a, zeros, replace=False)])
        live[dead] = False
    counts = np.where(live, r.zipf(1.3, a), 0).astype(np.float64)
    spare = (1 << k) - int(live.sum())
    c = live.astype(np.int64) + (counts * spare // counts.sum()).astype(
        np.int64)
    c[np.argmax(counts)] += (1 << k) - c.sum()
    return c, np.concatenate([[0], c.cumsum()])


def test_slot_table_equals_search(lib):
    """The slot table filled by symbol ranges answers as find_symbol's
    binary search for every rfreq at k = 16 and k = 12, for A = 1, 256,
    257 and 4096 with and without zero-frequency symbols, u8 slots up to
    256 symbols and u16 slots past them."""
    r = np.random.default_rng(90)
    slots, search = (np.empty(1 << 16, np.int32) for _ in range(2))
    for k in (16, 12):
        for a in (1, 256, 257, 4096):
            for zeros in ((0, 9) if a > 1 else (0,)):
                c, cum = _table(a, k, r, zeros)
                for sb in ((1, 2) if a <= 256 else (2,)):
                    valid = lib.fs_slots(_p(c), _p(cum), a, k, sb,
                                         _p(slots), _p(search))
                    assert valid, (k, a, zeros)
                    np.testing.assert_array_equal(
                        slots[: 1 << k], search[: 1 << k],
                        f"k {k} A {a} zeros {zeros} slot bytes {sb}")
    # a table that does not reach 2^k is refused, not filled
    c, cum = _table(256, 12, r, 0)
    cum[-1] -= 1
    assert not lib.fs_slots(_p(c), _p(cum), 256, 12, 1, _p(slots),
                            _p(search))


def _padded(payload: np.ndarray, offsets: np.ndarray, size: int):
    """A buffer of `size` junk bytes (0xA5) with PAD more on each side,
    each payload row written at its offset; returns (buffer, offsets into
    the padded buffer)."""
    buf = np.full(size + 2 * PAD, 0xA5, np.uint8)
    for row, off in zip(payload, offsets):
        buf[PAD + off : PAD + off + row.size] = row
    return buf, offsets + PAD


def _encoded(r, B: int, L: int, mode: str):
    """(rows u8, c, cum, k, total, code matrix, lengths) of a seeded
    variant: a 2^16 table, a raw total or per-block 2^12 tables."""
    rows = (r.zipf(1.3, (B, L)) % 256).astype(np.uint8)
    rows[0, : L // 2] = 255  # a rare symbol in a run: c = 1 steps
    if mode == "per_block":
        c = np.stack([planar_counts(x, 12) for x in rows])
        cum = np.pad(c.cumsum(1), ((0, 0), (1, 0)))
        k, total = 12, 1 << 12
    elif mode == "raw_total":
        c = np.bincount(rows.reshape(-1), minlength=256).astype(np.int64)
        c[3] += 1
        cum = np.concatenate([[0], c.cumsum()])
        k, total = 0, int(cum[-1])
    else:
        t = table_from_data_pow2(rows, 256, 16)
        c, cum = t.c.astype(np.int64), t.cum.astype(np.int64)
        k, total = 16, 1 << 16
    kw = {"k": k} if k else {"total": total}
    code, lengths = planar.planar_encode_plain(
        torch.from_numpy(rows), torch.from_numpy(c), torch.from_numpy(cum),
        capacity=-(-(6 * L + 8) // 8) * 8, **kw)
    return rows, c, cum, k, total, code.numpy(), lengths.numpy()


def planar_counts(row: np.ndarray, k: int) -> np.ndarray:
    counts = np.bincount(row, minlength=256)
    c = np.where(counts > 0, np.maximum(counts * (1 << k) // counts.sum(),
                                        1), 0).astype(np.int64)
    c[np.argmax(c)] += (1 << k) - c.sum()
    return c


def test_fast_decode_equals_first_loop(lib):
    """The shipped decode (CodeReader, the quotient, the slot table at a
    2^k shared table, four symbols a store) equals the first loop
    (CodeRow, u64 `/`, binary search) and the rows, on a 2^16 table, a
    raw total and per-block 2^12 tables, on payloads at odd offsets with
    junk between them, cut payloads (fewer bytes than the symbols need:
    zeros read past them) and empty ones, at L = 60 (four a store) and
    L = 61."""
    r = np.random.default_rng(100)
    for mode, L in ((m, n) for m in ("pow2", "raw_total", "per_block")
                    for n in (60, 61)):
        B = 37
        rows, c, cum, k, total, code, lengths = _encoded(r, B, L, mode)
        lens = lengths.copy()
        lens[5] = 3  # cut inside the first window
        lens[6] = 0
        lens[7] = max(9, lens[7] - 11)  # cut: the tail reads zeros
        gaps = r.integers(0, 20, B)
        gaps[0] = 1
        offs = np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
        payload = [code[b, : lens[b]] for b in range(B)]
        buf, poffs = _padded(payload, offs, int(offs[-1] + lens[-1] + 5))
        per_block = int(c.ndim == 2)
        outs = []
        for fast, slots in ((0, 0), (1, 0), (1, 1)):
            if slots and (per_block or not k):
                continue
            out = np.full((B, L), -1, np.int32)
            lib.fs_decode(_p(buf), _p(poffs), _p(lens), _LL(B), L, _p(c),
                          _p(cum), per_block, 256, k, _U(total), fast, slots,
                          _p(out))
            outs.append(out)
        for out in outs[1:]:
            np.testing.assert_array_equal(out, outs[0], f"{mode} L {L}")
        whole = lens == lengths
        np.testing.assert_array_equal(outs[0][whole], rows[whole])


def test_fast_writer_and_encode_equal_byte_sink(lib):
    """ByteWriter equals ByteSink byte for byte and in length: random
    transitions of 0 to 14 bytes into rows at starts that are not
    multiples of 4 or 8, with capacities that cut the stream at every
    residue mod 8 or hold it whole; then the shipped encode (16-byte symbol
    reads or scalar ones, ByteWriter, the raw total's Divisor) equals the
    first (SymbolRow, ByteSink, u64 `/`) on 2^16, raw-total and per-block
    tables, at row starts and capacities that are not multiples of 8."""
    r = np.random.default_rng(110)
    for trial in range(60):
        n = int(r.integers(0, 90))
        emit = _random_u64(r, n)
        nb = r.integers(0, 15, n).astype(np.int32)
        nb[r.random(n) < 0.3] = 0
        total = int(nb.sum())
        for cap in (total + 8, total, max(0, total - 1 - trial % 8), 5, 0):
            start = int(r.integers(0, 16))
            rows = [np.zeros(cap + 2 * PAD, np.uint8) for _ in range(2)]
            got = [lib.fs_write(_p(emit), _p(nb), _LL(n),
                                ctypes.c_void_p(row.ctypes.data + PAD + start),
                                _LL(cap), fast)
                   for fast, row in zip((1, 0), rows)]
            assert got[0] == got[1] == total
            np.testing.assert_array_equal(rows[0], rows[1], f"cap {cap}")
    for mode in ("pow2", "raw_total", "per_block"):
        B, L = 21, 64
        rows, c, cum, k, total, _, lengths = _encoded(r, B, L, mode)
        per_block = int(c.ndim == 2)
        aligned = int(rows.ctypes.data % 16 == 0)
        for start, cap, vec in ((0, 400, aligned), (3, 397, 0),
                                (0, 101, aligned), (5, 64, 0)):
            outs, lens = [], []
            for fast in (1, 0):
                out = np.zeros(B * cap + 2 * PAD, np.uint8)
                ln = np.empty(B, np.int64)
                lib.fs_encode(_p(rows), _LL(B), L, _p(c), _p(cum), per_block,
                              256, k, _U(total),
                              ctypes.c_void_p(out.ctypes.data + PAD + start),
                              _LL(cap), _LL(cap), fast, vec, _p(ln))
                outs.append(out)
                lens.append(ln)
            np.testing.assert_array_equal(lens[0], lens[1])
            np.testing.assert_array_equal(lens[0], lengths)
            np.testing.assert_array_equal(outs[0], outs[1],
                                          f"{mode} cap {cap}")


def test_flat_plain_decode_equals_matrix_and_jax():
    """The plain decode of the flat form (payloads joined at odd offsets,
    junk between them, an offset past the buffer read as empty) equals the
    matrix form's and the JAX package's decode_blocks, at B = 24, L = 64,
    and blocks.payload_buffers joins a container's payloads as the api
    uploads them."""
    r = np.random.default_rng(120)
    B, L = 24, 64
    rows, c, cum, k, _, code, lengths = _encoded(r, B, L, "pow2")
    ct, cumt = torch.from_numpy(c), torch.from_numpy(cum)
    want = planar.planar_decode_plain(torch.from_numpy(code), ct, cumt, k=k,
                                      block_len=L)
    np.testing.assert_array_equal(want.numpy(), rows)
    jdec = jblocks.decode_blocks(jnp.asarray(code), jnp.asarray(c),
                                 jnp.asarray(cum), k=k, block_len=L)
    np.testing.assert_array_equal(np.asarray(jdec), rows)
    gaps = r.integers(0, 4, B)
    gaps[0] = 3
    offs = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    buf = np.full(int(offs[-1] + lengths[-1] + 2), 0xA5, np.uint8)
    for b in range(B):
        buf[offs[b] : offs[b] + lengths[b]] = code[b, : lengths[b]]
    got = planar.planar_decode_plain(
        torch.from_numpy(buf), ct, cumt, k=k, block_len=L,
        offsets=torch.from_numpy(offs), lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), rows)
    flat, o2, l2 = blocks.payload_buffers(
        [code[b, : lengths[b]].tobytes() for b in range(B)], lengths, "cpu")
    assert flat.numel() == int(lengths.sum()) and o2[0] == 0
    got = blocks.decode_payloads(flat, o2, l2, ct, cumt, k=k, block_len=L)
    np.testing.assert_array_equal(got.numpy(), rows)
    # an offset past the buffer, a negative one, a length past the end
    bad_off = torch.tensor([flat.numel() + 1, -1, int(o2[-1])])
    bad_len = torch.tensor([8, 8, 10 ** 6])
    rows3 = planar.payload_rows(flat, bad_off, bad_len)
    assert rows3.shape == (3, int(l2[-1]))
    assert not rows3[:2].any()
    assert torch.equal(rows3[2], flat[int(o2[-1]):])
