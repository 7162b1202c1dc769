// The planar coder on native u64, written once for both planar kernels
// (planar_encode.cu, planar_decode.cu): the per-symbol arithmetic, a
// table in device memory, the output row's byte writer, and the whole
// per-block encode and decode loops.  Outside nvcc the functions are
// plain inline C++, so g++ compiles this header too
// (tests/test_torch_planar_step.py holds it to ops/transition.py and to
// the plain versions there).
//
// The coder is the reference's (reference src/range_coder.rs:53-92), in
// the closed form of ops/transition.py: with low' = low + rpt * cum,
// rng' = rpt * c and up' = low' + rng',
//   * the no-carry loop emits n1 = leading zero bytes of (low' ^ up')
//     bytes (at most 7);
//   * with low1 = low' << 8 n1 and rng1 = rng' << 8 n1, the reduction
//     loop runs iff rng1 < 2^48, n2 = 1 + the 0xFF bytes of low1 from
//     byte 5 down (at most 7 in all);
//   * the emitted bytes are the top n1 + n2 bytes of low' (zeros past the
//     eighth);
//   * low2 = low1 << 8 n2, and rng2 = (~(low1 << 8 (n2 - 1)) &
//     (2^48 - 1)) << 8 when the reduction ran, else rng1.
// C++ leaves a u64 shift by 64 or more (or by a negative count) undefined;
// every shift whose count can leave [0, 63] goes through shl(), which
// selects 0 there as ops/u64.shl does.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define PLANAR_HD __host__ __device__ __forceinline__
#else
#define PLANAR_HD inline
#endif

namespace planar {

using u64 = unsigned long long;

constexpr u64 kMask48 = (1ull << 48) - 1;
//: flush length: the final 64-bit lower bound (reference src/encoder.rs:40-46)
constexpr int kFlushBytes = 8;

struct Coder {
  u64 low;
  u64 rng;
};

// The fresh interval (0, 2^64 - 1) (reference src/range_coder.rs:15-18).
PLANAR_HD Coder init_coder() { return Coder{0ull, ~0ull}; }

// Leading zero bytes of x; 8 for x == 0 (__clzll(0) is 64).
PLANAR_HD int lzb(u64 x) {
#if defined(__CUDA_ARCH__)
  return __clzll(static_cast<long long>(x)) >> 3;
#else
  return x ? __builtin_clzll(x) >> 3 : 8;
#endif
}

// x << s for s in [0, 63]; 0 for any other s.
PLANAR_HD u64 shl(u64 x, int s) { return (s >= 0 && s < 64) ? x << s : 0ull; }

// The renormalisation of the interval (low', rng') into *st; returns n,
// the byte count of this transition (its bytes: the top n of low').
PLANAR_HD int renorm(u64 low, u64 rng, Coder* st) {
  int n1 = lzb(low ^ (low + rng));  // no overflow: carryless invariant
  if (n1 > 7) n1 = 7;  // rng' == 0 (a symbol of frequency 0), as lzb(0) = 7
  const u64 low1 = low << (8 * n1);
  const u64 rng1 = rng << (8 * n1);
  const bool need = rng1 <= kMask48;  // rng1 < 2^48
  int n_ff = lzb(~low1 << 16);
  if (n_ff > 6) n_ff = 6;
  const int n2 = need ? n_ff + 1 : 0;
  // the lower bound at the reduction loop's last iteration; its count is
  // -8 where the loop did not run, and that value is selected away
  const u64 last_low = shl(low1, 8 * (n2 - 1));
  st->low = shl(low1, 8 * n2);
  st->rng = need ? (~last_low & kMask48) << 8 : rng1;
  return n1 + n2;
}

// rpt = range / total: range >> k for a total of 2^k, or with kDiv the
// exact u64 division by a u32 total (reference src/range_coder.rs:38-40).
template <bool kDiv>
PLANAR_HD u64 range_per_total(u64 rng, int k, u64 total) {
  return kDiv ? rng / total : rng >> k;
}

// One symbol (c, cum) at rpt (reference src/range_coder.rs:62-68): the
// state moves in place, *emit_low receives low' and the byte count is
// returned.
PLANAR_HD int encode_step(Coder* st, u64 rpt, u64 c, u64 cum, u64* emit_low) {
  const u64 low = st->low + rpt * cum;  // carryless: no u64 overflow
  *emit_low = low;
  return renorm(low, rpt * c, st);
}

// Byte j (0 = the first) of a transition's stream bytes: the top bytes of
// emit_low, zeros past the eighth.
PLANAR_HD unsigned emit_byte(u64 emit_low, int j) {
  return j < 8 ? static_cast<unsigned>(emit_low >> (56 - 8 * j)) & 0xFFu : 0u;
}

// The decoder's target cumulative value (reference
// examples/sample_impl.rs:29-30): (window - low) / rpt, clamped to
// total - 1 as the reference's search never passes the last symbol (a
// total of 1 gives 0 whatever the quotient).
PLANAR_HD u64 decode_rfreq(u64 window, const Coder& st, u64 rpt, u64 total) {
  const u64 q = rpt ? (window - st.low) / rpt : ~0ull;
  return q < total - 1 ? q : total - 1;
}

// A read through the read-only cache on the card, a plain read on the
// host.
template <typename T>
PLANAR_HD T ldg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// A table of int64 entries in memory, already offset to the block's row:
// c (A,) and cum (A + 1,).  c(A) reads 0.
struct GlobalTable {
  const long long* c_row;
  const long long* cum_row;
  int a_count;
  PLANAR_HD u64 cum(int a) const { return static_cast<u64>(ldg(cum_row + a)); }
  PLANAR_HD u64 c(int a) const {
    return a < a_count ? static_cast<u64>(ldg(c_row + a)) : 0ull;
  }
};

// Row `b` of a block's symbols, each read at its own width (u8, u16 bits,
// i32 or i64); an index outside [0, A) reads as A - 1 (the plain version
// raises there; a kernel must not read outside its table).
template <typename Sym>
struct SymbolRow {
  const Sym* row;
  int a_count;
  PLANAR_HD int operator()(int i) const {
    const u64 u = sizeof(Sym) == 8
                      ? static_cast<u64>(ldg(row + i))
                      : static_cast<u64>(static_cast<unsigned>(ldg(row + i)));
    return u < static_cast<u64>(a_count) ? static_cast<int>(u) : a_count - 1;
  }
};

// A block's code bytes: byte p of the row, 0 past its `n` bytes (as
// ops/lookup.code_windows reads them).
struct CodeRow {
  const uint8_t* row;
  long long n;
  PLANAR_HD unsigned operator()(long long p) const {
    return p < n ? static_cast<unsigned>(ldg(row + p)) : 0u;
  }
};

// Appends a block's stream bytes to its output row of `cap` bytes: four
// bytes to one 32-bit store where `words` (the row 4-byte aligned and
// `cap` a multiple of 4), else byte by byte.  Nothing at or past `cap` is
// written; `pos` counts every byte, dropped ones included.  The row must
// come zeroed: a word's bytes past the stream's end are stored as 0.
struct ByteSink {
  uint8_t* row;
  long long cap;
  bool words;
  long long pos;
  unsigned acc;  // the bytes of the current word, little-endian

  PLANAR_HD void store(long long at) {
    if (words) {
      if (at < cap) *reinterpret_cast<unsigned*>(row + at) = acc;
    } else {
      for (int j = 0; j < 4; ++j)
        if (at + j < cap) row[at + j] = static_cast<uint8_t>(acc >> (8 * j));
    }
    acc = 0;
  }

  PLANAR_HD void put(unsigned byte) {
    const int slot = static_cast<int>(pos & 3);
    acc |= byte << (8 * slot);
    if (slot == 3) store(pos - 3);
    ++pos;
  }

  PLANAR_HD void emit(u64 emit_low, int n) {
    for (int j = 0; j < n; ++j) put(emit_byte(emit_low, j));
  }

  PLANAR_HD void finish() {
    if (pos & 3) store(pos & ~3ll);
  }
};

PLANAR_HD ByteSink byte_sink(uint8_t* row, long long cap) {
  const bool words = (reinterpret_cast<uintptr_t>(row) & 3) == 0 &&
                     (cap & 3) == 0;
  return ByteSink{row, cap, words, 0, 0u};
}

// One block's encode: L transitions and the flush into `sink`; total 2^k
// (rpt = range >> k) or, with kDiv, `total` (the exact division).
template <bool kDiv, typename Syms, typename Table>
PLANAR_HD void encode_block(const Syms& syms, int L, const Table& t, int k,
                            u64 total, ByteSink* sink) {
  Coder st = init_coder();
  for (int i = 0; i < L; ++i) {
    const int s = syms(i);
    const u64 rpt = range_per_total<kDiv>(st.rng, k, total);
    u64 emit_low;
    const int n = encode_step(&st, rpt, t.c(s), t.cum(s), &emit_low);
    sink->emit(emit_low, n);
  }
  sink->emit(st.low, kFlushBytes);
  sink->finish();
}

// The symbol of target `rfreq`: #{a < A : cum[a + 1] <= rfreq}, by binary
// search (the upper bound of rfreq in cum[1 .. A]).
template <typename Table>
PLANAR_HD int find_symbol(const Table& t, int a_count, u64 rfreq) {
  int lo = 0, n = a_count;
  while (n > 0) {
    const int half = n >> 1;
    if (t.cum(lo + half + 1) <= rfreq) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// One block's decode of L symbols into `out`: the 64-bit big-endian
// window of bytes [cursor - 8, cursor) in a register, shifted by the n
// bytes each transition consumes; `total` is 2^k without kDiv.
template <bool kDiv, typename Table>
PLANAR_HD void decode_block(const CodeRow& code, int L, const Table& t,
                            int a_count, int k, u64 total, int32_t* out) {
  long long cursor = 0;  // the next byte to shift into the window
  u64 window = 0;
  for (; cursor < kFlushBytes; ++cursor) window = window << 8 | code(cursor);
  Coder st = init_coder();
  for (int i = 0; i < L; ++i) {
    const u64 rpt = range_per_total<kDiv>(st.rng, k, total);
    const int s = find_symbol(t, a_count, decode_rfreq(window, st, rpt, total));
    const int sc = s < a_count ? s : a_count - 1;  // only for invalid tables
    u64 emit_low;
    const int n = encode_step(&st, rpt, t.c(sc), t.cum(sc), &emit_low);
    out[i] = s;
    for (int j = 0; j < n; ++j, ++cursor) window = window << 8 | code(cursor);
  }
}

}  // namespace planar
