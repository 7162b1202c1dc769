// The planar coder on native u64, written once for both planar kernels
// (planar_encode.cu, planar_decode.cu): the per-symbol arithmetic, the
// table reads, the code reader and the output writers, and the whole
// per-block encode and decode loops.  Outside nvcc the functions are
// plain inline C++, so g++ compiles this header too
// (tests/test_torch_planar_step.py holds it to ops/transition.py and to
// the plain versions there; tests/test_torch_planar_fast_step.py holds
// the shipped loops to the first routines below).
//
// Two generations of the loops live here.  The first (encode_block,
// decode_block, ByteSink, CodeRow, SymbolRow, range_per_total,
// decode_rfreq, find_symbol) reads one byte or one symbol at a time and
// divides with u64 `/`; it is the reference the tests hold the second
// to, and scripts_torch/decode_variants.py builds the kernels with one
// of its parts put back at a time (the RC_VARIANT_PLANAR_* macros of
// planar_device.cuh).  The second (encode_block_fast, decode_block_fast)
// is what the kernels run: a multiply-high by a reciprocal for a raw
// total (Divisor), the decoder's quotient from a float or double
// estimate and one exact correction (quotient), the symbol from a slot
// table (fill_slots, SlotFind), the code bytes read ahead 16 at a time
// (CodeReader), four symbols a store (SymbolOut), symbols read 16 bytes
// at a time with each table entry read one step ahead, and a byte writer
// that stores 8 bytes at a time (ByteWriter).
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

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define PLANAR_HD __host__ __device__ __forceinline__
#define PLANAR_UNROLL _Pragma("unroll")
#else
#define PLANAR_HD inline
#define PLANAR_UNROLL
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
  // the lower bound at the reduction loop's last iteration (selected away
  // where the loop did not run); both counts lie in [0, 56]
  const u64 last_low = low1 << (8 * n_ff);
  st->low = low1 << (8 * n2);
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

  PLANAR_HD long long length() const { return pos; }
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

// ----- the shipped loops ---------------------------------------------------

// x >> s for s in [0, 63]; 0 for any other s.
PLANAR_HD u64 shr(u64 x, int s) { return (s >= 0 && s < 64) ? x >> s : 0ull; }

// The high 64 bits of the 128-bit product a * b.
PLANAR_HD u64 mulhi(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return static_cast<u64>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// The bytes of x in the other order.
PLANAR_HD u64 bswap64(u64 x) {
#if defined(__CUDA_ARCH__)
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned hi = static_cast<unsigned>(x >> 32);
  return static_cast<u64>(__byte_perm(lo, 0u, 0x0123)) << 32 |
         __byte_perm(hi, 0u, 0x0123);
#else
  return __builtin_bswap64(x);
#endif
}

// The 16 bytes at p (16-byte aligned) as two little-endian words: one
// 16-byte load through the read-only cache on the card.
PLANAR_HD void load16(const void* p, u64* w0, u64* w1) {
#if defined(__CUDA_ARCH__)
  const ulonglong2 v = __ldg(static_cast<const ulonglong2*>(p));
  *w0 = v.x;
  *w1 = v.y;
#else
  std::memcpy(w0, p, 8);
  std::memcpy(w1, static_cast<const char*>(p) + 8, 8);
#endif
}

// Division by a u32 total fixed for the launch, as one multiply-high:
// with m = floor((2^64 - 1) / t), n * m / 2^64 lies within one of n / t
// (m is floor(2^64 / t), or 2^64 / t - 1 where t divides 2^64), so
// mulhi(n, m) is the quotient or one below it, for every u64 n; one
// compare corrects it.
struct Divisor {
  u64 t;
  u64 m;
};

PLANAR_HD Divisor make_divisor(u64 t) { return Divisor{t, ~0ull / t}; }

PLANAR_HD u64 divide(const Divisor& d, u64 n) {
#if defined(RC_VARIANT_PLANAR_DIV64)
  return n / d.t;
#else
  const u64 q = mulhi(n, d.m);
  return n - q * d.t >= d.t ? q + 1 : q;
#endif
}

// min(d / r, qmax), exactly, for every d and r (r = 0 gives qmax, as
// decode_rfreq's ~0 clamped): an estimate d * (1 / r) in float (kWide
// false, for qmax < 2^16: relative error under 2^-21, so an error under
// 1/32) or double (kWide, for qmax < 2^32: under 2^-50), clamped to qmax
// and so within one of the clamped quotient, then one exact correction
// from the 128-bit product q * r.  On the card the float reciprocal is
// one MUFU.RCP and the double one __drcp_rn; CUDA's u64 `/` is a software
// routine of some 100 instructions.
template <bool kWide>
PLANAR_HD u64 quotient(u64 d, u64 r, u64 qmax) {
#if defined(RC_VARIANT_PLANAR_DIV64)
  const u64 q64 = r ? d / r : ~0ull;
  return q64 < qmax ? q64 : qmax;
#else
  // r = 0 runs as r = 1 (no branch on the chain); qmax is selected below
  const u64 r0 = r;
  r = r ? r : 1;
  u64 q;
  if (kWide) {
#if defined(__CUDA_ARCH__)
    const double e = static_cast<double>(d) * __drcp_rn(static_cast<double>(r));
#else
    const double e = static_cast<double>(d) * (1.0 / static_cast<double>(r));
#endif
    q = e < static_cast<double>(qmax) ? static_cast<u64>(e) : qmax;
  } else {
    const float rf = static_cast<float>(r);
#if defined(__CUDA_ARCH__)
    float inv;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(rf));
#else
    float inv = 1.0f / rf;
#if defined(PLANAR_HOST_RCP_ULPS)  // the card's rcp.approx: within one ulp
    inv = std::nextafter(inv, PLANAR_HOST_RCP_ULPS > 0 ? 1e30f : 0.0f);
#endif
#endif
    const float e = static_cast<float>(d) * inv;
    q = e < static_cast<float>(qmax) ? static_cast<u64>(e) : qmax;
  }
  const u64 lo = q * r;
  if (mulhi(q, r) != 0 || lo > d) q -= 1;
  else if (d - lo >= r && q < qmax) q += 1;
  return r0 ? q : qmax;
#endif
}

//: the largest k of a total of 2^k: rpt = range >> k stays at 2^24 or more
//: under the coder's invariant range >= 2^48, and every table sum is a u32
constexpr int kMaxK = 24;
//: the largest k whose target takes the float quotient (its error stays
//: under 1/32 for qmax < 2^16); 2^k totals above it take the double one
constexpr int kFloatMaxK = 16;

//: the form of a launch's total (kernels/planar.py's TOTAL_FORMS names
//: them in this order): 2^k with the float quotient, 2^k with the double
//: quotient, or a raw u32 total
enum TotalForm { kPow2 = 0, kPow2Wide = 1, kRaw = 2 };

// The one rule of both planar launchers (k = 0: a raw total).
PLANAR_HD int total_form(int k) {
  return k == 0 ? kRaw : k <= kFloatMaxK ? kPow2 : kPow2Wide;
}

// The launch's total: 2^k for k <= 16 (rpt = range >> k; the float
// quotient), 2^k for k in [17, 24] (the same rpt; the double quotient: at
// k 24 the float estimate can miss by 4, past the one correction), or a
// raw u32 total (rpt by the Divisor; the double quotient).
// qmax = total - 1.
struct Pow2Total {
  static constexpr bool kWide = false;
  int k;
  u64 qmax;
  PLANAR_HD u64 rpt(u64 rng) const { return rng >> k; }
};

struct Pow2WideTotal {
  static constexpr bool kWide = true;
  int k;
  u64 qmax;
  PLANAR_HD u64 rpt(u64 rng) const { return rng >> k; }
};

struct RawTotal {
  static constexpr bool kWide = true;
  Divisor div;
  u64 qmax;
  PLANAR_HD u64 rpt(u64 rng) const { return divide(div, rng); }
};

PLANAR_HD Pow2Total pow2_total(int k) {
  return Pow2Total{k, (1ull << k) - 1};
}

PLANAR_HD Pow2WideTotal pow2_wide_total(int k) {
  return Pow2WideTotal{k, (1ull << k) - 1};
}

PLANAR_HD RawTotal raw_total(u64 total) {
  return RawTotal{make_divisor(total), total - 1};
}

// The slot -> symbol table of a total of 2^k: slots[j] = a for every j in
// [cum(a), cum(a + 1)), filled by symbol ranges (a symbol of frequency 0
// owns no slot).  The symbols a0, a0 + a_step, ... are filled, each by
// `lanes` lanes of which this is `lane` (on the card: the CTA's warps take
// the symbols round robin, a warp's lanes a symbol's slots).  The table
// must be monotone with cum(A) = 2^k (slots_valid); then slots[rfreq] is
// find_symbol's answer for every rfreq < 2^k.
template <typename Slot, typename Table>
PLANAR_HD void fill_slots(Slot* slots, const Table& t, int a_count, int a0,
                          int a_step, int lane, int lanes) {
  for (int a = a0; a < a_count; a += a_step) {
    const u64 hi = t.cum(a + 1);
    for (u64 j = t.cum(a) + lane; j < hi; j += lanes)
      slots[j] = static_cast<Slot>(a);
  }
}

// Whether the symbols a0, a0 + a_step, ... keep cum monotone, and, for
// a0 = 0, whether cum(0) = 0 and cum(A) = total: the table a slot table
// may stand for.
template <typename Table>
PLANAR_HD bool slots_valid(const Table& t, int a_count, u64 total, int a0,
                           int a_step) {
  bool ok = a0 != 0 || (t.cum(0) == 0 && t.cum(a_count) == total);
  for (int a = a0; a < a_count; a += a_step) ok &= t.cum(a) <= t.cum(a + 1);
  return ok;
}

// The symbol of a target from the slot table (one load) or by
// find_symbol's binary search.
template <typename Slot>
struct SlotFind {
  const Slot* slots;
  PLANAR_HD int operator()(u64 rfreq) const {
    return static_cast<int>(slots[rfreq]);
  }
};

template <typename Table>
struct SearchFind {
  Table t;
  int a_count;
  PLANAR_HD int operator()(u64 rfreq) const {
    return find_symbol(t, a_count, rfreq);
  }
};

// A block's code bytes read ahead in registers, for the decoder's 64-bit
// big-endian window of bytes [cursor - 8, cursor) (bytes past the block's
// `len` read 0, as CodeRow's).  The block starts at any byte: the reader
// loads the aligned 16-byte chunks around it.  In chunk coordinates
// (P = the block's byte + skew, skew = the start's offset in its chunk),
// w0..w3 hold chunks j0 and j0 + 1 big-endian, the window is their 8
// bytes from offset o in [0, 24], and chunk j0 + 2 is already loading
// into pend.  A transition's n <= 14 bytes move o; past 24 the words move
// down by a chunk, pend fills w2, w3 and the next chunk's load goes out,
// so no load waits on the step that needs its bytes.  A chunk is loaded
// only when it holds a byte of the block, so no load leaves the pages of
// the buffer.
struct CodeReader {
  const uint8_t* chunk0;  // chunk 0's address (16-byte aligned)
  long long end;          // P of the block's end (0 for an empty block)
  long long j0;           // the chunk in w0, w1
  int o;
  u64 w0, w1, w2, w3;
  u64 pend_lo, pend_hi;  // chunk j0 + 2 as loaded (little-endian words)

  PLANAR_HD void fetch(long long j, u64* lo, u64* hi) const {
    *lo = 0;
    *hi = 0;
    if (16 * j < end) load16(chunk0 + 16 * j, lo, hi);
  }

  // chunk j (little-endian words lo, hi) big-endian, bytes past the block
  // zeroed
  PLANAR_HD void settle(long long j, u64 lo, u64 hi, u64* be0,
                        u64* be1) const {
    const long long v = end - 16 * j;  // the block's bytes in the chunk
    const int v0 = v >= 8 ? 8 : v <= 0 ? 0 : static_cast<int>(v);
    const int v1 = v >= 16 ? 8 : v <= 8 ? 0 : static_cast<int>(v - 8);
    *be0 = bswap64(lo) & ~shr(~0ull, 8 * v0);
    *be1 = bswap64(hi) & ~shr(~0ull, 8 * v1);
  }

  PLANAR_HD u64 window() const {
    const int q = o >> 3;
    const int r = (o & 7) * 8;
    const u64 hi = q < 2 ? (q ? w1 : w0) : (q == 2 ? w2 : w3);
    const u64 lo = q < 2 ? (q ? w2 : w1) : w3;  // q = 3 only with r = 0
    return hi << r | (lo >> 1) >> (63 - r);
  }

  PLANAR_HD void advance(int n) {
    o += n;
    if (o > 24) {
      w0 = w2;
      w1 = w3;
      settle(j0 + 2, pend_lo, pend_hi, &w2, &w3);
      ++j0;
      o -= 16;
      fetch(j0 + 2, &pend_lo, &pend_hi);
    }
  }
};

// The reader of the `len` bytes at `start`, its window on the block's
// first 8 bytes.
PLANAR_HD CodeReader code_reader(const uint8_t* start, long long len) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(start);
  const int skew = static_cast<int>(at & 15);
  CodeReader r;
  r.chunk0 = start - skew;
  r.end = len > 0 ? skew + len : 0;
  r.j0 = 0;
  r.o = skew;
  u64 lo, hi;
  r.fetch(0, &lo, &hi);
  r.settle(0, lo, hi, &r.w0, &r.w1);
  r.fetch(1, &lo, &hi);
  r.settle(1, lo, hi, &r.w2, &r.w3);
  r.fetch(2, &r.pend_lo, &r.pend_hi);
  return r;
}

// The first generation's window: one byte load a consumed byte (CodeRow),
// behind the CodeReader's interface (RC_VARIANT_PLANAR_BYTE_REFILL).
struct ByteReader {
  CodeRow code;
  long long cursor;
  u64 win;
  PLANAR_HD u64 window() const { return win; }
  PLANAR_HD void advance(int n) {
    for (int j = 0; j < n; ++j, ++cursor) win = win << 8 | code(cursor);
  }
};

PLANAR_HD ByteReader byte_reader(const uint8_t* start, long long len) {
  ByteReader r{CodeRow{start, len}, 0, 0};
  r.advance(kFlushBytes);
  return r;
}

// Four decoded symbols as one 16-byte store (p 16-byte aligned).
PLANAR_HD void store4(int32_t* p, int s0, int s1, int s2, int s3) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(p) = make_int4(s0, s1, s2, s3);
#else
  const int32_t v[4] = {s0, s1, s2, s3};
  std::memcpy(p, v, sizeof v);
#endif
}

// One block's decoder (the shipped loop): each step the target by
// `quotient`, the symbol by `find`, then the encoder's own transition,
// whose byte count moves the reader.
template <typename Total, typename Find, typename Table, typename Reader>
struct BlockDecoder {
  Reader* code;
  const Table& t;
  int a_count;
  const Total& tot;
  const Find& find;
  Coder st;

  PLANAR_HD int step() {
    const u64 rpt = tot.rpt(st.rng);
    const int s = find(quotient<Total::kWide>(code->window() - st.low, rpt,
                                              tot.qmax));
    const int sc = s < a_count ? s : a_count - 1;  // only for invalid tables
    u64 emit_low;
    code->advance(encode_step(&st, rpt, t.c(sc), t.cum(sc), &emit_low));
    return s;
  }
};

// One block's decode of L symbols into `out`: four a store where `vec`.
template <typename Total, typename Find, typename Table, typename Reader>
PLANAR_HD void decode_block_fast(Reader* code, int L, const Table& t,
                                 int a_count, const Total& tot,
                                 const Find& find, int32_t* out, bool vec) {
  BlockDecoder<Total, Find, Table, Reader> d{code,  t,    a_count,
                                             tot,   find, init_coder()};
  int i = 0;
  if (vec) {
    for (; i + 4 <= L; i += 4) {
      const int s0 = d.step();
      const int s1 = d.step();
      const int s2 = d.step();
      const int s3 = d.step();
      store4(out + i, s0, s1, s2, s3);
    }
  }
  for (; i < L; ++i) out[i] = d.step();
}

// Appends a block's stream bytes to its output row of `cap` bytes, eight
// at a time: a transition's bytes (the top n of emit_low, zeros past the
// eighth) go into a 128-bit little-endian accumulator by funnel shifts,
// and each full 8 bytes go out as one 8-byte store (two 4-byte ones where
// the row is only 4-byte aligned); no loop over a transition's bytes.
// ByteSink's contract: nothing at or past `cap` is written (the store at
// the cut goes byte by byte), the length counts every byte, and the row
// must come zeroed (a word's bytes past the stream's end are stored as 0).
struct ByteWriter {
  uint8_t* row;
  long long cap;
  int align;       // 8, 4 or 1: the row's alignment
  long long done;  // bytes stored (a multiple of 8)
  int fill;        // bytes in the accumulator, below 8 between transitions
  u64 a0, a1;      // the accumulator: a0 holds bytes [done, done + 8)

  PLANAR_HD void store(u64 word) {
    uint8_t* p = row + done;
    if (done + 8 <= cap && align == 8) {
      *reinterpret_cast<u64*>(p) = word;
    } else if (done + 8 <= cap && align == 4) {
      reinterpret_cast<unsigned*>(p)[0] = static_cast<unsigned>(word);
      reinterpret_cast<unsigned*>(p)[1] = static_cast<unsigned>(word >> 32);
    } else {
      for (int j = 0; j < 8; ++j)
        if (done + j < cap) p[j] = static_cast<uint8_t>(word >> (8 * j));
    }
  }

  // one full word out, the accumulator down by 8 bytes
  PLANAR_HD void spill() {
    store(a0);
    done += 8;
    fill -= 8;
    a0 = a1;
    a1 = 0;
  }

  PLANAR_HD void emit(u64 emit_low, int n) {
    const int m = n < 8 ? n : 8;
    const u64 x = bswap64(emit_low) & ~shl(~0ull, 8 * m);
    const int sh = 8 * fill;  // below 64
    a0 |= x << sh;
    a1 |= (x >> 1) >> (63 - sh);
    fill += n;  // at most 7 + 14
    if (fill >= 8) spill();
    if (fill >= 8) spill();
  }

  PLANAR_HD void finish() {
    if (fill > 0) store(a0);
  }

  PLANAR_HD long long length() const { return done + fill; }
};

PLANAR_HD ByteWriter byte_writer(uint8_t* row, long long cap) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(row);
  const int align = (at & 7) == 0 ? 8 : (at & 3) == 0 ? 4 : 1;
  return ByteWriter{row, cap, align, 0, 0, 0ull, 0ull};
}

// Symbol i of a 16-byte chunk (two little-endian words) of Sym values, as
// SymbolRow reads it: an index outside [0, A) reads as A - 1.
template <typename Sym>
PLANAR_HD int chunk_symbol(u64 lo, u64 hi, int i, int a_count) {
  constexpr int kBits = 8 * sizeof(Sym);
  constexpr int kPer = 64 / kBits;  // values a word
  const u64 w = i < kPer ? lo : hi;
  const int sh = (i % kPer) * kBits;
  const u64 u = kBits == 64 ? w : (w >> sh) & ((1ull << (kBits & 63)) - 1);
  return u < static_cast<u64>(a_count) ? static_cast<int>(u) : a_count - 1;
}

// One block's encode (the shipped loop): L transitions and the flush into
// `sink`.  The symbols come 16 bytes at a time where `vec` (the row
// 16-byte aligned and L * sizeof(Sym) a multiple of 16), the next chunk's
// load a chunk ahead, else one scalar load a step; either way the next
// symbol's table entry is read one step ahead, so the state's chain is
// only rpt, the interval and the renormalisation.
template <typename Sym, typename Total, typename Table, typename Sink>
PLANAR_HD void encode_block_fast(const Sym* row, int L, int a_count,
                                 const Table& t, const Total& tot, Sink* sink,
                                 bool vec) {
  Coder st = init_coder();
  u64 emit_low;
  if (vec) {
    constexpr int kPer = 16 / sizeof(Sym);
    u64 lo = 0, hi = 0, nlo = 0, nhi = 0;
    if (L > 0) load16(row, &lo, &hi);
    int s = chunk_symbol<Sym>(lo, hi, 0, a_count);
    u64 c = t.c(s), cum = t.cum(s);
    for (int base = 0; base < L; base += kPer) {
      nlo = 0;
      nhi = 0;
      if (base + kPer < L) load16(row + base + kPer, &nlo, &nhi);
      PLANAR_UNROLL
      for (int j = 0; j < kPer; ++j) {
        const int sn = j + 1 < kPer ? chunk_symbol<Sym>(lo, hi, j + 1, a_count)
                                    : chunk_symbol<Sym>(nlo, nhi, 0, a_count);
        const u64 cn = t.c(sn), cumn = t.cum(sn);
        const int n = encode_step(&st, tot.rpt(st.rng), c, cum, &emit_low);
        sink->emit(emit_low, n);
        c = cn;
        cum = cumn;
      }
      lo = nlo;
      hi = nhi;
    }
  } else {
    const SymbolRow<Sym> syms{row, a_count};
    int s = L > 0 ? syms(0) : 0;
    u64 c = t.c(s), cum = t.cum(s);
    for (int i = 0; i < L; ++i) {
      const int sn = i + 1 < L ? syms(i + 1) : 0;
      const u64 cn = t.c(sn), cumn = t.cum(sn);
      const int n = encode_step(&st, tot.rpt(st.rng), c, cum, &emit_low);
      sink->emit(emit_low, n);
      c = cn;
      cum = cumn;
    }
  }
  sink->emit(st.low, kFlushBytes);
  sink->finish();
}

// The first generation's symbol reads behind the shipped loop's totals and
// sinks: the symbol and its table entry read in the step, one scalar load
// each (RC_VARIANT_PLANAR_SCALAR_SYMBOLS).
template <typename Syms, typename Table, typename Total, typename Sink>
PLANAR_HD void encode_block_scalar(const Syms& syms, int L, const Table& t,
                                   const Total& tot, Sink* sink) {
  Coder st = init_coder();
  u64 emit_low;
  for (int i = 0; i < L; ++i) {
    const int s = syms(i);
    const int n = encode_step(&st, tot.rpt(st.rng), t.c(s), t.cum(s),
                              &emit_low);
    sink->emit(emit_low, n);
  }
  sink->emit(st.low, kFlushBytes);
  sink->finish();
}

}  // namespace planar
