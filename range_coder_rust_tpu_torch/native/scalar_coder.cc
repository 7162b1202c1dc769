// Native scalar golden model of the carryless 64-bit range coder.
//
// Independent C++ implementation of the reference semantics
// (reference src/range_coder.rs:53-135, src/encoder.rs:24-46,
// src/decoder.rs:14-54) used for corpus-scale conformance checking against
// the Python golden model and the JAX/Pallas device paths, and as the CPU
// single-core throughput anchor (BASELINE.md: the Rust crate is
// single-threaded; this plays its role since no Rust toolchain exists here).
//
// Exposed as a C ABI for ctypes.  All functions return 0 on success or a
// negative error code.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kTop8 = 1ULL << 56;   // reference src/range_coder.rs:23
constexpr uint64_t kTop16 = 1ULL << 48;  // reference src/range_coder.rs:24

struct Coder {
  uint64_t low = 0;
  uint64_t range = ~0ULL;  // reference src/range_coder.rs:15-18
};

// Advance the interval by one symbol; append settled bytes to `out`.
// Returns the number of bytes emitted.  Mirrors param_update
// (reference src/range_coder.rs:53-92): range/total floor division, interval
// update, then the two renormalization loops in strict order.
inline int ParamUpdate(Coder& rc, uint32_t c, uint32_t cum, uint32_t total,
                       uint8_t* out) {
  const uint64_t rpt = rc.range / total;
  rc.range = rpt * c;
  rc.low += rpt * cum;  // carry cannot escape bit 63 (carryless invariant)

  int n = 0;
  // no-carry expansions: top byte settled while lower^upper < 2^56
  // (reference src/range_coder.rs:110-116)
  while ((rc.low ^ (rc.low + rc.range)) < kTop8) {
    out[n++] = static_cast<uint8_t>(rc.low >> 56);
    rc.low <<= 8;
    rc.range <<= 8;
  }
  // range-reduction expansions: clamp upper to lower | 0x0000FFFF'FFFFFFFF
  // (reference src/range_coder.rs:126-135)
  while (rc.range < kTop16) {
    rc.range = ~rc.low & (kTop16 - 1);
    out[n++] = static_cast<uint8_t>(rc.low >> 56);
    rc.low <<= 8;
    rc.range <<= 8;
  }
  return n;
}

}  // namespace

extern "C" {

// Encode n symbols with a static table (c[k], cum[k] exclusive, total).
// Writes the full stream (including the 8-byte flush,
// reference src/encoder.rs:40-46) to `out`; stores the stream length in
// *out_len.  out must have capacity >= n * 14 + 8.
int rc_encode(const uint32_t* syms, size_t n, const uint32_t* c,
              const uint32_t* cum, uint32_t total, uint8_t* out,
              size_t out_cap, size_t* out_len) {
  if (total == 0) return -2;
  Coder rc;
  size_t pos = 0;
  for (size_t i = 0; i < n; ++i) {
    if (pos + 14 > out_cap) return -3;
    const uint32_t s = syms[i];
    if (c[s] == 0) return -4;  // zero-frequency symbol is undefined
    pos += ParamUpdate(rc, c[s], cum[s], total, out + pos);
  }
  if (pos + 8 > out_cap) return -3;
  for (int i = 0; i < 8; ++i) {  // flush the residual 64-bit lower bound
    out[pos++] = static_cast<uint8_t>(rc.low >> 56);
    rc.low <<= 8;
  }
  *out_len = pos;
  return 0;
}

// Decode n symbols.  K = alphabet size; cum has K entries (exclusive).
// Uses the reference's binary search: largest i with cum[i] <= rfreq,
// probing cum[mid+1] (reference examples/sample_impl.rs:27-45).
int rc_decode(const uint8_t* code, size_t code_len, size_t n,
              const uint32_t* c, const uint32_t* cum, uint32_t K,
              uint32_t total, uint32_t* out_syms) {
  if (total == 0 || K == 0) return -2;
  if (code_len < 8) return -5;  // truncated: cannot prime the window
  Coder rc;
  uint64_t data = 0;
  size_t pos = 0;
  for (int i = 0; i < 8; ++i) data = (data << 8) | code[pos++];

  uint8_t scratch[16];
  for (size_t i = 0; i < n; ++i) {
    const uint64_t rpt = rc.range / total;
    const uint64_t rfreq = (data - rc.low) / rpt;
    uint32_t left = 0, right = K - 1;
    while (left < right) {
      const uint32_t mid = (left + right) / 2;
      if (cum[mid + 1] <= rfreq) {
        left = mid + 1;
      } else {
        right = mid;
      }
    }
    const int nb = ParamUpdate(rc, c[left], cum[left], total, scratch);
    if (pos + nb > code_len) return -5;
    for (int j = 0; j < nb; ++j) data = (data << 8) | code[pos++];
    out_syms[i] = left;
  }
  return 0;
}

// Single-symbol transition for property testing: given (low, range) and
// (c, cum, total), returns new state, emitted byte count, and bytes.
int rc_step(uint64_t* low, uint64_t* range, uint32_t c, uint32_t cum,
            uint32_t total, uint8_t* out_bytes, int* out_n) {
  if (total == 0) return -2;
  Coder rc{*low, *range};
  *out_n = ParamUpdate(rc, c, cum, total, out_bytes);
  *low = rc.low;
  *range = rc.range;
  return 0;
}

}  // extern "C"
