// rans16 decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_rans_decode_kernel` of
// range_coder_rust_tpu/kernels/rans_decode.py (wrapper rans_decode_tiled,
// with the in-kernel helpers _lane_prefix_flat, _lookup_rows and
// _select_by of kernels/vreg.py folded in).
//
// What it computes, per group of G lanes: prime each lane's state from
// the preamble; then per step t = 0 .. L-1 and lane,
//   slot = x & 0xFFFF;  s = largest s with cum[s] <= slot;
//   x = c[s] * (x >> 16) + slot - cum[s];
// and every lane with x < 2^32 refills one halfword, read from the
// group's region at cursor + (the lane's exclusive rank among the
// refilling lanes); the cursor then advances by the number of refills.
// The symbols are written lane-major, (group*G + lane, t), in the
// narrowest type of the alphabet (u8, u16 or i32).
//
// What bounds it on the H100: each step needs every lane's refill flag
// before any lane can read its halfword, so the block synchronises on
// every step, and a group is one block.  A 256 MB corpus at L = 32768 is
// 4 groups: 4 blocks on 132 SMs, each running 32768 dependent steps.
//
// What the design does about it: the cum table sits in shared memory and
// the symbol search is a binary search on it (exactly
// searchsorted(cum, slot, 'right') - 1, so leading zero-frequency symbols
// need no repair); the per-step rank is one shuffle scan per warp plus a
// scan of the warp counts, two barriers per step.  Each thread owns G /
// blockDim contiguous lanes in registers, so a 2048-lane group fits one
// 1024-thread block.  The halfword reads are clamped to the group's
// region: a corrupt stream decodes to garbage, never reads past it.
// Filling the card (more, narrower groups, or clusters) is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "rc_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int LPT, typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
rans_decode_kernel(const uint64_t* __restrict__ states,
                   const uint16_t* __restrict__ region,
                   const long long* __restrict__ grp_off,
                   const int32_t* __restrict__ cum_g, OutT* __restrict__ out,
                   long long region_len, int G, long long L, int a_count) {
  __shared__ uint32_t cum[rc::kCumEntries];
  __shared__ int sums[2][33];
  rc::load_cum(cum, cum_g);
  const long long g = blockIdx.x;
  // the group's region, clamped to the buffer whatever the offsets say
  const long long lo_off = min(max(grp_off[g], 0ll), region_len);
  const long long hi_off = min(max(grp_off[g + 1], lo_off), region_len);
  const uint16_t* src = region + lo_off;
  const long long n_hw = hi_off - lo_off;
  const long long lane0 = g * G + static_cast<long long>(threadIdx.x) * LPT;
  uint64_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = states[lane0 + j];
  OutT* o = out + lane0 * L;
  long long cursor = 0;
  for (long long t = 0; t < L; ++t) {
    int cnt = 0;
    unsigned long long need = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t slot = static_cast<uint32_t>(x[j]) & 0xFFFFu;
      int lo = 0, hi = a_count;  // cum[lo] <= slot < cum[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] <= slot) lo = mid; else hi = mid;
      }
      const uint32_t cs = cum[lo];
      const uint32_t c = cum[lo + 1] - cs;
      x[j] = static_cast<uint64_t>(c) * (x[j] >> 16) + (slot - cs);
      o[j * L + t] = static_cast<OutT>(lo);
      const bool r = x[j] < (1ull << 32);
      need |= static_cast<unsigned long long>(r) << j;
      cnt += r;
    }
    int total;
    int rank = rc::block_exclusive_scan<int>(cnt, sums[t & 1], total);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if ((need >> j) & 1ull) {
        const long long p = cursor + rank;
        const uint64_t h = p < n_hw ? src[p] : 0u;
        x[j] = (x[j] << 16) | h;
        ++rank;
      }
    }
    cursor += total;
  }
}

template <typename OutT>
int launch(const uint64_t* states, const uint16_t* region,
           const long long* grp_off, const int32_t* cum, void* out,
           long long region_len, int n_groups, int G, long long L,
           int a_count, cudaStream_t stream) {
  const int threads = G < kMaxThreads ? G : kMaxThreads;
  const int lpt = G / threads;
  OutT* o = static_cast<OutT*>(out);
#define RC_DECODE_CASE(N)                                                   \
  case N:                                                                   \
    rans_decode_kernel<N, OutT><<<n_groups, threads, 0, stream>>>(          \
        states, region, grp_off, cum, o, region_len, G, L, a_count);        \
    break;
  switch (lpt) {
    RC_DECODE_CASE(1)
    RC_DECODE_CASE(2)
    RC_DECODE_CASE(4)
    RC_DECODE_CASE(8)
    RC_DECODE_CASE(16)
    RC_DECODE_CASE(32)
    RC_DECODE_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RC_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states (n_groups*G,) u64 preamble; region (region_len,) u16: the
// groups' halfwords concatenated, group g at [grp_off[g], grp_off[g+1]);
// cum (1024,) int32 padded table; out (n_groups*G, L) of out_bytes (1: u8,
// 2: u16, 4: i32).
extern "C" int rc_rans_decode(const uint64_t* states, const uint16_t* region,
                              long long region_len, const long long* grp_off,
                              const int32_t* cum, void* out, int n_groups,
                              int G, long long L, int a_count, int out_bytes,
                              cudaStream_t stream) {
  if (n_groups < 1 || G < 32 || G % 32 || (G > kMaxThreads && G % kMaxThreads)
      || L < 1 || a_count < 1 || a_count >= rc::kCumEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (out_bytes) {
    case 1:
      return launch<uint8_t>(states, region, grp_off, cum, out, region_len,
                             n_groups, G, L, a_count, stream);
    case 2:
      return launch<uint16_t>(states, region, grp_off, cum, out, region_len,
                              n_groups, G, L, a_count, stream);
    case 4:
      return launch<int32_t>(states, region, grp_off, cum, out, region_len,
                             n_groups, G, L, a_count, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
