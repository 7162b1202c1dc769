// rans16 encode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_rans_encode_kernel` of
// range_coder_rust_tpu/kernels/rans_encode.py (wrapper rans_encode_tiled,
// with the in-kernel helpers _lane_prefix_flat of kernels/vreg.py and
// compact_flat_tile of kernels/compact_flat.py folded in).
//
// What it computes, per group of G lanes with L symbols each (lane-major
// rows, lane l of group g = row g*G + l):
//   * the backward rANS16 chain per lane, state x in [2^32, 2^48): at each
//     step t = L-1 .. 0, emit x & 0xFFFF and x >>= 16 when x >> 32 >= c;
//     then q, r = divmod(x, c) and x = (q << 16) | (cum + r);
//   * the final states (the container preamble), one u64 per lane;
//   * per-tile region sizes in time order (tile = `tile` steps);
//   * every group's region, the emitted halfwords in (step ascending,
//     lane ascending) order, concatenated over groups.
//
// What bounds it on the H100: the chain is one serial dependency per lane
// (a 64-bit division on every step), and there is one thread per lane, so
// a 256 MB corpus at L = 32768 runs 8192 threads: about two warps per SM
// of the 132.  The step loop is latency bound, not bandwidth bound.
//
// What the design does about it: the chain runs with nothing else on its
// critical path.  It parks `h | emit << 16` for each (step, lane) in device
// memory (coalesced, step-major) and adds its per-tile emission counts with
// one atomic per warp and tile.  A single-block scan turns the sizes into
// region offsets, and a block per (group, tile) then ranks the parked
// flags with warp ballots and a block scan and scatters each halfword to
// its place: no sequential step loop outside the chain.  The 64-bit
// division is exact (x < 2^48) and needs no Barrett constants.
#include <cstdint>
#include <cuda_runtime.h>

#include "rc_common.cuh"

namespace {

constexpr int kChainThreads = 128;  // divides every group width (>= 128)
constexpr int kBlock = 1024;

__global__ void __launch_bounds__(kChainThreads)
rans_encode_chain(const int32_t* __restrict__ sym,
                  const int32_t* __restrict__ cum_g,
                  uint64_t* __restrict__ states, int32_t* __restrict__ sizes,
                  uint32_t* __restrict__ park, int G, int L, int tile) {
  __shared__ uint32_t cum[rc::kCumEntries];
  rc::load_cum(cum, cum_g);
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long g = lane / G;
  const int l = static_cast<int>(lane - g * G);
  const int nt = L / tile;
  const int32_t* row = sym + lane * L;
  // park[(g, t, l)], step-major within the group: region order
  uint32_t* pk = park + g * static_cast<long long>(L) * G + l;
  int32_t* sz = sizes + g * nt;
  uint64_t x = 1ull << 32;
  int count = 0;
  for (int t = L - 1; t >= 0; --t) {
    // symbols must lie in the alphabet; one outside it codes garbage but
    // never indexes past the table
    const int s = min(max(row[t], 0), rc::kCumEntries - 2);
    const uint32_t cs = cum[s];
    const uint32_t c = cum[s + 1] - cs;
    const bool emit = static_cast<uint32_t>(x >> 32) >= c;
    const uint32_t h = static_cast<uint32_t>(x) & 0xFFFFu;
    if (emit) x >>= 16;
    const uint64_t q = x / c;
    const uint32_t r = static_cast<uint32_t>(x - q * c);
    x = (q << 16) | static_cast<uint64_t>(cs + r);
    pk[static_cast<long long>(t) * G] = h | (static_cast<uint32_t>(emit) << 16);
    count += emit;
    if (t % tile == 0) {  // uniform across the warp: same t, same group
      int w = count;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
      if ((threadIdx.x & 31) == 0 && w) atomicAdd(&sz[t / tile], w);
      count = 0;
    }
  }
  states[lane] = x;
}

// Exclusive prefix of the (group, tile) sizes in flat order -> region
// offsets; offs[n] is the total.  One block.
__global__ void __launch_bounds__(kBlock)
rans_encode_offsets(const int32_t* __restrict__ sizes,
                    long long* __restrict__ offs, long long n) {
  __shared__ long long sums[2][33];
  long long carry = 0;
  int k = 0;
  for (long long i0 = 0; i0 < n; i0 += blockDim.x, ++k) {
    const long long i = i0 + threadIdx.x;
    const long long v = i < n ? sizes[i] : 0;
    long long total;
    const long long excl = rc::block_exclusive_scan<long long>(
        v, sums[k & 1], total);
    if (i < n) offs[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) offs[n] = carry;
}

// One block per (group, tile): compact the tile's parked emissions into
// the region at the tile's offset, in (step, lane) order.
__global__ void __launch_bounds__(kBlock)
rans_encode_compact(const uint32_t* __restrict__ park,
                    const long long* __restrict__ offs,
                    uint16_t* __restrict__ region, int G, int L, int tile) {
  __shared__ int sums[2][33];
  const long long b = blockIdx.x;  // flat (group, tile) index
  const int nt = L / tile;
  const long long g = b / nt;
  const int ti = static_cast<int>(b - g * nt);
  const uint32_t* src =
      park + (g * L + static_cast<long long>(ti) * tile) * G;
  const int n = tile * G;
  long long cursor = offs[b];
  int k = 0;
  for (int i0 = 0; i0 < n; i0 += blockDim.x, ++k) {
    const int i = i0 + threadIdx.x;
    const uint32_t v = i < n ? src[i] : 0u;
    const bool f = (v >> 16) != 0u;
    int total;
    const int rank = rc::block_flag_rank(f, sums[k & 1], total);
    if (f) region[cursor + rank] = static_cast<uint16_t>(v);
    cursor += total;
  }
}

}  // namespace

extern "C" const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sym (n_groups*G, L) int32 lane-major; cum (1024,) int32 padded table;
// out: states (n_groups*G,) u64, sizes (n_groups, L/tile) int32 time
// order, offs (n_groups*L/tile + 1,) int64 region offsets, park
// (n_groups*G*L,) u32 scratch, region (n_groups*G*L,) u16 capacity.
extern "C" int rc_rans_encode(const int32_t* sym, const int32_t* cum,
                              uint64_t* states, int32_t* sizes,
                              long long* offs, uint32_t* park,
                              uint16_t* region, int n_groups, int G, int L,
                              int tile, cudaStream_t stream) {
  if (n_groups < 1 || G < kChainThreads || G % kChainThreads || L < 1 ||
      tile < 1 || L % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = static_cast<long long>(n_groups) * (L / tile);
  cudaError_t err = cudaMemsetAsync(sizes, 0, n_tiles * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes = static_cast<long long>(n_groups) * G;
  rans_encode_chain<<<static_cast<unsigned>(lanes / kChainThreads),
                      kChainThreads, 0, stream>>>(sym, cum, states, sizes,
                                                  park, G, L, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rans_encode_offsets<<<1, kBlock, 0, stream>>>(sizes, offs, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rans_encode_compact<<<static_cast<unsigned>(n_tiles), kBlock, 0, stream>>>(
      park, offs, region, G, L, tile);
  return static_cast<int>(cudaGetLastError());
}
