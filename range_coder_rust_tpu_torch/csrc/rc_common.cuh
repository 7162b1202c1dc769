// Shared device helpers for the rans16 kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rc {

//: entries of the padded cum table (kernels/vreg.py prep_cum_vreg)
constexpr int kCumEntries = 1024;

// Second stage of the block scans below: lane 31 of each warp holds the
// warp's total in `warp_total`; scan those totals across the block and
// return the thread's block-exclusive prefix, given its warp-exclusive
// prefix `in_warp`.  blockDim.x must be a multiple of 32 and at most 1024.
// `sums` is 33 words of shared memory; the caller alternates two such
// buffers between consecutive calls, so that a call's writes never race
// with the previous call's reads (each call has two barriers).  `total`
// receives the block-wide sum.
template <typename T>
__device__ __forceinline__ T finish_block_scan(T warp_total, T in_warp,
                                               T* sums, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 31) sums[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nwarps ? sums[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += n;
    }
    sums[lane] = wi - w;           // exclusive offset of each warp
    if (lane == 31) sums[32] = wi;  // block total
  }
  __syncthreads();
  total = sums[32];
  return sums[warp] + in_warp;
}

// Block-wide exclusive prefix sum of one value per thread, in thread
// order: a shuffle scan per warp, then finish_block_scan (same rules).
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* sums, T& total) {
  const int lane = threadIdx.x & 31;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  return finish_block_scan<T>(incl, incl - v, sums, total);
}

// Block-wide exclusive rank of a 0/1 flag per thread, in thread order:
// warp ballot and popcount, then finish_block_scan (same rules).
__device__ __forceinline__ int block_flag_rank(bool f, int* sums, int& total) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, f);
  return finish_block_scan<int>(__popc(ballot),
                                __popc(ballot & ((1u << lane) - 1u)), sums,
                                total);
}

// Stage the padded cum table in shared memory (all threads call this).
__device__ __forceinline__ void load_cum(uint32_t* cum, const int32_t* cum_g) {
  for (int i = threadIdx.x; i < kCumEntries; i += blockDim.x)
    cum[i] = static_cast<uint32_t>(cum_g[i]);
  __syncthreads();
}

}  // namespace rc
