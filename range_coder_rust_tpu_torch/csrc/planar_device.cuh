// What the planar kernels (planar_encode.cu, planar_decode.cu) share on
// the card beside planar_step.cuh: their block size, and a shared table
// staged in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "planar_step.cuh"

namespace planar {

//: coder blocks (one a thread) per CUDA block: 32768 blocks of a
//: 2^24-symbol call make 512 CUDA blocks, about 4 on each of 132 SMs
constexpr int kThreads = 64;
//: a shared table is staged in shared memory while its (A + 1) u32 pairs
//: fit this (A <= 6143); a wider one, and a table per block, is read from
//: device memory through the read-only cache
constexpr int kSmemTableBytes = 48 * 1024;

// The dynamic shared memory of a launch: the staged table's, or 0 where
// the table is read from device memory.
inline size_t smem_table_bytes(int per_block, int a_count) {
  const size_t bytes = (static_cast<size_t>(a_count) + 1) * sizeof(uint2);
  return !per_block && bytes <= kSmemTableBytes ? bytes : 0;
}

// A shared table staged in shared memory: entry a = (cum[a], c[a]) as
// u32, a in [0, A], with c[A] = 0.
struct SmemTable {
  const uint2* t;
  PLANAR_HD u64 cum(int a) const { return t[a].x; }
  PLANAR_HD u64 c(int a) const { return t[a].y; }
};

// Stage a shared (A,) / (A + 1,) int64 table into `smem` as u32 pairs
// (values below 2^32: u32 totals); every thread of the CUDA block calls
// this, before any returns.
__device__ __forceinline__ void stage_table(uint2* smem, const long long* c,
                                            const long long* cum,
                                            int a_count) {
  for (int a = threadIdx.x; a <= a_count; a += blockDim.x)
    smem[a] = make_uint2(static_cast<unsigned>(cum[a]),
                         a < a_count ? static_cast<unsigned>(c[a]) : 0u);
  __syncthreads();
}

// The table of coder block b: the staged one (kSmem), or its rows of the
// device tables (`per_block`: c is (B, A), cum (B, A + 1); else one
// shared (A,) / (A + 1,) pair).
template <bool kSmem>
struct TableFor {
  __device__ static GlobalTable get(const uint2*, const long long* c,
                                    const long long* cum, int a_count,
                                    int per_block, long long b) {
    const long long row = per_block ? b : 0;
    return GlobalTable{c + row * a_count, cum + row * (a_count + 1), a_count};
  }
};

template <>
struct TableFor<true> {
  __device__ static SmemTable get(const uint2* smem, const long long*,
                                  const long long*, int, int, long long) {
    return SmemTable{smem};
  }
};

}  // namespace planar
