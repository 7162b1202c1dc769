// What the planar kernels (planar_encode.cu, planar_decode.cu) share on
// the card beside planar_step.cuh: their CTA size, the tables staged in
// shared memory (the (cum, c) pairs, and the decode's slot table), the
// shared-memory opt-in, and the one decision of where a launch's table
// lies (placement, which each entry point reports to its caller).
//
// scripts_torch/decode_variants.py --kernel planar_decode|planar_encode
// builds the kernels with one design point put back at a time; the normal
// build defines none of these macros:
//   RC_VARIANT_PLANAR_BINARY_SEARCH  the decode searches cum, no slot table
//   RC_VARIANT_PLANAR_DIV64          u64 `/` for the target and raw rpt
//   RC_VARIANT_PLANAR_BYTE_REFILL    the window refilled one byte a load
//   RC_VARIANT_PLANAR_SCALAR_STORES  the decode stores one symbol a store
//   RC_VARIANT_PLANAR_SCALAR_SYMBOLS the encode reads a symbol and its
//                                    table entry in the step, one load each
//   RC_VARIANT_PLANAR_BYTE_WRITER    the encode's per-byte ByteSink
//   RC_VARIANT_PLANAR_DECODE_THREADS=n  decode CTAs of n threads (the
//                                       first design's: 64)
//   RC_VARIANT_PLANAR_ENCODE_THREADS=n  encode CTAs of n threads (the
//                                       first design's: 64)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "planar_step.cuh"

namespace planar {

#ifndef RC_VARIANT_PLANAR_DECODE_THREADS
#define RC_VARIANT_PLANAR_DECODE_THREADS 256
#endif
#ifndef RC_VARIANT_PLANAR_ENCODE_THREADS
#define RC_VARIANT_PLANAR_ENCODE_THREADS 128
#endif
//: coder blocks (one a thread) per decode CTA.  The slot table takes
//: 64 KiB (u8 slots) or 128 KiB (u16) of shared memory a CTA, so an SM
//: holds one to three CTAs; 64-thread CTAs would leave it 64-192 threads.
//: 256 threads make the 32768 blocks of a 2^24-symbol call 128 CTAs, one
//: wave on 132 SMs at 256 threads an SM, the occupancy 64-thread CTAs had
//: without a slot table (about 248), with one table build a CTA
//: (measured on the H100: 64-thread CTAs take 1.8 times as long,
//: 128-thread ones 5 % longer; PERF.md).
constexpr int kDecodeThreads = RC_VARIANT_PLANAR_DECODE_THREADS;
//: coder blocks per encode CTA: its table is a few KB, so the size only
//: sets how the blocks spread; 128 threads (256 CTAs, every SM busy)
//: measured 3 % faster than the decode's 256 on the H100, and no slower
//: than 64 (PERF.md)
constexpr int kEncodeThreads = RC_VARIANT_PLANAR_ENCODE_THREADS;
//: a (cum, c) table without a slot table is staged in shared memory while
//: its (A + 1) u32 pairs fit the default 48 KB (A <= 6143); a wider one,
//: and a table per block, is read from device memory through the
//: read-only cache
constexpr int kSmemTableBytes = 48 * 1024;

// The dynamic shared memory of a launch that stages the (cum, c) pairs
// only: theirs, or 0 where the table is read from device memory.
inline size_t smem_table_bytes(int per_block, int a_count) {
  const size_t bytes = (static_cast<size_t>(a_count) + 1) * sizeof(uint2);
  return !per_block && bytes <= kSmemTableBytes ? bytes : 0;
}

// The bytes of a slot (1 for A <= 256, 2 for A <= 65536; 0: no slot table
// can hold the symbols).
inline int slot_bytes(int a_count) {
  return a_count <= 256 ? 1 : a_count <= 65536 ? 2 : 0;
}

// The shared memory a CTA may opt in to on the current device.
inline cudaError_t max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

//: where a launch finds its table (kernels/planar.py's PLACEMENTS names
//: them in this order): a search of the (cum, c) pairs in device memory,
//: the same search of the pairs staged in shared memory, or the decode's
//: slot table of u8 or u16 slots behind the staged pairs
enum Placement { kGlobal = 0, kSmemPairs = 1, kSlots8 = 2, kSlots16 = 3 };

// The one decision of both planar launchers: the placement of a launch's
// table and the dynamic shared memory it takes.  The decode (`decode`) of
// one shared table of total 2^k (k >= 1) takes a slot table where the
// pairs and the slots fit the device's opt-in; otherwise the pairs are
// staged where they fit the default 48 KB (a shared table of A <= 6143
// symbols), and read from device memory where not.
inline cudaError_t placement(bool decode, int per_block, int a_count, int k,
                             int* where, size_t* smem) {
#if !defined(RC_VARIANT_PLANAR_BINARY_SEARCH)
  const int sb = slot_bytes(a_count);
  if (decode && k > 0 && !per_block && sb) {
    const size_t pairs = (static_cast<size_t>(a_count) + 1) * sizeof(uint2);
    int limit = 0;
    const cudaError_t err = max_smem_optin(&limit);
    if (err != cudaSuccess) return err;
    const size_t with_slots = pairs + (static_cast<size_t>(sb) << k);
    if (with_slots <= static_cast<size_t>(limit)) {
      *where = sb == 1 ? kSlots8 : kSlots16;
      *smem = with_slots;
      return cudaSuccess;
    }
  }
#endif
  *smem = smem_table_bytes(per_block, a_count);
  *where = *smem ? kSmemPairs : kGlobal;
  return cudaSuccess;
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory: above
// the default 48 KB only after the opt-in, which is checked against the
// device's limit (a refused launch would never run).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemTableBytes) return cudaSuccess;
  int limit = 0;
  cudaError_t err = max_smem_optin(&limit);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A shared table staged in shared memory: entry a = (cum[a], c[a]) as
// u32, a in [0, A], with c[A] = 0.
struct SmemTable {
  const uint2* t;
  PLANAR_HD u64 cum(int a) const { return t[a].x; }
  PLANAR_HD u64 c(int a) const { return t[a].y; }
};

// Stage a shared (A,) / (A + 1,) int64 table into `smem` as u32 pairs
// (values below 2^32: u32 totals); every thread of the CTA calls this,
// before any returns.
__device__ __forceinline__ void stage_table(uint2* smem, const long long* c,
                                            const long long* cum,
                                            int a_count) {
  for (int a = threadIdx.x; a <= a_count; a += blockDim.x)
    smem[a] = make_uint2(static_cast<unsigned>(cum[a]),
                         a < a_count ? static_cast<unsigned>(c[a]) : 0u);
  __syncthreads();
}

// Build the slot table of the staged pairs for a total of 2^k, the CTA's
// warps taking the symbols round robin; every thread calls this after
// stage_table, before any returns.  Returns false, and builds nothing,
// where the staged table is not one a slot table can stand for (not
// monotone, or cum[A] != 2^k): the CTA then searches the pairs.
template <typename Slot>
__device__ __forceinline__ bool build_slots(Slot* slots, const uint2* pairs,
                                            int a_count, u64 total) {
  const SmemTable t{pairs};
  const int valid = __syncthreads_and(
      slots_valid(t, a_count, total, threadIdx.x, blockDim.x));
  if (!valid) return false;
  fill_slots(slots, t, a_count, threadIdx.x >> 5, blockDim.x >> 5,
             threadIdx.x & 31, 32);
  __syncthreads();
  return true;
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

// The launch's total as the step takes it: 2^k for k >= 1, else the raw
// u32 `total` (its reciprocal computed here, once a launch).
template <typename Total>
Total total_of(int k, u64 total);

template <>
inline Pow2Total total_of<Pow2Total>(int k, u64) {
  return pow2_total(k);
}

template <>
inline RawTotal total_of<RawTotal>(int, u64 total) {
  return raw_total(total);
}

}  // namespace planar
