// Order-0 histogram for Hopper (sm_90a): the counts of the planar
// encode's shared table, taken over the symbols already on the card.
//
// Replaces no Pallas kernel: the reference takes this histogram with
// np.bincount on the host (range_coder_rust_tpu/api.py), and so did the
// port until it uploaded the input before the table.  np.bincount widens
// every symbol to intp first (2 GiB of int64 for 256 MiB of bytes); here
// the symbols are counted where the encode reads them, at their own width.
//
// What it computes: counts[s] = the number of symbols equal to s among
// the n symbols of `sym` (u8, u16 bits or i32; a symbol outside
// [0, a_count) is not counted), as u64, exact in any order of the adds.
//
// What bounds it on the H100: the adds, not the bytes.  256 MiB of bytes
// read once take 0.08 ms at 3.35 TB/s; each symbol is one atomic add to
// shared memory, and a Zipf(1.2) byte corpus sends a quarter of them to
// one bin, so adds to one address from many threads serialise.  The
// design (rc_planar_histogram chooses the path from the alphabet, the
// width and the device's opt-in shared memory, planar_histogram_path.cuh,
// and reports it):
// * the input read 16 bytes a thread a load (16 u8, 8 u16 or 4 i32
//   symbols), the unaligned head and tail symbol by symbol;
// * warp_private (at most 256 bins): one u32 copy of the bins for each
//   warp of the CTA in shared memory, so a hot bin is contended only
//   within a warp;
// * block_smem (bins that fit the opt-in shared memory: up to 58112 on
//   the H100): one u32 copy a CTA, one CTA a SM (GPT-2's 50257 tokens
//   take 201 KB);
// * global: u64 atomics straight to the totals, for wider alphabets;
// * the totals: each CTA adds its non-zero bins to the u64 totals with
//   one atomic each.  A CTA counts about 2^31 symbols at most (the grid
//   grows with n), so its u32 copies cannot wrap.
#include <cstdint>
#include <cuda_runtime.h>

#include "planar_device.cuh"
#include "planar_histogram_path.cuh"

namespace {

using planar_histogram::kBlockSmem;
using planar_histogram::kGlobalBins;
using planar_histogram::kWarpBins;
using planar_histogram::kWarpPrivate;

constexpr int kThreads = 1024;
//: the most symbols one CTA counts, so that its u32 copies cannot wrap
constexpr long long kCtaSymbols = 1ll << 31;

template <typename Sym>
__device__ __forceinline__ unsigned value_of(Sym s) {
  // u16 symbols arrive as int16 bits; a negative i32 reads as >= 2^31,
  // outside every alphabet
  return static_cast<unsigned>(s) &
         (sizeof(Sym) == 1 ? 0xFFu : sizeof(Sym) == 2 ? 0xFFFFu : ~0u);
}

template <int kPath>
struct Bins {
  unsigned* copy;                 // this thread's copy in shared memory
  unsigned long long* totals;     // the u64 totals (the global path)
  unsigned bins;
  __device__ __forceinline__ void add(unsigned s) const {
    if (s >= bins) return;
    if (kPath == kGlobalBins)
      atomicAdd(totals + s, 1ull);
    else
      atomicAdd(copy + s, 1u);
  }
};

// Every symbol of one 16-byte load.
template <typename Sym, int kPath>
__device__ __forceinline__ void add_vector(const uint4& v,
                                           const Bins<kPath>& b) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  constexpr int kPerWord = 4 / sizeof(Sym);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPerWord; ++j)
      b.add(value_of<Sym>(static_cast<Sym>(w[i] >> (8 * sizeof(Sym) * j))));
}

// `head` symbols before the first 16-byte boundary, then 16-byte loads,
// then the tail; counted into shared copies (their totals added once a
// CTA) or straight into the totals.
template <typename Sym, int kPath>
__global__ void __launch_bounds__(kThreads)
    planar_histogram_kernel(const Sym* __restrict__ sym, long long n,
                            int head, unsigned bins,
                            unsigned long long* __restrict__ totals) {
  extern __shared__ unsigned copies[];
  const unsigned stride = kPath == kWarpPrivate ? kWarpBins : bins;
  const unsigned n_copies = kPath == kWarpPrivate ? blockDim.x / 32 : 1;
  if constexpr (kPath != kGlobalBins) {
    for (unsigned i = threadIdx.x; i < n_copies * stride; i += blockDim.x)
      copies[i] = 0;
    __syncthreads();
  }
  const Bins<kPath> b{
      copies + (kPath == kWarpPrivate ? (threadIdx.x / 32) * kWarpBins : 0),
      totals, bins};

  constexpr int kPerVector = 16 / sizeof(Sym);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n_vectors = (n - head) / kPerVector;
  const uint4* vectors = reinterpret_cast<const uint4*>(sym + head);
  for (long long i = tid; i < n_vectors; i += threads)
    add_vector<Sym, kPath>(__ldcs(vectors + i), b);
  const long long tail = head + n_vectors * kPerVector;
  if (tid < head) b.add(value_of<Sym>(sym[tid]));
  if (tid < n - tail) b.add(value_of<Sym>(sym[tail + tid]));
  if constexpr (kPath != kGlobalBins) {
    __syncthreads();
    for (unsigned s = threadIdx.x; s < bins; s += blockDim.x) {
      unsigned long long t = 0;
      for (unsigned c = 0; c < n_copies; ++c) t += copies[c * stride + s];
      if (t) atomicAdd(totals + s, t);
    }
  }
}

template <typename Sym, int kPath>
cudaError_t launch(const Sym* sym, long long n, unsigned bins,
                   unsigned long long* totals, cudaStream_t stream) {
  const size_t smem =
      kPath == kWarpPrivate ? (kThreads / 32) * kWarpBins * sizeof(unsigned)
      : kPath == kBlockSmem ? bins * sizeof(unsigned)
                            : 0;
  const auto kernel = planar_histogram_kernel<Sym, kPath>;
  cudaError_t err = planar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(sym) & 15;
  const long long head_max = misaligned ? (16 - misaligned) / sizeof(Sym) : 0;
  const int head = static_cast<int>(n < head_max ? n : head_max);
  // one wave of CTAs, fewer for a short input (each flushes its bins),
  // more where a CTA would count 2^31 symbols or more
  const long long per_cta = static_cast<long long>(kThreads) * 16 /
                            static_cast<long long>(sizeof(Sym));
  long long grid = (n + per_cta - 1) / per_cta;
  const long long wave = static_cast<long long>(sms) * per_sm;
  if (grid > wave) grid = wave;
  if (grid < (n + kCtaSymbols - 1) / kCtaSymbols)
    grid = (n + kCtaSymbols - 1) / kCtaSymbols;
  if (grid < 1) grid = 1;
  planar_histogram_kernel<Sym, kPath>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(sym, n, head,
                                                                bins, totals);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_path(const void* sym, long long n, unsigned bins, int path,
                        unsigned long long* totals, cudaStream_t stream) {
  const Sym* s = static_cast<const Sym*>(sym);
  switch (path) {
    case kWarpPrivate:
      return launch<Sym, kWarpPrivate>(s, n, bins, totals, stream);
    case kBlockSmem:
      return launch<Sym, kBlockSmem>(s, n, bins, totals, stream);
    case kGlobalBins:
      return launch<Sym, kGlobalBins>(s, n, bins, totals, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Count the `n` symbols at `sym` (`sym_bytes` 1: u8, 2: u16 bits, 4: i32)
// into the (a_count,) u64 `totals`, which are zeroed here first, on the
// path planar_histogram::path_of picks for the device (reported through
// `path`: kWarpPrivate, kBlockSmem or kGlobalBins).  Returns the
// cudaError_t of the memset and the launch.
extern "C" int rc_planar_histogram(const void* sym, int sym_bytes, long long n,
                                   int a_count, unsigned long long* totals,
                                   cudaStream_t stream, int* path) {
  if (n < 0 || a_count < 1 ||
      (sym_bytes != 1 && sym_bytes != 2 && sym_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  cudaError_t err = planar::max_smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int where = planar_histogram::path_of(a_count, sym_bytes, optin);
  const size_t bytes = static_cast<size_t>(a_count) * sizeof(*totals);
  err = cudaMemsetAsync(totals, 0, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bins = planar_histogram::bins_of(a_count, sym_bytes);
  switch (sym_bytes) {
    case 1:
      err = launch_path<uint8_t>(sym, n, bins, where, totals, stream);
      break;
    case 2:
      err = launch_path<uint16_t>(sym, n, bins, where, totals, stream);
      break;
    default:
      err = launch_path<int32_t>(sym, n, bins, where, totals, stream);
  }
  if (err == cudaSuccess && path) *path = where;
  return static_cast<int>(err);
}
