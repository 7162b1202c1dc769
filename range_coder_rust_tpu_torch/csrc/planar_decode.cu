// Planar decode for Hopper (sm_90a): the block decoder of CodecConfig()'s
// default profile.
//
// Replaces the reference's XLA scans (no Pallas kernel there):
// decode_blocks of range_coder_rust_tpu/blocks.py:319, decode_blocks_div
// (:277) and decode_blocks_adaptive (range_coder_rust_tpu/adaptive.py:112);
// in the port it replaces the step loop of kernels/planar.py
// (planar_decode_plain), which launches some 67 small kernels a step and
// builds a (B, C + 1) int64 window matrix.
//
// What it computes, per block b: `block_len` symbols, each the count of
// cum[a + 1] <= rfreq (reference examples/sample_impl.rs:33-44) for the
// target rfreq of the 64-bit window of bytes [cursor - 8, cursor) of the
// block's payload (reference src/decoder.rs:27-35; bytes past the
// payload's length read 0), then the encoder's own transition
// (planar_step.cuh), whose byte count advances the cursor.  The payloads
// come where they lie: block b's are the lengths[b] bytes at offsets[b]
// of one flat byte buffer (as the container holds them, joined), or row b
// of a (B, C) matrix (offsets b * C, lengths C).  An offset or length
// outside the buffer is cut to it.  Output (B, block_len) int32.  Totals
// and tables as in planar_encode.cu.
//
// What bounds it on the H100: the chain.  One thread owns one block and
// its L dependent steps; 32768 blocks are 256 threads an SM, two warps a
// scheduler, too few to hide a step's latency, so the kernel takes about
// L times one step's latency.  The first design's step was a u64
// division (a software routine), log2(A + 1) dependent shared-memory
// reads of a binary search, the transition, then up to 14 dependent
// single-byte loads, each behind a branch, and a 4-byte store.  The
// design shortens that chain
// (scripts_torch/decode_variants.py --kernel planar_decode puts each
// point back alone; the macros are listed in planar_device.cuh):
// 1. The symbol from a slot table in one shared-memory load, for a shared
//    table of total 2^k: 2^k u8 slots (A <= 256) or u16 ones, built by
//    symbol ranges at the CTA's start after the (cum, c) pairs, 64 KiB or
//    128 KiB behind the shared-memory opt-in.  Raw totals, per-block
//    tables and tables too wide for shared memory keep the binary search.
// 2. The target without a u64 division: a float (2^k totals) or double
//    (raw totals) reciprocal estimate and one exact correction by a
//    128-bit product (planar_step.cuh's quotient); a raw total's rpt by a
//    multiply-high with a reciprocal computed once a launch (Divisor).
// 3. The code bytes read ahead in registers: aligned 16-byte loads one
//    chunk ahead of the window, and the n bytes of a transition moved in
//    by shifts (CodeReader), not n loads.
// 4. Four symbols a 16-byte store.
// 5. 256-thread CTAs (planar_device.cuh says why).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "planar_device.cuh"
#include "planar_step.cuh"

namespace {

using planar::u64;

// the slot type of a placement (planar_device.cuh's Placement)
template <int kMode>
struct SlotOf {
  using type = uint8_t;
};
template <>
struct SlotOf<planar::kSlots16> {
  using type = uint16_t;
};

template <typename Total, typename Find, typename Table>
__device__ __forceinline__ void decode_one(const uint8_t* start,
                                           long long len, int L,
                                           const Table& t, int a_count,
                                           const Total& tot, const Find& find,
                                           int32_t* out, bool vec) {
#if defined(RC_VARIANT_PLANAR_BYTE_REFILL)
  planar::ByteReader code = planar::byte_reader(start, len);
#else
  planar::CodeReader code = planar::code_reader(start, len);
#endif
  planar::decode_block_fast(&code, L, t, a_count, tot, find, out, vec);
}

template <typename Total, int kMode>
__global__ void __launch_bounds__(planar::kDecodeThreads)
    planar_decode_kernel(const uint8_t* __restrict__ code,
                         long long code_bytes,
                         const long long* __restrict__ offsets,
                         const long long* __restrict__ lengths,
                         long long row_bytes, const long long* __restrict__ c,
                         const long long* __restrict__ cum, int per_block,
                         int a_count, Total tot, int32_t* __restrict__ out,
                         long long n_blocks, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* pairs = reinterpret_cast<uint2*>(smem);
  using Slot = typename SlotOf<kMode>::type;
  Slot* slots = reinterpret_cast<Slot*>(pairs + a_count + 1);
  bool use_slots = false;
  if (kMode != planar::kGlobal) planar::stage_table(pairs, c, cum, a_count);
  if (kMode == planar::kSlots8 || kMode == planar::kSlots16)
    use_slots = planar::build_slots(slots, pairs, a_count, tot.qmax + 1);
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  long long off = offsets ? offsets[b] : b * row_bytes;
  long long len = lengths ? lengths[b] : row_bytes;
  if (off < 0 || off > code_bytes) off = len = 0;
  if (len > code_bytes - off) len = code_bytes - off;
  if (len < 0) len = 0;
  int32_t* row = out + b * L;
#if defined(RC_VARIANT_PLANAR_SCALAR_STORES)
  const bool vec = false;
#else
  const bool vec =
      (L & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#endif
  auto table = planar::TableFor<kMode != planar::kGlobal>::get(
      pairs, c, cum, a_count, per_block, b);
  if (use_slots)
    decode_one(code + off, len, L, table, a_count, tot,
               planar::SlotFind<Slot>{slots}, row, vec);
  else
    decode_one(code + off, len, L, table, a_count, tot,
               planar::SearchFind<decltype(table)>{table, a_count}, row, vec);
}

template <typename Total, int kMode>
cudaError_t launch_mode(size_t smem, unsigned grid, const uint8_t* code,
                        long long code_bytes, const long long* offsets,
                        const long long* lengths, long long row_bytes,
                        const long long* c, const long long* cum,
                        int per_block, int a_count, int k, u64 total,
                        int32_t* out, long long n_blocks, int L,
                        cudaStream_t stream) {
  const auto kernel = planar_decode_kernel<Total, kMode>;
  cudaError_t err = planar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, planar::kDecodeThreads, smem, stream>>>(
      code, code_bytes, offsets, lengths, row_bytes, c, cum, per_block,
      a_count, planar::total_of<Total>(k, total), out, n_blocks, L);
  return cudaGetLastError();
}

template <typename Total>
cudaError_t launch(const uint8_t* code, long long code_bytes,
                   const long long* offsets, const long long* lengths,
                   long long row_bytes, const long long* c,
                   const long long* cum, int per_block, int a_count, int k,
                   u64 total, int32_t* out, long long n_blocks, int L,
                   cudaStream_t stream, int* placed) {
  const unsigned grid = static_cast<unsigned>(
      (n_blocks + planar::kDecodeThreads - 1) / planar::kDecodeThreads);
  int where = planar::kGlobal;
  size_t smem = 0;
  const cudaError_t err =
      planar::placement(true, per_block, a_count, k, &where, &smem);
  if (err != cudaSuccess) return err;
  if (placed) *placed = where;
  auto run = where == planar::kSmemPairs
                 ? &launch_mode<Total, planar::kSmemPairs>
                 : &launch_mode<Total, planar::kGlobal>;
  // placement gives a slot table to totals of 2^k only
  if constexpr (std::is_same<Total, planar::Pow2Total>::value) {
    if (where == planar::kSlots8) run = &launch_mode<Total, planar::kSlots8>;
    if (where == planar::kSlots16)
      run = &launch_mode<Total, planar::kSlots16>;
  }
  return run(smem, grid, code, code_bytes, offsets, lengths, row_bytes, c,
             cum, per_block, a_count, k, total, out, n_blocks, L, stream);
}

}  // namespace

// Decode `n_blocks` payloads into (n_blocks, L) int32 symbols: block b's
// are the lengths[b] bytes at offsets[b] of the `code_bytes` bytes at
// `code`, or, with `offsets` and `lengths` null, the row_bytes bytes at
// b * row_bytes.  The table c / cum (int64; one shared, or one per block
// when `per_block`); total 2^k for k in [1, 16] or `total` for k = 0.
// Where `placed` is not null, the launch's planar::Placement is written
// there.  Returns the launch's cudaError_t.
extern "C" int rc_planar_decode(const uint8_t* code, long long code_bytes,
                                const long long* offsets,
                                const long long* lengths, long long row_bytes,
                                const long long* c, const long long* cum,
                                int per_block, int a_count, int k,
                                unsigned long long total, int32_t* out,
                                long long n_blocks, int L,
                                cudaStream_t stream, int* placed) {
  if (n_blocks < 1 || L < 0 || row_bytes < 0 || code_bytes < 0 ||
      a_count < 1 || k < 0 || k > 16 || total < 1 || total >> 32 ||
      (offsets == nullptr) != (lengths == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return k ? launch<planar::Pow2Total>(code, code_bytes, offsets, lengths,
                                       row_bytes, c, cum, per_block, a_count,
                                       k, total, out, n_blocks, L, stream,
                                       placed)
           : launch<planar::RawTotal>(code, code_bytes, offsets, lengths,
                                      row_bytes, c, cum, per_block, a_count,
                                      k, total, out, n_blocks, L, stream,
                                      placed);
}
