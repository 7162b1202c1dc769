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
// What it computes, per block b (row b of a (B, C) uint8 code matrix, of
// any width C): `block_len` symbols, each the count of cum[a + 1] <= rfreq
// (reference examples/sample_impl.rs:33-44) for the target rfreq of the
// 64-bit window of bytes [cursor - 8, cursor) (reference
// src/decoder.rs:27-35; bytes past the row read 0), then the encoder's
// own transition (planar_step.cuh), whose byte count advances the
// cursor.  Output (B, block_len) int32.  Totals and tables as in
// planar_encode.cu.
//
// What bounds it on the H100: the chain, as in the encode, and each step
// is longer: a full u64 division (CUDA's 64-bit `/` is a software
// routine, exact; a total of 2^k saves only the range's shift), a binary
// search of log2(A + 1) dependent table reads, then the transition.  The
// design keeps the window in a register and shifts in the n bytes a step
// consumes (no window matrix), reads a shared table of A <= 6143 symbols
// from shared memory, and keeps the state in native u64.
#include <cstdint>

#include <cuda_runtime.h>

#include "planar_device.cuh"
#include "planar_step.cuh"

namespace {

using planar::u64;

template <bool kDiv, bool kSmem>
__global__ void __launch_bounds__(planar::kThreads)
    planar_decode_kernel(const uint8_t* __restrict__ code, long long row_bytes,
                         const long long* __restrict__ c,
                         const long long* __restrict__ cum, int per_block,
                         int a_count, int k, u64 total,
                         int32_t* __restrict__ out, long long n_blocks,
                         int L) {
  extern __shared__ uint2 smem_table[];
  if (kSmem) planar::stage_table(smem_table, c, cum, a_count);
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const auto table =
      planar::TableFor<kSmem>::get(smem_table, c, cum, a_count, per_block, b);
  planar::decode_block<kDiv>(planar::CodeRow{code + b * row_bytes, row_bytes},
                             L, table, a_count, k, total, out + b * L);
}

template <bool kDiv>
cudaError_t launch(const uint8_t* code, long long row_bytes,
                   const long long* c, const long long* cum, int per_block,
                   int a_count, int k, u64 total, int32_t* out,
                   long long n_blocks, int L, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(
      (n_blocks + planar::kThreads - 1) / planar::kThreads);
  const size_t smem = planar::smem_table_bytes(per_block, a_count);
  if (smem)
    planar_decode_kernel<kDiv, true><<<grid, planar::kThreads, smem, stream>>>(
        code, row_bytes, c, cum, per_block, a_count, k, total, out, n_blocks,
        L);
  else
    planar_decode_kernel<kDiv, false><<<grid, planar::kThreads, 0, stream>>>(
        code, row_bytes, c, cum, per_block, a_count, k, total, out, n_blocks,
        L);
  return cudaGetLastError();
}

}  // namespace

// Decode `n_blocks` rows of `row_bytes` code bytes into (n_blocks, L)
// int32 symbols, with the table c / cum (int64; one shared, or one per
// block when `per_block`), total 2^k for k in [1, 16] or `total` for
// k = 0.  Returns the launch's cudaError_t.
extern "C" int rc_planar_decode(const uint8_t* code, long long row_bytes,
                                const long long* c, const long long* cum,
                                int per_block, int a_count, int k,
                                unsigned long long total, int32_t* out,
                                long long n_blocks, int L,
                                cudaStream_t stream) {
  if (n_blocks < 1 || L < 0 || row_bytes < 0 || a_count < 1 || k < 0 ||
      k > 16 || total < 1 || total >> 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return k ? launch<false>(code, row_bytes, c, cum, per_block, a_count, k,
                           total, out, n_blocks, L, stream)
           : launch<true>(code, row_bytes, c, cum, per_block, a_count, k,
                          total, out, n_blocks, L, stream);
}
