// Planar encode for Hopper (sm_90a): the block coder of CodecConfig()'s
// default profile.
//
// Replaces the reference's XLA scans (no Pallas kernel there):
// encode_scan and compact_emissions of range_coder_rust_tpu/blocks.py:69
// and :127, encode_scan_div (:232) and encode_scan_adaptive
// (range_coder_rust_tpu/adaptive.py:77); in the port it replaces the step
// loop of kernels/planar.py (planar_encode_plain), which launches some 43
// small kernels a step.
//
// What it computes, per block b of L symbols (row b of a (B, L) matrix of
// u8, u16, i32 or i64 symbols): the range coder's L transitions and the
// flush (planar_step.cuh), their bytes written in stream order into row b
// of the (B, capacity) uint8 output, and the block's length, the flush's
// 8 bytes included.  Bytes past `capacity` are dropped while the length
// keeps counting: a length above the capacity tells the caller to encode
// again with more room.  The output comes zeroed from the wrapper, so the
// row past the length reads 0.  The total is 2^k (rpt = range >> k) or
// any u32 total (k = 0: the exact u64 division).  The table is one
// shared (A,) / (A + 1,) pair of int64 tables or one pair per block
// (the adaptive mode).  A symbol outside [0, A) is coded as A - 1 (the
// plain version raises; the kernel must not read outside the table).
//
// What bounds it on the H100: the chain.  One thread owns one block and
// its L dependent transitions (each a few dozen integer operations on
// u64, one table read); a 2^24-symbol call has 32768 threads, about 248
// on each SM, so the kernel takes about L times the latency of one step.
// The bytes (16 MiB of u8 symbols in, the code matrix out) would take
// 0.02 ms at the memory's rate.  The design keeps everything of a block in
// registers: native u64 state, the scan and the compaction fused (each
// byte goes straight to its place in the row, four at a time as one
// 32-bit store where the row allows: planar_step.cuh's ByteSink), and a
// table of A <= 6143 symbols staged once per CUDA block in shared
// memory.  The symbol reads are one
// scalar load a step; a row's 128-byte lines stay in L1 across the
// steps that use them.
#include <cstdint>

#include <cuda_runtime.h>

#include "planar_device.cuh"
#include "planar_step.cuh"

namespace {

using planar::u64;

template <typename Sym, bool kDiv, bool kSmem>
__global__ void __launch_bounds__(planar::kThreads)
    planar_encode_kernel(const Sym* __restrict__ sym,
                         const long long* __restrict__ c,
                         const long long* __restrict__ cum, int per_block,
                         int a_count, int k, u64 total,
                         uint8_t* __restrict__ out,
                         long long* __restrict__ lengths, long long n_blocks,
                         int L, long long capacity) {
  extern __shared__ uint2 smem_table[];
  if (kSmem) planar::stage_table(smem_table, c, cum, a_count);
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const auto table =
      planar::TableFor<kSmem>::get(smem_table, c, cum, a_count, per_block, b);
  planar::ByteSink sink = planar::byte_sink(out + b * capacity, capacity);
  planar::encode_block<kDiv>(planar::SymbolRow<Sym>{sym + b * L, a_count}, L,
                             table, k, total, &sink);
  lengths[b] = sink.pos;
}

template <typename Sym, bool kDiv>
cudaError_t launch(const void* sym, const long long* c, const long long* cum,
                   int per_block, int a_count, int k, u64 total, uint8_t* out,
                   long long* lengths, long long n_blocks, int L,
                   long long capacity, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(
      (n_blocks + planar::kThreads - 1) / planar::kThreads);
  const size_t smem = planar::smem_table_bytes(per_block, a_count);
  const Sym* rows = static_cast<const Sym*>(sym);
  if (smem)
    planar_encode_kernel<Sym, kDiv, true>
        <<<grid, planar::kThreads, smem, stream>>>(
            rows, c, cum, per_block, a_count, k, total, out, lengths,
            n_blocks, L, capacity);
  else
    planar_encode_kernel<Sym, kDiv, false>
        <<<grid, planar::kThreads, 0, stream>>>(rows, c, cum, per_block,
                                                a_count, k, total, out,
                                                lengths, n_blocks, L,
                                                capacity);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_total(const void* sym, const long long* c,
                         const long long* cum, int per_block, int a_count,
                         int k, u64 total, uint8_t* out, long long* lengths,
                         long long n_blocks, int L, long long capacity,
                         cudaStream_t stream) {
  return k ? launch<Sym, false>(sym, c, cum, per_block, a_count, k, total,
                                out, lengths, n_blocks, L, capacity, stream)
           : launch<Sym, true>(sym, c, cum, per_block, a_count, k, total, out,
                               lengths, n_blocks, L, capacity, stream);
}

}  // namespace

// Encode `n_blocks` rows of L symbols (`sym_bytes` 1: u8, 2: u16 bits,
// 4: i32, 8: i64) with the table c / cum (int64; one shared, or one per
// block when `per_block`), total 2^k for k in [1, 16] or `total` for
// k = 0.  `out` is the zeroed (n_blocks, capacity) code matrix, `lengths`
// (n_blocks,) int64.  Returns the launch's cudaError_t.
extern "C" int rc_planar_encode(const void* sym, int sym_bytes,
                                const long long* c, const long long* cum,
                                int per_block, int a_count, int k,
                                unsigned long long total, uint8_t* out,
                                long long* lengths, long long n_blocks, int L,
                                long long capacity, cudaStream_t stream) {
  if (n_blocks < 1 || L < 0 || a_count < 1 || capacity < 0 || k < 0 ||
      k > 16 || (k == 0 && (total < 1 || total >> 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sym_bytes) {
    case 1:
      return launch_total<uint8_t>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream);
    case 2:
      return launch_total<uint16_t>(sym, c, cum, per_block, a_count, k,
                                    total, out, lengths, n_blocks, L,
                                    capacity, stream);
    case 4:
      return launch_total<int32_t>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream);
    case 8:
      return launch_total<long long>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
