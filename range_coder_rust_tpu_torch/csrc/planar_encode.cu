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
// any u32 total (k = 0: the exact u64 division, by a reciprocal).  The
// table is one shared (A,) / (A + 1,) pair of int64 tables or one pair
// per block (the adaptive mode).  A symbol outside [0, A) is coded as
// A - 1 (the plain version raises; the kernel must not read outside the
// table).
//
// What bounds it on the H100: the chain.  One thread owns one block and
// its L dependent transitions (each a few dozen integer operations on
// u64); a 2^24-symbol call has 32768 threads, 248 an SM, so the kernel
// takes about L times the latency of one step.  The bytes (16 MiB of u8
// symbols in, the payloads out) would take 0.02 ms at the memory's rate.
// The design keeps everything of a block in registers (native u64 state;
// the scan and the compaction fused: each byte goes straight to its place
// in the row) and shortens the step's chain
// (scripts_torch/decode_variants.py --kernel planar_encode puts each
// point back alone; the macros are listed in planar_device.cuh):
// 1. Symbols and table entries ahead of the chain: the row read 16 bytes
//    at a time (16 u8, 8 u16, 4 i32 or 2 i64 symbols; one scalar load a
//    step where the row is not 16-byte aligned), the next chunk's load a
//    chunk ahead, and the next symbol's (cum, c) read one step ahead, so
//    the state's chain is only rpt, the interval and the renormalisation.
// 2. A branch-free byte writer: a transition's bytes enter a 128-bit
//    accumulator by funnel shifts and leave as 8-byte stores
//    (planar_step.cuh's ByteWriter), not a loop of one byte at a time,
//    which diverged across the warp on the byte count.
// 3. A raw total's rpt by a multiply-high with a reciprocal computed once
//    a launch (Divisor), not a u64 division a step.
// 4. 128-thread CTAs, the measured choice (planar_device.cuh).
// A shared table of A <= 6143 symbols is staged once per CTA in shared
// memory.
#include <cstdint>

#include <cuda_runtime.h>

#include "planar_device.cuh"
#include "planar_step.cuh"

namespace {

using planar::u64;

template <typename Sym, typename Total, bool kSmem>
__global__ void __launch_bounds__(planar::kEncodeThreads)
    planar_encode_kernel(const Sym* __restrict__ sym,
                         const long long* __restrict__ c,
                         const long long* __restrict__ cum, int per_block,
                         int a_count, Total tot, uint8_t* __restrict__ out,
                         long long* __restrict__ lengths, long long n_blocks,
                         int L, long long capacity) {
  extern __shared__ uint2 smem_table[];
  if (kSmem) planar::stage_table(smem_table, c, cum, a_count);
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const auto table =
      planar::TableFor<kSmem>::get(smem_table, c, cum, a_count, per_block, b);
#if defined(RC_VARIANT_PLANAR_BYTE_WRITER)
  planar::ByteSink sink = planar::byte_sink(out + b * capacity, capacity);
#else
  planar::ByteWriter sink = planar::byte_writer(out + b * capacity, capacity);
#endif
  const Sym* row = sym + b * L;
#if defined(RC_VARIANT_PLANAR_SCALAR_SYMBOLS)
  planar::encode_block_scalar(planar::SymbolRow<Sym>{row, a_count}, L, table,
                              tot, &sink);
#else
  const bool vec = (reinterpret_cast<uintptr_t>(sym) & 15) == 0 &&
                   (static_cast<long long>(L) * sizeof(Sym)) % 16 == 0;
  planar::encode_block_fast(row, L, a_count, table, tot, &sink, vec);
#endif
  lengths[b] = sink.length();
}

template <typename Sym, typename Total>
cudaError_t launch(const void* sym, const long long* c, const long long* cum,
                   int per_block, int a_count, int k, u64 total, uint8_t* out,
                   long long* lengths, long long n_blocks, int L,
                   long long capacity, cudaStream_t stream, int* placed) {
  const unsigned grid = static_cast<unsigned>(
      (n_blocks + planar::kEncodeThreads - 1) / planar::kEncodeThreads);
  int where = planar::kGlobal;
  size_t smem = 0;
  const cudaError_t err =
      planar::placement(false, per_block, a_count, k, &where, &smem);
  if (err != cudaSuccess) return err;
  if (placed) *placed = where;
  const Sym* rows = static_cast<const Sym*>(sym);
  const Total tot = planar::total_of<Total>(k, total);
  if (where == planar::kSmemPairs)
    planar_encode_kernel<Sym, Total, true>
        <<<grid, planar::kEncodeThreads, smem, stream>>>(
            rows, c, cum, per_block, a_count, tot, out, lengths, n_blocks, L,
            capacity);
  else
    planar_encode_kernel<Sym, Total, false>
        <<<grid, planar::kEncodeThreads, 0, stream>>>(rows, c, cum, per_block,
                                                a_count, tot, out, lengths,
                                                n_blocks, L, capacity);
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t launch_total(const void* sym, const long long* c,
                         const long long* cum, int per_block, int a_count,
                         int k, u64 total, uint8_t* out, long long* lengths,
                         long long n_blocks, int L, long long capacity,
                         cudaStream_t stream, int* placed) {
  return k ? launch<Sym, planar::Pow2Total>(sym, c, cum, per_block, a_count,
                                            k, total, out, lengths, n_blocks,
                                            L, capacity, stream, placed)
           : launch<Sym, planar::RawTotal>(sym, c, cum, per_block, a_count, k,
                                           total, out, lengths, n_blocks, L,
                                           capacity, stream, placed);
}

}  // namespace

// Encode `n_blocks` rows of L symbols (`sym_bytes` 1: u8, 2: u16 bits,
// 4: i32, 8: i64) with the table c / cum (int64; one shared, or one per
// block when `per_block`), total 2^k for k in [1, 16] or `total` for
// k = 0.  `out` is the zeroed (n_blocks, capacity) code matrix, `lengths`
// (n_blocks,) int64.  Where `placed` is not null, the launch's
// planar::Placement (kSmemPairs or kGlobal) is written there.  Returns the
// launch's cudaError_t.
extern "C" int rc_planar_encode(const void* sym, int sym_bytes,
                                const long long* c, const long long* cum,
                                int per_block, int a_count, int k,
                                unsigned long long total, uint8_t* out,
                                long long* lengths, long long n_blocks, int L,
                                long long capacity, cudaStream_t stream,
                                int* placed) {
  if (n_blocks < 1 || L < 0 || a_count < 1 || capacity < 0 || k < 0 ||
      k > 16 || (k == 0 && (total < 1 || total >> 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sym_bytes) {
    case 1:
      return launch_total<uint8_t>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream, placed);
    case 2:
      return launch_total<uint16_t>(sym, c, cum, per_block, a_count, k,
                                    total, out, lengths, n_blocks, L,
                                    capacity, stream, placed);
    case 4:
      return launch_total<int32_t>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream, placed);
    case 8:
      return launch_total<long long>(sym, c, cum, per_block, a_count, k, total,
                                   out, lengths, n_blocks, L, capacity,
                                   stream, placed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
