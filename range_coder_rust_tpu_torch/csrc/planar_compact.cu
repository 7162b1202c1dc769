// Payload compaction for Hopper (sm_90a): the planar encode's code matrix
// joined on the card into one flat payload area, so that only payload
// bytes cross to the host.
//
// Replaces no TPU kernel: the JAX package copies its whole code matrix to
// the host and trims each block there, one slice a block
// (range_coder_rust_tpu/api.py:245-250), and so did the port until this
// kernel: the (B, capacity) matrix is about 4.4 times the payload bytes
// at CodecConfig()'s capacity (1544 B a block against ~354 B coded), and
// the host's slices cost one Python object a block.
//
// What it computes: row b's first lengths[b] bytes of the (B, row_bytes)
// u8 matrix `code`, written at offsets[b] of the u8 area `out` of `size`
// bytes.  With offsets the exclusive prefix sum of the lengths and size
// their sum, `out` is every row's payload joined in row order, as the
// container holds them; the caller computes the offsets (the host has the
// lengths already, for the capacity check and the container).  A length
// is cut to the row and to the room left in `out`, and a row whose offset
// lies outside [0, size] writes nothing, so no launch writes outside its
// buffers; bytes of `out` that no row covers are left as they were.
//
// What bounds it on the H100: the bytes, about 2 x 11.6 MB a 2^24-symbol
// chunk of a Zipf(1.2) byte corpus (~7 us at 3.35 TB/s, against ~0.18 ms
// of the encode kernel on the same chunk), and, at ~354 B a row, the
// latency of one short copy a row.  The design:
// * one warp a row, eight rows a CTA, rows strided over the grid;
// * the row read as aligned u32 words: the matrix starts on a 4-byte
//   boundary and row_bytes is a multiple of 4, as the encode's capacity
//   always is (8-byte rows in both benchmark cells, 1544 = 8 x 193);
//   another geometry reads byte by byte (the kWords = false build);
// * the row lands at any byte of `out`, so the lanes store aligned
//   16-byte vectors from the destination's first 16-byte boundary on,
//   each built from five source words by funnel shifts (the shift is the
//   same for every vector of the row), and the bytes before that
//   boundary (the head) and after the last whole vector (the tail) one
//   byte a lane.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;
//: the most CTAs a launch starts; rows beyond them stride over the grid
constexpr long long kMaxCtas = 1ll << 20;

// Bytes [pos, pos + 16) of `row`, all below the row's length, as one
// vector.  With kWords, `row` is 4-byte aligned and its size a multiple of
// 4, and every word read lies inside it: the fifth word is read only when
// pos % 4 != 0, and then it starts below pos + 16.
template <bool kWords>
__device__ __forceinline__ uint4 vector_at(const uint8_t* __restrict__ row,
                                           long long pos) {
  uint32_t v[4];
  if constexpr (kWords) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (pos >> 2);
    const unsigned shift = 8u * static_cast<unsigned>(pos & 3);
    uint32_t a[5];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = __ldg(w + j);
    a[4] = shift ? __ldg(w + 4) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __funnelshift_r(a[j], a[j + 1], shift);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* p = row + pos + 4 * j;
      v[j] = static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
             static_cast<uint32_t>(p[2]) << 16 |
             static_cast<uint32_t>(p[3]) << 24;
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
    planar_compact_kernel(const uint8_t* __restrict__ code, long long row_bytes,
                          const long long* __restrict__ lengths,
                          const long long* __restrict__ offsets,
                          uint8_t* __restrict__ out, long long size,
                          long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerCta;
  for (long long b = static_cast<long long>(blockIdx.x) * kRowsPerCta +
                     (threadIdx.x >> 5);
       b < n_rows; b += stride) {
    const long long off = offsets[b];
    long long len = lengths[b];
    if (off < 0 || off > size || len <= 0) continue;  // the whole warp
    len = min(len, min(row_bytes, size - off));
    const uint8_t* row = code + b * row_bytes;
    uint8_t* dst = out + off;
    const long long to_grid =
        (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(dst) & 15)) &
        15;
    const long long head = min(len, to_grid);
    const long long n_vectors = (len - head) >> 4;
    const long long tail = head + (n_vectors << 4);
    if (lane < head) dst[lane] = row[lane];
    for (long long v = lane; v < n_vectors; v += 32) {
      const long long pos = head + (v << 4);
      *reinterpret_cast<uint4*>(dst + pos) = vector_at<kWords>(row, pos);
    }
    if (lane < len - tail) dst[tail + lane] = row[tail + lane];
  }
}

}  // namespace

// Write row b's first lengths[b] bytes of the (n_rows, row_bytes) u8
// matrix `code` at offsets[b] of the `size`-byte area `out` (lengths and
// offsets: (n_rows,) int64 on the card), cut as the header says.  Returns
// the cudaError_t of the launch.
extern "C" int rc_planar_compact(const uint8_t* code, long long row_bytes,
                                 const long long* lengths,
                                 const long long* offsets, uint8_t* out,
                                 long long size, long long n_rows,
                                 cudaStream_t stream) {
  if (n_rows < 0 || row_bytes < 0 || size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  long long grid = (n_rows + kRowsPerCta - 1) / kRowsPerCta;
  if (grid > kMaxCtas) grid = kMaxCtas;
  const bool words =
      ((reinterpret_cast<uintptr_t>(code) | static_cast<uintptr_t>(row_bytes)) &
       3) == 0;
  if (words)
    planar_compact_kernel<true>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            code, row_bytes, lengths, offsets, out, size, n_rows);
  else
    planar_compact_kernel<false>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            code, row_bytes, lengths, offsets, out, size, n_rows);
  return static_cast<int>(cudaGetLastError());
}
