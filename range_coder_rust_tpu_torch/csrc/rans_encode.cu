// rans16 encode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_rans_encode_kernel` of
// range_coder_rust_tpu/kernels/rans_encode.py:175 (wrapper rans_encode_tiled,
// with the in-kernel helpers _lane_prefix_flat of kernels/vreg.py and
// compact_flat_tile of kernels/compact_flat.py folded in).
//
// What it computes, per group of G lanes with L symbols each (lane-major
// rows, lane l of group g = row g*G + l; u8, u16 or i32 symbols):
//   * the backward rANS16 chain per lane, state x in [2^32, 2^48): at each
//     step t = L-1 .. 0, emit x & 0xFFFF and x >>= 16 when x >> 32 >= c;
//     then q, r = divmod(x, c) and x = (q << 16) | (cum + r);
//   * the final states (the container preamble), one u64 per lane;
//   * per-tile region sizes in time order (tile = `tile` steps);
//   * every group's region, the emitted halfwords in (step ascending,
//     lane ascending) order, concatenated over groups;
//   * with a sync period T > 0 (tile random access), each lane's state
//     right after the chain finishes time-tile j*T, j = 1 .. (NT-1)/T:
//     the state the decoder holds before that tile.
// The cum table is one for all groups, or one per group (the adaptive
// mode; `cum_stride` 1024).  Each chain block builds its table from its
// own group's cum: a block never straddles a group (G is a multiple of
// the block).
//
// What bounds it on the H100: the chain.  Each lane's L steps depend on
// one another, and the lanes are few (8192 on the 256 MB main path, one
// thread each), so the kernel takes L times the latency of one step
// (about 45 ns, 32768 steps); the bytes (u8 symbols in, region out) would
// take 0.13 ms at the memory's rate.  The design takes
// everything but the arithmetic off the step's dependent path, and cuts
// the bytes the compaction moves.  scripts_torch/decode_variants.py
// --kernel encode times the kernel with each design point reverted (the
// RC_VARIANT_* macros below, which only that script defines) on the main
// path; PERF.md has what each costs:
//
// 1. Symbols at their width, ahead of the chain (RC_VARIANT_INT32_SYMBOLS
//    reverts: int32 rows, one scalar load on each step).  Rows come as u8
//    (A <= 256), u16 (A <= 1023) or i32.  Each lane reads 32 bytes of its
//    row at a time (32 steps of u8, 16 of u16, 8 of i32), walking
//    backward, one chunk ahead in registers: no load latency sits on a
//    step.  Rows whose base or length is not a multiple of 16 bytes read
//    their chunks symbol by symbol (chosen per launch), and the L % chunk
//    steps at the top of a row are read one by one before the chunks.
// 2. A reciprocal instead of a 64-bit division (RC_VARIANT_DIV64 reverts).
//    Each block builds a table in shared memory, one 16-byte entry a
//    symbol: cs, c and m = ceil(2^64 / c).  After renormalisation
//    x < c * 2^32 <= 2^48, so for 2 <= c <= 2^16, q = umulhi(x, m) is
//    x / c exactly: the error of the estimate is below x / 2^64 < 2^-16,
//    and the fraction of x / c is at most 1 - 1/c <= 1 - 2^-16.  c = 1
//    (m would be 2^64) takes q = x.  The entry for step t - 1 is read while
//    step t runs (reading it 2, 4 or 8 steps ahead through a ring of
//    registers did not shorten the step).
// 3. Half the park (RC_VARIANT_U32_PARK reverts: `h | emit << 16` as u32
//    and a compaction that ranks 65536 flags a tile with 64 block scans).
//    The chain parks each step's halfword as u16, step-major, and the emit
//    flags as one ballot word per (step, warp).  The per-tile sizes are
//    the popcounts of those same ballots, added with one atomic per warp
//    and tile, so sizes and masks agree by construction.  A block per
//    (group, tile) ranks the tile's words with one block scan of their
//    popcounts and scatters each emitted halfword to
//    offset + (word's rank) + popc(mask & lanes below).
// 4. Chain block width (RC_VARIANT_CHAIN_THREADS = 32, 64 or 128; 64 is
//    the build's).  64-thread blocks spread the main path's 8192 lanes
//    over 128 SMs, 2 warps each; 128-thread blocks (4 warps on each of 64
//    SMs) made every step about 10 % slower, 32-thread blocks no faster.
// 5. Sync states in a build of their own (RC_VARIANT_ALWAYS_SYNC reverts:
//    the sync build runs without sync states too).  The store sits on the
//    tile-boundary branch, uniform across the warp, found by a count-down
//    of finished tiles instead of a division; but the branch is inlined
//    into every step of the unrolled chunk loop, and its code alone made
//    the main path's step about 6 % slower (a division there, 80 %).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "rc_common.cuh"

namespace {

#ifndef RC_VARIANT_CHAIN_THREADS
#define RC_VARIANT_CHAIN_THREADS 64
#endif
constexpr int kChainThreads = RC_VARIANT_CHAIN_THREADS;
static_assert(kChainThreads == 32 || kChainThreads == 64 ||
                  kChainThreads == 128,
              "the chain block is 32, 64 or 128 threads (group widths are "
              "multiples of 128)");
constexpr int kBlock = 1024;
//: table entries: the symbols a (clamped) symbol index can reach
constexpr int kTable = rc::kCumEntries - 1;
//: bytes of a row that one lane reads at a time
constexpr int kChunkBytes = 32;
//: mask words a compaction pass ranks (two a thread)
constexpr int kPassWords = 2 * kBlock;
//: mask words a warp of the compaction scatters with its loads in flight
constexpr int kScatterUnroll = 8;

// How the chain reads its symbols: one scalar load per step, not ahead
// (RC_VARIANT_INT32_SYMBOLS); chunks one ahead, symbol by symbol; chunks
// one ahead as two 16-byte loads.
enum Load { kLoadStep, kLoadScalar, kLoadVector };

// The parked emissions: u16 halfwords and ballot words, or (U32_PARK)
// `h | emit << 16` words.
struct Park {
  uint16_t* hw;
  uint32_t* mask;
  uint32_t* u32;
};

// Stage the symbol table in shared memory: entry s = {cs, c, m lo, m hi}
// with m = ceil(2^64 / c) for c >= 2, else 0.  Symbols outside the
// alphabet meet the padding (c = 0 or huge): they code garbage, and never
// index past the table.
__device__ __forceinline__ void build_table(uint4* tab,
                                            const int32_t* cum_g) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    const uint32_t cs = static_cast<uint32_t>(cum_g[i]);
    const uint32_t c = static_cast<uint32_t>(cum_g[i + 1]) - cs;
    const uint64_t m = c >= 2 ? ~0ull / c + 1 : 0ull;
    tab[i] = make_uint4(cs, c, static_cast<uint32_t>(m),
                        static_cast<uint32_t>(m >> 32));
  }
  __syncthreads();
}

// A symbol's bits -> its table index, clamped into the table.
template <typename T>
__device__ __forceinline__ int table_index(uint32_t v) {
  if constexpr (std::is_signed_v<T>)
    return min(max(static_cast<int>(v), 0), kTable - 1);
  else
    return min(static_cast<int>(v), kTable - 1);
}

// Symbol i of a 32-byte chunk held as 8 words (little-endian).
template <typename T>
__device__ __forceinline__ uint32_t chunk_symbol(const uint32_t (&w)[8],
                                                 int i) {
  if constexpr (sizeof(T) == 4) {
    return w[i];
  } else {
    constexpr int kPer = 4 / sizeof(T);
    constexpr int kBits = 8 * sizeof(T);
    return (w[i / kPer] >> (kBits * (i % kPer))) & ((1u << kBits) - 1u);
  }
}

// One symbol's bits, zero-extended for unsigned T.
template <typename T>
__device__ __forceinline__ uint32_t load_symbol(const T* p) {
  if constexpr (std::is_signed_v<T>)
    return static_cast<uint32_t>(static_cast<int32_t>(*p));
  else
    return static_cast<uint32_t>(*p);
}

// The 32-byte chunk at p (kChunkBytes / sizeof(T) symbols) into w.
template <typename T, Load kLoad>
__device__ __forceinline__ void load_chunk(const T* p, uint32_t (&w)[8]) {
  if constexpr (kLoad == kLoadVector) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = load_symbol(p + j);
  } else {
    constexpr int kPer = 4 / sizeof(T);
    constexpr int kBits = 8 * sizeof(T);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        v |= load_symbol(p + j * kPer + k) << (kBits * k);
      w[j] = v;
    }
  }
}

// One step of one lane's chain on x = hi:lo with the symbol's table entry
// e = {cs, c, m lo, m hi}: renormalise, then x = (x / c) << 16 | (cs +
// x % c).  Returns the emit flag; h receives the low halfword of x before
// the step (the one emitted, if any).
__device__ __forceinline__ bool encode_step(uint32_t& lo, uint32_t& hi,
                                            const uint4 e, uint32_t& h) {
  const uint32_t cs = e.x, c = e.y;
  const bool emit = hi >= c;
  h = lo & 0xFFFFu;
  if (emit) {
    lo = __funnelshift_r(lo, hi, 16);
    hi >>= 16;
  }
  const uint64_t x = static_cast<uint64_t>(hi) << 32 | lo;
#ifdef RC_VARIANT_DIV64
  const uint32_t q = static_cast<uint32_t>(x / c);
#else
  const uint64_t m = static_cast<uint64_t>(e.w) << 32 | e.z;
  const uint32_t q = c == 1u ? lo : static_cast<uint32_t>(__umul64hi(x, m));
#endif
  // cs + r with r = x - q * c < c, in 32 bits
  const uint32_t low = lo + cs - q * c;
  lo = (q << 16) | low;
  hi = q >> 16;
  return emit;
}

// Where the chain writes the sync states: syncs[g][j - 1][l] for
// j = 1 .. n_sync, every `period` time-tiles (period 0: none).
struct Syncs {
  uint64_t* states;
  int period;
  int n_sync;
};

// kSync: the chain writes sync states (a build of its own, so that the
// chain without them carries no sync code on its step).
template <typename T, Load kLoad, bool kSync>
__global__ void __launch_bounds__(kChainThreads)
rans_encode_chain(const T* __restrict__ sym, const int32_t* __restrict__ cum,
                  int cum_stride, uint64_t* __restrict__ states,
                  int32_t* __restrict__ sizes, Park park, Syncs syncs, int G,
                  int L, int tile) {
  __shared__ uint4 tab[kTable];
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long g = lane / G;  // the same for the whole block
  build_table(tab, cum + g * cum_stride);
  const int l = static_cast<int>(lane - g * G);
  const T* row = sym + lane * L;
  int32_t* sz = sizes + g * (L / tile);
  // the sync states, walking down: the next one is sync n_sync, stored
  // when a count-down of finished tiles (no division on the step's path)
  // meets 0
  uint64_t* sp = nullptr;
  int sync_left = 0, n_left = 0;
  if constexpr (kSync) {
    n_left = syncs.n_sync;
    sp = syncs.states + (g * syncs.n_sync + n_left - 1) * G + l;
    // (period 0 only in the RC_VARIANT_ALWAYS_SYNC build: no sync)
    sync_left = (L / tile - 1) % max(syncs.period, 1);
  }
  const bool leader = (threadIdx.x & 31) == 0;
  // where step t parks, (g, t) step-major (region order): running
  // pointers one step past, moved down before each store, so that the
  // leader's ballot store is one predicated store (an address computed
  // for it on every step put a divergent branch on the warp's path)
  const long long past = g * L + L;
#ifdef RC_VARIANT_U32_PARK
  uint32_t* pk = park.u32 + past * G + l;
#else
  uint16_t* pk = park.hw + past * G + l;
  uint32_t* pm = park.mask + past * (G / 32) + l / 32;
#endif
  uint32_t lo = 0, hi = 1;  // x = 2^32
  // tile accounting: `left` steps remain in tile `ti` (counting down)
  int count = 0, left = tile, ti = L / tile - 1;

  // the steps run in order t = L-1, ..., 0
  auto step = [&](const uint4 e) {
    uint32_t h;
    const bool emit = encode_step(lo, hi, e, h);
    const unsigned ballot = __ballot_sync(0xffffffffu, emit);
    pk -= G;
#ifdef RC_VARIANT_U32_PARK
    *pk = h | (static_cast<uint32_t>(emit) << 16);
#else
    *pk = static_cast<uint16_t>(h);
    pm -= G / 32;
    if (leader) *pm = ballot;
#endif
    count += __popc(ballot);
    if (--left == 0) {  // uniform across the warp: same t, same group
      if (leader && count) atomicAdd(&sz[ti], count);
      if constexpr (kSync) {  // tile ti finished: a sync if ti % period == 0
        if (sync_left-- == 0) {
          sync_left = syncs.period - 1;
          if (n_left-- > 0) {  // ti > 0
            *sp = static_cast<uint64_t>(hi) << 32 | lo;
            sp -= G;
          }
        }
      }
      count = 0;
      left = tile;
      --ti;
    }
  };

  if constexpr (kLoad == kLoadStep) {
    for (int t = L - 1; t >= 0; --t)
      step(tab[table_index<T>(load_symbol(row + t))]);
  } else {
    constexpr int kSteps = kChunkBytes / sizeof(T);
    const int n_chunks = L / kSteps;
    // the top L % kSteps steps, one load each
    for (int t = L - 1; t >= n_chunks * kSteps; --t)
      step(tab[table_index<T>(load_symbol(row + t))]);
    uint32_t cur[8], nxt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (n_chunks > 0) load_chunk<T, kLoad>(row + (n_chunks - 1) * kSteps, cur);
    for (int k = n_chunks - 1; k >= 0; --k) {
      if (k > 0) load_chunk<T, kLoad>(row + (k - 1) * kSteps, nxt);
      uint4 e = tab[table_index<T>(chunk_symbol<T>(cur, kSteps - 1))];
#pragma unroll
      for (int i = kSteps - 1; i >= 0; --i) {
        // the next step's entry, read while this step runs
        const uint4 next_e =
            i > 0 ? tab[table_index<T>(chunk_symbol<T>(cur, i > 0 ? i - 1 : 0))]
                  : e;
        step(e);
        e = next_e;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
    }
  }
  states[lane] = static_cast<uint64_t>(hi) << 32 | lo;
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

#ifndef RC_VARIANT_U32_PARK
// One block per (group, tile): compact the tile's parked halfwords into
// the region at the tile's offset, in (step, lane) order.  Element i of
// the tile (step i / G, lane i % G) is bit i % 32 of mask word i / 32.
__global__ void __launch_bounds__(kBlock)
rans_encode_compact(const uint16_t* __restrict__ park,
                    const uint32_t* __restrict__ masks,
                    const long long* __restrict__ offs,
                    uint16_t* __restrict__ region, int G, int L, int tile) {
  __shared__ uint32_t s_mask[kPassWords];
  __shared__ int s_off[kPassWords];
  __shared__ int sums[33];
  const long long b = blockIdx.x;  // flat (group, tile) index
  const int nt = L / tile;
  const long long g = b / nt;
  const int ti = static_cast<int>(b - g * nt);
  const long long first = (g * L + static_cast<long long>(ti) * tile) * G;
  const uint16_t* src = park + first;
  const uint32_t* mk = masks + first / 32;
  const int n_words = tile * (G / 32);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  long long cursor = offs[b];
  for (int w0 = 0; w0 < n_words; w0 += kPassWords) {
    const int n = min(kPassWords, n_words - w0);
    const int j = 2 * threadIdx.x;
    const uint32_t m0 = j < n ? mk[w0 + j] : 0u;
    const uint32_t m1 = j + 1 < n ? mk[w0 + j + 1] : 0u;
    int total;
    // the barriers after the stores below and after the scatter keep
    // this scan's use of `sums` apart from the next pass's
    const int excl = rc::block_exclusive_scan<int>(__popc(m0) + __popc(m1),
                                                   sums, total);
    s_mask[j] = m0;
    s_mask[j + 1] = m1;
    s_off[j] = excl;
    s_off[j + 1] = excl + __popc(m0);
    __syncthreads();
    // warp `warp` scatters words warp, warp + 32, ...; kScatterUnroll of
    // them with their park loads in flight together
    for (int k0 = warp; k0 < n; k0 += kScatterUnroll * (kBlock / 32)) {
      uint32_t m[kScatterUnroll];
      uint16_t v[kScatterUnroll];
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        const int k = k0 + u * (kBlock / 32);
        m[u] = k < n ? s_mask[k] : 0u;
        v[u] = (m[u] >> lane & 1u)
                   ? src[static_cast<long long>(w0 + k) * 32 + lane]
                   : uint16_t{0};
      }
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        const int k = k0 + u * (kBlock / 32);
        if (m[u] >> lane & 1u)
          region[cursor + s_off[k] + __popc(m[u] & below)] = v[u];
      }
    }
    cursor += total;
    __syncthreads();
  }
}
#else
// One block per (group, tile): compact the tile's parked `h | emit << 16`
// words, ranking 1024 flags at a time with a ballot and a block scan.
__global__ void __launch_bounds__(kBlock)
rans_encode_compact_u32(const uint32_t* __restrict__ park,
                        const long long* __restrict__ offs,
                        uint16_t* __restrict__ region, int G, int L,
                        int tile) {
  __shared__ int sums[2][33];
  const long long b = blockIdx.x;
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
#endif

bool valid_shape(int n_groups, int G, int L, int tile, int sym_bytes) {
#ifdef RC_VARIANT_INT32_SYMBOLS
  if (sym_bytes != 4) return false;
#else
  if (sym_bytes != 1 && sym_bytes != 2 && sym_bytes != 4) return false;
#endif
  return n_groups >= 1 && G >= kChainThreads && G % kChainThreads == 0 &&
         G % 32 == 0 && L >= 1 && tile >= 1 && L % tile == 0;
}

long long scratch_bytes(int n_groups, int G, int L) {
  const long long n = static_cast<long long>(n_groups) * G * L;
#ifdef RC_VARIANT_U32_PARK
  return 4 * n;
#else
  return (2 * n + 15) / 16 * 16 + n / 8;  // u16 park, then ballot words
#endif
}

template <typename T, bool kSync>
cudaError_t launch_chain(const T* rows, const int32_t* cum, int cum_stride,
                         uint64_t* states, int32_t* sizes, Park park,
                         Syncs syncs, int n_groups, int G, int L, int tile,
                         cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      static_cast<long long>(n_groups) * G / kChainThreads);
#ifdef RC_VARIANT_INT32_SYMBOLS
  rans_encode_chain<T, kLoadStep, kSync>
      <<<blocks, kChainThreads, 0, stream>>>(rows, cum, cum_stride, states,
                                             sizes, park, syncs, G, L, tile);
#else
  const bool vector =
      reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
      static_cast<long long>(L) * static_cast<long long>(sizeof(T)) % 16 == 0;
  if (vector)
    rans_encode_chain<T, kLoadVector, kSync>
        <<<blocks, kChainThreads, 0, stream>>>(rows, cum, cum_stride, states,
                                               sizes, park, syncs, G, L,
                                               tile);
  else
    rans_encode_chain<T, kLoadScalar, kSync>
        <<<blocks, kChainThreads, 0, stream>>>(rows, cum, cum_stride, states,
                                               sizes, park, syncs, G, L,
                                               tile);
#endif
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chain(const void* sym, const int32_t* cum, int cum_stride,
                         uint64_t* states, int32_t* sizes, Park park,
                         Syncs syncs, int n_groups, int G, int L, int tile,
                         cudaStream_t stream) {
  const T* rows = static_cast<const T*>(sym);
#ifdef RC_VARIANT_ALWAYS_SYNC
  const bool sync = true;
#else
  const bool sync = syncs.period != 0;
#endif
  return sync ? launch_chain<T, true>(rows, cum, cum_stride, states, sizes,
                                      park, syncs, n_groups, G, L, tile,
                                      stream)
              : launch_chain<T, false>(rows, cum, cum_stride, states, sizes,
                                       park, syncs, n_groups, G, L, tile,
                                       stream);
}

}  // namespace

extern "C" const char* rc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What a launch of this build needs: the scratch bytes, the chain's block
// size and the steps one symbol chunk covers (1: one load per step).
extern "C" int rc_rans_encode_plan(int n_groups, int G, int L, int sym_bytes,
                                   long long* scratch, int* chain_threads,
                                   int* chunk_steps) {
  if (!valid_shape(n_groups, G, L, 1, sym_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  *scratch = scratch_bytes(n_groups, G, L);
  *chain_threads = kChainThreads;
#ifdef RC_VARIANT_INT32_SYMBOLS
  *chunk_steps = 1;
#else
  *chunk_steps = kChunkBytes / sym_bytes;
#endif
  return 0;
}

// sym (n_groups*G, L) lane-major, sym_bytes 1 (u8), 2 (u16 bits) or 4
// (i32); cum the int32 padded table(s): (1024,) with cum_stride 0, or
// (n_groups, 1024) with cum_stride 1024; out: states (n_groups*G,) u64,
// sizes (n_groups, L/tile) int32 time order, offs (n_groups*L/tile + 1,)
// int64 region offsets, syncs (n_groups, (L/tile - 1)/sync_tiles, G) u64
// when sync_tiles > 0 (else unused), scratch (at least
// rc_rans_encode_plan's bytes), region (n_groups*G*L,) u16 capacity.
extern "C" int rc_rans_encode(const void* sym, int sym_bytes,
                              const int32_t* cum, int cum_stride,
                              uint64_t* states, int32_t* sizes,
                              long long* offs, uint64_t* syncs,
                              int sync_tiles, void* scratch,
                              long long scratch_len, uint16_t* region,
                              int n_groups, int G, int L, int tile,
                              cudaStream_t stream) {
  if (!valid_shape(n_groups, G, L, tile, sym_bytes) ||
      scratch_len < scratch_bytes(n_groups, G, L) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 ||
      (cum_stride != 0 && cum_stride != rc::kCumEntries) || sync_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sync = sync_tiles ? (L / tile - 1) / sync_tiles : 0;
  if (n_sync && !syncs) return static_cast<int>(cudaErrorInvalidValue);
  const Syncs sy{syncs, n_sync ? sync_tiles : 0, n_sync};
  const long long n = static_cast<long long>(n_groups) * G * L;
  Park park{static_cast<uint16_t*>(scratch),
            reinterpret_cast<uint32_t*>(static_cast<char*>(scratch) +
                                        (2 * n + 15) / 16 * 16),
            static_cast<uint32_t*>(scratch)};
  const long long n_tiles = static_cast<long long>(n_groups) * (L / tile);
  cudaError_t err = cudaMemsetAsync(sizes, 0, n_tiles * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sym_bytes == 1)
    err = launch_chain<uint8_t>(sym, cum, cum_stride, states, sizes, park,
                                sy, n_groups, G, L, tile, stream);
  else if (sym_bytes == 2)
    err = launch_chain<uint16_t>(sym, cum, cum_stride, states, sizes, park,
                                 sy, n_groups, G, L, tile, stream);
  else
    err = launch_chain<int32_t>(sym, cum, cum_stride, states, sizes, park,
                                sy, n_groups, G, L, tile, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_encode_offsets<<<1, kBlock, 0, stream>>>(sizes, offs, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
#ifdef RC_VARIANT_U32_PARK
  rans_encode_compact_u32<<<static_cast<unsigned>(n_tiles), kBlock, 0,
                            stream>>>(park.u32, offs, region, G, L, tile);
#else
  rans_encode_compact<<<static_cast<unsigned>(n_tiles), kBlock, 0, stream>>>(
      park.hw, park.mask, offs, region, G, L, tile);
#endif
  return static_cast<int>(cudaGetLastError());
}
