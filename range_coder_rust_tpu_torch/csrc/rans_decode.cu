// rans16 decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_rans_decode_kernel` of
// range_coder_rust_tpu/kernels/rans_decode.py:75 (wrapper rans_decode_tiled,
// with the in-kernel helpers _lane_prefix_flat, _lookup_rows and
// _select_by of kernels/vreg.py folded in).
//
// What it computes, per group of G lanes: prime each lane's state from
// the preamble; then per step t = 0 .. L-1 and lane,
//   slot = x & 0xFFFF;  s = largest s with cum[s] <= slot;
//   x = c[s] * (x >> 16) + slot - cum[s];
// and every lane with x < 2^32 refills one halfword, read from the
// group's region at cursor + (the lane's exclusive rank among the
// refilling lanes, in lane order); the cursor then advances by the number
// of refills.  A read past the group's region gives 0.  The symbols are
// written lane-major, (group*G + lane, t), in u8, u16 bits or i32.  The
// cum table is one for all groups, or one per group (the adaptive mode;
// `cum_stride` 1024): each block builds its tables from its own group's.
//
// What bounds it on the H100: the serial chain.  Step t+1 needs every
// lane's state after step t, and a lane's refill position needs the refill
// flags of all lanes before it, so each group is one block that meets at a
// barrier on every step: L dependent steps per group (32768 on the 256 MB
// main path, 4 groups = 4 blocks on 132 SMs).  The bytes moved (states and
// region in, symbols out) would take 0.13 ms at the memory's rate; the
// time is the number of steps times the cost of one step, and the design
// cuts that cost at its four parts.  scripts_torch/decode_variants.py
// times the kernel with each of them reverted (the RC_VARIANT_* macros
// below, which only that script defines) on the main path; PERF.md has
// what each saves:
//
// 1. Symbol stores.  A lane's symbols are a row of L; storing one symbol
//    per lane per step makes every warp store touch 32 rows L bytes apart.
//    Here each lane packs its symbols into a 32-bit word in a register;
//    every full word goes to a shared stage (step-major words, one vector
//    store per thread).  The stage has two halves of kHalf steps (16 bytes
//    of each row); in the kHalf steps after a half fills, while the other
//    half fills, each step writes G / kHalf of its rows out with one
//    16-byte store per row (so no burst, and no extra barrier).  The
//    write-out and the ring copies of item 3 depend only on the cursor at
//    the step's start, so they run before the barrier, beside the decode.  A group too
//    wide for the stage beside the tables and the ring (G * 32 bytes;
//    G >= 8192 at u8, G >= 4096 at u16 with A > 256) runs the DIRECT-STORE
//    variant, chosen by shape in launch(): one store per lane per step
//    straight to the output.
// 2. Symbol search.  A 65536-entry slot -> symbol table in shared memory
//    (u8 for A <= 256, else u16), built by each block from the cum table:
//    slot i holds searchsorted(cum, i, 'right') - 1, so zero-width ranges
//    (zero-frequency symbols) are never returned.  One shared load then
//    gives s, and a second gives cum[s] and c[s] - 1 packed in one word.
// 3. Refill reads.  The group's halfwords are copied ahead of the cursor
//    into a shared ring with cp.async (16-byte units, waited for kLead
//    steps later, the ring sized for the worst case of G halfwords a step
//    where shared memory allows), so the read on the serial chain is a
//    shared load, and the lanes' loads are independent.  Units past
//    the region's end are zero-filled; units the region only partly covers
//    (its two ends, or a region not 16-byte aligned) are read halfword by
//    halfword inside [grp_off[g], grp_off[g+1]).  A position the ring does
//    not hold yet (a ring narrower than the worst case) is read from
//    device memory directly, with the same bounds.
// 4. One barrier per step.  Each warp ranks its refills with one ballot
//    per lane a thread and writes its count into one of two alternating
//    arrays; after the single __syncthreads every warp sums the <= 32
//    counts itself with two warp reductions.
//
// Each thread owns G / blockDim contiguous lanes in registers: one lane up
// to 1024 lanes, else kWideLanes or more (a 2048-lane group is one block of
// 512 threads).  States are below 2^48 (the container's preamble is
// 48-bit), so x >> 16 fits 32 bits.  What is left is the chain itself,
// about 0.95 us a step on the main path; filling the card (more, narrower
// groups, or clusters) is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "rc_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
//: lanes a thread owns once a group is wider than kMaxThreads: a 2048-lane
//: group runs as 512 threads of 4 lanes, faster on the H100 than 1024 of 2
//: or 256 of 8 (scripts_torch/decode_variants.py, lanes_2 and lanes_8)
#ifndef RC_VARIANT_WIDE_LANES
#define RC_VARIANT_WIDE_LANES 4
#endif
constexpr int kWideLanes = RC_VARIANT_WIDE_LANES;
//: slot -> symbol table entries (the total frequency, 2^16)
constexpr int kSlots = 1 << 16;
//: steps between a ring copy's issue and the first step that may read it
constexpr int kLead = 4;
//: ring heads kept: steps t - kLead .. t, and one more so that a step's
//: write never meets a slow thread's read of the step before
constexpr int kHeadSlots = kLead + 2;
//: room for the ready heads (long long each)
constexpr int kHeadCap = 8;
static_assert(kHeadSlots <= kHeadCap, "too few ready-head slots");
//: bytes of one lane's row that one stage half holds (one 16-byte store)
constexpr int kRowBytes = 16;

// Shared memory, in this order (every offset a multiple of 16 bytes):
// slot table (kSlots SlotT), cum (1024 u32), packed cum (1024 u32), warp
// counts (2 x 32 int), ready heads (kHeadCap long long), ring (ring_hw u16),
// stage (2 halves x G lanes x kRowBytes; staged variant only).
__host__ __device__ constexpr size_t fixed_smem(size_t slot_bytes) {
  return kSlots * slot_bytes + 2 * rc::kCumEntries * 4 + 2 * 32 * 4 +
         kHeadCap * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy ring units [u_begin, u_end) (unit u = halfwords [8u, 8u + 8) of
// the region buffer) into the ring, the block's threads sharing the units.
// Only halfwords inside [lo_off, hi_off) are read; the rest are 0.
__device__ __forceinline__ void fill_units(uint16_t* ring, uint32_t ring_mask,
                                           const uint16_t* region,
                                           long long lo_off, long long hi_off,
                                           long long u_begin, long long u_end,
                                           bool vec_ok) {
  for (long long u = u_begin + threadIdx.x; u < u_end; u += blockDim.x) {
    const long long a0 = u << 3;
    uint16_t* dst = ring + (static_cast<uint32_t>(a0) & ring_mask);
    if (vec_ok && a0 >= lo_off && a0 + 8 <= hi_off) {
      cp_async16(dst, region + a0);
    } else if (a0 >= hi_off) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long a = a0 + k;
        dst[k] = (a >= lo_off && a < hi_off) ? region[a] : uint16_t(0);
      }
    }
  }
}

// Store N consecutive 32-bit words with the widest aligned stores their
// size allows (dst is aligned to 4 * N rounded down to a power of two).
template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<uint4*>(dst + i) = make_uint4(v[i], v[i + 1],
                                                      v[i + 2], v[i + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<uint2*>(dst + i) = make_uint2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

// Write n steps of one lane's symbols to dst from the word stage: `src`
// points at the lane's first word of a stage half; word k of the half is
// src[k * G].  A full, aligned half is one 16-byte store.
template <typename OutT>
__device__ __forceinline__ void flush_row(OutT* dst, const uint32_t* src,
                                          int G, int n) {
  constexpr int kWidth = static_cast<int>(sizeof(OutT));
  constexpr int kSpw = 4 / kWidth;  // steps per word
  if (n == kRowBytes / kWidth &&
      (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(src[0], src[G], src[2 * G], src[3 * G]);
    return;
  }
  for (int k = 0; k < n; ++k)
    dst[k] = static_cast<OutT>(src[(k / kSpw) * G] >> (8 * kWidth * (k % kSpw)));
}

template <int LPT, typename OutT, typename SlotT>
__global__ void __launch_bounds__(kMaxThreads)
rans_decode_kernel(const uint64_t* __restrict__ states,
                   const uint16_t* __restrict__ region,
                   const long long* __restrict__ grp_off,
                   const int32_t* __restrict__ cum_g, int cum_stride,
                   OutT* __restrict__ out, long long region_len, int G,
                   long long L, int a_count, int ring_hw, bool staged) {
  constexpr int kWidth = static_cast<int>(sizeof(OutT));
  constexpr int kSpw = 4 / kWidth;                    // steps per word
  constexpr int kHalfWords = kRowBytes / 4;           // words per half row
  constexpr int kHalf = kHalfWords * kSpw;            // steps per half
  extern __shared__ __align__(16) unsigned char smem[];
  SlotT* slot_sym = reinterpret_cast<SlotT*>(smem);
  uint32_t* cum = reinterpret_cast<uint32_t*>(smem + kSlots * sizeof(SlotT));
  uint32_t* cum_pk = cum + rc::kCumEntries;
  int* counts = reinterpret_cast<int*>(cum_pk + rc::kCumEntries);
  long long* heads = reinterpret_cast<long long*>(counts + 2 * 32);
  uint16_t* ring = reinterpret_cast<uint16_t*>(heads + kHeadCap);
  // the stage: word q of lane l at stage[q * G + l], 2 halves of
  // kHalfWords words (kHalf steps) each
  uint32_t* stage = reinterpret_cast<uint32_t*>(ring + ring_hw);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  const long long g = blockIdx.x;
  // the tables: cum, packed (cum[s] | (c[s] - 1) << 16), slot -> symbol
  rc::load_cum(cum, cum_g + g * cum_stride);
  for (int s = tid; s < rc::kCumEntries; s += nthreads) {
    const uint32_t lo = cum[s];
    const uint32_t hi = s + 1 < rc::kCumEntries ? cum[s + 1] : lo;
    cum_pk[s] = (lo & 0xFFFFu) | ((hi - lo - 1u) << 16);
  }
  for (int i = tid; i < kSlots; i += nthreads) {
    int lo = 0, hi = a_count;  // cum[lo] <= i < cum[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= static_cast<uint32_t>(i)) lo = mid; else hi = mid;
    }
    slot_sym[i] = static_cast<SlotT>(lo);
  }

  // the group's region, clamped to the buffer whatever the offsets say
  const long long lo_off = min(max(grp_off[g], 0ll), region_len);
  const long long hi_off = min(max(grp_off[g + 1], lo_off), region_len);
  const bool vec_ok = (reinterpret_cast<uintptr_t>(region) & 15u) == 0;
  const uint32_t ring_mask = static_cast<uint32_t>(ring_hw - 1);
  // pos: absolute region index of the cursor; issued: the next ring unit.
  // Step t copies up to ring_hw - 16 halfwords past the cursor of step
  // t - 1 (prev), whose reads a slow thread may still be making: no copy
  // lands on a unit that is still to be read (ring_hw is a power of two)
  long long pos = lo_off, prev = lo_off;
  long long issued = lo_off >> 3;
  {
    const long long target = (prev + ring_hw - 9) >> 3;
    fill_units(ring, ring_mask, region, lo_off, hi_off, issued, target,
               vec_ok);
    issued = max(issued, target);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (tid < kHeadSlots) heads[tid] = issued << 3;

  const long long lane0 = g * G + static_cast<long long>(tid) * LPT;
  uint64_t x[LPT];
  uint32_t pack[LPT];  // the steps of the current stage word, newest on top
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    x[j] = states[lane0 + j];
    pack[j] = 0;
  }
  OutT* o = out + lane0 * L;  // direct-store variant: this thread's rows
  OutT* rows = out + g * G * L;
  // the rolling write-out: in the kHalf steps after a stage half fills,
  // each step writes G / kHalf of its lane rows; lane l by thread
  // l % nthreads, fb = that thread for the step's first lane
  const int lanes_per_step = G / kHalf;
  int fb = 0;
  __syncthreads();

  int st = 0;  // t % (2 * kHalf): the step's place in the stage
  int hs = 0;  // t % kHeadSlots
  for (long long t = 0; t < L; ++t) {
    const int buf = static_cast<int>(t & 1);
    // Before the barrier, beside the decode: what depends only on the
    // cursor at the step's start.  The ring copies (one commit group a
    // step) and their head; the head of step t - kLead, whose copies the
    // wait below completes, bounds what the refills may read from the ring
    {
      const long long target = (prev + ring_hw - 9) >> 3;
      if (target > issued) {
        fill_units(ring, ring_mask, region, lo_off, hi_off, issued, target,
                   vec_ok);
        issued = target;
      }
      cp_async_commit();
      if (tid == 0) heads[hs] = issued << 3;
    }
    const int hr = hs + kHeadSlots - kLead;
#ifdef RC_VARIANT_DEVICE_REFILL
    const long long head = 0;  // every refill from device memory
#else
    const long long head = heads[hr >= kHeadSlots ? hr - kHeadSlots : hr];
#endif
    // the rolling write-out of the stage half that filled before this half
    if (staged && t >= kHalf) {
      const int k = st & (kHalf - 1);  // steps since it filled, less one
      const int half = (st / kHalf) ^ 1;
      const long long t0 = t - k - kHalf;
      int r = tid - fb;
      if (r < 0) r += nthreads;
      for (int l = k * lanes_per_step + r; l < (k + 1) * lanes_per_step;
           l += nthreads)
        flush_row<OutT>(rows + l * L + t0, stage + half * kHalfWords * G + l,
                        G, kHalf);
      fb = k == kHalf - 1 ? 0 : fb + lanes_per_step;
      if (fb >= nthreads) fb -= nthreads;
    }

    bool need[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t slot = static_cast<uint32_t>(x[j]) & 0xFFFFu;
#ifdef RC_VARIANT_BINARY_SEARCH
      int lo = 0, hi = a_count;  // cum[lo] <= slot < cum[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] <= slot) lo = mid; else hi = mid;
      }
      const uint32_t s = lo;
#else
      const uint32_t s = slot_sym[slot];
#endif
      const uint32_t e = cum_pk[s];
      const uint32_t cs = e & 0xFFFFu;
      const uint32_t c = (e >> 16) + 1u;
      // x < 2^48, so x >> 16 fits 32 bits: one 32 x 32 -> 64 multiply-add
      x[j] = static_cast<uint64_t>(c) * static_cast<uint32_t>(x[j] >> 16) +
             (slot - cs);
      need[j] = (x[j] >> 32) == 0;
      if (staged) {
        const uint32_t v = static_cast<uint32_t>(static_cast<OutT>(s));
        if constexpr (kWidth == 4) pack[j] = v;
        else pack[j] = (pack[j] >> (8 * kWidth)) | (v << (32 - 8 * kWidth));
      } else {
        o[j * L + t] = static_cast<OutT>(s);
      }
    }
    if (staged && (st % kSpw) == kSpw - 1)
      store_words<LPT>(stage + (st / kSpw) * G + tid * LPT, pack);
    // rank of this thread's first refill within its warp, and the warp's
    // refill count
    int pre = 0, wcnt = 0;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, need[j]);
      pre += __popc(b & below);
      wcnt += __popc(b);
    }
    if (lane == 0) counts[buf * 32 + warp] = wcnt;
    cp_async_wait<kLead>();  // this thread's copies of step t - kLead
    __syncthreads();

    // the warp's offset and the block's total, from the warp counts
    const int v = lane < nwarps ? counts[buf * 32 + lane] : 0;
    const int woff = __reduce_add_sync(0xffffffffu, lane < warp ? v : 0);
    const int total = __reduce_add_sync(0xffffffffu, v);
#ifdef RC_VARIANT_TWO_BARRIERS
    __syncthreads();
#endif
    const int in_ring =
        static_cast<int>(max(min(head - pos, 0x7fffffffll), 0ll));
    // refills at pos + off: from the ring below in_ring, else (rarely, a
    // ring narrower than the worst case) from device memory; the lanes'
    // loads are independent
    const uint32_t pos_lo = static_cast<uint32_t>(pos);
    int off[LPT];
    off[0] = woff + pre;
#pragma unroll
    for (int j = 1; j < LPT; ++j) off[j] = off[j - 1] + need[j - 1];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const bool hit = need[j] && off[j] < in_ring;
      const uint32_t h = hit ? ring[(pos_lo + off[j]) & ring_mask] : 0u;
      slow |= need[j] && !hit;
      x[j] = need[j] ? (x[j] << 16) | h : x[j];
    }
    if (slow) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const long long a = pos + off[j];
        if (need[j] && off[j] >= in_ring && a < hi_off) x[j] |= region[a];
      }
    }
    hs = hs == kHeadSlots - 1 ? 0 : hs + 1;
    st = (st + 1) & (2 * kHalf - 1);
    prev = pos;
    pos += total;
  }
  cp_async_wait<0>();

  if (staged) {
    // the last, partial word; then what the rolling write-out left: the
    // rest of the last full half, and the ragged half after it
    const int rem = static_cast<int>(L % kSpw);
    if (rem) {
      const int q = static_cast<int>((L - 1) % (2 * kHalf)) / kSpw;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        stage[q * G + tid * LPT + j] = pack[j] >> (8 * kWidth * (kSpw - rem));
    }
    __syncthreads();
    const int k_last = static_cast<int>(L % kHalf);
    if (L >= kHalf) {
      const long long tc = L - 1 - k_last;
      const int half = static_cast<int>(tc % (2 * kHalf)) / kHalf;
      for (int l = k_last * lanes_per_step + tid; l < G; l += nthreads)
        flush_row<OutT>(rows + l * L + tc - kHalf + 1,
                        stage + half * kHalfWords * G + l, G, kHalf);
    }
    if (k_last) {
      const long long t0 = L - k_last;
      const int half = static_cast<int>(t0 % (2 * kHalf)) / kHalf;
      for (int l = tid; l < G; l += nthreads)
        flush_row<OutT>(rows + l * L + t0, stage + half * kHalfWords * G + l,
                        G, k_last);
    }
  }
}

constexpr long long pow2_ceil(long long v) {
  long long p = 1;
  while (p < v) p <<= 1;
  return p;
}

constexpr long long pow2_floor(long long v) {
  long long p = 1;
  while (p * 2 <= v) p <<= 1;
  return p;
}

// Threads per block: one per lane up to kMaxThreads lanes, else
// kWideLanes (or more) contiguous lanes a thread.
int threads_for(int G) {
  if (G <= kMaxThreads) return G;
  return G / kWideLanes < kMaxThreads ? G / kWideLanes : kMaxThreads;
}

// The shape's variant and shared memory: staged unless the stage leaves
// less than a G-halfword ring; the ring is the worst case for kLead steps,
// or the largest power of two that fits.
struct Plan {
  int staged;
  int ring_hw;
  int smem;
};

int plan_for(int G, size_t slot_bytes, Plan* plan) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fixed = static_cast<long long>(fixed_smem(slot_bytes));
  const long long stage = 2LL * kRowBytes * G;
  const long long ring_worst = pow2_ceil((kLead + 2LL) * G + 16);
  const long long ring_min = pow2_ceil(G > 64 ? G : 64);
#ifdef RC_VARIANT_DIRECT_STORES
  const bool staged = false;
#else
  const bool staged = fixed + stage + 2 * ring_min <= max_smem;
#endif
  const long long avail = max_smem - fixed - (staged ? stage : 0);
  if (avail < 2 * 64) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ring = ring_worst < pow2_floor(avail / 2)
                             ? ring_worst : pow2_floor(avail / 2);
  plan->staged = staged;
  plan->ring_hw = static_cast<int>(ring);
  plan->smem = static_cast<int>(fixed + 2 * ring + (staged ? stage : 0));
  return 0;
}

template <typename OutT, typename SlotT>
int launch(const uint64_t* states, const uint16_t* region,
           const long long* grp_off, const int32_t* cum, int cum_stride,
           void* out, long long region_len, int n_groups, int G, long long L,
           int a_count, cudaStream_t stream) {
  const int threads = threads_for(G);
  const int lpt = G / threads;
  Plan plan;
  const int perr = plan_for(G, sizeof(SlotT), &plan);
  if (perr) return perr;
  OutT* o = static_cast<OutT*>(out);
  cudaError_t err = cudaSuccess;
#define RC_DECODE_CASE(N)                                                   \
  case N: {                                                                 \
    auto kern = rans_decode_kernel<N, OutT, SlotT>;                         \
    err = cudaFuncSetAttribute(                                             \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);      \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    kern<<<n_groups, threads, plan.smem, stream>>>(                         \
        states, region, grp_off, cum, cum_stride, o, region_len, G, L,      \
        a_count, plan.ring_hw, plan.staged != 0);                           \
    break;                                                                  \
  }
  switch (lpt) {
    RC_DECODE_CASE(1)
    RC_DECODE_CASE(2)
    RC_DECODE_CASE(4)
    RC_DECODE_CASE(8)
    RC_DECODE_CASE(16)
    RC_DECODE_CASE(32)
    RC_DECODE_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RC_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int G, long long L, int a_count) {
  return !(G < 32 || G % 32 || (G > kMaxThreads && G % kMaxThreads) ||
           G > 64 * kMaxThreads || L < 1 || a_count < 1 ||
           a_count >= rc::kCumEntries);
}

size_t slot_bytes_for(int a_count, int out_bytes) {
  return out_bytes == 1 && a_count <= 256 ? 1 : 2;
}

}  // namespace

// states (n_groups*G,) u64 preamble; region (region_len,) u16: the
// groups' halfwords concatenated, group g at [grp_off[g], grp_off[g+1]);
// cum the int32 padded table(s): (1024,) with cum_stride 0, or
// (n_groups, 1024) with cum_stride 1024; out (n_groups*G, L) of out_bytes
// (1: u8, 2: u16, 4: i32).
extern "C" int rc_rans_decode(const uint64_t* states, const uint16_t* region,
                              long long region_len, const long long* grp_off,
                              const int32_t* cum, int cum_stride, void* out,
                              int n_groups, int G, long long L, int a_count,
                              int out_bytes, cudaStream_t stream) {
  if (n_groups < 1 || !valid_shape(G, L, a_count) ||
      (cum_stride != 0 && cum_stride != rc::kCumEntries))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = slot_bytes_for(a_count, out_bytes) == 1;
  switch (out_bytes) {
    case 1:
      return narrow
          ? launch<uint8_t, uint8_t>(states, region, grp_off, cum,
                                     cum_stride, out, region_len, n_groups,
                                     G, L, a_count, stream)
          : launch<uint8_t, uint16_t>(states, region, grp_off, cum,
                                      cum_stride, out, region_len, n_groups,
                                      G, L, a_count, stream);
    case 2:
      return launch<uint16_t, uint16_t>(states, region, grp_off, cum,
                                        cum_stride, out, region_len,
                                        n_groups, G, L, a_count, stream);
    case 4:
      return launch<int32_t, uint16_t>(states, region, grp_off, cum,
                                       cum_stride, out, region_len,
                                       n_groups, G, L, a_count, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The decode's plan for a shape: staged (1) or direct-store (0) variant,
// ring halfwords, dynamic shared memory bytes and threads per block.
extern "C" int rc_rans_decode_plan(int G, int a_count, int out_bytes,
                                   int* staged, int* ring_hw, int* smem,
                                   int* threads) {
  if (!valid_shape(G, 1, a_count) ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const int err = plan_for(G, slot_bytes_for(a_count, out_bytes), &plan);
  if (err) return err;
  *staged = plan.staged;
  *ring_hw = plan.ring_hw;
  *smem = plan.smem;
  *threads = threads_for(G);
  return 0;
}
