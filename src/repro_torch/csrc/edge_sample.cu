// Fused two-way edge sampler (Algorithm 2) for Hopper.
//
// Replaces the TPU kernel repro/kernels/edge_sample.py (_kernel /
// edge_sample_batched).  For each slot b and stratum s it draws the
// n_i = #{t < b_max : float(t) < b_i} edges of a joinable stratum, hashes
// draw t into each side's segment, gathers v1[i1] and v2[i2], forms
// f = v1 + v2 (or v1 * v2) and reduces to (n, sum f, sum f^2).  No [S, b_max]
// tile exists anywhere, and a masked draw reads no value (a stratum absent
// from a side has start == n there, and it draws nothing).
//
// Bound: operations.  A draw needs, per side, the rest of counter_hash
// after a table lookup (two multiply, shift, xor, multiply rounds and three
// xors, see finish_hash) and a remainder by the segment's count; its two
// 4-byte gathers fall in segments that L1 and L2 hold, and the function's
// bytes (each stratum's operands, the values its draws need) take far less
// time.  What holds the kernel is the issue of those instructions and the
// latency of each stratum's chain (record, hashes, gathers, reduction).
//
// Design:
// - Work is handed out by drawing stratum, not by stratum slot.  A plan
//   kernel (one thread per stratum) computes n_i as an integer, writes each
//   drawing stratum's operands into one 48-byte record of a compact list
//   (one atomic per warp and class reserves its records) and the zeros of
//   the strata that draw nothing, which never reach the sampler.  A
//   persistent sampler grid (SMs x resident blocks) walks the list: a
//   stratum of more than 256 draws takes a block of 4 warps, 8 draws a
//   thread per round, the others a warp each, so a full stratum spreads
//   over 4 warps and one of a few draws holds a warp, not a block.
// - Several gathers in flight: a thread takes 8 draws at once, in phases
//   (all 8 table words, all hashes, all 16 gathers, then the sums).
// - Work hoisted out of the draw: counter_hash's first round depends on the
//   draw counter and side alone, so the plan kernel tabulates it once per
//   launch ([b_max] pairs, read through L1); the xor-shifts where one
//   fmix32 round meets the next cancel (finish_hash), which leaves 8 of its
//   20 shifts and logic operations a side; h % c is a multiply-high, a
//   multiply-add, an add and a min, by a per-stratum magic number.
// - Deterministic sums: a thread adds its draws in a fixed order, a warp
//   reduces with a butterfly and a block adds its warps' sums in warp order.
//   Which block or warp takes a stratum does not change how its sums are
//   formed, so they depend neither on the grid nor on the batch: two
//   launches agree bit for bit and a B-slot launch equals B one-slot
//   launches.  No atomic touches a result, and n is the exact integer n_i.
//
// Layout: values float32 [B, n1] and [B, n2]; keys, start1, count1, start2,
// count2 int64 [B, S]; joinable bool [B, S]; b_i float32 [B, S]; seeds int64
// [B]; outputs n, sum_f, sum_f2 float32 [B, S]; scratch
// edge_sample_scratch_bytes(B, S, b_max) bytes, uninitialised.  Needs
// n1, n2 and B * S below 2^31 and b_max at most 2^24 (the wrapper checks).

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 128;          // both kernels' blocks
constexpr int kWarps = kThreads / 32;
constexpr int kDrawsPerLane = 8;       // a thread's draws at once
constexpr int kWarpDraws = 32 * kDrawsPerLane;
constexpr int kBlockDraws = kThreads * kDrawsPerLane;

// What the sampler needs of one drawing stratum (three 16-byte loads).  The
// segments are stored as addresses so that a gather's address is one
// multiply-add of the index onto them.
struct alignas(16) Record {
  const float* seg1;  // side 1's segment: values1 + b * n1 + start1
  const float* seg2;
  uint32_t key_mix;   // K and S of finish_hash
  uint32_t seed_mix;
  int32_t draws;      // n_i
  int32_t out;        // b * S + s
  uint32_t neg_count1;  // -count, for the remainder
  uint32_t magic1;
  uint32_t neg_count2;
  uint32_t magic2;
};

// Scratch: [0, 16) two counters (strata a block draws, strata a warp
// draws), then the hash table, then one record slot per stratum: a block's
// strata from the front, a warp's from the back.
struct Layout {
  int64_t table, records, bytes;
  Layout(int64_t strata, int64_t b_max)
      : table(16),
        records((16 + b_max * 8 + 15) & ~int64_t(15)),
        bytes(records + strata * (int64_t)sizeof(Record)) {}
};

// #{t < b_max : float(t) < b_i}, exactly: every t < b_max <= 2^24 is a float,
// so float(t) < b_i <=> t < ceil(b_i); 0 for b_i <= 0 and for NaN.
__device__ __forceinline__ int draw_count(float b_i, int b_max) {
  if (!(b_i > 0.f)) return 0;
  if (b_i >= (float)b_max) return b_max;
  return (int)ceilf(b_i);
}

// floor(2^32 / c) (2^32 - 1 for c = 1): with it h % c is exact for every
// 32-bit h after one correction, since the quotient it gives is q or q - 1.
__device__ __forceinline__ uint32_t magic_of(uint32_t c) {
  return c == 1u ? 0xFFFFFFFFu : (uint32_t)(0x100000000ull / c);
}

// h % c, given neg_c = -c and m = magic_of(c): r = h - q c is h % c or
// h % c + c, and as unsigned numbers r - c < r exactly when r >= c.
__device__ __forceinline__ uint32_t mod_magic(uint32_t h, uint32_t neg_c,
                                              uint32_t m) {
  const uint32_t r = h + __umulhi(h, m) * neg_c;
  return min(r, r + neg_c);
}

// fmix32 without its last step h ^= h >> 16.
__device__ __forceinline__ uint32_t fmix32_head(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h * 0xC2B2AE35u;
}

// x -> x ^ (x >> 16) is its own inverse on 32 bits, so where one fmix32 ends
// with it and the next, after an xor with y, begins with it, the pair is an
// xor with y ^ (y >> 16).  counter_hash(seed, key, t, side) is thus
//   x = head(t * GOLDEN + side) ^ K,  K = k ^ (k >> 16), k = key * 0x85EBCA6B
//   x = mid(x) ^ S,                   S = seed ^ (seed >> 16)
//   x = mid(x), return x ^ (x >> 16)
// where head() is the table's word and mid() is fmix32 without its first and
// last steps: 8 shifts and logic operations a side instead of 20.
__device__ __forceinline__ uint32_t fmix32_mid(uint32_t h) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h * 0xC2B2AE35u;
}

__device__ __forceinline__ uint32_t finish_hash(uint32_t head, uint32_t key_mix,
                                                uint32_t seed_mix) {
  const uint32_t h = fmix32_mid(fmix32_mid(head ^ key_mix) ^ seed_mix);
  return h ^ (h >> 16);
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;  // the same bits in every lane
}

// Adds draws t = tb + u * kStride + tid (u < U, t < t_end) of stratum r to
// acc = (sum f, sum f^2), in order of u: all U table words, then all hashes,
// then all 2U gathers, then the sums, so the loads of a phase are in flight
// together.  A draw at or past t_end loads nothing and adds zeros.
template <int U, int kStride>
__device__ __forceinline__ void draw_round(const Record& r,
                                           const uint2* __restrict__ table,
                                           int tb, int t_end, int tid,
                                           int product, float2& acc) {
  const uint2* row = table + tb + tid;
  const int left = t_end - tb - tid;  // this thread's draws: u * kStride < left
  uint2 h[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    h[u] = u * kStride < left ? __ldg(row + u * kStride) : make_uint2(0u, 0u);
  uint32_t i1[U], i2[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    i1[u] = mod_magic(finish_hash(h[u].x, r.key_mix, r.seed_mix),
                      r.neg_count1, r.magic1);
    i2[u] = mod_magic(finish_hash(h[u].y, r.key_mix, r.seed_mix),
                      r.neg_count2, r.magic2);
  }
  float a[U], c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = u * kStride < left;
    a[u] = ok ? __ldg(r.seg1 + i1[u]) : 0.f;
    c[u] = ok ? __ldg(r.seg2 + i2[u]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float f = u * kStride < left
                        ? (product ? __fmul_rn(a[u], c[u])
                                   : __fadd_rn(a[u], c[u]))
                        : 0.f;
    acc.x = __fadd_rn(acc.x, f);
    acc.y = __fmaf_rn(f, f, acc.y);
  }
}

__global__ void __launch_bounds__(kThreads) plan_kernel(
    const float* values1, const float* values2, int64_t n1, int64_t n2,
    const int64_t* __restrict__ keys, const int64_t* __restrict__ start1,
    const int64_t* __restrict__ count1, const int64_t* __restrict__ start2,
    const int64_t* __restrict__ count2, const bool* __restrict__ joinable,
    const float* __restrict__ b_i, const int64_t* __restrict__ seeds,
    int64_t total, int64_t num_strata, int b_max,
    float* __restrict__ n_out, float* __restrict__ sum_out,
    float* __restrict__ sum2_out, uint8_t* __restrict__ scratch,
    Layout lay) {
  auto* counters = reinterpret_cast<int*>(scratch);
  auto* table = reinterpret_cast<uint2*>(scratch + lay.table);
  auto* records = reinterpret_cast<Record*>(scratch + lay.records);
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // counter_hash's first round up to its last step, for both sides, once
  // per launch
  if (idx < b_max)
    table[idx] = make_uint2(fmix32_head((uint32_t)idx * repro::kGolden),
                            fmix32_head((uint32_t)idx * repro::kGolden + 1u));
  const bool in = idx < total;
  const int draws = in && joinable[idx] ? draw_count(b_i[idx], b_max) : 0;
  // a stratum of more draws than a warp takes at once goes to a block;
  // one atomic per warp and kind reserves the warp's record slots
  const bool big = draws > kWarpDraws;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned big_mask = __ballot_sync(0xffffffffu, big);
  const unsigned small_mask = __ballot_sync(0xffffffffu, draws > 0 && !big);
  int base = 0;
  if (lane == 0 && big_mask) base = atomicAdd(counters, __popc(big_mask));
  if (lane == 1 && small_mask)
    base = atomicAdd(counters + 1, __popc(small_mask));
  const int big_base = __shfl_sync(0xffffffffu, base, 0);
  const int small_base = __shfl_sync(0xffffffffu, base, 1);
  if (!in) return;
  if (draws == 0) {
    n_out[idx] = 0.f;
    sum_out[idx] = 0.f;
    sum2_out[idx] = 0.f;
    return;
  }
  const int64_t slot = idx / num_strata;
  const uint32_t c1 = (uint32_t)count1[idx], c2 = (uint32_t)count2[idx];
  const uint32_t k = (uint32_t)keys[idx] * 0x85EBCA6Bu;
  const uint32_t seed = (uint32_t)seeds[slot];
  Record r;
  r.seg1 = values1 + slot * n1 + start1[idx];
  r.seg2 = values2 + slot * n2 + start2[idx];
  r.key_mix = k ^ (k >> 16);
  r.seed_mix = seed ^ (seed >> 16);
  r.draws = draws;
  r.out = (int32_t)idx;
  r.neg_count1 = 0u - c1;
  r.magic1 = magic_of(c1);
  r.neg_count2 = 0u - c2;
  r.magic2 = magic_of(c2);
  records[big ? big_base + __popc(big_mask & below)
              : total - 1 - small_base - __popc(small_mask & below)] = r;
}

__global__ void __launch_bounds__(kThreads, 8) sample_kernel(
    int64_t total, int product,
    float* __restrict__ n_out, float* __restrict__ sum_out,
    float* __restrict__ sum2_out, const uint8_t* __restrict__ scratch,
    Layout lay) {
  const int* counters = reinterpret_cast<const int*>(scratch);
  const auto* table = reinterpret_cast<const uint2*>(scratch + lay.table);
  const auto* records = reinterpret_cast<const Record*>(scratch + lay.records);
  const int n_big = counters[0], n_small = counters[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float2 parts[2][kWarps];

  // strata of more than kWarpDraws draws: a block each, kDrawsPerLane draws
  // a thread per round, the warps' sums added in warp order; the next
  // stratum's record is in flight while this one draws
  Record next;
  if (blockIdx.x < n_big) next = records[blockIdx.x];
  for (int i = blockIdx.x, n = 0; i < n_big; i += gridDim.x, n ^= 1) {
    const Record r = next;
    if (i + gridDim.x < n_big) next = records[i + gridDim.x];
    float2 acc = make_float2(0.f, 0.f);
    for (int tb = 0; tb < r.draws; tb += kBlockDraws)
      draw_round<kDrawsPerLane, kThreads>(r, table, tb, r.draws, tid, product,
                                          acc);
    acc = warp_sum(acc);
    if (lane == 0) parts[n][warp] = acc;
    __syncthreads();  // parts[n] is written again two strata later
    if (tid == 0) {
      float2 all = parts[n][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        all.x += parts[n][w].x;
        all.y += parts[n][w].y;
      }
      n_out[r.out] = (float)r.draws;
      sum_out[r.out] = all.x;
      sum2_out[r.out] = all.y;
    }
  }

  // the others: a warp each, kDrawsPerLane draws a lane, or one for up to
  // 32 draws: most strata of skewed keys draw a few times, and 8 a lane
  // would hash 7 masked draws for each one drawn
  const int warps = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + warp; i < n_small; i += warps) {
    const Record r = records[total - 1 - i];
    float2 acc = make_float2(0.f, 0.f);
    if (r.draws <= 32)
      draw_round<1, 32>(r, table, 0, r.draws, lane, product, acc);
    else
      draw_round<kDrawsPerLane, 32>(r, table, 0, r.draws, lane, product, acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      n_out[r.out] = (float)r.draws;
      sum_out[r.out] = acc.x;
      sum2_out[r.out] = acc.y;
    }
  }
}

int sample_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sample_kernel,
                                                  kThreads, 0);
    cached[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// The sampler's grid: SMs x its resident blocks an SM.
extern "C" int64_t edge_sample_grid_blocks() { return sample_blocks(); }

extern "C" int64_t edge_sample_scratch_bytes(int64_t batch, int64_t num_strata,
                                             int64_t b_max) {
  return Layout(batch * num_strata, b_max).bytes;
}

extern "C" int edge_sample(const void* values1, const void* values2, int64_t n1,
                           int64_t n2, const void* keys, const void* start1,
                           const void* count1, const void* start2,
                           const void* count2, const void* joinable,
                           const void* b_i, const void* seeds, int64_t batch,
                           int64_t num_strata, int64_t b_max, int64_t product,
                           void* n_out, void* sum_out, void* sum2_out,
                           void* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = batch * num_strata;
  const Layout lay(total, b_max);
  cudaMemsetAsync(scratch, 0, 16, s);
  const int64_t plan_threads = total > b_max ? total : b_max;
  plan_kernel<<<(unsigned)((plan_threads + kThreads - 1) / kThreads), kThreads,
                0, s>>>(
      (const float*)values1, (const float*)values2, n1, n2,
      (const int64_t*)keys, (const int64_t*)start1, (const int64_t*)count1,
      (const int64_t*)start2, (const int64_t*)count2, (const bool*)joinable,
      (const float*)b_i, (const int64_t*)seeds, total, num_strata, (int)b_max,
      (float*)n_out, (float*)sum_out, (float*)sum2_out, (uint8_t*)scratch,
      lay);
  sample_kernel<<<sample_blocks(), kThreads, 0, s>>>(
      total, (int)product, (float*)n_out, (float*)sum_out, (float*)sum2_out,
      (const uint8_t*)scratch, lay);
  return (int)cudaGetLastError();
}
