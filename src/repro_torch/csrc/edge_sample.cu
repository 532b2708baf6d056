// Fused two-way edge sampler (Algorithm 2) for Hopper.
//
// Replaces the TPU kernel repro/kernels/edge_sample.py (_kernel /
// edge_sample_batched).  One warp per (slot, stratum); only joinable strata
// draw.  Lane l takes draws t = l, l + 32, ... while t < b_max and
// float(t) < b_i: it hashes (seed, key, t, side) into each side's segment,
// gathers v1[i1] and v2[i2], forms f = v1 + v2 (or v1 * v2) and keeps n,
// sum f and sum f^2 in registers; a shuffle reduction folds the 32 lanes.
// No [S, b_max] tile exists anywhere, and no value is read for a masked
// draw (a stratum absent from a side has start == n there).
//
// Bound: bytes.  Each draw is two random 4-byte gathers from the sorted
// value arrays (global memory through L2); per stratum it reads 45 bytes of
// operands and writes 12.  The TPU kernel pins both value arrays in VMEM
// (<= 8 MiB); at 2^24 rows per side they are 64 MiB each, so here they stay
// in global memory.
//
// Layout: values float32 [B, n1] and [B, n2]; keys, start1, count1, start2,
// count2 int64 [B, S]; joinable bool [B, S]; b_i float32 [B, S]; seeds int64
// [B]; outputs n, sum_f, sum_f2 float32 [B, S].

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ uint32_t segment_count(int64_t c) {
  return c > 1 ? (uint32_t)c : 1u;
}

__global__ void edge_sample_kernel(
    const float* __restrict__ values1, const float* __restrict__ values2,
    int64_t n1, int64_t n2, const int64_t* __restrict__ keys,
    const int64_t* __restrict__ start1, const int64_t* __restrict__ count1,
    const int64_t* __restrict__ start2, const int64_t* __restrict__ count2,
    const bool* __restrict__ joinable, const float* __restrict__ b_i,
    const int64_t* __restrict__ seeds, int64_t num_strata, int b_max,
    int product, float* __restrict__ n_out, float* __restrict__ sum_out,
    float* __restrict__ sum2_out) {
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t b = blockIdx.y;
  if (s >= num_strata) return;  // the whole warp leaves together
  const int64_t idx = b * num_strata + s;
  float cnt = 0.f, sum = 0.f, sum2 = 0.f;
  if (joinable[idx]) {
    const float bi = b_i[idx];
    const uint32_t seed = (uint32_t)seeds[b];
    const uint32_t key = (uint32_t)keys[idx];
    const float* v1 = values1 + b * n1 + start1[idx];
    const float* v2 = values2 + b * n2 + start2[idx];
    const uint32_t c1 = segment_count(count1[idx]);
    const uint32_t c2 = segment_count(count2[idx]);
    for (int t = lane; t < b_max && (float)t < bi; t += 32) {
      const uint32_t h1 = repro::counter_hash(seed, key, (uint32_t)t, 0u);
      const uint32_t h2 = repro::counter_hash(seed, key, (uint32_t)t, 1u);
      const float a = __ldg(v1 + h1 % c1);
      const float c = __ldg(v2 + h2 % c2);
      const float f = product ? __fmul_rn(a, c) : __fadd_rn(a, c);
      cnt += 1.f;
      sum += f;
      sum2 += __fmul_rn(f, f);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    sum2 += __shfl_down_sync(0xffffffffu, sum2, off);
  }
  if (lane == 0) {
    n_out[idx] = cnt;
    sum_out[idx] = sum;
    sum2_out[idx] = sum2;
  }
}

}  // namespace

extern "C" int edge_sample(const void* values1, const void* values2, int64_t n1,
                           int64_t n2, const void* keys, const void* start1,
                           const void* count1, const void* start2,
                           const void* count2, const void* joinable,
                           const void* b_i, const void* seeds, int64_t batch,
                           int64_t num_strata, int64_t b_max, int64_t product,
                           void* n_out, void* sum_out, void* sum2_out,
                           void* stream) {
  const dim3 grid((unsigned)((num_strata + kWarps - 1) / kWarps),
                  (unsigned)batch);
  edge_sample_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)values1, (const float*)values2, n1, n2,
      (const int64_t*)keys, (const int64_t*)start1, (const int64_t*)count1,
      (const int64_t*)start2, (const int64_t*)count2, (const bool*)joinable,
      (const float*)b_i, (const int64_t*)seeds, num_strata, (int)b_max,
      (int)product, (float*)n_out, (float*)sum_out, (float*)sum2_out);
  return (int)cudaGetLastError();
}
