// Join-filter membership probe for Hopper.
//
// Replaces the TPU kernel repro/kernels/bloom_probe.py (_kernel /
// bloom_probe_batched).  One thread per (slot, key): it hashes the key,
// loads the key's 32-byte block as two 16-byte loads and writes whether every
// lane holds the key's bit.  Each slot probes its own filter.
//
// Bound: bytes.  Each key reads 8 bytes of key, one 32-byte sector of the
// filter and writes 1 byte.  The TPU kernel pins the whole filter in VMEM
// (<= 8 MiB); a Hopper block has at most 227 KB of shared memory, and the
// join filter at 2^24 keys is 32 MiB, so this kernel reads the filter
// through the 50 MB L2 instead of staging it.
//
// Layout: words uint32 [B, num_blocks, 8] (16-byte aligned), keys int64
// [B, n] (uint32 values), seeds int64 [B], out bool [B, n].

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bloom_probe_kernel(const uint32_t* __restrict__ words,
                                   const int64_t* __restrict__ keys,
                                   const int64_t* __restrict__ seeds,
                                   bool* __restrict__ out, int64_t n,
                                   int64_t num_blocks) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (i >= n) return;
  const int64_t row = b * n + i;
  const uint32_t h = repro::hash2((uint32_t)keys[row], (uint32_t)seeds[b]);
  const int64_t blk = h & (uint32_t)(num_blocks - 1);
  const uint4* p = reinterpret_cast<const uint4*>(words + (b * num_blocks + blk) * 8);
  const uint4 lo = __ldg(p);
  const uint4 hi = __ldg(p + 1);
  uint32_t m[8];
  repro::lane_masks(h, m);
  out[row] = (lo.x & m[0]) == m[0] && (lo.y & m[1]) == m[1] &&
             (lo.z & m[2]) == m[2] && (lo.w & m[3]) == m[3] &&
             (hi.x & m[4]) == m[4] && (hi.y & m[5]) == m[5] &&
             (hi.z & m[6]) == m[6] && (hi.w & m[7]) == m[7];
}

}  // namespace

extern "C" int bloom_probe(const void* words, const void* keys,
                           const void* seeds, void* out, int64_t batch,
                           int64_t n, int64_t num_blocks, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)batch);
  bloom_probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int64_t*)keys, (const int64_t*)seeds,
      (bool*)out, n, num_blocks);
  return (int)cudaGetLastError();
}
