// Bloom filter build for Hopper: hash and commit in one pass.
//
// Replaces the TPU kernel repro/kernels/bloom_build.py (_kernel /
// bloom_hashes_batched) together with the scatter-OR commit its wrapper runs
// (repro/core/bloom.py scatter_or).  One thread per (slot, key): it hashes
// the key, picks its 256-bit block and ORs one bit into each of the block's
// 8 words with atomicOr.  OR does not depend on order, so the words are the
// same bits whatever order the threads commit in.
//
// Bound: bytes.  Each key reads 8 bytes of key and 1 of validity, and
// touches one 32-byte block of a filter that fits in L2 (32 MiB at 2^24
// keys), so the atomics resolve in L2; the words go to memory once.
//
// Layout: keys int64 [B, n] (uint32 values), valid bool [B, n], seeds int64
// [B], words uint32 [B, num_blocks, 8] zeroed by the caller.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bloom_build_kernel(const int64_t* __restrict__ keys,
                                   const bool* __restrict__ valid,
                                   const int64_t* __restrict__ seeds,
                                   uint32_t* __restrict__ words, int64_t n,
                                   int64_t num_blocks) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (i >= n) return;
  const int64_t row = b * n + i;
  if (!valid[row]) return;
  const uint32_t h = repro::hash2((uint32_t)keys[row], (uint32_t)seeds[b]);
  const int64_t blk = h & (uint32_t)(num_blocks - 1);
  uint32_t m[8];
  repro::lane_masks(h, m);
  uint32_t* w = words + (b * num_blocks + blk) * 8;
#pragma unroll
  for (int l = 0; l < 8; ++l) atomicOr(w + l, m[l]);
}

// The hash half alone (block index and lane masks per key, no commit), so
// tests can hold it against the TPU kernel's outputs.
__global__ void bloom_hashes_kernel(const int64_t* __restrict__ keys,
                                    const int64_t* __restrict__ seeds,
                                    int64_t* __restrict__ blk_out,
                                    int64_t* __restrict__ masks_out, int64_t n,
                                    int64_t num_blocks) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (i >= n) return;
  const int64_t row = b * n + i;
  const uint32_t h = repro::hash2((uint32_t)keys[row], (uint32_t)seeds[b]);
  blk_out[row] = h & (uint32_t)(num_blocks - 1);
  uint32_t m[8];
  repro::lane_masks(h, m);
#pragma unroll
  for (int l = 0; l < 8; ++l) masks_out[row * 8 + l] = m[l];
}

dim3 grid_for(int64_t batch, int64_t n) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)batch);
}

}  // namespace

extern "C" int bloom_build(const void* keys, const void* valid,
                           const void* seeds, void* words, int64_t batch,
                           int64_t n, int64_t num_blocks, void* stream) {
  bloom_build_kernel<<<grid_for(batch, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const bool*)valid, (const int64_t*)seeds,
      (uint32_t*)words, n, num_blocks);
  return (int)cudaGetLastError();
}

extern "C" int bloom_hashes(const void* keys, const void* seeds, void* blk,
                            void* masks, int64_t batch, int64_t n,
                            int64_t num_blocks, void* stream) {
  bloom_hashes_kernel<<<grid_for(batch, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int64_t*)seeds, (int64_t*)blk,
      (int64_t*)masks, n, num_blocks);
  return (int)cudaGetLastError();
}
