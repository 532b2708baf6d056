// Join-filter membership probe for Hopper.
//
// Replaces the TPU kernel repro/kernels/bloom_probe.py (_kernel /
// bloom_probe_batched).  One thread per (slot, key): it hashes the key under
// the slot's seed, mixed once per block, loads the key's 32-byte block as two
// 16-byte loads and writes whether every lane holds the key's bit.  Each slot
// probes its own filter.
//
// Bound: bytes.  Each key reads 8 bytes of key and writes 1, and the 32-byte
// words are read once; its integer operations (hash, masks, compare: 39 on
// the ALU pipe and 13 multiplies, counted in chip_smoke.py) take less time at
// the card's integer rates.  The TPU kernel pins the whole filter in VMEM
// (<= 8 MiB); a Hopper block has at most 227 KB of shared memory, and the
// join filter at 2^24 keys is 32 MiB, so this kernel reads the filter
// through L1 and the 50 MB L2 instead of staging it.
//
// More keys in flight did not help on the paper's microbenchmark: 4 keys a
// thread, and two threads a key (one 16-byte half of the block each, 16
// whole sectors a warp load) with 4 or 8 keys a thread, all took 0.17-0.21
// ms for 2^24 keys on an H100 80GB HBM3 at 700 W, as this design does.
//
// Layout: words uint32 [B, num_blocks, 8] (32-byte aligned), keys int64
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
  __shared__ uint32_t mixed_seed;
  const int64_t b = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = b * n + i;
  // the key's load goes out before the barrier, beside the seed's, so the
  // seed mix adds no round trip of its own
  const uint32_t key = i < n ? (uint32_t)keys[row] : 0u;
  if (threadIdx.x == 0) mixed_seed = repro::mix_seed((uint32_t)seeds[b]);
  __syncthreads();
  if (i >= n) return;
  const uint32_t h = repro::hash2_premixed(key, mixed_seed);
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
