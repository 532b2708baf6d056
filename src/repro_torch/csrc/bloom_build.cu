// Bloom filter build for Hopper: hash and commit in one pass, and commit
// only the bits a block lacks.
//
// Replaces the TPU kernel repro/kernels/bloom_build.py (_kernel /
// bloom_hashes_batched) together with the scatter-OR commit its wrapper runs
// (repro/core/bloom.py scatter_or): TPU Pallas has no scatter atomics,
// Hopper does.
//
// What held it back: the first Hopper version issued 8 32-bit atomicOr per
// valid key, 134 M atomics for 2^24 keys, and took 1.6622 ms on an H100 80GB
// HBM3 at 700 W, about 30x its byte bound.  On the paper's microbenchmark
// each of 2^16 keys repeats about 256 times, so the atomics queued on a few
// L2 words at the rate of L2's atomic units, and nearly all of them left the
// words as they were.
//
// Design: read a block before committing to it, and commit only the bits
// it lacks: one 64-bit atomicOr per pair of lanes, and only for a pair that
// lacks one of the key's bits (missing = mask & ~word).  The reads come from
// L2 (ld.global.cg), since the words change during the kernel.  A stale
// read shows fewer bits than are set, which costs a redundant atomic and
// never a wrong word; OR does not depend on order, so the words equal the
// plain version's bit for bit.  At most 4 atomics per key, none for a key
// whose bits are all set: on repeated keys the kernel becomes a stream of
// reads.  A warp takes 16 kKeys consecutive rows of a slot: lanes 2i and
// 2i+1 share key i of each 16 and each reads and commits one 16-byte half
// of its block, so one warp load asks for 16 whole sectors, one per key, and
// each lane has kKeys block reads in flight before its first commit (4; 8
// measured no faster on an H100).
//
// Bound: bytes.  9 bytes per key (int64 key, bool validity) plus the
// 32-byte words once.  The integer operations a key needs (hash, masks, the
// OR of its 8 lanes: 39 on the ALU pipe and 13 multiplies, counted once per
// key in chip_smoke.py, though both lanes of a pair hash it) take less time
// at the card's integer rates.  Atomics are not in the bound.
//
// Layout: keys int64 [B, n] (uint32 values), valid bool [B, n], seeds int64
// [B], words uint32 [B, num_blocks, 8] zeroed by the caller, 32-byte
// aligned.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 4;            // keys a lane pair builds
constexpr int kTile = 16 * kKeys;   // rows a warp builds

// OR into this lane's half of a block (w) the bits of the key hashed to h
// that the half, as read into `have`, lacks, if the key is valid: one
// 64-bit atomicOr per pair of lanes that lacks one (lane 2j is the low half
// on this little-endian machine).  Validity masks the bits rather than
// skipping the call, so the loads are used on every path and stay ahead of
// the first compare.
__device__ __forceinline__ void commit_half(uint32_t* w, uint32_t h, int half,
                                            uint4 have, bool valid) {
  uint32_t m[4];
  repro::lane_masks_half(h, half, m);
  const uint32_t keep = valid ? 0xFFFFFFFFu : 0u;
  const unsigned long long missing[2] = {
      (unsigned long long)(m[1] & ~have.y & keep) << 32 |
          (m[0] & ~have.x & keep),
      (unsigned long long)(m[3] & ~have.w & keep) << 32 |
          (m[2] & ~have.z & keep)};
  unsigned long long* pair = reinterpret_cast<unsigned long long*>(w);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (missing[j] != 0) atomicOr(pair + j, missing[j]);
}

__global__ void __launch_bounds__(kThreads)
    bloom_build_kernel(const int64_t* __restrict__ keys,
                       const bool* __restrict__ valid,
                       const int64_t* __restrict__ seeds,
                       uint32_t* __restrict__ words, int64_t n,
                       int64_t num_blocks) {
  __shared__ uint32_t mixed_seed;
  const int64_t b = blockIdx.y;
  const int64_t tile =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32 * kTile;
  const int lane = threadIdx.x & 31, half = lane & 1;
  const int64_t first = tile + (lane >> 1);
  const long long* slot_keys =
      reinterpret_cast<const long long*>(keys + b * n);
  const bool* slot_valid = valid + b * n;

  // the rows' loads go out before the barrier, beside the seed's, so the
  // seed mix adds no round trip of its own
  uint32_t h[kKeys];
  bool ok[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int64_t r = first + 16 * k;
    ok[k] = r < n && __ldcs(reinterpret_cast<const unsigned char*>(
                         slot_valid + r)) != 0;
    h[k] = r < n ? (uint32_t)__ldcs(slot_keys + r) : 0u;
  }
  if (threadIdx.x == 0) mixed_seed = repro::mix_seed((uint32_t)seeds[b]);
  __syncthreads();
  if (tile >= n) return;  // the whole warp leaves together
  const uint32_t mixed = mixed_seed;
  const uint32_t nb_mask = (uint32_t)(num_blocks - 1);
  uint32_t* slot = words + b * num_blocks * 8 + 4 * half;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) h[k] = repro::hash2_premixed(h[k], mixed);
  // read every block half (from L2: the words change during the kernel)
  // before the first commit
  uint4 have[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k)
    have[k] = __ldcg(reinterpret_cast<const uint4*>(
        slot + (size_t)(h[k] & nb_mask) * 8));
#pragma unroll
  for (int k = 0; k < kKeys; ++k)
    commit_half(slot + (size_t)(h[k] & nb_mask) * 8, h[k], half, have[k],
                ok[k]);
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

}  // namespace

extern "C" int bloom_build(const void* keys, const void* valid,
                           const void* seeds, void* words, int64_t batch,
                           int64_t n, int64_t num_blocks, void* stream) {
  const int64_t warps = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)((warps * 32 + kThreads - 1) / kThreads),
                  (unsigned)batch);
  bloom_build_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const bool*)valid, (const int64_t*)seeds,
      (uint32_t*)words, n, num_blocks);
  return (int)cudaGetLastError();
}

extern "C" int bloom_hashes(const void* keys, const void* seeds, void* blk,
                            void* masks, int64_t batch, int64_t n,
                            int64_t num_blocks, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)batch);
  bloom_hashes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int64_t*)seeds, (int64_t*)blk,
      (int64_t*)masks, n, num_blocks);
  return (int)cudaGetLastError();
}
