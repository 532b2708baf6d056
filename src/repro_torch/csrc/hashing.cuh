// Device copies of core/hashing.py and core/bloom.py's per-key hashes.
//
// Plain uint32 arithmetic, so the kernels and the plain PyTorch versions give
// the same bits.  Shared by bloom_build.cu, bloom_probe.cu and edge_sample.cu.
#pragma once

#include <cstdint>

namespace repro {

constexpr uint32_t kGolden = 0x9E3779B1u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The half of hashing.hash2 that depends on the seed alone, so a kernel
// whose keys share a seed mixes it once.
__device__ __forceinline__ uint32_t mix_seed(uint32_t seed) {
  return fmix32(seed * kGolden);
}

// hashing.hash2 of a key under a seed already mixed by mix_seed.
__device__ __forceinline__ uint32_t hash2_premixed(uint32_t key,
                                                   uint32_t mixed_seed) {
  return fmix32(key ^ mixed_seed);
}

// hashing.hash2: fmix32(key ^ fmix32(seed * GOLDEN)).
__device__ __forceinline__ uint32_t hash2(uint32_t key, uint32_t seed) {
  return hash2_premixed(key, mix_seed(seed));
}

// hashing.counter_hash: the sampler's stateless draw.
__device__ __forceinline__ uint32_t counter_hash(uint32_t seed, uint32_t stratum,
                                                 uint32_t counter, uint32_t lane) {
  uint32_t h = fmix32(counter * kGolden + lane);
  h = fmix32(h ^ (stratum * 0x85EBCA6Bu));
  return fmix32(h ^ seed);
}

// bloom.lane_masks from the key's hash2 value h: one bit in each of the
// block's 8 lanes, at the top 5 bits of (fmix32(h * C + 1) * SALT[lane]).
__device__ __forceinline__ void lane_masks(uint32_t h, uint32_t m[8]) {
  const uint32_t x = fmix32(h * 0x85EBCA6Bu + 1u);
  m[0] = 1u << ((x * 0x47B6137Bu) >> 27);
  m[1] = 1u << ((x * 0x44974D91u) >> 27);
  m[2] = 1u << ((x * 0x8824AD5Bu) >> 27);
  m[3] = 1u << ((x * 0xA2B7289Du) >> 27);
  m[4] = 1u << ((x * 0x705495C7u) >> 27);
  m[5] = 1u << ((x * 0x2DF1424Bu) >> 27);
  m[6] = 1u << ((x * 0x9EFC4947u) >> 27);
  m[7] = 1u << ((x * 0x5C6BFB31u) >> 27);
}

// The 4 masks of one half of the block, lanes 4 half .. 4 half + 3, for a
// build thread that shares its key with another thread writing the other
// half.
__device__ __forceinline__ void lane_masks_half(uint32_t h, int half,
                                                uint32_t m[4]) {
  const uint32_t x = fmix32(h * 0x85EBCA6Bu + 1u);
  m[0] = 1u << ((x * (half ? 0x705495C7u : 0x47B6137Bu)) >> 27);
  m[1] = 1u << ((x * (half ? 0x2DF1424Bu : 0x44974D91u)) >> 27);
  m[2] = 1u << ((x * (half ? 0x9EFC4947u : 0x8824AD5Bu)) >> 27);
  m[3] = 1u << ((x * (half ? 0x5C6BFB31u : 0xA2B7289Du)) >> 27);
}

}  // namespace repro
