// The two-lane multilinear fingerprint, shared by both kernels of the port.
//
// Lane k of a packed int32[W] row is fmix32(seed_k + sum_w c_k[w] * row[w])
// in uint32 wraparound arithmetic, with the per-position odd constants of
// ops/fingerprint.lane_constants.  Bit-identical to the plain torch version
// (ops/fingerprint.fingerprint), to the JAX reference's ops/fingerprint.py
// and Pallas kernel, and to its C++ host store.  csrc/fingerprint.cu runs
// it over stored rows; csrc/step.cu runs it on each candidate successor as
// it packs it, so the row never leaves registers.
#pragma once

#include <cstdint>

#define RT_LANE_SEED_HI 0x9E3779B9u
#define RT_LANE_SEED_LO 0x85EBCA77u

struct RtFp {
  uint32_t s1 = 0u, s2 = 0u;
};

// murmur3 32-bit finalizer (public domain avalanche function).
__device__ __forceinline__ uint32_t rt_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Multiply-accumulate one word of the row into both lanes.
__device__ __forceinline__ void rt_fp_mac(RtFp& acc, int word, uint32_t c1,
                                          uint32_t c2) {
  const uint32_t x = static_cast<uint32_t>(word);
  acc.s1 += c1 * x;
  acc.s2 += c2 * x;
}

// Finalize both lanes; the keys leave as int32 holding the uint32 bits.
__device__ __forceinline__ void rt_fp_finish(const RtFp& acc, int* hi,
                                             int* lo) {
  *hi = static_cast<int>(rt_fmix32(acc.s1 + RT_LANE_SEED_HI));
  *lo = static_cast<int>(rt_fmix32(acc.s2 + RT_LANE_SEED_LO));
}
