// K2 — the two-lane fingerprint of stored rows, hand-written for Hopper.
//
// Replaces: raft_tla_tpu/ops/pallas_fp.py `_fp_call` (pl.pallas_call at
// :86, kernel body `_fp_kernel` at :59, entry `fingerprint_rows` at :116).
// On the TPU the kernel walks 1,024-row blocks with the lanes zero-padded
// to 128; here no padding is needed.
//
// What bounds it on the H100: bytes.  It reads each int32[W] row once and
// writes two int32 keys; the arithmetic is 2W multiply-adds and two fmix32
// finalizers per row, far below the card's integer rate.  So the design is
// about keeping enough loads in flight to read at the memory's rate, with
// no shared memory and no per-word index arithmetic:
//
// - a group of G lanes (a power of two) owns one row, and lane g of the
//   group reads the row's items g, g + G, ..., g + (K-1) G, so each load
//   instruction of a warp reads G neighbouring items of each of its 32 / G
//   rows.  An item is 16 bytes (an int4) when W is a multiple of 4 and the
//   rows are 16-byte aligned, otherwise one word;
// - the warps walk the rows in steps of the grid (as many blocks as the
//   card holds at once), so the constants c1, c2 of a lane's word
//   positions, the same for every row, are loaded into registers once;
// - all K loads of a lane are independent and issued before any is used,
//   and every warp has 32 / G rows in flight;
// - the group's two uint32 sums are reduced with shuffles (wraparound
//   addition is exact in any order) and its first lane writes the keys.
//
// G is the least power of two with G * K items covering the row (K = 4
// int4s or 8 words); a row wider than 32 * K items takes a general form
// that loops over its words with the constants read through the read-only
// cache.  The arithmetic is csrc/fp.cuh, the same code the fused step
// kernel (csrc/step.cu) runs on each successor it emits.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void fold(RtFp& acc, int4 x, const uint32_t* a1,
                                     const uint32_t* a2) {
  rt_fp_mac(acc, x.x, a1[0], a2[0]);
  rt_fp_mac(acc, x.y, a1[1], a2[1]);
  rt_fp_mac(acc, x.z, a1[2], a2[2]);
  rt_fp_mac(acc, x.w, a1[3], a2[3]);
}

// The group's sums into its first lane, which writes the keys.
template <int G>
__device__ __forceinline__ void finish(RtFp acc, long long r, long long n,
                                       int* hi, int* lo) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    acc.s1 += __shfl_xor_sync(kFull, acc.s1, o);
    acc.s2 += __shfl_xor_sync(kFull, acc.s2, o);
  }
  if ((threadIdx.x & (G - 1)) == 0 && r < n) rt_fp_finish(acc, hi + r, lo + r);
}

// Each warp walks the rows in steps of the grid, 32 / G rows at a time,
// from this first row: the same for all its lanes, so every lane takes part
// in every shuffle.
template <int G>
__device__ __forceinline__ long long first_row() {
  return static_cast<long long>(blockIdx.x) * (kThreads / G) +
         (threadIdx.x >> 5) * (32 / G);
}

// Rows of W = 4 * C words, 16-byte aligned: G lanes a row, K int4s a lane.
template <int G, int K>
__global__ void __launch_bounds__(kThreads)
    fp_vec4(const int4* __restrict__ rows, long long n, int C,
            const uint32_t* __restrict__ c1, const uint32_t* __restrict__ c2,
            int* __restrict__ hi, int* __restrict__ lo) {
  const int g = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) / G;
  uint32_t a1[K][4], a2[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = g + G * k;
      a1[k][e] = c < C ? __ldg(c1 + 4 * c + e) : 0u;
      a2[k][e] = c < C ? __ldg(c2 + 4 * c + e) : 0u;
    }
  const long long step = static_cast<long long>(gridDim.x) * (kThreads / G);
  for (long long r0 = first_row<G>(); r0 < n; r0 += step) {
    const long long r = r0 + sub;
    int4 x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = g + G * k;
      x[k] = c < C && r < n ? __ldg(rows + r * C + c) : make_int4(0, 0, 0, 0);
    }
    RtFp acc;
#pragma unroll
    for (int k = 0; k < K; ++k) fold(acc, x[k], a1[k], a2[k]);
    finish<G>(acc, r, n, hi, lo);
  }
}

// Rows of any W (4-byte aligned): G lanes a row, K words a lane.
template <int G, int K>
__global__ void __launch_bounds__(kThreads)
    fp_word(const int* __restrict__ rows, long long n, int W,
            const uint32_t* __restrict__ c1, const uint32_t* __restrict__ c2,
            int* __restrict__ hi, int* __restrict__ lo) {
  const int g = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) / G;
  uint32_t a1[K], a2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = g + G * k;
    a1[k] = w < W ? __ldg(c1 + w) : 0u;
    a2[k] = w < W ? __ldg(c2 + w) : 0u;
  }
  const long long step = static_cast<long long>(gridDim.x) * (kThreads / G);
  for (long long r0 = first_row<G>(); r0 < n; r0 += step) {
    const long long r = r0 + sub;
    int x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = g + G * k;
      x[k] = w < W && r < n ? __ldg(rows + r * W + w) : 0;
    }
    RtFp acc;
#pragma unroll
    for (int k = 0; k < K; ++k) rt_fp_mac(acc, x[k], a1[k], a2[k]);
    finish<G>(acc, r, n, hi, lo);
  }
}

// Rows wider than 256 words: a warp a row, a loop over its words.
__global__ void __launch_bounds__(kThreads)
    fp_wide(const int* __restrict__ rows, long long n, int W,
            const uint32_t* __restrict__ c1, const uint32_t* __restrict__ c2,
            int* __restrict__ hi, int* __restrict__ lo) {
  const int g = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long r = first_row<32>(); r < n; r += step) {
    RtFp acc;
    for (int w = g; w < W; w += 32)
      rt_fp_mac(acc, __ldg(rows + r * W + w), __ldg(c1 + w), __ldg(c2 + w));
    finish<32>(acc, r, n, hi, lo);
  }
}

// Blocks for n rows at `per` rows a block: enough to cover the rows, at
// most what the card holds at once (2,048 threads a multiprocessor).
unsigned grid_for(long long n, int per) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long need = (n + per - 1) / per;
  const long long cap = static_cast<long long>(sms) * (2048 / kThreads);
  return static_cast<unsigned>(need < cap ? need : cap);
}

template <int G>
cudaError_t launch_vec4(const int* rows, long long n, int W,
                        const uint32_t* c1, const uint32_t* c2, int* hi,
                        int* lo, cudaStream_t st) {
  fp_vec4<G, 4><<<grid_for(n, kThreads / G), kThreads, 0, st>>>(
      reinterpret_cast<const int4*>(rows), n, W / 4, c1, c2, hi, lo);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_word(const int* rows, long long n, int W,
                        const uint32_t* c1, const uint32_t* c2, int* hi,
                        int* lo, cudaStream_t st) {
  fp_word<G, 8><<<grid_for(n, kThreads / G), kThreads, 0, st>>>(
      rows, n, W, c1, c2, hi, lo);
  return cudaGetLastError();
}

// The least power of two G <= 32 with G * per >= items; 64 when none.
int group_lanes(int items, int per) {
  int G = 1;
  while (G <= 32 && G * per < items) G *= 2;
  return G;
}

}  // namespace

extern "C" int rt_fingerprint_launch(const int* rows, long long n_rows,
                                     int W, const uint32_t* c1,
                                     const uint32_t* c2, int* hi, int* lo,
                                     void* stream) {
  if (n_rows <= 0) return 0;
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaError_t err;
  switch (vec4 ? group_lanes(W / 4, 4) : group_lanes(W, 8)) {
#define RT_CASE(G)                                                    \
  case G:                                                             \
    err = vec4 ? launch_vec4<G>(rows, n_rows, W, c1, c2, hi, lo, st)  \
               : launch_word<G>(rows, n_rows, W, c1, c2, hi, lo, st); \
    break;
    RT_CASE(1)
    RT_CASE(2)
    RT_CASE(4)
    RT_CASE(8)
    RT_CASE(16)
    RT_CASE(32)
#undef RT_CASE
    default:
      fp_wide<<<grid_for(n_rows, kThreads / 32), kThreads, 0, st>>>(
          rows, n_rows, W, c1, c2, hi, lo);
      err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
