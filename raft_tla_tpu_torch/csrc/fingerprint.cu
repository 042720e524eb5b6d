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
// about reading the rows at full bandwidth: a block of 128 threads copies
// its 128 rows into shared memory with coalesced loads (neighbouring threads
// on neighbouring words), then each thread hashes one row out of shared
// memory.  Rows sit at an odd stride (W | 1 words) so the 32 threads of a
// warp, reading word w of 32 rows, hit 32 different banks.  The constants
// live in shared memory too.
//
// The arithmetic is csrc/fp.cuh, the same code the fused step kernel
// (csrc/step.cu) runs on each successor it emits.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp.cuh"

namespace {

constexpr int kRows = 128;  // rows (and threads) per block

__global__ void __launch_bounds__(kRows)
    fingerprint_kernel(const int* __restrict__ rows, long long n_rows, int W,
                       const uint32_t* __restrict__ c1g,
                       const uint32_t* __restrict__ c2g, int* __restrict__ hi,
                       int* __restrict__ lo) {
  extern __shared__ int sm[];
  const int Wp = W | 1;  // odd row stride: conflict-free column reads
  uint32_t* c1 = reinterpret_cast<uint32_t*>(sm + kRows * Wp);
  uint32_t* c2 = c1 + W;
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    c1[t] = c1g[t];
    c2[t] = c2g[t];
  }
  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  const int nrows =
      n_rows - base < kRows ? static_cast<int>(n_rows - base) : kRows;
  const int* src = rows + base * W;
  for (int t = threadIdx.x; t < nrows * W; t += blockDim.x) {
    const int r = t / W;
    sm[r * Wp + (t - r * W)] = src[t];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= nrows) return;
  RtFp acc;
  const int* row = sm + r * Wp;
  for (int w = 0; w < W; ++w) rt_fp_mac(acc, row[w], c1[w], c2[w]);
  rt_fp_finish(acc, hi + base + r, lo + base + r);
}

}  // namespace

extern "C" int rt_fingerprint_launch(const int* rows, long long n_rows,
                                     int W, const uint32_t* c1,
                                     const uint32_t* c2, int* hi, int* lo,
                                     void* stream) {
  if (n_rows <= 0) return 0;
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kRows) * (W | 1) + 2 * W) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fingerprint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kRows - 1) / kRows;
  fingerprint_kernel<<<static_cast<unsigned>(blocks), kRows, smem,
                       static_cast<cudaStream_t>(stream)>>>(rows, n_rows, W,
                                                            c1, c2, hi, lo);
  return static_cast<int>(cudaGetLastError());
}
