// Host emulation of the CUDA features the port's kernels use, for g++:
// one std::thread per CUDA thread, blocks one after another, std::barrier
// for __syncthreads and for the warp collectives (every lane of a warp
// must reach each collective, as the kernels are written).  `__shared__`
// variables become statics (one block runs at a time); emulate.py rewrites
// `extern __shared__` and the `<<<...>>>` launches before compiling.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__ static
#define __launch_bounds__(...)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, size_t) { *b = 1; return 0; }
// Four multiprocessors: small enough that grid-stride loops take several turns.
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 4; return 0; }
namespace emu {
inline thread_local dim3 tidx, bidx;
inline dim3 bdim, gdim;
struct Warp { std::unique_ptr<std::barrier<>> bar; uint64_t buf[32]; };
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<Warp> warps;
inline int wsize(int w) { int n = bdim.x - 32 * w; return n > 32 ? 32 : n; }
inline void wsync() { warps[tidx.x / 32].bar->arrive_and_wait(); }
template <class T> T exch(T v, int src) {
  Warp& w = warps[tidx.x / 32];
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  w.buf[tidx.x % 32] = u; w.bar->arrive_and_wait();
  uint64_t r = w.buf[src]; w.bar->arrive_and_wait();
  T out; std::memcpy(&out, &r, sizeof(T)); return out;
}
template <class K> struct Launch {
  K k; unsigned grid, block;
  template <class... A> void operator()(A... args) {
    gdim.x = grid; bdim.x = block;
    for (unsigned b = 0; b < grid; ++b) {
      block_bar = std::make_unique<std::barrier<>>(block);
      warps.clear(); warps.resize((block + 31) / 32);
      for (unsigned w = 0; w < warps.size(); ++w) warps[w].bar = std::make_unique<std::barrier<>>(wsize(w));
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([=, this] { tidx.x = t; bidx.x = b; k(args...); });
      for (auto& t : ts) t.join();
    }
  }
};
template <class K> Launch<K> launch(K k, unsigned g, unsigned b) { return {k, g, b}; }
}
#define threadIdx emu::tidx
#define blockIdx emu::bidx
#define blockDim emu::bdim
#define gridDim emu::gdim
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::wsync(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  // each lane publishes its predicate, then every lane gathers all of them
  unsigned m = 0;
  emu::Warp& w = emu::warps[threadIdx.x / 32];
  w.buf[threadIdx.x % 32] = p; w.bar->arrive_and_wait();
  int n = emu::wsize(threadIdx.x / 32);
  for (int l = 0; l < n; ++l) if (w.buf[l]) m |= 1u << l;
  w.bar->arrive_and_wait(); return m;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu::exch(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return emu::exch(v, (threadIdx.x % 32) ^ o); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicCAS(unsigned long long* p, unsigned long long cmp, unsigned long long v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST); return cmp;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
template <class T> T __ldg(const T* p) { return *p; }
