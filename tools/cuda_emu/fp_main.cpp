// K2 (csrc/fingerprint.cu) under the host emulation:
//   fp_main N W OFFSET ROWS CONSTS OUT
// hashes N rows of W words read from ROWS, placed OFFSET words past a
// 16-byte boundary, with the 2 x W constants of CONSTS; writes hi then lo.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>
#include "kernel_gen.cu"

int main(int, char** argv) {
  const long long n = atoll(argv[1]);
  const int W = atoi(argv[2]), off = atoi(argv[3]);
  std::vector<int4> buf((n * W + off + 3) / 4 + 1);
  int* rows = reinterpret_cast<int*>(buf.data()) + off;
  std::vector<uint32_t> c(2 * W);
  FILE* f = fopen(argv[4], "rb");
  if (fread(rows, 4, n * W, f) != static_cast<size_t>(n * W)) return 2;
  fclose(f);
  f = fopen(argv[5], "rb");
  if (fread(c.data(), 4, 2 * W, f) != static_cast<size_t>(2 * W)) return 2;
  fclose(f);
  std::vector<int> hi(n, 7), lo(n, 7);
  if (rt_fingerprint_launch(rows, n, W, c.data(), c.data() + W, hi.data(),
                            lo.data(), nullptr))
    return 4;
  f = fopen(argv[6], "wb");
  fwrite(hi.data(), 4, n, f);
  fwrite(lo.data(), 4, n, f);
  fclose(f);
  return 0;
}
