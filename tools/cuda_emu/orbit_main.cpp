// The orbit-key entry of csrc/step.cu (rt_orbit_key_launch) under the host
// emulation: reads a case written by emulate.py from a directory (meta.i32
// holds N W P Q nv view; valid.u8, when there, the rows' mask, else every
// row is valid), launches it, writes the keys.  The outputs start as
// garbage, so a row the kernel leaves unwritten shows.
#include <cstdio>
#include <string>
#include <vector>

#include <cuda_runtime.h>
namespace { alignas(16) int sm[1 << 17]; }  // the block's dynamic shared memory
#include "kernel_gen.cu"

template <class T>
std::vector<T> load(const std::string& dir, const char* name) {
  std::vector<T> v;
  FILE* f = fopen((dir + "/" + name).c_str(), "rb");
  if (!f) return v;
  fseek(f, 0, SEEK_END);
  v.resize(ftell(f) / sizeof(T));
  fseek(f, 0, SEEK_SET);
  if (!v.empty() && fread(v.data(), sizeof(T), v.size(), f) != v.size())
    v.clear();
  fclose(f);
  return v;
}

int main(int, char** argv) {
  const std::string d = argv[1];
  const auto m = load<int>(d, "meta.i32");  // N W P Q nv view
  const int n = m[0];
  if (m[1] != rt_step_width()) return 3;
  const auto rows = load<int>(d, "rows.i32");
  const auto c1 = load<uint32_t>(d, "c1.u32"), c2 = load<uint32_t>(d, "c2.u32");
  const auto group = load<int8_t>(d, "group.i8");
  const auto rmaps = load<int16_t>(d, "rmaps.i16");
  auto valid = load<uint8_t>(d, "valid.u8");
  if (valid.empty()) valid.assign(n, 1);
  std::vector<int> keys(2 * static_cast<size_t>(n), 0x5A5A5A5A);
  std::vector<int> work(n + 1, 0x5A5A5A5A);
  const int err = rt_orbit_key_launch(
      rows.data(), valid.data(), work.data(), n, c1.data(), c2.data(), group.data(), m[2], m[3], m[4],
      rmaps.empty() ? nullptr : rmaps.data(), m[5], keys.data(),
      keys.data() + n, nullptr);
  if (err) return 4;
  FILE* f = fopen((d + "/o_keys.i32").c_str(), "wb");
  fwrite(keys.data(), sizeof(int), keys.size(), f);
  fclose(f);
  return 0;
}
