// K1 (csrc/step.cu) under the host emulation: reads a case written by
// emulate.py from a directory, launches rt_step_launch, writes the outputs.
// Outputs start as garbage, so a lane the kernel leaves unwritten shows.
// meta.i32 holds B A W P Q nv view n_inv, the four limits and the
// orbit-scan variant; the kStats counters go to o_stats.u64.
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

template <class T>
void save(const std::string& dir, const char* name, const T* p, size_t n) {
  FILE* f = fopen((dir + "/" + name).c_str(), "wb");
  fwrite(p, sizeof(T), n, f);
  fclose(f);
}

int main(int, char** argv) {
  const std::string d = argv[1];
  const auto m = load<int>(d, "meta.i32");  // B A W P Q nv view n_inv lims
  const int B = m[0], A = m[1], W = m[2], n_inv = m[7];
  if (W != rt_step_width()) return 3;
  unsigned long long stats[4] = {0, 0, 0, 0};
  const auto codes = load<int>(d, "inv.i32");
  const auto prog = load<int>(d, "prog.i32");
  const auto vecs = load<int>(d, "vecs.i32");
  const auto table = load<int>(d, "table.i32");
  const auto c1 = load<uint32_t>(d, "c1.u32"), c2 = load<uint32_t>(d, "c2.u32");
  const auto group = load<int8_t>(d, "group.i8");
  const auto rmaps = load<int16_t>(d, "rmaps.i16");
  const size_t lanes = static_cast<size_t>(B) * A;
  std::vector<int4> sv((lanes * W + 3) / 4 + 1);  // 16-byte aligned
  int* svecs = reinterpret_cast<int*>(sv.data());
  memset(svecs, 0xAB, sv.size() * sizeof(int4));
  std::vector<uint8_t> valid(lanes, 0xCD), ovf(lanes, 0xCD), con(lanes, 0xCD),
      inv(lanes * (n_inv ? n_inv : 1), 0xCD);
  std::vector<int> hi(lanes, 0x5A5A5A5A), lo(lanes, 0x5A5A5A5A);
  const int err = rt_step_launch(
      vecs.data(), B, table.data(), A, c1.data(), c2.data(), group.data(),
      m[3], m[4], m[5], rmaps.empty() ? nullptr : rmaps.data(), m[6],
      codes.data(), n_inv, prog.data(), m[8], m[9], m[10], m[11], m[12], stats,
      svecs, valid.data(),
      ovf.data(), hi.data(), lo.data(), inv.data(), con.data(), nullptr);
  if (err) return 4;
  save(d, "o_svecs.i32", svecs, lanes * W);
  save(d, "o_valid.u8", valid.data(), lanes);
  save(d, "o_overflow.u8", ovf.data(), lanes);
  save(d, "o_fp_hi.i32", hi.data(), lanes);
  save(d, "o_fp_lo.i32", lo.data(), lanes);
  save(d, "o_inv_ok.u8", inv.data(), lanes * n_inv);
  save(d, "o_con_ok.u8", con.data(), lanes);
  save(d, "o_stats.u64", stats, 4);
  return 0;
}
