// Runs csrc/jacobi_fused.cu's register kernel (regs_kernel) on the CPU, one
// std::thread a CUDA thread (tests/_torch_cuda_emu.h), on one fp32 instance
// and compares it with a plain loop of the same arithmetic: pinned shell,
// zeros outside the grid, taps summed in tap order.  Built by
// tests/test_torch_regs_emulation.py from a copy of the source with its
// launch syntax removed (EMU_SOURCE), and run as
//
//     regs_emu MASK KC FIELDS H W STEPS BC
//
// printing the count of cells that differ; exit code 0 when none does.
#include EMU_SOURCE

#include <cstdio>
#include <cstdlib>
#include <random>
#include <thread>

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
EmuCta emu_cta;
namespace kernels {
alignas(16) float edges[1 << 18];
float smem[1], tile[1];
}  // namespace kernels

namespace {

void plain(std::vector<float>& x, int H, int W, const Taps& t,
           const float* f, int steps, bool bc, float bcv) {
  auto shell = [&](int i, int j) {
    return i == 0 || j == 0 || i == H - 1 || j == W - 1;
  };
  if (bc)
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j)
        if (shell(i, j)) x[i * W + j] = bcv;
  for (int s = 0; s < steps; ++s) {
    std::vector<float> y(x.size());
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        if (bc && shell(i, j)) {
          y[i * W + j] = bcv;
          continue;
        }
        float acc = 0.f;
        for (int k = 0; k < t.n; ++k) {
          const int a = i + t.dr[k], b = j + t.dc[k];
          const float v =
              a >= 0 && a < H && b >= 0 && b < W ? x[a * W + b] : 0.f;
          const float w =
              t.field[k] < 0 ? t.w[k] : f[t.field[k] * H * W + i * W + j];
          acc = __fadd_rn(acc, __fmul_rn(v, w));
        }
        y[i * W + j] = acc;
      }
    x = y;
  }
}

template <int MASK, int KC, bool FIELDS>
int run(int H, int W, int steps, bool bc) {
  Taps t{};
  int n = 0;
  for (int b = 0; b < 9; ++b)
    if (MASK >> b & 1) {
      t.dr[n] = b / 3 - 1, t.dc[n] = b % 3 - 1, t.field[n] = -1;
      t.w[n] = 0.1f + 0.07f * n;
      ++n;
    }
  t.n = n;
  if (FIELDS) t.field[0] = 1, t.field[n - 1] = 0;
  std::mt19937 gen(H * 131 + W * 7 + steps);
  std::uniform_real_distribution<float> u(-1.f, 1.f);
  std::vector<float> x(H * W), fields(2 * H * W), out(H * W, -99.f);
  for (float& v : x) v = u(gen);
  for (float& v : fields) v = 0.15f + 0.1f * u(gen);
  const int TX = ((W + 1) / 2 + 31) / 32 * 32, TY = (H + KC - 1) / KC;
  if (TX * TY > kernels::REGS_MAX_THREADS ||
      2 * kernels::regs_edge_floats(TX, TY, KC) > (1 << 18)) {
    std::printf("patch past the kernel's threads\n");
    return 2;
  }
  blockDim = dim3(TX, TY);
  emu_cta.block = std::make_unique<std::barrier<>>(TX * TY);
  emu_cta.warps.clear();
  for (int w = 0; w < TX * TY / 32; ++w)
    emu_cta.warps.push_back(std::make_unique<std::barrier<>>(32));
  emu_cta.slots.assign(TX * TY, 0.f);
  std::vector<std::thread> threads;
  for (int ty = 0; ty < TY; ++ty)
    for (int tx = 0; tx < TX; ++tx)
      threads.emplace_back([&, tx, ty] {
        threadIdx = {(unsigned)tx, (unsigned)ty, 0};
        blockIdx = {0, 0, 0};
        kernels::regs_kernel<float, MASK, KC, FIELDS>(
            x.data(), FIELDS ? fields.data() : nullptr, out.data(), H, W, t,
            steps, bc, 1.5f);
      });
  for (std::thread& th : threads) th.join();
  plain(x, H, W, t, fields.data(), steps, bc, 1.5f);
  int bad = 0;
  for (int i = 0; i < H * W; ++i) bad += x[i] != out[i];
  std::printf("%d cells differ\n", bad);
  return bad != 0;
}

template <int MASK, int KC>
int by_fields(bool f, int H, int W, int steps, bool bc) {
  return f ? run<MASK, KC, true>(H, W, steps, bc)
           : run<MASK, KC, false>(H, W, steps, bc);
}

template <int MASK>
int by_rows(int kc, bool f, int H, int W, int steps, bool bc) {
  switch (kc) {
    case 4: return by_fields<MASK, 4>(f, H, W, steps, bc);
    case 8: return by_fields<MASK, 8>(f, H, W, steps, bc);
    case 16: return by_fields<MASK, 16>(f, H, W, steps, bc);
  }
  return 2;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int mask = std::strtol(argv[1], nullptr, 0), kc = std::atoi(argv[2]);
  const bool f = std::atoi(argv[3]);
  const int H = std::atoi(argv[4]), W = std::atoi(argv[5]);
  const int steps = std::atoi(argv[6]);
  const bool bc = std::atoi(argv[7]);
  if (mask == kernels::MASK_STAR)
    return by_rows<kernels::MASK_STAR>(kc, f, H, W, steps, bc);
  if (mask == kernels::MASK_BOX)
    return by_rows<kernels::MASK_BOX>(kc, f, H, W, steps, bc);
  return 2;
}
