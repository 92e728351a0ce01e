// out = x @ W for the paper's dense-layer encoding (Algorithm 1): the Hopper
// port of the TPU kernel kernels/dense_stencil.py::dense_stencil_matmul
// (src/repro, its pl.pallas_call at :61, body _kernel).
//
// x is (S, N), W is (N, N), both fp32 or both bf16, row-major; out is (S, N)
// in x's type.  Products and sums in fp32, rounded to out's type once.
//
// Bound: operations.  2 * S * N^2 FLOPs against (S*N*2 + N^2) * itemsize
// bytes: at N = 4096 that is about 1000 FLOPs a byte, far above the card's
// ridge point, so the fp32 pipes (67 TFLOP/s outside the tensor cores; TF32
// would lose the fp32 result) are the limit.  The TPU kernel's grid
// revisits an fp32 VMEM scratch over a K-innermost grid; here the K loop
// runs inside the CTA instead.  A CTA owns a 128 x 128 output tile in
// registers (8 x 8 a thread, 256 threads), stages 128 x 16 slabs of x and
// 16 x 128 slabs of W through shared memory per K step, and loads each
// value from device memory once per tile: 64 FMAs per 16 shared-memory
// reads a thread.  A thread's rows and columns are strided by 16, so the
// warp's shared-memory reads fall in distinct banks or broadcast.  Ragged
// edges (any S and N) are masked in the kernel, not padded in memory as
// the TPU kernel pads to its blocks.  wgmma and TMA are later work.
#include "common.cuh"  // the fp32/bf16 conversions, dtype codes, error text

namespace {

constexpr int BM = 128;  // rows of x (and out) per CTA
constexpr int BN = 128;  // columns of W (and out) per CTA
constexpr int BK = 16;   // K per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int STRIDE_M = BM / TM;  // 16: a thread's rows are tr + 16 i
constexpr int STRIDE_N = BN / TN;  // 16: its columns are tc + 16 j

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dense_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int S, int N) {
  // x's slab transposed (K-major) so a thread's row reads are one address
  // per k; +2 columns keep the transposing stores free of bank conflicts.
  __shared__ float xs[BK][BM + 2];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / STRIDE_N, tc = tid % STRIDE_N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int l = tid + q * THREADS;
      const int m = l / BK, kk = l % BK;
      const int gr = row0 + m, gk = k0 + kk;
      xs[kk][m] = (gr < S && gk < N) ? to_f32(x[(size_t)gr * N + gk]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int l = tid + q * THREADS;
      const int kk = l / BN, c = l % BN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < N && gc < N) ? to_f32(w[(size_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr + STRIDE_M * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc + STRIDE_N * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr + STRIDE_M * i;
    if (gr >= S) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc + STRIDE_N * j;
      if (gc < N) out[(size_t)gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int S, int N,
           cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM);
  dense_stencil_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), S, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dense_stencil_launch(const void* x, const void* w, void* out,
                                    int S, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch<float>(x, w, out, S, N, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, out, S, N, s);
  return (int)cudaErrorInvalidValue;
}
