// One 2D stencil step on (B, H, W): the Hopper port of the TPU kernel
// kernels/stencil2d.py::stencil2d (src/repro, its pl.pallas_call at :125,
// body _kernel/_stencil_block).
//
// Computes out[b,i,j] = sum_k w_k(i,j) * x[b, i+dr_k, j+dc_k] with zero
// padding outside the grid; w_k is a scalar or a per-cell field read at the
// output cell.  With a bc the Dirichlet shell is pinned to it (the paper's
// mask trick, fused).  Sums in fp32, writes x's type.
//
// Bound: bytes.  One sweep must read x and the V fields and write out,
// (2 + V) * B * H * W * itemsize, against a few FLOPs per cell, so the kernel
// sits far below the card's ridge point.  The design streams each input
// once: one thread per output cell, threads of a warp on consecutive
// columns so every load and store is coalesced, and the taps' re-reads of
// the neighbouring rows hit L1/L2 instead of device memory.  No halo copy
// and no padded copy of x: the kernel masks its own ragged edge.
#include "taps.cuh"

namespace {

constexpr int THREADS = 32 * 8;  // per CTA: one warp per row of 32 columns

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    stencil2d_kernel(const T* __restrict__ x,
                                 const float* __restrict__ fields,
                                 T* __restrict__ out, int H, int W, int r,
                                 const __grid_constant__ Taps taps,
                                 const Tap* __restrict__ big_taps, int has_bc,
                                 float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  // A table past Taps' capacity takes the generic kernel (dispatch_taps).
  const Tap* big = NT == 0 ? big_taps : nullptr;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const size_t plane = (size_t)H * W;
  const int cell = i * W + j;  // the wrapper keeps H * W below 2^31
  const T* xb = x + blockIdx.z * plane;
  float acc = 0.f;
  if (has_bc && on_shell(i, j, H, W)) {
    acc = bc;
  } else if (i >= r && i < H - r && j >= r && j < W - r) {
    // Every neighbour inside the grid: no bounds checks.
    TapRegs<NT> rt;
    rt.init(s_taps, W);
    acc = sum_taps<NT>(xb, cell, rt, s_taps, big, W, fields, plane, cell);
  } else {
    for (int k = 0; k < s_taps.n; ++k) {
      const Tap e = tap_at(s_taps, big, k);
      const int ii = i + e.dr, jj = j + e.dc;
      const float v = (ii >= 0 && ii < H && jj >= 0 && jj < W)
                          ? to_f32(xb[ii * W + jj])
                          : 0.f;
      const float w = e.field < 0 ? e.w : fields[e.field * plane + cell];
      acc = __fadd_rn(acc, __fmul_rn(v, w));
    }
  }
  out[blockIdx.z * plane + cell] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* fields, void* out, int B, int H, int W,
           int r, const Taps* taps, const Tap* big, int has_bc, float bc,
           cudaStream_t s) {
  const dim3 block(32, THREADS / 32);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y,
                  B);
  return dispatch_taps(taps->n, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    stencil2d_kernel<T, NT><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(fields),
        static_cast<T*>(out), H, W, r, *taps, big, has_bc, bc);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// r is the spec's radius.  big: the whole table on the device when it has
// more than STENCIL_MAX_TAPS taps (taps->n then counts them), else null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stencil2d_launch(const void* x, const void* fields, void* out,
                                int B, int H, int W, int r, int dtype,
                                const Taps* taps, const Tap* big, int has_bc,
                                float bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((taps->n > STENCIL_MAX_TAPS) != (big != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return launch<float>(x, fields, out, B, H, W, r, taps, big, has_bc, bc,
                         s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, fields, out, B, H, W, r, taps, big,
                                 has_bc, bc, s);
  return (int)cudaErrorInvalidValue;
}
