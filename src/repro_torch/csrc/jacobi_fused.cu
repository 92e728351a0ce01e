// T Jacobi steps per pass over device memory on (B, H, W): the Hopper port
// of the TPU kernel kernels/jacobi_fused.py::jacobi2d_fused_step (src/repro),
// in both of its geometries:
//
//   trapezoid  (_kernel, pl.pallas_call at :247).  A CTA owns a BH x BW
//              output tile.  It loads the tile with a T*r-deep halo into
//              shared memory and runs the T steps there in two ping-pong
//              buffers; the valid window shrinks by r per step, and after T
//              steps exactly the owned tile is valid.  The halo rims are
//              recomputed by the neighbouring CTAs too (overlapped tiling).
//   resident   (_resident_kernel, pl.pallas_call at :215).  One CTA holds a
//              whole instance, with a zero ring r deep, in shared memory
//              and runs all T steps there; nothing is recomputed and T has
//              no bound.  Legal while the two fp32 buffers fit one CTA's
//              232,448 bytes (tiling.resident_fits: about 168x168 at r=1).
//
// Semantics of every step, both geometries: cells outside the grid are zero;
// with a bc the Dirichlet shell is pinned to it (before step 1 too); taps
// are scalar or per-cell fields read at the cell's global index.  The T
// steps run in fp32 and the result is rounded to the output's type once per
// pass.  A trapezoid of depth T whose halo does not fit one CTA runs as
// several passes of the deepest depth that fits; the wrapper hands them fp32
// through a scratch buffer (a pass reads Tin and writes Tout, each fp32 or
// bf16), so a bf16 grid is still rounded once, after step T, as the TPU
// kernel rounds it.
//
// Bound: bytes.  A pass must read x once and write it once,
// 2 * B * H * W * itemsize, for T steps of a few FLOPs per cell, so at T=1
// the kernel sits far below the card's ridge point and each added step
// divides the traffic per step by T.  The design keeps the T intermediate
// grids in shared memory and never in device memory; the price is the
// trapezoid's rim recompute, (BH + T r)(BW + T r) / (BH BW) on average,
// which the resident geometry avoids for grids that fit one CTA.
#include "taps.cuh"

namespace {

// Threads per CTA.  The launch bounds hold ptxas to what these need: at 1024
// threads a kernel may use at most 64 registers, and a 9-tap kernel left to
// itself takes more and then cannot launch.
constexpr int TRAPEZOID_THREADS = 32 * 8;
constexpr int RESIDENT_THREADS = 32 * 32;

template <typename T>
__device__ __forceinline__ float load_cell(const T* xb, int gi, int gj, int H,
                                           int W, int has_bc, float bc) {
  if (gi < 0 || gi >= H || gj < 0 || gj >= W) return 0.f;
  if (has_bc && on_shell(gi, gj, H, W)) return bc;
  return to_f32(xb[(size_t)gi * W + gj]);
}

// One step at the cell (gi, gj) whose value sits at buf[idx]: zero off the
// grid, bc on the shell, the taps elsewhere.
template <int NT>
__device__ __forceinline__ float step_cell(const float* buf, int idx, int SW,
                                           int gi, int gj, int H, int W,
                                           const TapRegs<NT>& rt,
                                           const Taps& taps, const Tap* big,
                                           const float* __restrict__ fields,
                                           int has_bc, float bc) {
  if (gi < 0 || gi >= H || gj < 0 || gj >= W) return 0.f;
  if (has_bc && on_shell(gi, gj, H, W)) return bc;
  return sum_taps<NT>(buf, idx, rt, taps, big, SW, fields, (size_t)H * W,
                      (size_t)gi * W + gj);
}

template <typename Tin, typename Tout, int NT>
__global__ void __launch_bounds__(TRAPEZOID_THREADS)
    trapezoid_kernel(const Tin* __restrict__ x,
                                 const float* __restrict__ fields,
                                 Tout* __restrict__ out, int H, int W,
                                 int tile_h, int tile_w,
                                 const __grid_constant__ Taps taps,
                                 const Tap* __restrict__ big_taps, int r,
                                 int steps, int has_bc, float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  // A table past Taps' capacity takes the generic kernel (dispatch_taps).
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float smem[];
  const int halo = steps * r;
  const int SH = tile_h + 2 * halo, SW = tile_w + 2 * halo;
  float* cur = smem;
  float* nxt = smem + SH * SW;
  const int row0 = blockIdx.y * tile_h - halo;  // global row of cur[0]
  const int col0 = blockIdx.x * tile_w - halo;
  const Tin* xb = x + blockIdx.z * (size_t)H * W;
  TapRegs<NT> rt;
  rt.init(s_taps, SW);
  // Every cell of this CTA's region off the grid's edge and shell: no cell
  // needs a check (uniform across the CTA).
  const bool inner =
      row0 >= 1 && col0 >= 1 && row0 + SH <= H - 1 && col0 + SW <= W - 1;

  for (int li = threadIdx.y; li < SH; li += blockDim.y)
    for (int lj = threadIdx.x; lj < SW; lj += blockDim.x)
      cur[li * SW + lj] =
          inner ? to_f32(xb[(size_t)(row0 + li) * W + col0 + lj])
                : load_cell(xb, row0 + li, col0 + lj, H, W, has_bc, bc);
  __syncthreads();

  const size_t plane = (size_t)H * W;
  for (int t = 0; t < steps; ++t) {
    const int lo = (t + 1) * r;  // the window still valid after this step
    if (inner) {
      for (int li = lo + threadIdx.y; li < SH - lo; li += blockDim.y) {
        const size_t grow = (size_t)(row0 + li) * W + col0;
        for (int lj = lo + threadIdx.x; lj < SW - lo; lj += blockDim.x)
          nxt[li * SW + lj] = sum_taps<NT>(cur, li * SW + lj, rt, s_taps,
                                           big, SW, fields, plane, grow + lj);
      }
    } else {
      for (int li = lo + threadIdx.y; li < SH - lo; li += blockDim.y)
        for (int lj = lo + threadIdx.x; lj < SW - lo; lj += blockDim.x)
          nxt[li * SW + lj] =
              step_cell<NT>(cur, li * SW + lj, SW, row0 + li, col0 + lj, H,
                            W, rt, s_taps, big, fields, has_bc, bc);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  Tout* ob = out + blockIdx.z * plane;
  for (int ti = threadIdx.y; ti < tile_h; ti += blockDim.y) {
    const int gi = row0 + halo + ti;
    if (gi >= H) break;
    for (int tj = threadIdx.x; tj < tile_w; tj += blockDim.x) {
      const int gj = col0 + halo + tj;
      if (gj < W)
        ob[(size_t)gi * W + gj] =
            from_f32<Tout>(cur[(halo + ti) * SW + halo + tj]);
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(RESIDENT_THREADS)
    resident_kernel(const T* __restrict__ x,
                                const float* __restrict__ fields,
                                T* __restrict__ out, int H, int W,
                                const __grid_constant__ Taps taps,
                                const Tap* __restrict__ big_taps, int r,
                                int steps, int has_bc, float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float smem[];
  const int SH = H + 2 * r, SW = W + 2 * r;
  float* cur = smem;
  float* nxt = smem + SH * SW;
  const T* xb = x + blockIdx.z * (size_t)H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  TapRegs<NT> rt;
  rt.init(s_taps, SW);

  // The zero ring of both buffers is never written again.
  for (int idx = tid; idx < 2 * SH * SW; idx += nthreads) smem[idx] = 0.f;
  __syncthreads();
  for (int i = threadIdx.y; i < H; i += blockDim.y)
    for (int j = threadIdx.x; j < W; j += blockDim.x)
      cur[(i + r) * SW + j + r] = load_cell(xb, i, j, H, W, has_bc, bc);
  __syncthreads();

  const size_t plane = (size_t)H * W;
  for (int t = 0; t < steps; ++t) {
    for (int i = threadIdx.y; i < H; i += blockDim.y)
      for (int j = threadIdx.x; j < W; j += blockDim.x) {
        const int idx = (i + r) * SW + j + r;
        nxt[idx] = has_bc && on_shell(i, j, H, W)
                       ? bc
                       : sum_taps<NT>(cur, idx, rt, s_taps, big, SW,
                                      fields, plane, (size_t)i * W + j);
      }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  T* ob = out + blockIdx.z * plane;
  for (int i = threadIdx.y; i < H; i += blockDim.y)
    for (int j = threadIdx.x; j < W; j += blockDim.x)
      ob[(size_t)i * W + j] = from_f32<T>(cur[(i + r) * SW + j + r]);
}

// Past the default 48 KB (static tap table included) a kernel must opt in.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem + sizeof(Taps) <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Tin, typename Tout>
int launch(int resident, const void* x, const void* fields, void* out, int B,
           int H, int W, int tile_h, int tile_w, const Taps* taps,
           const Tap* big, int r, int steps, int has_bc, float bc,
           size_t smem, cudaStream_t s) {
  const Tin* xt = static_cast<const Tin*>(x);
  Tout* ot = static_cast<Tout*>(out);
  const float* f = static_cast<const float*>(fields);
  return dispatch_taps(taps->n, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if constexpr (std::is_same_v<Tin, Tout>) {
      if (resident) {
        int err = set_smem(resident_kernel<Tin, NT>, smem);
        if (err) return err;
        const dim3 block(32, RESIDENT_THREADS / 32);
        resident_kernel<Tin, NT><<<dim3(1, 1, B), block, smem, s>>>(
            xt, f, ot, H, W, *taps, big, r, steps, has_bc, bc);
        return (int)cudaGetLastError();
      }
    } else if (resident) {
      return (int)cudaErrorInvalidValue;  // one pass: x's type in and out
    }
    int err = set_smem(trapezoid_kernel<Tin, Tout, NT>, smem);
    if (err) return err;
    const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
    const dim3 block(32, TRAPEZOID_THREADS / 32);
    trapezoid_kernel<Tin, Tout, NT><<<grid, block, smem, s>>>(
        xt, f, ot, H, W, tile_h, tile_w, *taps, big, r, steps, has_bc, bc);
    return (int)cudaGetLastError();
  });
}

template <typename Tin>
int launch_in(int out_dtype, int resident, const void* x, const void* fields,
              void* out, int B, int H, int W, int tile_h, int tile_w,
              const Taps* taps, const Tap* big, int r, int steps, int has_bc,
              float bc, size_t smem, cudaStream_t s) {
  if (out_dtype == DTYPE_F32)
    return launch<Tin, float>(resident, x, fields, out, B, H, W, tile_h,
                              tile_w, taps, big, r, steps, has_bc, bc, smem,
                              s);
  if (out_dtype == DTYPE_BF16)
    return launch<Tin, __nv_bfloat16>(resident, x, fields, out, B, H, W,
                                      tile_h, tile_w, taps, big, r, steps,
                                      has_bc, bc, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// resident = 0: trapezoid geometry with a tile_h x tile_w output tile;
// 1: resident geometry (tile ignored; in_dtype == out_dtype).  in_dtype and
// out_dtype are the types of x and out (one pass of several hands the next
// one fp32).  big: the whole tap table on the device when it has more than
// STENCIL_MAX_TAPS taps (taps->n then counts them), else null.  smem is the
// dynamic shared memory in bytes (two fp32 buffers), computed and checked by
// the wrapper.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int jacobi_fused_launch(int resident, const void* x,
                                   const void* fields, void* out, int B,
                                   int H, int W, int tile_h, int tile_w,
                                   int in_dtype, int out_dtype,
                                   const Taps* taps, const Tap* big, int r,
                                   int steps, int has_bc, float bc,
                                   long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((taps->n > STENCIL_MAX_TAPS) != (big != nullptr))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == DTYPE_F32)
    return launch_in<float>(out_dtype, resident, x, fields, out, B, H, W,
                            tile_h, tile_w, taps, big, r, steps, has_bc, bc,
                            (size_t)smem, s);
  if (in_dtype == DTYPE_BF16)
    return launch_in<__nv_bfloat16>(out_dtype, resident, x, fields, out, B,
                                    H, W, tile_h, tile_w, taps, big, r, steps,
                                    has_bc, bc, (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}
