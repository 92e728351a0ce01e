// One 3D stencil step on (B, Z, X, Y): the Hopper port of the TPU kernel
// kernels/stencil3d.py::stencil3d (src/repro, its pl.pallas_call at :117,
// body _kernel/_shift3d).
//
// Computes out[b,z,i,j] = sum_k w_k(z,i,j) * x[b, z+dz_k, i+dr_k, j+dc_k]
// with zero padding outside the grid (in Z too); w_k is a scalar or a
// per-cell field read at the output cell, shared by the batch.  With a bc
// the Dirichlet shell is pinned to it on all six faces (the mask trick,
// fused).  Sums in fp32, in the spec's tap order with one rounding per
// product and per add (so fp32 equals the plain version bit for bit), and
// writes x's type.
//
// Bound: bytes.  One sweep must read x and the V fields and write out,
// (2 + V) * B * Z * X * Y * itemsize, against a few FLOPs per cell.  The TPU
// kernel's layout (Z whole in VMEM, Y padded to 128 lanes, X in 64-row
// blocks) is a TPU artefact and is not carried over.  Here one thread owns
// one output cell; a CTA covers a 8 x 32 (X, Y) patch of one Z plane, so
// every load and store of a warp is 32 consecutive cells along Y, and the
// neighbouring rows and planes the taps re-read come from L1/L2 (a whole
// plane is a few KiB to 1 MiB, far inside the 50 MB L2), not device memory.
// The tap table stays in the kernel's parameter space (__grid_constant__):
// every thread of a warp reads the same tap at once, which the constant
// cache broadcasts, and no CTA spends a copy and a barrier on it.
#include "taps.cuh"

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 8;
constexpr int THREADS = TILE_Y * TILE_X;

__device__ __forceinline__ bool on_shell3(int z, int i, int j, int Z, int X,
                                          int Y) {
  return z == 0 || i == 0 || j == 0 || z == Z - 1 || i == X - 1 ||
         j == Y - 1;
}

// NT > 0: the tap count is a compile-time constant and the interior loop
// unrolls; NT == 0 takes any count.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    stencil3d_kernel(const T* __restrict__ x,
                     const float* __restrict__ fields, T* __restrict__ out,
                     int Z, int X, int Y, int r, int y_tiles,
                     const __grid_constant__ Taps3 taps,
                     const Tap* __restrict__ big_taps, int has_bc,
                     float bc) {
  // A table past Taps3's capacity takes the generic kernel (NT == 0).
  const Tap* big = NT == 0 ? big_taps : nullptr;
  const int j = (blockIdx.x % y_tiles) * TILE_Y + threadIdx.x;
  const int i = (blockIdx.x / y_tiles) * TILE_X + threadIdx.y;
  const int z = blockIdx.y;
  if (i >= X || j >= Y) return;
  const int plane = X * Y;
  const size_t vol = (size_t)Z * plane;  // the batch offset needs 64 bits
  const int cell = z * plane + i * Y + j;  // the wrapper keeps vol < 2^31
  const T* xb = x + blockIdx.z * vol;
  const int n = NT > 0 ? NT : taps.n;
  float acc = 0.f;
  if (has_bc && on_shell3(z, i, j, Z, X, Y)) {
    acc = bc;
  } else if (z >= r && z < Z - r && i >= r && i < X - r && j >= r &&
             j < Y - r) {
    // Every neighbour inside the grid: no bounds checks.
    if constexpr (NT > 0) {
      // All neighbour loads first, in one straight run, so they are in
      // flight together; the weights' branches come after them.
      float v[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k)
        v[k] = to_f32(
            xb[cell + taps.dz[k] * plane + taps.dr[k] * Y + taps.dc[k]]);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const int f = taps.field[k];
        const float w = f < 0 ? taps.w[k] : fields[f * vol + cell];
        acc = __fadd_rn(acc, __fmul_rn(v[k], w));
      }
    } else {
      for (int k = 0; k < n; ++k) {
        const Tap e = tap_at(taps, big, k);
        const float w = e.field < 0 ? e.w : fields[e.field * vol + cell];
        const int off = e.dz * plane + e.dr * Y + e.dc;
        acc = __fadd_rn(acc, __fmul_rn(to_f32(xb[cell + off]), w));
      }
    }
  } else {
    for (int k = 0; k < n; ++k) {
      const Tap e = tap_at(taps, big, k);
      const int zz = z + e.dz, ii = i + e.dr, jj = j + e.dc;
      const float v = (zz >= 0 && zz < Z && ii >= 0 && ii < X && jj >= 0 &&
                       jj < Y)
                          ? to_f32(xb[(zz * X + ii) * Y + jj])
                          : 0.f;
      const float w = e.field < 0 ? e.w : fields[e.field * vol + cell];
      acc = __fadd_rn(acc, __fmul_rn(v, w));
    }
  }
  out[blockIdx.z * vol + cell] = from_f32<T>(acc);
}

// The tap counts of the 3D stencils in use (6: the 7-point Laplace and
// heterogeneous Jacobi; 7: with a centre; 13: the radius-2 star with a
// centre; 27: the 3x3x3 box) unroll; any other count takes NT = 0.
template <typename Launch>
int dispatch_taps3(int n, Launch launch_fn) {
  switch (n) {
    case 6: return launch_fn(std::integral_constant<int, 6>{});
    case 7: return launch_fn(std::integral_constant<int, 7>{});
    case 13: return launch_fn(std::integral_constant<int, 13>{});
    case 27: return launch_fn(std::integral_constant<int, 27>{});
    default: return launch_fn(std::integral_constant<int, 0>{});
  }
}

template <typename T>
int launch(const void* x, const void* fields, void* out, int B, int Z, int X,
           int Y, int r, const Taps3* taps, const Tap* big, int has_bc,
           float bc, cudaStream_t s) {
  const int y_tiles = (Y + TILE_Y - 1) / TILE_Y;
  const int x_tiles = (X + TILE_X - 1) / TILE_X;
  const dim3 block(TILE_Y, TILE_X);
  const dim3 grid(y_tiles * x_tiles, Z, B);
  return dispatch_taps3(taps->n, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    stencil3d_kernel<T, NT><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(fields),
        static_cast<T*>(out), Z, X, Y, r, y_tiles, *taps, big, has_bc, bc);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// r is the spec's radius.  big: the whole table on the device when it has
// more than STENCIL3D_MAX_TAPS taps (taps->n then counts them), else null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stencil3d_launch(const void* x, const void* fields, void* out,
                                int B, int Z, int X, int Y, int r, int dtype,
                                const Taps3* taps, const Tap* big, int has_bc,
                                float bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((taps->n > STENCIL3D_MAX_TAPS) != (big != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return launch<float>(x, fields, out, B, Z, X, Y, r, taps, big, has_bc, bc,
                         s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, fields, out, B, Z, X, Y, r, taps, big,
                                 has_bc, bc, s);
  return (int)cudaErrorInvalidValue;
}
