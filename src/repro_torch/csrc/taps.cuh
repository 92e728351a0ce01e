// Shared by the stencil kernels: the tap table.
//
// Taps arrive in the spec's canonical order (sorted by offset) and every
// kernel sums them in that order, one rounded multiply and one rounded add
// per tap (__fmul_rn/__fadd_rn: no contraction to FMA).  That is the plain
// PyTorch version's arithmetic, so a kernel and its plain version agree bit
// for bit in fp32.
#pragma once

#include <type_traits>

#include "common.cuh"

// Radius 2 in full (a 5x5 box, a 5x5x5 box) fits the kernels' parameter
// tables.  A spec with more taps arrives as a device array of Tap (below).
#define STENCIL_MAX_TAPS 25
#define STENCIL3D_MAX_TAPS 125

// field[k] < 0: tap k has the scalar weight w[k].  Otherwise its weight is
// the per-cell field fields[field[k]] read at the output cell.
struct Taps {
  int n;
  int dr[STENCIL_MAX_TAPS];
  int dc[STENCIL_MAX_TAPS];
  int field[STENCIL_MAX_TAPS];
  float w[STENCIL_MAX_TAPS];
};

// The 3D table: tap k reads the neighbour at (dz, dr, dc) = (z, x, y)
// offsets; field and w as in Taps.
struct Taps3 {
  int n;
  int dz[STENCIL3D_MAX_TAPS];
  int dr[STENCIL3D_MAX_TAPS];
  int dc[STENCIL3D_MAX_TAPS];
  int field[STENCIL3D_MAX_TAPS];
  float w[STENCIL3D_MAX_TAPS];
};

// One tap of a table too large for Taps/Taps3: the wrapper copies such a
// table whole to the device as an array of these (dz = 0 in 2D), and the
// kernels' generic path (NT == 0) reads it through L1 by broadcast.  Its n
// stays in the Taps/Taps3 parameter.
struct Tap {
  int dz, dr, dc, field;
  float w;
};

// Tap k of a 2D or 3D table: from `big` where the wrapper passed one, else
// from the parameter table.
__device__ __forceinline__ Tap tap_at(const Taps& t, const Tap* big, int k) {
  if (big) return big[k];
  return Tap{0, t.dr[k], t.dc[k], t.field[k], t.w[k]};
}
__device__ __forceinline__ Tap tap_at(const Taps3& t, const Tap* big, int k) {
  if (big) return big[k];
  return Tap{t.dz[k], t.dr[k], t.dc[k], t.field[k], t.w[k]};
}

// Copies the tap table into shared memory, where every thread of the block
// reads it by broadcast.  Ends with a barrier.
__device__ __forceinline__ void load_taps(Taps& dst, const Taps& src) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int i = tid; i < (int)(sizeof(Taps) / sizeof(int)); i += nthreads)
    d[i] = s[i];
  __syncthreads();
}

__device__ __forceinline__ bool on_shell(int i, int j, int H, int W) {
  return i == 0 || j == 0 || i == H - 1 || j == W - 1;
}

// The taps one thread applies to a row-major buffer of row stride SW.  For
// NT > 0 the tap count is a compile-time constant: the loops unroll and
// each tap's flat offset, weight and field index sit in registers, read
// once per thread instead of once per cell.  NT == 0 takes any count and
// reads the shared table.
template <int NT>
struct TapRegs {
  static constexpr int N = NT > 0 ? NT : 1;
  int off[N];
  int field[N];
  float w[N];

  __device__ __forceinline__ void init(const Taps& t, int SW) {
    if constexpr (NT > 0) {
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        off[k] = t.dr[k] * SW + t.dc[k];
        field[k] = t.field[k];
        w[k] = t.w[k];
      }
    }
  }
};

// sum_k w_k * buf[idx + off_k] in tap order, every neighbour inside buf.
// Field taps read fields[field_k * plane + cell].  NT == 0 reads tap k
// from big where it is not null (more taps than Taps holds).  FIELDS =
// false promises an NT > 0 table with no field tap: the weights come from
// registers with no per-tap test.
template <int NT, typename E, bool FIELDS = true>
__device__ __forceinline__ float sum_taps(const E* buf, int idx,
                                          const TapRegs<NT>& rt,
                                          const Taps& t, const Tap* big,
                                          int SW,
                                          const float* __restrict__ fields,
                                          size_t plane, size_t cell) {
  float acc = 0.f;
  if constexpr (NT > 0) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float wk = !FIELDS || rt.field[k] < 0
                           ? rt.w[k]
                           : fields[rt.field[k] * plane + cell];
      acc = __fadd_rn(acc, __fmul_rn(to_f32(buf[idx + rt.off[k]]), wk));
    }
  } else {
    for (int k = 0; k < t.n; ++k) {
      const Tap e = tap_at(t, big, k);
      const float wk = e.field < 0 ? e.w : fields[e.field * plane + cell];
      acc = __fadd_rn(acc,
                      __fmul_rn(to_f32(buf[idx + e.dr * SW + e.dc]), wk));
    }
  }
  return acc;
}

// Calls launch_fn<NT>() for the tap counts of the stencils in use (4: the
// 5-point Laplace and heterogeneous Jacobi; 5: with a centre; 8: the
// radius-2 star; 9: the radius-2 star with a centre, the 3x3 box) and the
// generic kernel otherwise.
template <typename Launch>
int dispatch_taps(int n, Launch launch_fn) {
  switch (n) {
    case 4: return launch_fn(std::integral_constant<int, 4>{});
    case 5: return launch_fn(std::integral_constant<int, 5>{});
    case 8: return launch_fn(std::integral_constant<int, 8>{});
    case 9: return launch_fn(std::integral_constant<int, 9>{});
    default: return launch_fn(std::integral_constant<int, 0>{});
  }
}
