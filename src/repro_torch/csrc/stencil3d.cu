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
// blocks) is a TPU artefact and is not carried over.  Two kernels, chosen
// by the tap table, Y and the batch (stencil3d_kernel_for: a dispatch by
// shape, not a fallback):
//   - the unrolled tap counts in use (6: the 7-point Laplace and
//     heterogeneous Jacobi; 7: with a centre; 13: the radius-2 star with a
//     centre; 27: the 3x3x3 box) up to radius 2, on grids whose Y is a
//     multiple of 4 and batches of enough (X, Y) tiles to fill the card,
//     take the Z-streaming kernel (stencil3d_stream below):
//     a CTA owns a 16 x 64 (X, Y) tile of one instance and walks down Z
//     with the planes it needs in a shared-memory ring, so each cell is
//     read from device memory once a sweep; at the paper's 50,000
//     (10, 64, 64) grids that is 200,000 CTAs of 10 planes, where one CTA
//     a plane patch made 8 M;
//   - any other table (a count past those, or a radius past 2, such as the
//     343-tap radius-3 box), Y or small batch (the Fig-6 single-grid solve)
//     takes the cell kernel (stencil3d_kernel):
//     one thread owns one output cell and a CTA an 8 x 32 (X, Y) patch of
//     one Z plane, every load and store of a warp 32 consecutive cells
//     along Y; the neighbours the taps re-read come from L1/L2.
// Both read the tap table from the kernel's parameter space
// (__grid_constant__): every thread of a warp reads the same tap at once,
// which the constant cache broadcasts, and no CTA spends a copy and a
// barrier on it.
#include <cstdint>

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

// The tap counts of the 3D stencils in use (above) unroll; any other count
// takes NT = 0.
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

// --- The Z-streaming kernel (the unrolled tap counts, radius <= 2) ---------
//
// A CTA owns an (X, Y) tile of SX x SY cells of one instance and walks down
// a chunk of Z.  Shared memory holds the tile's planes, with a halo of R
// rows and 4 columns on each side, in x's type, as a ring of 2R + D slots:
// planes z - R .. z + R for the plane z being computed, and the next D
// planes in flight (cp.async, 16 bytes a copy in fp32 and 8 in bf16, each
// 4 cells along Y; reads outside the grid fill zeros, which is the zero
// padding).  So each cell is read from device memory once a sweep, plus the
// tile's halo rows (from L2) and, per Z chunk, 2R planes more; the taps read
// shared memory only, with no bounds checks.  The copies need Y a multiple
// of 4 (16-byte rows in fp32, 8-byte in bf16): any other Y takes the cell
// kernel, as any other tap table does.  A thread computes the 4 cells of
// one Y column SX / 4 rows apart, so a warp reads 32 consecutive elements
// of shared memory a tap (no bank conflicts) and stores one whole line of
// out a cell (128 bytes in fp32, coalesced, 4 bytes a thread).
constexpr int SX = 16;      // X rows of a streaming tile
constexpr int SY = 64;      // Y columns of a streaming tile
constexpr int PAD = 4;      // halo columns each side: one 4-cell copy
constexpr int SROW = SY + 2 * PAD;
constexpr int QROW = SROW / 4;   // 4-cell copies a row
constexpr int STHREADS = 256;
constexpr int ROWS_PER_THREAD = SX * SY / STHREADS;   // 4
constexpr int D = 2;        // planes in flight ahead of the ones computed
// Z chunks: below this many CTAs a launch splits Z so that it still fills
// the card (16 CTAs on each of 132 SMs).
constexpr long long STREAM_CTAS = 132 * 16;
// The fewest cells, over the batch, a launch gives the streaming kernel
// (stencil3d_kernel_for below).
constexpr long long STREAM_MIN_CELLS = 1LL << 20;

template <int R>
struct Ring {
  static constexpr int SLOTS = 2 * R + D;
  static constexpr int ROWS = SX + 2 * R;
  static constexpr int PLANE = ROWS * SROW;   // elements a slot
  static constexpr int COPIES = ROWS * QROW;  // 4-cell copies a plane
};

// A copy of 4 elements of x (16 or 8 bytes) from global into shared
// memory; bytes = 0 fills zeros.
template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src, bool ok) {
  constexpr int BYTES = 4 * sizeof(T);
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's latest copy groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int NT, int R>
__global__ void __launch_bounds__(STHREADS, 4)
    stencil3d_stream(const T* __restrict__ x,
                     const float* __restrict__ fields, T* __restrict__ out,
                     int Z, int X, int Y, int zc, int x_tiles, int y_tiles,
                     const __grid_constant__ Taps3 taps, int has_bc,
                     float bc) {
  using G = Ring<R>;
  __shared__ __align__(16) T ring[G::SLOTS * G::PLANE];
  const int tiles = x_tiles * y_tiles;
  const int tile = blockIdx.x % tiles;
  const int x0 = tile / y_tiles * SX, y0 = tile % y_tiles * SY;
  const int zb = blockIdx.x / tiles * zc;
  const int ze = min(Z, zb + zc);
  const int plane = X * Y;
  const size_t vol = (size_t)Z * plane;  // the batch offset needs 64 bits
  const T* xb = x + blockIdx.z * vol;
  T* ob = out + blockIdx.z * vol;
  auto slot = [&](int p) {
    return ring + (p + G::SLOTS) % G::SLOTS * G::PLANE;
  };

  // Plane p of the tile with its halo into its slot, one commit group
  // (empty past the last plane this chunk reads).
  auto issue = [&](int p) {
    if (p < ze + R) {
      T* dst = slot(p);
      const bool zin = p >= 0 && p < Z;
      for (int i = threadIdx.x; i < G::COPIES; i += STHREADS) {
        const int xx = x0 - R + i / QROW, yy = y0 - PAD + 4 * (i % QROW);
        const bool ok = zin && xx >= 0 && xx < X && yy >= 0 && yy < Y;
        copy4(dst + i * 4, ok ? xb + (p * X + xx) * Y + yy : xb, ok);
      }
    }
    copy_commit();
  };

  // This thread's cells: column y, rows x0 + gx + 4 j.
  const int gx = threadIdx.x / SY, cy = threadIdx.x % SY;
  const int y = y0 + cy;
  const int base = (gx + R) * SROW + PAD + cy;

  for (int p = zb - R; p < zb + R + D; ++p) issue(p);
  for (int z = zb; z < ze; ++z) {
    copy_wait<D - 1>();  // this thread's copies of plane z + R have landed
    __syncthreads();     // and every thread's
    float acc[ROWS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const T* src =
          slot(z + taps.dz[k]) + base + taps.dr[k] * SROW + taps.dc[k];
      const int fk = taps.field[k];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const int xx = x0 + gx + 4 * j;
        const bool inside = xx < X && y < Y;
        const float w =
            fk < 0 ? taps.w[k]
                   : (inside ? fields[fk * vol + z * plane + xx * Y + y] : 0.f);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(src[4 * j * SROW]), w));
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int xx = x0 + gx + 4 * j;
      if (xx < X && y < Y) {
        const bool pinned = has_bc && on_shell3(z, xx, y, Z, X, Y);
        ob[z * plane + xx * Y + y] = from_f32<T>(pinned ? bc : acc[j]);
      }
    }
    __syncthreads();      // every read of plane z - R is done: its slot
    issue(z + R + D);     // takes plane z + R + D
  }
}

template <typename T, int NT, int R>
int launch_stream(const T* x, const float* fields, T* out, int B, int Z,
                  int X, int Y, const Taps3* taps, int has_bc, float bc,
                  cudaStream_t s) {
  const int x_tiles = (X + SX - 1) / SX, y_tiles = (Y + SY - 1) / SY;
  const long long per_chunk = (long long)x_tiles * y_tiles * B;
  int chunks = 1;
  if (per_chunk < STREAM_CTAS) {
    const long long want = (STREAM_CTAS + per_chunk - 1) / per_chunk;
    chunks = want < Z ? (int)want : Z;
  }
  const int zc = (Z + chunks - 1) / chunks;
  chunks = (Z + zc - 1) / zc;
  const dim3 grid(x_tiles * y_tiles * chunks, 1, B);
  stencil3d_stream<T, NT, R><<<grid, STHREADS, 0, s>>>(
      x, fields, out, Z, X, Y, zc, x_tiles, y_tiles, *taps, has_bc, bc);
  return (int)cudaGetLastError();
}

// Whether the streaming kernel can take a table of n taps of radius r on a
// grid of Y columns: the unrolled counts of dispatch_taps3 up to radius 2,
// and Y a multiple of 4 (its 4-cell copies).
bool stream_takes(int n, int r, int Y) {
  return (n == 6 || n == 7 || n == 13 || n == 27) && r <= 2 && Y % 4 == 0;
}

// The two kernels, as stencil3d_kernel_for names them and stencil3d_launch
// takes them.
enum { K4_CELL = 1, K4_STREAM = 2 };

template <typename T>
int launch(const void* x, const void* fields, void* out, int B, int Z, int X,
           int Y, int r, const Taps3* taps, const Tap* big, int kernel,
           int has_bc, float bc, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* ft = static_cast<const float*>(fields);
  T* ot = static_cast<T*>(out);
  return dispatch_taps3(taps->n, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if constexpr (NT > 0) {
      if (kernel == K4_STREAM)
        return r <= 1 ? launch_stream<T, NT, 1>(xt, ft, ot, B, Z, X, Y, taps,
                                                has_bc, bc, s)
                      : launch_stream<T, NT, 2>(xt, ft, ot, B, Z, X, Y, taps,
                                                has_bc, bc, s);
    }
    const int y_tiles = (Y + TILE_Y - 1) / TILE_Y;
    const int x_tiles = (X + TILE_X - 1) / TILE_X;
    const dim3 block(TILE_Y, TILE_X);
    const dim3 grid(y_tiles * x_tiles, Z, B);
    stencil3d_kernel<T, NT><<<grid, block, 0, s>>>(
        xt, ft, ot, Z, X, Y, r, y_tiles, *taps, big, has_bc, bc);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// The kernel a launch of B instances takes (K4_CELL or K4_STREAM): the
// streaming kernel where it can take the table and Y (stream_takes) and
// the batch holds at least STREAM_MIN_CELLS cells; else the cell kernel.
// A dispatch by shape, not a fallback.  Below about a million cells a step
// is a few microseconds of latency either way, and the cell kernel's CTAs,
// one round of loads each, finish before the streaming kernel's ring has
// filled; chip_smoke.py phase 11 times both kernels on 1, 16 and 32 Fig-6
// grids (41 K to 1.3 M cells), where the two cross (PERF.md).
extern "C" int stencil3d_kernel_for(int n_taps, int r, int B, int Z, int X,
                                    int Y) {
  if (!stream_takes(n_taps, r, Y)) return K4_CELL;
  return (long long)B * Z * X * Y >= STREAM_MIN_CELLS ? K4_STREAM : K4_CELL;
}

// r is the spec's radius.  big: the whole table on the device when it has
// more than STENCIL3D_MAX_TAPS taps (taps->n then counts them), else null.
// kernel: K4_CELL, or K4_STREAM where stream_takes and x is aligned to its
// 4-cell copies (16 bytes in fp32, 8 in bf16).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int stencil3d_launch(const void* x, const void* fields, void* out,
                                int B, int Z, int X, int Y, int r, int dtype,
                                const Taps3* taps, const Tap* big, int kernel,
                                int has_bc, float bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((taps->n > STENCIL3D_MAX_TAPS) != (big != nullptr))
    return (int)cudaErrorInvalidValue;
  if (kernel != K4_CELL && kernel != K4_STREAM)
    return (int)cudaErrorInvalidValue;
  if (kernel == K4_STREAM) {
    if (!stream_takes(taps->n, r, Y)) return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(x) % (dtype == DTYPE_F32 ? 16 : 8))
      return (int)cudaErrorMisalignedAddress;
  }
  if (dtype == DTYPE_F32)
    return launch<float>(x, fields, out, B, Z, X, Y, r, taps, big, kernel,
                         has_bc, bc, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, fields, out, B, Z, X, Y, r, taps, big,
                                 kernel, has_bc, bc, s);
  return (int)cudaErrorInvalidValue;
}
