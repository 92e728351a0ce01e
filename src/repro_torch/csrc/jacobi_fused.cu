// T Jacobi steps per pass over device memory on (B, H, W): the Hopper port
// of the TPU kernel kernels/jacobi_fused.py::jacobi2d_fused_step (src/repro),
// in both of its geometries.  Five kernels; the wrapper picks one by shape
// (jacobi_fused.py::kernel_for, a dispatch by shape, not a fallback) or by
// name:
//
// trapezoid (_kernel, pl.pallas_call at :247): the rims are recomputed.
//   stream (K2)   A CTA owns a strip of output columns (at most
//                 STREAM_W - 2 T r) of a chunk of rows of one instance and
//                 walks down the rows.  Each of the T time levels keeps a
//                 small ring of rows in shared memory; a row advance loads
//                 one input row (STREAM_D rows in flight a thread, held in
//                 registers) and computes one row at every level, level t
//                 lagging level t-1 by r+1 rows, so one __syncthreads a row
//                 advance suffices.  Only level T is written out.  The rim
//                 recompute is the strip's column halo and the chunk's
//                 fill, about (BW + 2Tr)/BW x (Hc + T(2r+1))/Hc; the
//                 chunks are as many as a wave of CTAs holds (four waves
//                 below STREAM_U levels).  Inside the grid a level is its
//                 taps' loads, sums and one select, the loads of STREAM_U
//                 levels in flight together.
//   tile          The kernel before the stream one, still faster on small
//                 launches at T = 1-3 and on deep T over few rows (the
//                 shape picks it there): a CTA owns a 64 x 64 output tile,
//                 loads it with a T*r-deep halo and runs the T steps in two
//                 ping-pong buffers, one barrier a step; rim recompute
//                 (64 + 2Tr)^2 / 64^2.
// resident (_resident_kernel, pl.pallas_call at :215): nothing is
// recomputed and T has no bound.
//   regs (K3)     One CTA an instance, its cells in registers: a thread
//                 holds a KC x 2 patch (KC rows a compile-time constant)
//                 for all T steps and exchanges only its patch's edges,
//                 with the next lanes by __shfl and past its warp or
//                 segment through shared memory, one barrier a step.  For
//                 tables in the 3 x 3 window with an instance (the 5-point
//                 star, the 3 x 3 box) on grids of at most 512 threads'
//                 patches.
//   cta           One CTA an instance, the grid in shared memory (two fp32
//                 buffers with a zero ring r deep): for the other one-CTA
//                 grids.  Thread (tx, ty) owns column tx, rows ty + k TY,
//                 computed in branch-free groups of 8, one barrier a step.
//   smem          The one-CTA kernel before the two above: by name only.
//   grid          A grid past one CTA, up to the JAX package's 8 MiB limit
//                 (tiling.resident_fits): a cooperative launch of
//                 persistent CTAs, each walking 16 x 64 tiles (with the
//                 r-deep halo read into shared memory from L2) for all T
//                 steps; the two fp32 ping-pong grids live in device memory
//                 (2 x 8 MiB at most: they stay in the 50 MB L2), and one
//                 grid-wide barrier ends each step.
//
// Semantics of every step, every kernel: cells outside the grid are zero;
// with a bc the Dirichlet shell is pinned to it (before step 1 too); taps
// are scalar or per-cell fields read at the cell's global index, summed in
// the spec's tap order with __fmul_rn/__fadd_rn (taps.cuh), so fp32 equals
// the plain version bit for bit.  The T steps run in fp32 and the result
// is rounded to the output's type once per pass.  A trapezoid of depth T
// whose rings do not fit one CTA runs as several passes of the deepest
// depth that fits; the wrapper hands them fp32 through a scratch buffer (a
// pass reads Tin and writes Tout, each fp32 or bf16), so a bf16 grid is
// still rounded once, after step T, as the TPU kernel rounds it.
//
// Bound: bytes.  A pass must read x once and write it once,
// 2 * B * H * W * itemsize, for T steps of a few FLOPs per cell, so at T=1
// the kernels sit far below the card's ridge point, and each added step
// divides the traffic per step by T until the shared-memory reads (one a
// tap a cell a step) and the instructions around them bound the stream
// kernel.  A small resident grid is bound by one SM: one 64 x 64 instance
// occupies one SM, whose 128 fp32 lanes take about 220 cycles for a
// 5-point step.  With every tap read from shared memory (the cta and smem
// kernels) its 4096 x 5 loads and stores take about 640 cycles of the
// SM's one warp-wide access a cycle; the register kernel reads about 1.5 a
// cell (a shuffle for each of its two neighbour columns a row of two cells,
// the edges), so its bound moves toward the arithmetic.
#include <cstdint>
#include <utility>

#include "taps.cuh"

namespace {

// Threads per CTA.  The launch bounds hold ptxas to what these need: at 1024
// threads a kernel may use at most 64 registers, and a 9-tap kernel left to
// itself takes more and then cannot launch.
constexpr int TILE_THREADS = 32 * 8;
constexpr int SMEM_THREADS = 32 * 32;
constexpr int STREAM_W = 256;  // strip columns, one a thread
constexpr int STREAM_D = 4;    // input rows in flight a thread
constexpr int STREAM_U = 4;    // levels whose loads a thread has in flight
constexpr int GRID_TH = 16, GRID_TW = 64;  // a grid-kernel tile
constexpr int GRID_THREADS = GRID_TW * 4;
constexpr int GRID_LOADS = 8;  // rows of the tile a thread loads at once

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

// --- stream (K2) ------------------------------------------------------------
//
// Shared memory: levels 0..T-1, a ring each of S = 2r + 2 row slots of
// STREAM_W fp32, row q in slot q mod S, the first 2r slots mirrored after
// the last so that the 2r + 1 rows a tap window reads are contiguous; r
// floats of padding before the first ring and after the last.
// Advance s (after one barrier): level 0 takes input row L = R0 + s (its
// register fetched STREAM_D advances ago, converted to fp32 with the shell
// pinned); level t >= 1 computes row L - t (r + 1) from rows
// L - t (r + 1) - r .. + r of level t - 1, all written in earlier advances,
// into a slot no level reads in this advance.  Row q of level t is needed
// for q in [r0 - (T - t) r, r1 + (T - t) r), its columns in
// [t r, STREAM_W - t r); every row and column is computed, and those no
// level needs are read by none that is.
template <typename Tin, typename Tout, int NT, int R, int U>
__global__ void __launch_bounds__(STREAM_W, 1)
    stream_kernel(const Tin* __restrict__ x, const float* __restrict__ fields,
                  Tout* __restrict__ out, int H, int W, int strip_w,
                  int strips, int chunk_h, const __grid_constant__ Taps taps,
                  const Tap* __restrict__ big_taps, int r_arg, int steps,
                  int has_bc, float bc) {
  const int r = R > 0 ? R : r_arg;
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float smem[];
  float* rings = smem + r;  // r floats of padding each side (below)
  const int S = 2 * r + 2;
  const int ring = (S + 2 * r) * STREAM_W;
  const int halo = steps * r;
  const int lj = threadIdx.x;
  const int c0 = (int)(blockIdx.x % strips) * strip_w;
  const int r0 = (int)(blockIdx.x / strips) * chunk_h;
  const int r1 = min(H, r0 + chunk_h);
  const int gj = c0 - halo + lj;
  const bool col_in = gj >= 0 && gj < W;
  const bool col_shell = has_bc && (gj == 0 || gj == W - 1);
  const bool col_out = lj >= halo && lj < halo + strip_w && gj < W;
  // On a row inside the grid: the column's cells are the taps' sum, or
  // col_v (zero off the grid, bc on a pinned column).
  const bool col_plain = col_in && !col_shell;
  const float col_v = col_in ? bc : 0.f;
  const size_t plane = (size_t)H * W;
  const Tin* xb = x + blockIdx.z * plane;
  Tout* ob = out + blockIdx.z * plane;
  TapRegs<NT> rt;
  rt.init(s_taps, STREAM_W);

  const int R0 = r0 - halo;     // input row R0 + s arrives at advance s
  const int Rend = r1 + halo;   // past the last input row needed
  // Advances; the loop below runs whole rounds of D of them, so that the
  // register ring's index is a compile-time constant (the extra advances
  // compute rows no level needs).
  const int n_adv = r1 - R0 + steps * (r + 1);
  auto fetch = [&](int row) {
    return row >= 0 && row < H && row < Rend && col_in
               ? xb[(size_t)row * W + gj]
               : from_f32<Tin>(0.f);
  };
  auto put = [&](float* level, int slot, float v) {
    level[slot * STREAM_W + lj] = v;
    if (slot < 2 * r) level[(slot + S) * STREAM_W + lj] = v;
  };

  constexpr int D = STREAM_D;
  Tin pre[D];
#pragma unroll
  for (int k = 0; k < D; ++k) pre[k] = fetch(R0 + k);
  int A = (R0 % S + S) % S;  // the slot of row L
  for (int s0 = 0; s0 < n_adv; s0 += D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int L = R0 + s0 + k;
      __syncthreads();  // the last advance's rows are written
      float v0 = 0.f;
      if (L >= 0 && L < H && col_in)
        v0 = col_shell || (has_bc && (L == 0 || L == H - 1))
                 ? bc
                 : to_f32(pre[k]);
      pre[k] = fetch(L + D);
      put(rings, A, v0);
      // Slots of level t: odd t reads rows from slot (A + 1) mod S and
      // writes slot (A - r - 1) mod S; even t reads from (A - r) mod S and
      // writes slot A.
      const int read_odd = (A + 1 == S ? 0 : A + 1) + r;
      const int write_odd = A >= r + 1 ? A - r - 1 : A + r + 1;
      const int read_even = (A >= r ? A - r : A + r + 2) + r;
      // Level t's value of row q: zero off the grid, bc on a pinned shell.
      auto finish = [&](int t, float sum, int write) {
        const int q = L - t * (r + 1);
        const bool inside = q >= 0 && q < H && col_in;
        const float v =
            !inside ? 0.f
                    : (col_shell || (has_bc && (q == 0 || q == H - 1)) ? bc
                                                                        : sum);
        if (t < steps)
          put(rings + t * ring, write, v);
        else if (col_out && q >= r0 && q < r1)
          ob[(size_t)q * W + gj] = from_f32<Tout>(v);
      };
      // Every level computes its row whether or not a later level needs it
      // (a row or column no level needs is never read by one that is), so
      // a level runs without branches; the padding keeps the reads of the
      // strip's first and last columns inside shared memory.
      auto level = [&](int t, int read, int write) {
        const int q = L - t * (r + 1);
        const bool inside = q >= 0 && q < H && col_in;
        // An unrolled table (NT > 0) has no field tap here (launch).
        finish(t, sum_taps<NT, float, NT == 0>(
                      rings + (t - 1) * ring + read * STREAM_W, lj, rt,
                      s_taps, big, STREAM_W, fields, plane,
                      inside ? (size_t)q * W + gj : 0),
               write);
      };
      // An advance whose rows all lie inside the grid, off its first and
      // last rows (most of them), computes levels 1..T-1 on a fast path:
      // N levels at a time, all their taps' loads first, then the sums,
      // then the stores (no level reads the slot another writes in this
      // advance, so the loads need not wait for the stores and are in
      // flight together), the column's own zero or bc by one select, the
      // offsets between levels immediates when R is known.  The other
      // advances, and level T, take the checks of `level`.
      int t = 1;
      if constexpr (NT > 0) {
        if (L - steps * (r + 1) >= 1 && L <= H - 2) {
          auto fast = [&](auto n) {
            constexpr int N = decltype(n)::value;
            const float* b = rings + (t - 1) * ring + lj;
            const bool odd = N > 1 || (t & 1);  // groups start at odd t
            float val[N][NT];
#pragma unroll
            for (int u = 0; u < N; ++u)
#pragma unroll
              for (int k = 0; k < NT; ++k)
                val[u][k] = b[u * ring + ((u & 1) != odd ? read_odd
                                                          : read_even) *
                                             STREAM_W + rt.off[k]];
#pragma unroll
            for (int u = 0; u < N; ++u) {
              float acc = 0.f;
#pragma unroll
              for (int k = 0; k < NT; ++k)
                acc = __fadd_rn(acc, __fmul_rn(val[u][k], rt.w[k]));
              put(rings + (t + u) * ring,
                  (u & 1) != odd ? write_odd : A, col_plain ? acc : col_v);
            }
          };
          if constexpr (U > 1)
            for (; t + U <= steps; t += U)
              fast(std::integral_constant<int, U>{});
          for (; t < steps; ++t) fast(std::integral_constant<int, 1>{});
        }
      }
      for (; t <= steps; ++t)
        level(t, t & 1 ? read_odd : read_even, t & 1 ? write_odd : A);
      A = A + 1 == S ? 0 : A + 1;
    }
  }
}

// --- tile (K2's kernel before the stream one) --------------------------------
template <typename Tin, typename Tout, int NT>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_kernel(const Tin* __restrict__ x, const float* __restrict__ fields,
                Tout* __restrict__ out, int H, int W, int tile_h, int tile_w,
                const __grid_constant__ Taps taps,
                const Tap* __restrict__ big_taps, int r, int steps,
                int has_bc, float bc) {
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

// Both one-CTA kernels: zero the two (H + 2r) x (W + 2r) buffers (the zero
// ring is never written again), then x with the shell pinned into both, so
// a pinned cell holds bc in either buffer without being written again.
template <typename T>
__device__ __forceinline__ void load_resident(float* smem, const T* xb,
                                              int H, int W, int r,
                                              int has_bc, float bc) {
  const int SW = W + 2 * r, n = (H + 2 * r) * SW;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int idx = tid; idx < 2 * n; idx += nthreads) smem[idx] = 0.f;
  __syncthreads();
  constexpr int G = 8;  // rows of a thread's loads in flight together
  for (int j = threadIdx.x; j < W; j += blockDim.x)
    for (int i = threadIdx.y; i < H; i += G * blockDim.y) {
      float v[G];
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int ii = i + m * blockDim.y;
        v[m] = ii < H ? load_cell(xb, ii, j, H, W, has_bc, bc) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int ii = i + m * blockDim.y;
        if (ii < H) {
          smem[(ii + r) * SW + j + r] = v[m];
          smem[n + (ii + r) * SW + j + r] = v[m];
        }
      }
    }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void store_resident(T* ob, const float* cur, int H,
                                               int W, int r) {
  const int SW = W + 2 * r;
  for (int i = threadIdx.y; i < H; i += blockDim.y)
    for (int j = threadIdx.x; j < W; j += blockDim.x)
      ob[(size_t)i * W + j] = from_f32<T>(cur[(i + r) * SW + j + r]);
}

// --- regs (K3) ----------------------------------------------------------------
//
// Thread (tx, ty) of a TX x TY CTA (TX = round_up(ceil(W / 2), 32), so a
// warp is one row of threads) keeps the cells of rows ty KC .. ty KC + KC - 1
// and columns 2 tx, 2 tx + 1 in registers for all T steps, KC a
// compile-time constant (the patch from the grid's shape:
// jacobi_fused.py::regs_patch).  The taps lie in the 3 x 3 window and their
// offsets are a compile-time MASK, bit 3 (dr + 1) + dc + 1 (the canonical
// tap order is the bits' order).  A step reads its own two columns from
// registers, the columns beside them from the next lanes by __shfl, and
// from shared memory only what lies past its segment or its warp: the rows
// above and below the segment (written by the threads above and below) and,
// for a warp's first and last lane, the column beside the warp (written by
// the warp beside it).  A step writes only those edges, into the other of
// two buffers, and ends in one barrier.  A cell off the grid holds 0 and a
// pinned shell cell bc: a per-thread mask computed once keeps them, with no
// branch a step.
constexpr int REGS_MAX_THREADS = 512;
// The masks with an instance: the 5-point star (Laplace, heterogeneous
// Jacobi) and the 3 x 3 box.
constexpr int MASK_STAR = 0x0AA, MASK_BOX = 0x1FF;

__host__ __device__ constexpr int mask_taps(int mask) {
  int n = 0;
  for (int b = 0; b < 9; ++b) n += mask >> b & 1;
  return n;
}

// The window position (bit) of tap k of a mask: its k-th set bit.
__host__ __device__ constexpr int mask_bit(int mask, int k) {
  for (int b = 0; b < 9; ++b)
    if (mask >> b & 1) {
      if (k == 0) return b;
      --k;
    }
  return -1;
}

// f(integral_constant<int, i>) for i = 0 .. N - 1, each i a constant.
template <typename F, int... I>
__device__ __forceinline__ void unroll_seq(F& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void unroll(F f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

// Floats of one of the register kernel's two edge buffers: rows, for each
// of TY + 1 boundaries between rows of threads, the row above (side 0) and
// below it (side 1), each of 2 TX + 4 columns (column c at c + 2, the rest
// zero); then columns, for each row of threads and each of TX / 32 + 1
// boundaries between warps, the column left (side 0) and right of it (1),
// KC rows each.
__host__ __device__ constexpr int regs_edge_floats(int TX, int TY, int KC) {
  return (TY + 1) * 2 * (2 * TX + 4) + TY * (TX / 32 + 1) * 2 * KC;
}

template <typename T, int MASK, int KC, bool FIELDS>
__global__ void __launch_bounds__(REGS_MAX_THREADS)
    regs_kernel(const T* __restrict__ x, const float* __restrict__ fields,
                T* __restrict__ out, int H, int W,
                const __grid_constant__ Taps taps, int steps, int has_bc,
                float bc) {
  constexpr int NT = mask_taps(MASK);
  constexpr bool CORNERS = (MASK & 0x145) != 0;  // bits 0, 2, 6, 8
  extern __shared__ __align__(16) float edges[];
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y, lane = tx & 31, wx = tx / 32;
  const int RW = 2 * TX + 4;
  const int rows_n = (TY + 1) * 2 * RW;
  const int buf_n = regs_edge_floats(TX, TY, KC);
  const int tid = ty * TX + tx;
  for (int i = tid; i < 2 * buf_n; i += TX * TY) edges[i] = 0.f;

  const int i0 = ty * KC, j0 = 2 * tx;
  const int plane = H * W;
  const T* xb = x + blockIdx.z * (size_t)plane;
  float w[NT];
  int fi[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    w[k] = taps.w[k];
    fi[k] = taps.field[k];
  }
  float v[KC][2];
  unsigned live[2] = {0u, 0u};  // bit k: cell k is in the grid, not pinned
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + k, j = j0 + c;
      v[k][c] = load_cell(xb, i, j, H, W, has_bc, bc);
      if (i < H && j < W && !(has_bc && on_shell(i, j, H, W)))
        live[c] |= 1u << k;
    }

  auto row_at = [&](float* b, int boundary, int side) {
    return b + (boundary * 2 + side) * RW + 2;
  };
  auto col_at = [&](float* b, int boundary, int side) {
    return b + rows_n + ((ty * (TX / 32 + 1) + boundary) * 2 + side) * KC;
  };
  // The edges others read: the segment's first and last rows; a warp's
  // first and last columns.
  auto publish = [&](float* b) {
    *reinterpret_cast<float2*>(row_at(b, ty, 1) + j0) =
        make_float2(v[0][0], v[0][1]);
    *reinterpret_cast<float2*>(row_at(b, ty + 1, 0) + j0) =
        make_float2(v[KC - 1][0], v[KC - 1][1]);
    auto column = [&](float* col, auto cc) {
      constexpr int c = decltype(cc)::value;
#pragma unroll
      for (int q = 0; q < KC; q += 4)
        *reinterpret_cast<float4*>(col + q) =
            make_float4(v[q][c], v[q + 1][c], v[q + 2][c], v[q + 3][c]);
    };
    if (lane == 0) column(col_at(b, wx, 1), std::integral_constant<int, 0>{});
    if (lane == 31)
      column(col_at(b, wx + 1, 0), std::integral_constant<int, 1>{});
  };
  __syncthreads();  // the buffers are zero
  publish(edges);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    float* cur = s & 1 ? edges + buf_n : edges;
    float* nxt = s & 1 ? edges : edges + buf_n;
    // Rows above (u) and below (d) the segment, columns j0 - 1 .. j0 + 2.
    float u[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const float* up = row_at(cur, ty, 0) + j0;
      const float* dn = row_at(cur, ty + 1, 1) + j0;
      const float2 u2 = *reinterpret_cast<const float2*>(up);
      const float2 d2 = *reinterpret_cast<const float2*>(dn);
      u[1] = u2.x, u[2] = u2.y, d[1] = d2.x, d[2] = d2.y;
      if constexpr (CORNERS) {
        u[0] = up[-1], u[3] = up[2];
        d[0] = dn[-1], d[3] = dn[2];
      }
    }
    // Columns j0 - 1 (l) and j0 + 2 (r): the next lanes', or past the
    // warp's edge the warp beside's.
    float l[KC], r[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      l[k] = __shfl_up_sync(0xffffffffu, v[k][1], 1);
      r[k] = __shfl_down_sync(0xffffffffu, v[k][0], 1);
    }
    if (lane == 0 || lane == 31) {
      const float* col = lane == 0 ? col_at(cur, wx, 0)
                                   : col_at(cur, wx + 1, 1);
      float e[KC];
#pragma unroll
      for (int q = 0; q < KC; q += 4) {
        const float4 f4 = *reinterpret_cast<const float4*>(col + q);
        e[q] = f4.x, e[q + 1] = f4.y, e[q + 2] = f4.z, e[q + 3] = f4.w;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (lane == 0) l[k] = e[k];
        else r[k] = e[k];
      }
    }
    float nv[KC][2];
    unroll<KC>([&](auto kk) {
      constexpr int k = decltype(kk)::value;
      unroll<2>([&](auto cc) {
        constexpr int c = decltype(cc)::value;
        float acc = 0.f;
        unroll<NT>([&](auto tt) {
          constexpr int t = decltype(tt)::value;
          constexpr int bit = mask_bit(MASK, t);
          constexpr int m = k + bit / 3 - 1, n = c + bit % 3 - 1;
          float val;
          if constexpr (m < 0) val = u[n + 1];
          else if constexpr (m >= KC) val = d[n + 1];
          else if constexpr (n < 0) val = l[m];
          else if constexpr (n > 1) val = r[m];
          else val = v[m][n];
          float wt = w[t];
          if constexpr (FIELDS) {
            const int cell = min((i0 + k) * W + j0 + c, plane - 1);
            if (fi[t] >= 0) wt = fields[fi[t] * (size_t)plane + cell];
          }
          acc = __fadd_rn(acc, __fmul_rn(val, wt));
        });
        nv[k][c] = live[c] >> k & 1 ? acc : v[k][c];
      });
    });
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k][0] = nv[k][0], v[k][1] = nv[k][1];
    publish(nxt);
    __syncthreads();
  }
  T* ob = out + blockIdx.z * (size_t)plane;
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (i0 + k < H && j0 + c < W)
        ob[(size_t)(i0 + k) * W + j0 + c] = from_f32<T>(v[k][c]);
}

// The mask of a table whose taps all lie in the 3 x 3 window, else -1.
inline int window_mask(const Taps& t) {
  if (t.n > STENCIL_MAX_TAPS) return -1;
  int mask = 0;
  for (int k = 0; k < t.n; ++k) {
    if (t.dr[k] < -1 || t.dr[k] > 1 || t.dc[k] < -1 || t.dc[k] > 1)
      return -1;
    mask |= 1 << (3 * (t.dr[k] + 1) + t.dc[k] + 1);
  }
  return mask_taps(mask) == t.n ? mask : -1;
}

// --- cta (one CTA, cells in shared memory) ----------------------------------
//
// For the one-CTA grids the register kernel does not take (a table past the
// 3 x 3 window or without an instance, a grid past its patch): thread
// (tx, ty) of a round_up(W, 32) x TY CTA owns column tx, rows ty + k TY for
// k < kc (a multiple of CTA_GROUP, from the grid's shape:
// jacobi_fused.py::cta_patch).  Its live cells (in the grid, off a pinned
// shell; a pinned cell keeps bc in both buffers) are the rows k in
// [k_lo, k_hi) of a live column, computed once.  A step computes them in
// groups of CTA_GROUP independent cells (the taps' loads of a group in
// flight together, from the whole grid in shared memory), one barrier a
// step.
constexpr int CTA_MAX_THREADS = 512;
constexpr int CTA_GROUP = 8;

template <typename T, int NT, bool FIELDS>
__global__ void __launch_bounds__(CTA_MAX_THREADS)
    cta_kernel(const T* __restrict__ x, const float* __restrict__ fields,
               T* __restrict__ out, int H, int W, int kc,
               const __grid_constant__ Taps taps,
               const Tap* __restrict__ big_taps, int r, int steps,
               int has_bc, float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float smem[];
  const int SW = W + 2 * r;
  float* cur = smem;
  float* nxt = smem + (H + 2 * r) * SW;
  const size_t plane = (size_t)H * W;
  const T* xb = x + blockIdx.z * plane;
  load_resident(smem, xb, H, W, r, has_bc, bc);
  TapRegs<NT> rt;
  rt.init(s_taps, SW);

  const int j = threadIdx.x, i0 = threadIdx.y, TY = blockDim.y;
  const bool col_live = j < W && !(has_bc && (j == 0 || j == W - 1));
  const int rows = i0 < H ? (H - 1 - i0) / TY + 1 : 0;  // k with i < H
  const int k_lo = has_bc && i0 == 0 ? 1 : 0;
  const int k_hi =
      !col_live ? 0
                : rows - (has_bc && rows > 0 && i0 + (rows - 1) * TY == H - 1);
  // A cell past the grid reads the taps of cell (0, 0) instead, so every
  // cell's loads are in bounds and a group's run without branches; only
  // the live cells store.
  const bool any = j < W && rows > 0;
  const int base = any ? (i0 + r) * SW + j + r : r * SW + r;
  const int stride = TY * SW, last = any ? rows - 1 : 0;
  const size_t cell = any ? (size_t)i0 * W + j : 0;
  const size_t cell_stride = (size_t)TY * W;

  for (int t = 0; t < steps; ++t) {
    for (int g = 0; g < kc; g += CTA_GROUP) {
      float v[CTA_GROUP];
#pragma unroll
      for (int c = 0; c < CTA_GROUP; ++c) {
        const int k = min(g + c, last);
        v[c] = sum_taps<NT, float, FIELDS>(cur, base + k * stride, rt, s_taps,
                                           big, SW, fields, plane,
                                           cell + k * cell_stride);
      }
#pragma unroll
      for (int c = 0; c < CTA_GROUP; ++c)
        if (g + c >= k_lo && g + c < k_hi) nxt[base + (g + c) * stride] = v[c];
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  store_resident(out + blockIdx.z * plane, cur, H, W, r);
}

// --- smem (K3's kernel before the register one) ----------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(SMEM_THREADS)
    smem_kernel(const T* __restrict__ x, const float* __restrict__ fields,
                T* __restrict__ out, int H, int W,
                const __grid_constant__ Taps taps,
                const Tap* __restrict__ big_taps, int r, int steps,
                int has_bc, float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float smem[];
  const int SW = W + 2 * r;
  float* cur = smem;
  float* nxt = smem + (H + 2 * r) * SW;
  const size_t plane = (size_t)H * W;
  const T* xb = x + blockIdx.z * plane;
  load_resident(smem, xb, H, W, r, has_bc, bc);
  TapRegs<NT> rt;
  rt.init(s_taps, SW);

  for (int t = 0; t < steps; ++t) {
    for (int i = threadIdx.y; i < H; i += blockDim.y)
      for (int j = threadIdx.x; j < W; j += blockDim.x) {
        const int idx = (i + r) * SW + j + r;
        nxt[idx] = has_bc && on_shell(i, j, H, W)
                       ? bc
                       : sum_taps<NT>(cur, idx, rt, s_taps, big, SW, fields,
                                      plane, (size_t)i * W + j);
      }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  store_resident(out + blockIdx.z * plane, cur, H, W, r);
}

// --- grid (resident past one CTA) -------------------------------------------
//
// All CTAs are resident at once (a cooperative launch), so a CTA may wait
// for all the others: each arrives on a 64-bit counter (zeroed by the
// wrapper before the launch) and waits until every CTA has arrived `target`
// times in all.  The fences publish this CTA's stores before its arrival
// and order the wait before its next loads, which read the other CTAs'
// stores through L2 (ld.global.cg: L1 is not coherent).
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
    unsigned long long seen;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                   : "=l"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

template <typename T, int NT>
__global__ void __launch_bounds__(GRID_THREADS)
    grid_kernel(const T* __restrict__ x, const float* __restrict__ fields,
                T* __restrict__ out, float* buf, unsigned long long* bar,
                int B, int H, int W, const __grid_constant__ Taps taps,
                const Tap* __restrict__ big_taps, int r, int steps,
                int has_bc, float bc) {
  __shared__ Taps s_taps;
  load_taps(s_taps, taps);
  const Tap* big = NT == 0 ? big_taps : nullptr;
  extern __shared__ float tile[];
  const int SH = GRID_TH + 2 * r, SW = GRID_TW + 2 * r;
  const int tiles_x = (W + GRID_TW - 1) / GRID_TW;
  const int tiles_y = (H + GRID_TH - 1) / GRID_TH;
  const int tiles = B * tiles_x * tiles_y;
  const size_t plane = (size_t)H * W;
  TapRegs<NT> rt;
  rt.init(s_taps, SW);

  for (int t = 0; t < steps; ++t) {
    // Step t reads x (t = 0) or buf[(t - 1) % 2] and writes buf[t % 2], or
    // out after the last step.
    const float* src = buf + ((t + 1) & 1) * B * plane;
    float* dst = buf + (t & 1) * B * plane;
    const bool last = t == steps - 1;
    for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
      const int b = id / (tiles_x * tiles_y);
      const int rest = id % (tiles_x * tiles_y);
      const int row0 = rest / tiles_x * GRID_TH - r;
      const int col0 = rest % tiles_x * GRID_TW - r;
      // The tile with its halo: GRID_LOADS rows of two columns a thread in
      // flight at once, then into shared memory.
      for (int lj0 = 0; lj0 < SW; lj0 += 2 * GRID_TW)
      for (int li0 = 0; li0 < SH; li0 += GRID_LOADS * GRID_THREADS / GRID_TW)
      {
        float v[GRID_LOADS][2];
#pragma unroll
        for (int m = 0; m < GRID_LOADS; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int li = li0 + threadIdx.y + m * blockDim.y;
            const int lj = lj0 + threadIdx.x + c * GRID_TW;
            const int gi = row0 + li, gj = col0 + lj;
            if (li >= SH || lj >= SW)
              v[m][c] = 0.f;
            else if (t == 0)
              v[m][c] = load_cell(x + b * plane, gi, gj, H, W, has_bc, bc);
            else
              v[m][c] = gi >= 0 && gi < H && gj >= 0 && gj < W
                            ? __ldcg(src + b * plane + (size_t)gi * W + gj)
                            : 0.f;
          }
#pragma unroll
        for (int m = 0; m < GRID_LOADS; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int li = li0 + threadIdx.y + m * blockDim.y;
            const int lj = lj0 + threadIdx.x + c * GRID_TW;
            if (li < SH && lj < SW) tile[li * SW + lj] = v[m][c];
          }
      }
      __syncthreads();
      for (int li = threadIdx.y; li < GRID_TH; li += blockDim.y) {
        const int gi = row0 + r + li, gj = col0 + r + threadIdx.x;
        if (gi >= H || gj >= W) continue;
        const float v = step_cell<NT>(tile, (li + r) * SW + threadIdx.x + r,
                                      SW, gi, gj, H, W, rt, s_taps, big,
                                      fields, has_bc, bc);
        const size_t at = b * plane + (size_t)gi * W + gj;
        if (last)
          out[at] = from_f32<T>(v);
        else
          dst[at] = v;
      }
      __syncthreads();  // the tile is read before the next one is loaded
    }
    if (!last) grid_barrier(bar, (unsigned long long)(t + 1) * gridDim.x);
  }
}

// Past the default 48 KB (static tap table included) a kernel must opt in.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem + sizeof(Taps) <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The kernels, as jacobi_fused.py's KERNELS names them; K_STREAM_R0 and
// K_STREAM_U1 are the stream kernel with the radius a runtime value, and
// with one level at a time (by name only, to time the variants K_STREAM
// picks against them).
enum {
  K_TILE = 1, K_STREAM = 2, K_SMEM = 3, K_REGS = 4, K_GRID = 5, K_CTA = 6,
  K_STREAM_R0 = 7, K_STREAM_U1 = 8
};

// What one launch takes beyond x, fields and out.
struct Geometry {
  // tile: tile_h, tile_w; stream: strip_w, strips, waves, the fewest rows
  // a chunk; regs: the CTA's rows of threads, rows a thread (KC); cta: the
  // CTA's rows of threads, cells a thread.
  int p0, p1, p2, p3;
  float* buf;      // grid: two fp32 grids of B instances (steps > 1)
  unsigned long long* bar;  // grid: the barrier's counter, zeroed
};

template <typename T>
int launch_regs(const T* x, const float* f, T* out, int B, int H, int W,
                const Geometry& g, const Taps* taps, int steps, int has_bc,
                float bc, cudaStream_t s) {
  const int TX = ((W + 1) / 2 + 31) / 32 * 32, TY = g.p0, KC = g.p1;
  const int mask = window_mask(*taps);
  if (TX * TY > REGS_MAX_THREADS || (long long)TY * KC < H)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)regs_edge_floats(TX, TY, KC) * 4;
  auto go = [&](auto kernel) {
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<dim3(1, 1, B), dim3(TX, TY), smem, s>>>(x, f, out, H, W, *taps,
                                                     steps, has_bc, bc);
    return (int)cudaGetLastError();
  };
  auto by_fields = [&](auto m, auto kc) {
    constexpr int M = decltype(m)::value, K = decltype(kc)::value;
    return f ? go(regs_kernel<T, M, K, true>) : go(regs_kernel<T, M, K, false>);
  };
  auto by_rows = [&](auto m) {
    switch (KC) {
      case 4: return by_fields(m, std::integral_constant<int, 4>{});
      case 8: return by_fields(m, std::integral_constant<int, 8>{});
      case 16: return by_fields(m, std::integral_constant<int, 16>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (mask == MASK_STAR)
    return by_rows(std::integral_constant<int, MASK_STAR>{});
  if (mask == MASK_BOX) return by_rows(std::integral_constant<int, MASK_BOX>{});
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NT>
int launch_cta(const T* x, const float* f, T* out, int B, int H, int W,
               const Geometry& g, const Taps* taps, const Tap* big, int r,
               int steps, int has_bc, float bc, size_t smem,
               cudaStream_t s) {
  const dim3 block((W + 31) / 32 * 32, g.p0);
  if (block.x * block.y > CTA_MAX_THREADS || g.p1 % CTA_GROUP ||
      (long long)g.p0 * g.p1 < H)
    return (int)cudaErrorInvalidValue;
  // Without fields the unrolled tables' weights come from registers with
  // no per-tap test (PERF.md: the test doubles a step's time).
  auto go = [&](auto kernel) {
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<dim3(1, 1, B), block, smem, s>>>(x, f, out, H, W, g.p1, *taps,
                                              big, r, steps, has_bc, bc);
    return (int)cudaGetLastError();
  };
  if constexpr (NT > 0)
    if (!f) return go(cta_kernel<T, NT, false>);
  return go(cta_kernel<T, NT, true>);
}

template <typename T, int NT>
int launch_grid(const T* x, const float* f, T* out, int B, int H, int W,
                const Geometry& g, const Taps* taps, const Tap* big, int r,
                int steps, int has_bc, float bc, cudaStream_t s) {
  auto kernel = grid_kernel<T, NT>;
  const size_t smem = (size_t)(GRID_TH + 2 * r) * (GRID_TW + 2 * r) * 4;
  int err = set_smem(kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, GRID_THREADS, smem)))
    return err;
  const long long tiles = (long long)B * ((H + GRID_TH - 1) / GRID_TH) *
                          ((W + GRID_TW - 1) / GRID_TW);
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(tiles < resident ? tiles : resident));
  const dim3 block(GRID_TW, GRID_THREADS / GRID_TW);
  float* buf = g.buf;
  unsigned long long* bar = g.bar;
  Taps t = *taps;
  void* args[] = {(void*)&x,  (void*)&f,   (void*)&out, (void*)&buf,
                  (void*)&bar, (void*)&B,  (void*)&H,   (void*)&W,
                  (void*)&t,  (void*)&big, (void*)&r,   (void*)&steps,
                  (void*)&has_bc, (void*)&bc};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, grid, block,
                                          args, smem, s);
}

template <typename Tin, typename Tout>
int launch(int kernel, const void* x, const void* fields, void* out, int B,
           int H, int W, const Geometry& g, const Taps* taps, const Tap* big,
           int r, int steps, int has_bc, float bc, size_t smem,
           cudaStream_t s) {
  const Tin* xt = static_cast<const Tin*>(x);
  Tout* ot = static_cast<Tout*>(out);
  const float* f = static_cast<const float*>(fields);
  // The stream kernel's unrolled tables carry scalar weights only: a table
  // with a field tap takes its generic kernel.
  const bool stream =
      kernel == K_STREAM || kernel == K_STREAM_R0 || kernel == K_STREAM_U1;
  const int n = stream && f ? 0 : taps->n;
  if constexpr (std::is_same_v<Tin, Tout>) {
    if (kernel == K_REGS)
      return launch_regs<Tin>(xt, f, ot, B, H, W, g, taps, steps, has_bc, bc,
                              s);
  }
  return dispatch_taps(n, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (stream) {
      auto go = [&](auto k) {
        int err = set_smem(k, smem);
        if (err) return err;
        // Rows in as many chunks as g.p2 waves of CTAs on the card hold
        // beside the strips and the batch (whole waves leave no SM idle at
        // the end), of at least g.p3 rows (a CTA's own start costs a few
        // advances).
        int dev = 0, sms = 0, per_sm = 0;
        if ((err = (int)cudaGetDevice(&dev))) return err;
        if ((err = (int)cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)))
          return err;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, k, STREAM_W, smem)))
          return err;
        const long long across = (long long)g.p1 * B;
        long long chunks = (long long)per_sm * sms * g.p2 / across;
        const long long most = (H + g.p3 - 1) / g.p3;
        chunks = chunks < 1 ? 1 : chunks > most ? most : chunks;
        const int chunk_h = (int)((H + chunks - 1) / chunks);
        chunks = (H + chunk_h - 1) / chunk_h;
        k<<<dim3((unsigned)(g.p1 * chunks), 1, B), STREAM_W, smem, s>>>(
            xt, f, ot, H, W, g.p0, g.p1, chunk_h, *taps, big, r, steps,
            has_bc, bc);
        return (int)cudaGetLastError();
      };
      // Fewer levels than a group: one level at a time; more: groups of
      // STREAM_U, the radius-1 offsets as immediates.
      if constexpr (NT > 0) {
        if (steps >= STREAM_U && kernel != K_STREAM_U1)
          return r == 1 && kernel == K_STREAM
                     ? go(stream_kernel<Tin, Tout, NT, 1, STREAM_U>)
                     : go(stream_kernel<Tin, Tout, NT, 0, STREAM_U>);
      }
      return go(stream_kernel<Tin, Tout, NT, 0, 1>);
    }
    if (kernel == K_TILE) {
      auto k = tile_kernel<Tin, Tout, NT>;
      int err = set_smem(k, smem);
      if (err) return err;
      const dim3 grid((W + g.p1 - 1) / g.p1, (H + g.p0 - 1) / g.p0, B);
      const dim3 block(32, TILE_THREADS / 32);
      k<<<grid, block, smem, s>>>(xt, f, ot, H, W, g.p0, g.p1, *taps, big, r,
                                  steps, has_bc, bc);
      return (int)cudaGetLastError();
    }
    // The resident kernels run one pass: x's type in and out.
    if constexpr (std::is_same_v<Tin, Tout>) {
      if (kernel == K_CTA)
        return launch_cta<Tin, NT>(xt, f, ot, B, H, W, g, taps, big, r, steps,
                                   has_bc, bc, smem, s);
      if (kernel == K_GRID) {
        int err = launch_grid<Tin, NT>(xt, f, ot, B, H, W, g, taps, big, r,
                                       steps, has_bc, bc, s);
        return err ? err : (int)cudaGetLastError();
      }
      if (kernel == K_SMEM) {
        auto k = smem_kernel<Tin, NT>;
        int err = set_smem(k, smem);
        if (err) return err;
        k<<<dim3(1, 1, B), dim3(32, SMEM_THREADS / 32), smem, s>>>(
            xt, f, ot, H, W, *taps, big, r, steps, has_bc, bc);
        return (int)cudaGetLastError();
      }
    }
    return (int)cudaErrorInvalidValue;
  });
}

template <typename Tin>
int launch_in(int out_dtype, int kernel, const void* x, const void* fields,
              void* out, int B, int H, int W, const Geometry& g,
              const Taps* taps, const Tap* big, int r, int steps, int has_bc,
              float bc, size_t smem, cudaStream_t s) {
  if (out_dtype == DTYPE_F32)
    return launch<Tin, float>(kernel, x, fields, out, B, H, W, g, taps, big,
                              r, steps, has_bc, bc, smem, s);
  if (out_dtype == DTYPE_BF16)
    return launch<Tin, __nv_bfloat16>(kernel, x, fields, out, B, H, W, g,
                                      taps, big, r, steps, has_bc, bc, smem,
                                      s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kernel: one of the K_* codes (jacobi_fused.py's KERNELS), with its
// geometry p0..p3 as struct Geometry says (computed and checked by the
// wrapper), and for K_GRID the scratch grids `buf` (null
// when steps == 1) and the zeroed barrier counter `bar`.  in_dtype and
// out_dtype are the types of x and out (a trapezoid pass of several hands
// the next one fp32; the resident kernels take x's type in and out).  big:
// the whole tap table on the device when it has more than STENCIL_MAX_TAPS
// taps (taps->n then counts them), else null.  smem is the dynamic shared
// memory in bytes (K_GRID's is fixed by r, K_REGS's by its patch).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int jacobi_fused_launch(int kernel, const void* x,
                                   const void* fields, void* out, void* buf,
                                   void* bar, int B, int H, int W, int p0,
                                   int p1, int p2, int p3, int in_dtype,
                                   int out_dtype, const Taps* taps,
                                   const Tap* big, int r, int steps,
                                   int has_bc, float bc, long long smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((taps->n > STENCIL_MAX_TAPS) != (big != nullptr))
    return (int)cudaErrorInvalidValue;
  if (kernel == K_GRID && (bar == nullptr || (steps > 1 && buf == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Geometry g{p0, p1, p2, p3, static_cast<float*>(buf),
                   static_cast<unsigned long long*>(bar)};
  if (in_dtype == DTYPE_F32)
    return launch_in<float>(out_dtype, kernel, x, fields, out, B, H, W, g,
                            taps, big, r, steps, has_bc, bc, (size_t)smem, s);
  if (in_dtype == DTYPE_BF16)
    return launch_in<__nv_bfloat16>(out_dtype, kernel, x, fields, out, B, H,
                                    W, g, taps, big, r, steps, has_bc, bc,
                                    (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}
