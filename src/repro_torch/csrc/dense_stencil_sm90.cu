// out = x @ W for the paper's dense-layer encoding (Algorithm 1) on Hopper's
// tensor cores: the Hopper port of the TPU kernel
// kernels/dense_stencil.py::dense_stencil_matmul (src/repro, its
// pl.pallas_call at :61, body _kernel).
//
// x is (S, N), W is (N, N), both fp32 or both bf16, row-major; out is (S, N)
// in x's type, the sums in fp32.  The TPU's matrix unit takes bf16 and builds
// an fp32 product from bf16 passes; this kernel does the same on wgmma:
//
//   - bf16: one product.  x's tiles are K-major, W's MN-major (W is K x N
//     with N contiguous: the descriptor's transpose bit), sums in fp32
//     registers, rounded to bf16 once.
//   - fp32: each value is split into three bf16 pieces, v0 = bf16(v),
//     v1 = bf16(v - v0), v2 = bf16(v - v0 - v1) (split_bf16x3 below, round
//     to nearest even; each difference is exact in fp32), so that
//     v = v0 + v1 + v2 exactly for |v| >= 2^-110 (below that v2 can fall
//     into bf16's subnormals and lose bits; stencil fields are O(1)).  Each
//     product of two pieces is exact in fp32.  The kernel sums the six
//     piece products with i + j <= 2: x0.W0, and x0.W1, x1.W0, x0.W2, x1.W1,
//     x2.W0; the three it drops are about 2^-24 of the result (a two-piece
//     split would drop about 2^-16).  The order of the sums is part of the
//     design.  The five small products accumulate in one register tile
//     across all of K.  x0.W0 accumulates per K tile into a second one,
//     which is then added to a third, the fp32 sum, with round-to-nearest
//     adds (wgmma's own fp32 accumulation aligns its addends to the
//     largest and may truncate; over 4096 terms that is measured in
//     chip_smoke.py phase 11 against an fp64 product).  The result is the
//     sum plus the small products, one rounded add.  So a product with one
//     nonzero term (W a permutation) gives x0 + (x1 + x2) = x exactly.
//
// The wrapper (kernels/dense_stencil.py) runs split_bf16x3 on x and on W
// into bf16 scratch of three planes whose row stride Np is N rounded up to
// a multiple of 8 (TMA's 16-byte stride rule), zero-filled past N; a bf16
// x or W whose N is not a multiple of 8 is padded the same way.
//
// Bound: operations.  2 * S * N^2 flops against (2 * S * N + N^2) *
// itemsize bytes, about 1000 flops a byte at N = 4096: far above the
// card's ridge point.  bf16: 2.22 ms at the 989 TFLOP/s of dense bf16 for
// S = 65,536 and N = 4096; fp32 by this design six such products, 13.34
// ms (on the CUDA cores instead, 32.82 ms at 67 TFLOP/s).  Design:
//   - one CTA per 128 x BN output tile (BN 256 in bf16, 128 in fp32: the
//     fp32 route holds three register tiles), x's row block fastest across
//     the grid so that the CTAs in flight share x's tiles in L2;
//   - three warpgroups: a producer (setmaxnreg down to 24 registers) whose
//     one thread issues the TMA loads, and two consumers (240 registers),
//     64 rows of the tile each;
//   - TMA copies the tiles of every piece through 3D tensor maps (columns,
//     rows, piece), encoded on the host per call and passed as
//     __grid_constant__ parameters, into a 4-stage mbarrier ring of 48 KB
//     stages; reads past S, past N in K and past N in the columns fill
//     zeros, so ragged edges need no masks until the epilogue;
//   - the wgmma chain of a K tile is committed, and the stage it read is
//     released once the next chain has been issued and the earlier one has
//     finished (wgmma.wait_group 1), so the tensor cores always have a
//     chain queued;
//   - the epilogue writes x's type with the ragged rows and columns
//     predicated off.
#include "sm90.cuh"

namespace {

constexpr int BM = 128;         // rows of x (and out) per CTA
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 4;

// The tile geometry of a route: P pieces of x and of W, BN output columns,
// BK of K per stage.  A tile of x is BM rows of BK * 2 bytes (K-major); a
// tile of W is BN / 64 boxes of BK rows of 128 bytes (64 columns, MN-major).
template <int P>
struct Route {
  static constexpr int BN = P == 1 ? 256 : 128;
  static constexpr int BK = P == 1 ? 64 : 32;
  static constexpr int A_ROW = BK * 2;              // 128 or 64 bytes
  static constexpr int A_BYTES = BM * A_ROW;        // one piece of x's tile
  static constexpr int B_BOX = BK * 128;            // 64 columns of W's tile
  static constexpr int B_BYTES = BN / 64 * B_BOX;   // one piece of W's tile
  static constexpr int STAGE = P * (A_BYTES + B_BYTES);  // 48 KB either way
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 16 * STAGES + 1024;
  static constexpr CUtensorMapSwizzle A_SWIZZLE =
      A_ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool two,
                                       bool paired);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b,
                                              bool two, bool paired) {
  if (two && paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b,
                                                      bool two, bool paired) {
  if (two && paired) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (two) p[1] = __float2bfloat16(b);
  }
}

// Writes one consumer thread's 64 x 128 accumulator slice: rows row and
// row + 8, columns col0 + 8 j + (0, 1) for j < 16 (wgmma's layout).
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out,
                                           const float (&v)[64], int row,
                                           int col0, int S, int N) {
  const bool paired = N % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row + 8 * r;
    if (gr >= S) continue;
    T* orow = out + (size_t)gr * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j;
      if (c < N)
        store2<T>(orow + c, v[4 * j + 2 * r], v[4 * j + 2 * r + 1],
                  c + 1 < N, paired);
    }
  }
}

template <int P, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    dense_gemm_sm90(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    TO* __restrict__ out, int S, int N) {
  using R = Route<P>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // Stage s: x's pieces at a_tile(s, p), W's at b_tile(s, p).
  auto a_tile = [&](int s, int p) {
    return base + s * R::STAGE + p * R::A_BYTES;
  };
  auto b_tile = [&](int s, int p) {
    return base + s * R::STAGE + P * R::A_BYTES + p * R::B_BYTES;
  };
  const uint32_t full = base + STAGES * R::STAGE;   // + 8 * s
  const uint32_t empty = full + 8 * STAGES;         // + 8 * s

  const int n0 = blockIdx.x * R::BN, m0 = blockIdx.y * BM;
  const int k_tiles = (N + R::BK - 1) / R::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        mbar_wait(empty + 8 * s, (use & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, R::STAGE);
        for (int p = 0; p < P; ++p) {
          tma_load_3d(a_tile(s, p), &ta, full + 8 * s, t * R::BK, m0, p);
          for (int c = 0; c < R::BN / 64; ++c)
            tma_load_3d(b_tile(s, p) + c * R::B_BOX, &tb, full + 8 * s,
                        n0 + 64 * c, t * R::BK, p);
        }
      }
    }
    return;
  }

  // A consumer: rows [64 wg, 64 wg + 64) of the tile.  Thread (warp w,
  // lane) holds rows 16 w + lane / 4 and that + 8, columns 2 (lane % 4) and
  // + 1 of every 8-column group (wgmma's accumulator layout).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int row = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  const uint32_t a_wg = wg * 64 * R::A_ROW;
  // Descriptors of K slice kk (16 deep) of piece p: x's tile K-major (a
  // 32-byte step inside its swizzled rows), W's MN-major (16 rows on; the
  // leading offset steps over a 64-column box).
  auto da = [&](int s, int p, int kk) {
    return smem_desc<R::A_ROW>(a_tile(s, p) + a_wg + 32 * kk, 16);
  };
  auto db = [&](int s, int p, int kk, int half) {
    return smem_desc<128>(b_tile(s, p) + 2 * half * R::B_BOX + kk * 2048,
                          R::B_BOX);
  };

  if constexpr (P == 1) {
    float acc0[64], acc1[64];  // columns [0, 128) and [128, 256) of the tile
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int t = 0; t < k_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::BK / 16; ++kk) {
        wgmma_ss_n128<1>(acc0, da(s, 0, kk), db(s, 0, kk, 0), 1);
        wgmma_ss_n128<1>(acc1, da(s, 0, kk), db(s, 0, kk, 1), 1);
      }
      wgmma_commit();
      wgmma_wait_n<1>();  // the chain of tile t - 1 is done
      if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
    }
    wgmma_wait();
    fence_regs(acc0);
    fence_regs(acc1);
    store_tile<TO>(out, acc0, row, col, S, N);
    store_tile<TO>(out, acc1, row, col + 128, S, N);
  } else {
    // small: x0.W1 + x1.W0 + x0.W2 + x1.W1 + x2.W0 over all of K; big:
    // x0.W0 over one K tile; sum: the big tiles added with rounding.
    constexpr int SMALL[5][2] = {{0, 1}, {1, 0}, {0, 2}, {1, 1}, {2, 0}};
    float small[64], big[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) small[i] = sum[i] = 0.f;
    for (int t = 0; t < k_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      fence_regs(big);
      fence_regs(small);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::BK / 16; ++kk)
        wgmma_ss_n128<1>(big, da(s, 0, kk), db(s, 0, kk, 0), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int q = 0; q < 5; ++q)
#pragma unroll
        for (int kk = 0; kk < R::BK / 16; ++kk)
          wgmma_ss_n128<1>(small, da(s, SMALL[q][0], kk),
                           db(s, SMALL[q][1], kk, 0), 1);
      wgmma_commit();
      // Done: this tile's big chain and everything before it (the small
      // chain of tile t - 1, the last reader of its stage).
      wgmma_wait_n<1>();
      fence_regs(big);
      if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], big[i]);
    }
    wgmma_wait();
    fence_regs(small);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], small[i]);
    store_tile<TO>(out, sum, row, col, S, N);
  }
}

// split_bf16x3: src (rows, N) fp32 into dst, three bf16 planes (rows, Np),
// plane p at dst + p * rows * Np, zero past N.  A thread takes 8 columns:
// one 16-byte store a plane.
__global__ void __launch_bounds__(256)
    split_bf16x3(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                 long long rows, int N, int Np) {
  const int per_row = Np / 8;
  const long long chunks = rows * per_row;
  const long long plane = rows * Np;
  const bool aligned = N % 4 == 0;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * blockDim.x) {
    const long long r = c / per_row;
    const int c0 = (int)(c % per_row) * 8;
    const float* s = src + r * N + c0;
    float v[8];
    if (aligned && c0 + 8 <= N) {
      const float4 lo = *reinterpret_cast<const float4*>(s);
      const float4 hi = *reinterpret_cast<const float4*>(s + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c0 + i < N ? s[i] : 0.f;
    }
    uint32_t w[3][4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float p0[2], p1[2], p2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = v[i + e];
        p0[e] = __bfloat162float(__float2bfloat16_rn(x));
        const float r1 = __fsub_rn(x, p0[e]);
        p1[e] = __bfloat162float(__float2bfloat16_rn(r1));
        p2[e] = __fsub_rn(r1, p1[e]);  // rounded to bf16 by pack_bf16
      }
      w[0][i / 2] = pack_bf16(p0[0], p0[1]);
      w[1][i / 2] = pack_bf16(p1[0], p1[1]);
      w[2][i / 2] = pack_bf16(p2[0], p2[1]);
    }
    __nv_bfloat16* d = dst + r * Np + c0;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(d + p * plane) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

template <int P, typename TO>
int launch_gemm(const void* a, const void* b, void* out, int S, int N, int Np,
                cudaStream_t s) {
  using R = Route<P>;
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t a_strides[2] = {(cuuint64_t)Np * 2,
                                   (cuuint64_t)S * Np * 2};
  const cuuint32_t a_box[3] = {(cuuint32_t)R::BK, (cuuint32_t)BM, 1};
  const cuuint64_t b_dims[3] = {(cuuint64_t)N, (cuuint64_t)N, (cuuint64_t)P};
  const cuuint64_t b_strides[2] = {(cuuint64_t)Np * 2,
                                   (cuuint64_t)N * Np * 2};
  const cuuint32_t b_box[3] = {64, (cuuint32_t)R::BK, 1};
  if (!encode_map<3>(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, a_dims,
                     a_strides, a_box, R::A_SWIZZLE) ||
      !encode_map<3>(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, b_dims,
                     b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_gemm_sm90<P, TO>;
  constexpr size_t smem = R::SMEM;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((N + R::BN - 1) / R::BN, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, s>>>(ta, tb, static_cast<TO*>(out), S, N);
  return (int)cudaGetLastError();
}

}  // namespace

// a: P planes (S, Np) of x's pieces, b: P planes (N, Np) of W's, bf16,
// contiguous, 16-byte aligned, Np a multiple of 8 and at least N; out (S, N)
// contiguous.  pieces 1 with dtype bf16 (x and W themselves, out bf16) or
// pieces 3 with dtype fp32 (split_bf16x3's planes, out fp32); the wrapper
// keeps S under 65,535 * 128.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int dense_stencil_sm90_launch(const void* a, const void* b,
                                         void* out, int S, int N, int Np,
                                         int pieces, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Np % 8 || Np < N) return (int)cudaErrorInvalidValue;
  if (pieces == 1 && dtype == DTYPE_BF16)
    return launch_gemm<1, __nv_bfloat16>(a, b, out, S, N, Np, s);
  if (pieces == 3 && dtype == DTYPE_F32)
    return launch_gemm<3, float>(a, b, out, S, N, Np, s);
  return (int)cudaErrorInvalidValue;
}

// src (rows, N) fp32 contiguous into dst, 3 planes (rows, Np) bf16, Np a
// multiple of 8 and at least N.  Returns cudaGetLastError() after the
// launch.
extern "C" int split_bf16x3_launch(const float* src, void* dst, long long rows,
                                   int N, int Np, void* stream) {
  if (Np % 8 || Np < N) return (int)cudaErrorInvalidValue;
  const long long chunks = rows * (Np / 8);
  const long long want = (chunks + 255) / 256;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  if (blocks == 0) return 0;
  split_bf16x3<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<__nv_bfloat16*>(dst), rows, N, Np);
  return (int)cudaGetLastError();
}
