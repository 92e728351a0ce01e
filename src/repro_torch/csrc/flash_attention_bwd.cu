// The fp32 flash-attention backward: the Hopper port of the two TPU
// kernels of the JAX package's kernels/flash_attention_bwd.py::_flash_bwd,
//
//   K8  pl.pallas_call at :223, body _dq_kernel (:119) — dq, kv innermost;
//   K9  pl.pallas_call at :249, body _dkv_kernel (:163) — dk and dv, q
//       innermost, the GQA group folded into the accumulation.
//
// Both recompute the probabilities from the forward's row logsumexp (K7's
// lse) instead of reading them: for query row i of head h and key j of kv
// head h / G (G = H / KV),
//   s_ij  = (q_i . k_j) * hd^-0.5, products summed in fp32; s = -1e30
//           (finite) unless j < Skv, j - kv_offset < Skv and, when causal,
//           j - kv_offset <= i (the TPU kernels' k_pos: kv_offset is
//           subtracted from the kv index);
//   p_ij  = exp(s_ij - lse_i);
//   dp_ij = do_i . v_j in fp32 (do and v cast up, :138 and :186);
//   ds_ij = p_ij * (dp_ij - delta_i) * hd^-0.5, delta_i = do_i . o_i (the
//           wrapper computes it, as JAX does outside its kernels, :221);
//   K8:  dq_i = sum_j round_k(ds_ij) k_j          (ds in k's type, :150)
//   K9:  dk_j = sum_{g, i} round_q(ds_ij) q_i     (ds in q's type, :203)
//        dv_j = sum_{g, i} p_ij do_i              (p NOT rounded: do is
//                                                  already fp32 there, :196)
// with fp32 sums; dq is written in q's type, dk and dv in k's and v's.  On
// every row with at least one unmasked key a masked entry has p = 0, so the
// result does not depend on the tiles.
//
// Bound: operations.  Each (query, visible key) pair costs 6 * hd flops in
// K8 (s, dp, ds . k) and 8 * hd in K9 (s, dp, p . do, ds . q), while q, k,
// v, do and the outputs are each read or written once: at the training
// shape (S = 2048, hd = 128) hundreds of flops a byte, past the card's
// ridge point.  The TPU kernels keep s, p and ds in VMEM for that reason;
// these keep them in registers and shared memory.  This file is the fp32
// kernel only, on the CUDA cores (fp32 multiply-adds, the 67 TFLOP/s rate):
// fp32 is the parity path, and no tensor-core format keeps its bound.  bf16
// runs the tensor-core kernels of flash_attention_bwd_sm90.cu, and this file
// refuses it.  In fp32 the roundings of ds to q's and k's type are the
// identity.  Design:
//   - K8: one CTA of 256 threads per (batch, head, 64-row q tile), q and do
//     resident in shared memory as fp32; per 64-row kv tile, V is staged
//     (dp = do . V^T), then K into the same buffer (s = q . K^T, ds, then
//     dq += ds . K), so 118 KB a CTA at hd 128.  The q tiles are issued
//     longest first (under the causal mask the last tile sees every kv
//     tile).
//   - K9: one CTA per (batch, kv head, 64-row k tile), K and V resident;
//     it loops over the G query heads of the group and, for each, over the
//     q tiles at or below the diagonal, staging q and do, and accumulates
//     dk and dv in registers across the whole loop: no atomics, so the
//     result is deterministic.  Each q tile's 64-term product is summed
//     apart and then added to the running sums (JAX's dot of a block, then
//     its add), so a group of G heads over S queries chains G S / 64 adds,
//     not G S: at GQA 16 over 2048 queries the one chain of 32,768 fmas
//     lay 6e-6 of max-abs from float64, past the fp32 bound.  p^T and then
//     ds^T pass through one shared tile (153 KB a CTA at hd 128).
//   - a 16 x 16 thread grid, as K7: thread (ty, tx) owns rows 4ty..4ty+3 of
//     the CTA's own tile, score columns tx + 16j (j < 4) and accumulator
//     columns tx + 16n (n < hd/16); row strides hd + 4 and 64 + 4 floats
//     keep the float4 and scalar shared reads free of bank conflicts;
//   - causal: tiles wholly above the diagonal are never loaded;
//   - q, do, k, v are read in the public layout (B, S, heads, hd), lse and
//     delta as (B, H, Sq) fp32, and the ragged edges (Sq, Skv not
//     multiples of 64) are masked here: no transpose, no padded copy.
// expf, not the fast intrinsic; no --use_fast_math.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PS = BK + 4;     // row stride of the score tiles (floats)
constexpr float NEG_INF = -1e30f;

// Rows r0..r0+63 of one head of a (S, heads, HD) tensor into a 64 x (HD+4)
// fp32 tile; rows past S read as 0.  ``src`` points at row 0 of the head.
template <int HD>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int r0, int S, size_t stride) {
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 4) + d] =
        r0 + r < S ? src[(size_t)(r0 + r) * stride + d] : 0.f;
  }
}

// out[i][j] = a[4ty+i] . b[tx+16j] over HD, for two 64 x (HD+4) tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&out)[4][4]) {
  constexpr int RS = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(4 * ty + i) * RS + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * RS + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(x[i].x, y[j].x, out[i][j]);
        out[i][j] = fmaf(x[i].y, y[j].y, out[i][j]);
        out[i][j] = fmaf(x[i].z, y[j].z, out[i][j]);
        out[i][j] = fmaf(x[i].w, y[j].w, out[i][j]);
      }
  }
}

// acc[i][n] += sum_c p[4ty+i][c] * m[c][tx+16n], p a 64 x PS tile, m a
// 64 x (HD+4) tile.
template <int HD>
__device__ __forceinline__ void tile_acc(const float* p, const float* m,
                                         int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
  constexpr int RS = HD + 4;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&p[(4 * ty + i) * PS + c]);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      const float m0 = m[(c + 0) * RS + tx + 16 * n];
      const float m1 = m[(c + 1) * RS + tx + 16 * n];
      const float m2 = m[(c + 2) * RS + tx + 16 * n];
      const float m3 = m[(c + 3) * RS + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][n] = fmaf(pv[i].x, m0, acc[i][n]);
        acc[i][n] = fmaf(pv[i].y, m1, acc[i][n]);
        acc[i][n] = fmaf(pv[i].z, m2, acc[i][n]);
        acc[i][n] = fmaf(pv[i].w, m3, acc[i][n]);
      }
    }
  }
}

// acc[i][n] += (sum_c p[4ty+i][c] * m[c][tx+16n]): the tile's sum formed
// on its own first, then added.
template <int HD>
__device__ __forceinline__ void tile_add(const float* p, const float* m,
                                         int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
  float part[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) part[i][n] = 0.f;
  tile_acc<HD>(p, m, ty, tx, part);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) acc[i][n] += part[i][n];
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&a)[4][HD / 16],
                                         float (&b)[4][HD / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) a[i][n] = b[i][n] = 0.f;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (size_t)(3 * BQ * (HD + 4) + BQ * PS) * sizeof(float);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(4 * BQ * (HD + 4) + BK * PS) * sizeof(float);
}

// K8: dq for one (batch, head, q tile).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq,
                        int Sq, int Skv, int H, int KV, int causal,
                        int kv_offset, float scale) {
  constexpr int RS = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x RS
  float* dos = qs + BQ * RS;                    // BQ x RS
  float* kvs = dos + BQ * RS;                   // BK x RS: V, then K
  float* dss = kvs + BK * RS;                   // BQ x PS: ds

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_head = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  stage<HD>(qs, q + q_head, q0, Sq, q_stride);
  stage<HD>(dos, dout + q_head, q0, Sq, q_stride);

  float lse_r[4], delta_r[4];
  const size_t row_stat = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < Sq ? lse[row_stat + row] : 0.f;
    delta_r[i] = row < Sq ? delta[row_stat + row] : 0.f;
  }

  // Tiles past the last one holding a key at or before the tile's last
  // query position are wholly masked: skip them.
  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // largest visible kv index
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BK;
    __syncthreads();  // q, do staged; the last tile's ds . K reads are done
    stage<HD>(kvs, vb, kv0, Skv, kv_stride);
    __syncthreads();
    float dp[4][4];
    tile_dot<HD>(dos, kvs, ty, tx, dp);
    __syncthreads();  // every thread is done reading V
    stage<HD>(kvs, kb, kv0, Skv, kv_stride);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(qs, kvs, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = kv0 + tx + 16 * j;
        const int kpos = idx - kv_offset;
        const bool ok = idx < Skv && kpos < Skv && (!causal || kpos <= qpos);
        const float sv = ok ? s[i][j] * scale : NEG_INF;
        const float p = expf(sv - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        dss[(4 * ty + i) * PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_acc<HD>(dss, kvs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    float* out = dq + q_head + (size_t)row * q_stride;
#pragma unroll
    for (int n = 0; n < NC; ++n) out[tx + 16 * n] = acc[i][n];
  }
}

// K9: dk and dv for one (batch, kv head, k tile), summed over the G query
// heads of the group and every q tile.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq,
                         int Skv, int H, int KV, int causal, int kv_offset,
                         float scale) {
  constexpr int RS = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // BK x RS
  float* vs = ks + BK * RS;                     // BK x RS
  float* qs = vs + BK * RS;                     // BQ x RS
  float* dos = qs + BQ * RS;                    // BQ x RS
  float* pt = dos + BQ * RS;                    // BK x PS: p^T, then ds^T

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK;  // causal: the first tiles see the most q
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t kv_head = (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  stage<HD>(ks, k + kv_head, k0, Skv, kv_stride);
  stage<HD>(vs, v + kv_head, k0, Skv, kv_stride);

  // q tiles holding a row at or past the tile's first key position.
  const int n_q = (Sq + BQ - 1) / BQ;
  int t0 = 0;
  if (causal) {
    const int first = k0 - kv_offset;
    t0 = first <= 0 ? 0 : first / BQ;
  }

  float dk_acc[4][NC], dv_acc[4][NC];
  zero_acc<HD>(dk_acc, dv_acc);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_head = (size_t)b * Sq * q_stride + (size_t)h * HD;
    const size_t row_stat = ((size_t)b * H + h) * Sq;
    for (int tq = t0; tq < n_q; ++tq) {
      const int q0 = tq * BQ;
      __syncthreads();  // K, V staged; the last tile's reads are done
      stage<HD>(qs, q + q_head, q0, Sq, q_stride);
      stage<HD>(dos, dout + q_head, q0, Sq, q_stride);
      float lse_c[4], delta_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = q0 + tx + 16 * j;
        lse_c[j] = col < Sq ? lse[row_stat + col] : 0.f;
        delta_c[j] = col < Sq ? delta[row_stat + col] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<HD>(ks, qs, ty, tx, s);    // s^T: key rows, query columns
      tile_dot<HD>(vs, dos, ty, tx, dp);  // dp^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = k0 + 4 * ty + i;
        const int kpos = idx - kv_offset;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool ok = idx < Skv && kpos < Skv && (!causal || kpos <= qpos);
          const float sv = ok ? s[i][j] * scale : NEG_INF;
          // Rows past Sq do not exist (JAX's zero padding gives them no
          // weight either).
          const float p = qpos < Sq ? expf(sv - lse_c[j]) : 0.f;
          s[i][j] = p * (dp[i][j] - delta_c[j]) * scale;  // ds^T
          pt[(4 * ty + i) * PS + tx + 16 * j] = p;
        }
      }
      __syncthreads();
      tile_add<HD>(pt, dos, ty, tx, dv_acc);  // dv += p^T . do
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pt[(4 * ty + i) * PS + tx + 16 * j] = s[i][j];
      __syncthreads();
      tile_add<HD>(pt, qs, ty, tx, dk_acc);  // dk += ds^T . q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= Skv) continue;
    const size_t off = kv_head + (size_t)row * kv_stride;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk[off + tx + 16 * n] = dk_acc[i][n];
      dv[off + tx + 16 * n] = dv_acc[i][n];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  int B, Sq, Skv, H, KV, causal, kv_offset;
  float scale;
  cudaStream_t s;
};

template <int HD>
int launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<HD>;
  constexpr size_t smem = dq_smem_bytes<HD>();
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.kv_offset, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<HD>;
  constexpr size_t smem = dkv_smem_bytes<HD>();
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.KV, a.B);
  kernel<<<grid, THREADS, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.kv_offset, a.scale);
  return (int)cudaGetLastError();
}

template <bool DQ>
int launch_hd(int dtype, int hd, const Args& a) {
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return DQ ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32: return DQ ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64: return DQ ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128: return DQ ? launch_dq<128>(a) : launch_dkv<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), contiguous fp32 (any
// other dtype is refused); lse, delta: (B, H, Sq) fp32.  hd is 16, 32, 64
// or 128; the wrapper checks the shapes and that H, KV and B fit
// gridDim.y/z.  Each returns cudaGetLastError() after its launch (0 on
// success).

// K8: dq (B, Sq, H, hd) in fp32.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int Sq, int Skv, int H,
                                   int KV, int hd, int dtype, int causal,
                                   int kv_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Skv, H, KV,
               causal, kv_offset, scale, static_cast<cudaStream_t>(stream)};
  return launch_hd<true>(dtype, hd, a);
}

// K9: dk, dv (B, Skv, KV, hd) in fp32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int B, int Sq,
                                    int Skv, int H, int KV, int hd, int dtype,
                                    int causal, int kv_offset, float scale,
                                    void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, KV,
               causal, kv_offset, scale, static_cast<cudaStream_t>(stream)};
  return launch_hd<false>(dtype, hd, a);
}
