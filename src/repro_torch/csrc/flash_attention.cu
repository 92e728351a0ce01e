// Causal or non-causal GQA attention forward with an online softmax: the
// Hopper port of two TPU kernels of the JAX package (src/repro), which
// compute the same function,
//
//   K6  kernels/flash_attention.py::flash_attention (pl.pallas_call at
//       :122, body _kernel) — the output only;
//   K7  kernels/flash_attention_bwd.py::_flash_fwd (pl.pallas_call at :86,
//       body _fwd_kernel) — the output and the row logsumexp lse, which the
//       backward kernels (K8/K9, flash_attention_bwd.cu) read.
//
// One template serves both; LSE switches the lse output on.  This file is
// the fp32 kernel: bf16 runs on the tensor cores (flash_attention_sm90.cu),
// and no fp32 format of the tensor cores keeps fp32's bound of 2e-5 (TF32
// keeps a 10-bit mantissa), so fp32, the parity path of the serve and train
// checks, stays on the CUDA cores here.
//
// Computes, for query row i of head h and the keys j of kv head h / G
// (G = H / KV, no K/V broadcast in memory):
//   s_ij = (q_i . k_j) * hd^-0.5, products summed in fp32;
//   masked (s = -1e30, finite) unless j < Skv, j - kv_offset < Skv and, when
//   causal, j - kv_offset <= i (the TPU kernel's k_pos, :47: kv_offset is
//   subtracted from the kv index);
//   m, l, acc updated per kv tile as the TPU kernel does (m_new = max,
//   p = exp(s - m_new), alpha = exp(m - m_new)), with p in v's type (fp32
//   here: the TPU kernel's p.astype(v.dtype), :73, rounds nothing) and
//   summed in fp32;
//   out_i = acc / l (l = 0 read as 1), lse_i = m + log(l).
// On every row with at least one unmasked key that is softmax(s) . v.  A row
// with none gets what the tiles that ran leave (0 if none ran), as in JAX,
// where it depends on the block sizes.
//
// Bound: operations.  Each (query, visible key) pair costs 4 * hd flops
// (q . k and p . v) while q, k, v and out are each read or written once: at
// the serve shape (S = 2048, hd = 128) that is over 600 flops a byte, past
// the card's ridge point.  The TPU kernel keeps the scores in VMEM for that
// reason, and so does this one (registers and shared memory).  It runs on
// the CUDA cores (fp32 multiply-adds, the 67 TFLOP/s rate).  Design:
//   - one CTA of 256 threads per (batch, head, 64-row q tile); the q tile
//     stays in shared memory as fp32 for the whole kv loop;
//   - kv tiles of 64 rows: K, then V, staged as fp32 through one shared
//     buffer (85 KB a CTA at hd 128, two CTAs an SM);
//   - a 16 x 16 thread grid: thread (ty, tx) owns q rows 4ty..4ty+3, score
//     columns tx + 16j (j < 4) and output columns tx + 16n (n < hd/16), so
//     a row's max and sum are reduced over 16 lanes of one warp by shuffles
//     and m, l live in registers;
//   - row strides hd + 4 and 64 + 4 floats keep the float4 reads of the
//     score loop and the scalar reads of the p . v loop free of bank
//     conflicts;
//   - causal: kv tiles wholly above the diagonal are never loaded;
//   - q/k/v are read in the public layout (B, S, heads, hd) and the ragged
//     edges (Sq, Skv not multiples of 64) are masked here: no transpose, no
//     padded copy.
// expf and logf, not the fast intrinsics; no --use_fast_math.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // kv rows per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (HD + 4) + BQ * (BK + 4)) * sizeof(float);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                     int causal, int kv_offset, float scale) {
  constexpr int QS = HD + 4;   // row stride of the q and kv tiles (floats)
  constexpr int PS = BK + 4;   // row stride of the p tile
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x QS
  float* kvs = qs + BQ * QS;                    // BK x QS: K, then V
  float* ps = kvs + BK * QS;                    // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * HD;    // between tokens of q and out
  const size_t kv_stride = (size_t)KV * HD;  // between tokens of k and v
  const float* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    qs[r * QS + d] =
        q0 + r < Sq ? qb[(size_t)(q0 + r) * q_stride + d] : 0.f;
  }

  // Tiles past the last one holding a key at or before the tile's last
  // query position are wholly masked: skip them.
  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // largest visible kv index
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BK;
    __syncthreads();  // q stored; the last tile's p . v reads are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      kvs[r * QS + d] =
          kv0 + r < Skv ? kb[(size_t)(kv0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = kv0 + tx + 16 * j;
        const int kpos = idx - kv_offset;
        const bool ok =
            idx < Skv && kpos < Skv && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(4 * ty + i) * PS + tx + 16 * j] = s[i][j];  // fp32: v's type
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      kvs[r * QS + d] =
          kv0 + r < Skv ? vb[(size_t)(kv0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * PS + c]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float v0 = kvs[(c + 0) * QS + tx + 16 * n];
        const float v1 = kvs[(c + 1) * QS + tx + 16 * n];
        const float v2 = kvs[(c + 2) * QS + tx + 16 * n];
        const float v3 = kvs[(c + 3) * QS + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][n] = fmaf(p[i].x, v0, acc[i][n]);
          acc[i][n] = fmaf(p[i].y, v1, acc[i][n]);
          acc[i][n] = fmaf(p[i].z, v2, acc[i][n]);
          acc[i][n] = fmaf(p[i].w, v3, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* ob = out + (size_t)b * Sq * q_stride + (size_t)row * q_stride +
            (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      ob[tx + 16 * n] = acc[i][n] / l_safe;
    if (LSE && tx == 0)
      lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KV, int causal,
           int kv_offset, float scale, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<HD, LSE>;
  constexpr size_t smem = smem_bytes<HD>();
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
      H, KV, causal, kv_offset, scale);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Skv, int H, int KV, int causal,
              int kv_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, LSE>(q, k, v, out, lse, B, Sq, Skv, H, KV,
                                    causal, kv_offset, scale, s);
    case 32: return launch<32, LSE>(q, k, v, out, lse, B, Sq, Skv, H, KV,
                                    causal, kv_offset, scale, s);
    case 64: return launch<64, LSE>(q, k, v, out, lse, B, Sq, Skv, H, KV,
                                    causal, kv_offset, scale, s);
    case 128: return launch<128, LSE>(q, k, v, out, lse, B, Sq, Skv, H, KV,
                                      causal, kv_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), contiguous fp32 (any
// other dtype is refused: bf16 is flash_attention_sm90.cu's); lse: (B, H,
// Sq) fp32, or null for K6 (no lse).  hd is 16, 32, 64 or 128; the wrapper
// checks the shapes and that H, B fit gridDim.y/z.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int hd, int dtype, int causal,
                                      int kv_offset, float scale,
                                      void* stream) {
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse)
    return launch_hd<true>(hd, q, k, v, out, lse, B, Sq, Skv, H, KV, causal,
                           kv_offset, scale, s);
  return launch_hd<false>(hd, q, k, v, out, lse, B, Sq, Skv, H, KV, causal,
                          kv_offset, scale, s);
}
