// bf16 GQA attention forward on Hopper's tensor cores: the sm_90a kernel of
// K6 and K7, the Hopper port of two TPU kernels of the JAX package
// (src/repro), which compute the same function,
//
//   K6  kernels/flash_attention.py::flash_attention (pl.pallas_call at
//       :122, body _kernel) — the output only;
//   K7  kernels/flash_attention_bwd.py::_flash_fwd (pl.pallas_call at :86,
//       body _fwd_kernel) — the output and the row logsumexp lse (natural
//       log, fp32), from which K8/K9 recompute p.
//
// The function is flash_attention.cu's (its header states it): s = (q . k) *
// hd^-0.5 with fp32 sums, the finite -1e30 mask with kv_offset subtracted
// from the kv index, the online m, l, acc per kv tile, p rounded to v's type
// (bf16, round to nearest even) before p . v, l = 0 read as 1.  Here the
// softmax runs in log2 units, log2(e) folded into the scale
// (exp2(s * scale * log2e - m2) = exp(s * scale - m)), and lse = m2 * ln2 +
// log(l).  This file takes bf16 only; fp32 keeps the SIMT kernel of
// flash_attention.cu, because no fp32 format of the tensor cores keeps the
// fp32 bound of 2e-5 (TF32 keeps a 10-bit mantissa), and fp32 is the parity
// path, on no bf16 main path.
//
// Bound: operations.  4 * hd flops per (query, visible key) pair against q,
// k, v and out read or written once: at the serve shape (S = 2048, hd 128,
// causal) 6.9e10 flops, 0.070 ms at the 989 TFLOP/s of dense bf16, against
// 0.030 ms for the bytes.  Design:
//   - one CTA per (head, batch, 128-row q tile), q tiles launched last
//     first, so under the causal mask the longest CTAs start first; kv tiles
//     wholly above the diagonal are never loaded;
//   - three warpgroups: a producer (setmaxnreg down to 24 registers) whose
//     one thread issues the TMA loads, and two consumers (240 registers),
//     64 q rows each;
//   - TMA copies bf16 tiles straight from the public layout (B, S, heads,
//     hd), through 4D tensor maps (hd, heads, S, B) encoded on the host per
//     call and passed as __grid_constant__ parameters (so a CUDA graph
//     replays them): Q once, K and V as 128-row tiles into a 2-stage ring
//     (32 + 2 * 2 * 32 KB at hd 128, one CTA an SM), each tile's arrival
//     and release signalled by mbarriers.  TMA zero-fills rows past the end
//     of each sequence, per batch; the kernel masks them;
//   - the shared-memory swizzle (128B for hd 64 and 128, 64-column boxes;
//     64B for hd 32; 32B for hd 16) is the one the wgmma descriptors name;
//   - S = Q . K^T by wgmma m64n128k16 (bf16 -> fp32), A and B from shared
//     memory, both K-major;
//   - the softmax in registers: a row's 128 scores sit on the 4 threads of
//     a quad (row max and sum by shuffles xor 1, 2); the mask is computed
//     only on tiles that reach past the diagonal or the end of K;
//   - O += P . V by wgmma m64n{hd}k16 with P as the register A operand: the
//     S accumulator's layout is the A fragment's, so P is S packed in place
//     to bf16x2; V is the shared-memory B operand in its natural (kv, hd)
//     layout, MN-major (the descriptor's transpose bit);
//   - the epilogue divides by l, writes bf16 with the ragged q rows
//     predicated off, and lse per row.
// TMA, mbarrier and wgmma plumbing, shared with flash_attention_bwd_sm90.cu.
#include "sm90.cuh"

namespace {

constexpr int BQ = 128;         // q rows per CTA, 64 per consumer warpgroup
constexpr int BK = 128;         // kv rows per tile
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;       // the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f * LOG2E;  // the TPU kernels' -1e30, log2 units

// A Q, K or V tile of 128 rows in shared memory, and the kernel's shared
// memory: Q, the K ring, the V ring, the mbarriers, and slack to align to
// 1 KB.
template <int HD>
struct Tile : SwizzledTile<HD, 128> {
  static constexpr size_t SMEM = (size_t)(1 + 2 * STAGES) *
                                     SwizzledTile<HD, 128>::BYTES +
                                 8 * (1 + 3 * STAGES) + 1024;
};

// wgmma's descriptor of a Q, K or V tile (sm90.cuh's smem_desc).
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return smem_desc<Tile<HD>::ROW>(addr, lbo);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Skv, int H, int KV, int causal, int kv_offset,
                   float scale_log2) {
  using G = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + G::BYTES;                 // + s * G::BYTES
  const uint32_t sv = base + (1 + STAGES) * G::BYTES;  // + s * G::BYTES
  const uint32_t bars = base + (1 + 2 * STAGES) * G::BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * s
  const uint32_t v_full = bars + 8 * (1 + STAGES);     // + 8 * s
  const uint32_t kv_empty = bars + 8 * (1 + 2 * STAGES);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;  // last first
  const int kvh = h / (H / KV);
  // Tiles past the last one holding a key at or before the tile's last
  // query position are wholly masked: never loaded.
  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // largest visible kv index
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, G::BYTES);
      tma_load_tile<HD, BQ>(sq, &tq, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        mbar_wait(kv_empty + 8 * s, (use & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, G::BYTES);
        tma_load_tile<HD, BK>(sk + s * G::BYTES, &tk, k_full + 8 * s, kvh,
                              t * BK, b);
        mbar_expect_tx(v_full + 8 * s, G::BYTES);
        tma_load_tile<HD, BK>(sv + s * G::BYTES, &tv, v_full + 8 * s, kvh,
                              t * BK, b);
      }
    }
  } else {
    // A consumer: 64 q rows.  Thread (warp w, lane) holds rows
    // 16w + lane/4 and that + 8 of the warpgroup's, columns 2 (lane % 4)
    // and + 1 of every 8-column group (wgmma's accumulator layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int row0 = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;  // and + 8
    const int col = 2 * (lane % 4);
    const uint32_t q_wg = sq + wg * 64 * G::ROW;
    float o[HD / 2];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, use = t / STAGES;
      const int kv0 = t * BK;
      mbar_wait(k_full + 8 * s, use & 1);
      float sc[64];  // the first product overwrites it (accumulate = 0)
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = G::col16(16 * kk);  // 16 columns of hd
        wgmma_ss_n128(sc, desc<HD>(q_wg + off, 16),
                      desc<HD>(sk + s * G::BYTES + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      // Scores in log2 units, masked where a key is past the end of K, past
      // Skv after the offset, or (causal) after the query.
      const bool edge =
          kv0 + BK > Skv || kv0 + BK - kv_offset > Skv ||
          (causal && kv0 + BK - 1 - kv_offset > q0 + wg * 64);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int idx = kv0 + 8 * (i / 4) + col + (i % 2);
          const int kpos = idx - kv_offset;
          const int row = row0 + 8 * ((i / 2) % 2);
          const bool ok =
              idx < Skv && kpos < Skv && (!causal || kpos <= row);
          sc[i] = ok ? sc[i] * scale_log2 : MASKED;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }
      float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2f(sc[i] - m[(i / 2) % 2]);
        sum[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      // P in bf16: S's accumulator pairs are the A fragment's registers.
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      mbar_wait(v_full + 8 * s, use & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HD>(o, p + 4 * kk,
                     desc<HD>(sv + s * G::BYTES + kk * 16 * G::ROW, G::BLOCK));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(kv_empty + 8 * s);  // this thread is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      __nv_bfloat16* ob = out + (((size_t)b * Sq + row) * H + h) * HD + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
      if (LSE && lane % 4 == 0)
        lse[((size_t)b * H + h) * Sq + row] = m[r] * LN2 + logf(l_safe);
    }
  }
}

template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Skv, int H, int KV, int causal, int kv_offset,
           float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!encode<HD, BQ>(&tq, q, H, Sq, B) ||
      !encode<HD, BK>(&tk, k, KV, Skv, B) ||
      !encode<HD, BK>(&tv, v, KV, Skv, B))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90<HD, LSE>;
  constexpr size_t smem = Tile<HD>::SMEM;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, KV,
      causal, kv_offset, scale * LOG2E);
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

// flash_attention.cu's interface, bf16 only (any other dtype is refused):
// q, out (B, Sq, H, hd); k, v (B, Skv, KV, hd), contiguous bf16, 16-byte
// aligned; lse (B, H, Sq) fp32 or null (K6).  hd is 16, 32, 64 or 128; the
// wrapper checks that H, B and the q tiles fit gridDim.x/y/z.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           float* lse, int B, int Sq, int Skv,
                                           int H, int KV, int hd, int dtype,
                                           int causal, int kv_offset,
                                           float scale, void* stream) {
  if (dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse)
    return launch_hd<true>(hd, q, k, v, out, lse, B, Sq, Skv, H, KV, causal,
                           kv_offset, scale, s);
  return launch_hd<false>(hd, q, k, v, out, lse, B, Sq, Skv, H, KV, causal,
                          kv_offset, scale, s);
}
