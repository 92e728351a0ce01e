// bf16 flash-attention backward on Hopper's tensor cores: the sm_90a
// kernels of K8 and K9, the Hopper port of the two TPU kernels of the JAX
// package's kernels/flash_attention_bwd.py::_flash_bwd,
//
//   K8  pl.pallas_call at :223, body _dq_kernel (:119) — dq;
//   K9  pl.pallas_call at :249, body _dkv_kernel (:163) — dk and dv, the
//       GQA group folded into the accumulation.
//
// The function is flash_attention_bwd.cu's (its header states it): p =
// exp(s * hd^-0.5 - lse) from the forward's row logsumexp, with the finite
// -1e30 mask and kv_offset subtracted from the kv index; dp = do . v in fp32
// (do and v are bf16 values, which JAX casts up, :138 and :186); ds = p (dp
// - delta) hd^-0.5; dq = sum round(ds) k (ds rounded to k's type, :150); dk
// = sum round(ds)^T q (to q's type, :203); dv = sum p^T do with p NOT
// rounded (do is already fp32 there, :196).  fp32 sums throughout; dq is
// written in bf16, dk and dv in bf16.  This file takes bf16 only; fp32 keeps
// the SIMT kernels of flash_attention_bwd.cu (no tensor-core format keeps
// the fp32 bound).
//
// Bound: operations.  6 * hd flops per (query, visible key) pair in K8 (s,
// dp, ds . k) and 8 * hd in K9 (s, dp, p . do, ds . q), at the training
// shape (S = 2048, hd 128, causal) 1.03e11 and 1.38e11, 0.104 and 0.139 ms
// at the 989 TFLOP/s of dense bf16; the bytes take a tenth of that.  Design,
// K7's route (flash_attention_sm90.cu; the plumbing is sm90.cuh):
//   - three warpgroups: a producer (setmaxnreg down to 24 registers) that
//     issues TMA loads through per-call 4D tensor maps over the public
//     (B, S, heads, hd) layout into an mbarrier ring, and two consumers
//     (240 registers), 64 rows each, running wgmma;
//   - K8: one CTA per (head, batch, 128-row q tile), q tiles launched last
//     first (under the causal mask they see the most keys).  Q and dO stay
//     resident; K and V stream as 64-row tiles through a 2-stage ring.  S =
//     Q . K^T and dP = dO . V^T by wgmma m64n64k16, both operands K-major in
//     shared memory; ds in registers, rounded to bf16; dq += dS . K by
//     wgmma m64n{hd}k16 with dS as the register A operand (S's accumulator
//     layout is the A fragment's, as K7's P) and K as the MN-major B
//     operand (the transpose bit, as K7's V).  lse and delta of the
//     thread's two rows come once, from global memory;
//   - K9: one CTA per (kv head, batch, 128-row k tile), k tile 0 first
//     (under the causal mask it sees the most q tiles).  K and V stay
//     resident; the CTA loops over the G query heads of the group and, in
//     each, over the 64-row q tiles at or below the diagonal, Q, dO and
//     their lse and delta streaming through a 2-stage ring (the producer
//     warp stages lse and delta, 64 floats each, beside the TMA loads).  It
//     computes the transposes directly: S^T = K . Q^T and dP^T = V . dO^T,
//     both K-major; then dv += P^T . dO and dk += dS^T . Q with P^T and dS^T
//     as register A operands and dO and Q as MN-major B operands.  dk and dv
//     accumulate in registers across the whole loop: no atomics, so the
//     result is deterministic.  dS^T is rounded to bf16; P^T is not: it
//     goes in as two products into the same accumulator, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), which leaves about 2^-16 of p per term (25%
//     more tensor work in K9);
//   - tiles wholly above the causal diagonal are never loaded; TMA
//     zero-fills rows past each sequence, and the kernels mask the ragged
//     Sq and Skv themselves (a mask is computed only on tiles that reach
//     past an end or the diagonal);
//   - shared memory: 128 KB a CTA at hd 128 (one CTA an SM), tiles on 1 KB
//     with the swizzle by row bytes of K7 (128B at hd 64/128, 64B at 32,
//     32B at 16).
// expf, as the SIMT kernels and the plain versions; no --use_fast_math.
#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;      // the streaming ring
constexpr int DQ_Q = 128;      // K8: q rows per CTA
constexpr int DQ_KV = 64;      // K8: kv rows per streamed tile
constexpr int DKV_K = 128;     // K9: k rows per CTA
constexpr int DKV_Q = 64;      // K9: q rows per streamed tile
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t dq_smem() {
  // Q and dO; the K/V ring; the mbarriers; slack to align to 1 KB.
  return (size_t)2 * SwizzledTile<HD, DQ_Q>::BYTES +
         (size_t)STAGES * 2 * SwizzledTile<HD, DQ_KV>::BYTES +
         8 * (1 + 2 * STAGES) + 1024;
}

template <int HD>
constexpr size_t dkv_smem() {
  // K and V; the Q/dO ring; lse and delta of each stage; the mbarriers;
  // slack to align to 1 KB.
  return (size_t)2 * SwizzledTile<HD, DKV_K>::BYTES +
         (size_t)STAGES * 2 * SwizzledTile<HD, DKV_Q>::BYTES +
         (size_t)STAGES * 2 * DKV_Q * sizeof(float) +
         8 * (1 + 2 * STAGES) + 1024;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The thread's accumulator row r (0: its first row, 1: that + 8) of a
// 64 x HD fp32 wgmma accumulator, written as bf16 at out + 8j + col.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[HD / 2],
                                           int r, int col) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    *reinterpret_cast<uint32_t*>(out + 8 * j + col) =
        pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// K8: dq for one (head, batch, 128-row q tile).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                      int KV, int causal, int kv_offset, float scale) {
  using QT = SwizzledTile<HD, DQ_Q>;
  using KT = SwizzledTile<HD, DQ_KV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + QT::BYTES;
  // Stage s: K at ring + s * 2 * KT::BYTES, V right after it.
  const uint32_t ring = base + 2 * QT::BYTES;
  const uint32_t bars = ring + STAGES * 2 * KT::BYTES;
  const uint32_t q_full = bars;
  const uint32_t kv_full = bars + 8;                // + 8 * s
  const uint32_t kv_empty = bars + 8 * (1 + STAGES);  // + 8 * s

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * DQ_Q;  // last first
  const int kvh = h / (H / KV);
  // Tiles past the last one holding a key at or before the tile's last
  // query position are wholly masked: never loaded.
  int n_tiles = (Skv + DQ_KV - 1) / DQ_KV;
  if (causal) {
    const int last = q0 + DQ_Q - 1 + kv_offset;  // largest visible kv index
    n_tiles = last < 0 ? 0 : min(n_tiles, last / DQ_KV + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
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
      mbar_expect_tx(q_full, 2 * QT::BYTES);
      tma_load_tile<HD, DQ_Q>(sq, &tq, q_full, h, q0, b);
      tma_load_tile<HD, DQ_Q>(sdo, &tdo, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        const uint32_t sk = ring + s * 2 * KT::BYTES;
        mbar_wait(kv_empty + 8 * s, (use & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * s, 2 * KT::BYTES);
        tma_load_tile<HD, DQ_KV>(sk, &tk, kv_full + 8 * s, kvh, t * DQ_KV, b);
        tma_load_tile<HD, DQ_KV>(sk + KT::BYTES, &tv, kv_full + 8 * s, kvh,
                                 t * DQ_KV, b);
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
    const uint32_t q_wg = sq + wg * 64 * QT::ROW;
    const uint32_t do_wg = sdo + wg * 64 * QT::ROW;
    const size_t stat = ((size_t)b * H + h) * Sq;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse_r[r] = row < Sq ? lse[stat + row] : 0.f;
      delta_r[r] = row < Sq ? delta[stat + row] : 0.f;
    }
    float dq_acc[HD / 2];
    zero(dq_acc);
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, use = t / STAGES;
      const int kv0 = t * DQ_KV;
      const uint32_t sk = ring + s * 2 * KT::BYTES;
      const uint32_t sv = sk + KT::BYTES;
      mbar_wait(kv_full + 8 * s, use & 1);
      float sc[32], dp[32];  // the first products overwrite them
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, smem_desc<QT::ROW>(q_wg + QT::col16(16 * kk), 16),
                     smem_desc<KT::ROW>(sk + KT::col16(16 * kk), 16), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, smem_desc<QT::ROW>(do_wg + QT::col16(16 * kk), 16),
                     smem_desc<KT::ROW>(sv + KT::col16(16 * kk), 16), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);

      // ds, with s masked where a key is past the end of K, past Skv after
      // the offset, or (causal) after the query.
      const bool edge =
          kv0 + DQ_KV > Skv || kv0 + DQ_KV - kv_offset > Skv ||
          (causal && kv0 + DQ_KV - 1 - kv_offset > q0 + wg * 64);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const int idx = kv0 + 8 * (i / 4) + col + (i % 2);
        const int kpos = idx - kv_offset;
        const bool ok = !edge || (idx < Skv && kpos < Skv &&
                                  (!causal || kpos <= row0 + 8 * r));
        const float p = expf((ok ? sc[i] * scale : NEG_INF) - lse_r[r]);
        sc[i] = p * (dp[i] - delta_r[r]) * scale;
      }
      // ds in k's type: S's accumulator pairs are the A fragment's
      // registers.
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) ds[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_KV / 16; ++kk)
        wgmma_rs<HD>(dq_acc, ds + 4 * kk,
                     smem_desc<KT::ROW>(sk + kk * 16 * KT::ROW, KT::BLOCK));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq_acc);
      mbar_arrive(kv_empty + 8 * s);  // this thread is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq)
        store_rows<HD>(dq + (((size_t)b * Sq + row) * H + h) * HD, dq_acc, r,
                       col);
    }
  }
}

// K9: dk and dv for one (kv head, batch, 128-row k tile), summed over the
// G query heads of the group and every q tile.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                       int H, int KV, int causal, int kv_offset,
                       float scale) {
  using KT = SwizzledTile<HD, DKV_K>;
  using QT = SwizzledTile<HD, DKV_Q>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + KT::BYTES;
  // Stage s: Q at ring + s * 2 * QT::BYTES, dO right after it; lse at
  // stats + s * 2 * DKV_Q, delta right after it.
  const uint32_t ring = base + 2 * KT::BYTES;
  const uint32_t stats_at = ring + STAGES * 2 * QT::BYTES;
  float* const stats =
      reinterpret_cast<float*>(smem_raw + (stats_at - smem_u32(smem_raw)));
  const uint32_t bars = stats_at + STAGES * 2 * DKV_Q * sizeof(float);
  const uint32_t kv_full = bars;
  const uint32_t q_full = bars + 8;                   // + 8 * s
  const uint32_t q_empty = bars + 8 * (1 + STAGES);   // + 8 * s

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * DKV_K;  // causal: the first tiles see the most q
  const int G = H / KV;
  // q tiles holding a row at or past the tile's first key position.
  const int n_q = (Sq + DKV_Q - 1) / DKV_Q;
  int t0 = 0;
  if (causal) {
    const int first = k0 - kv_offset;
    t0 = first <= 0 ? 0 : first / DKV_Q;
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 32);  // the producer warp
      mbar_init(q_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // The producer: its first warp keeps the ring full, lane 0 issuing the
    // TMA loads and every lane staging lse and delta.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < CONSUMERS * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KT::BYTES);
        tma_load_tile<HD, DKV_K>(sk, &tk, kv_full, kvh, k0, b);
        tma_load_tile<HD, DKV_K>(sv, &tv, kv_full, kvh, k0, b);
      }
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const size_t stat = ((size_t)b * H + h) * Sq;
        for (int iq = t0; iq < n_q; ++iq, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          const int q0 = iq * DKV_Q;
          mbar_wait(q_empty + 8 * s, (use & 1) ^ 1);
          float* st = stats + s * 2 * DKV_Q;
          for (int c = lane; c < DKV_Q; c += 32) {
            const bool in = q0 + c < Sq;
            st[c] = in ? lse[stat + q0 + c] : 0.f;
            st[DKV_Q + c] = in ? delta[stat + q0 + c] : 0.f;
          }
          if (lane == 0) {
            // Lane 0's arrival carries the transaction count.
            const uint32_t sq = ring + s * 2 * QT::BYTES;
            mbar_expect_tx(q_full + 8 * s, 2 * QT::BYTES);
            tma_load_tile<HD, DKV_Q>(sq, &tq, q_full + 8 * s, h, q0, b);
            tma_load_tile<HD, DKV_Q>(sq + QT::BYTES, &tdo, q_full + 8 * s, h,
                                     q0, b);
          } else {
            mbar_arrive(q_full + 8 * s);  // releases this lane's stores
          }
        }
      }
    }
  } else {
    // A consumer: 64 k rows.  Thread (warp w, lane) holds key rows
    // 16w + lane/4 and that + 8 of the warpgroup's, q columns 2 (lane % 4)
    // and + 1 of every 8-column group.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int kw0 = k0 + wg * 64;
    const int row0 = kw0 + (tid / 32) * 16 + lane / 4;  // and + 8
    const int col = 2 * (lane % 4);
    const uint32_t k_wg = sk + wg * 64 * KT::ROW;
    const uint32_t v_wg = sv + wg * 64 * KT::ROW;
    float dk_acc[HD / 2], dv_acc[HD / 2];
    zero(dk_acc);
    zero(dv_acc);
    mbar_wait(kv_full, 0);

    int it = 0;
    for (int g = 0; g < G; ++g) {
      for (int iq = t0; iq < n_q; ++iq, ++it) {
        const int s = it % STAGES, use = it / STAGES;
        const int q0 = iq * DKV_Q;
        const uint32_t sq = ring + s * 2 * QT::BYTES;
        const uint32_t sdo = sq + QT::BYTES;
        const float* lse_s = stats + s * 2 * DKV_Q;
        const float* delta_s = lse_s + DKV_Q;
        mbar_wait(q_full + 8 * s, use & 1);
        float st[32], dpt[32];  // S^T, dP^T: key rows, query columns
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(st, smem_desc<KT::ROW>(k_wg + KT::col16(16 * kk), 16),
                       smem_desc<QT::ROW>(sq + QT::col16(16 * kk), 16),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(dpt,
                       smem_desc<KT::ROW>(v_wg + KT::col16(16 * kk), 16),
                       smem_desc<QT::ROW>(sdo + QT::col16(16 * kk), 16),
                       kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(st);
        fence_regs(dpt);

        // p^T and ds^T, masked where the query is past Sq, the key past the
        // end of K or past Skv after the offset, or (causal) after the
        // query.
        const bool edge =
            q0 + DKV_Q > Sq || kw0 + 64 > Skv || kw0 + 64 - kv_offset > Skv ||
            (causal && kw0 + 63 - kv_offset > q0);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + col + (i % 2);
          const int idx = row0 + 8 * ((i / 2) % 2);
          const int kpos = idx - kv_offset;
          const bool ok =
              !edge || (q0 + c < Sq && idx < Skv && kpos < Skv &&
                        (!causal || kpos <= q0 + c));
          const float p = expf((ok ? st[i] * scale : NEG_INF) - lse_s[c]);
          dpt[i] = p * (dpt[i] - delta_s[c]) * scale;
          st[i] = p;
        }
        // A fragments: p^T as p_hi + p_lo (not rounded, as JAX), ds^T in
        // q's type.
        uint32_t p_hi[16], p_lo[16], dst[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          p_hi[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p_hi[i]));
          p_lo[i] = pack_bf16(st[2 * i] - hi.x, st[2 * i + 1] - hi.y);
          dst[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
        }

        fence_regs(dk_acc);
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DKV_Q / 16; ++kk) {
          const uint64_t d_do =
              smem_desc<QT::ROW>(sdo + kk * 16 * QT::ROW, QT::BLOCK);
          wgmma_rs<HD>(dv_acc, p_hi + 4 * kk, d_do);
          wgmma_rs<HD>(dv_acc, p_lo + 4 * kk, d_do);
          wgmma_rs<HD>(dk_acc, dst + 4 * kk,
                       smem_desc<QT::ROW>(sq + kk * 16 * QT::ROW, QT::BLOCK));
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        mbar_arrive(q_empty + 8 * s);  // this thread is done with stage s
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Skv) continue;
      const size_t off = (((size_t)b * Skv + row) * KV + kvh) * HD;
      store_rows<HD>(dk + off, dk_acc, r, col);
      store_rows<HD>(dv + off, dv_acc, r, col);
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
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<HD, DQ_Q>(&tq, a.q, a.H, a.Sq, a.B) ||
      !encode<HD, DQ_Q>(&tdo, a.dout, a.H, a.Sq, a.B) ||
      !encode<HD, DQ_KV>(&tk, a.k, a.KV, a.Skv, a.B) ||
      !encode<HD, DQ_KV>(&tv, a.v, a.KV, a.Skv, a.B))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_sm90<HD>;
  constexpr size_t smem = dq_smem<HD>();
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.Sq + DQ_Q - 1) / DQ_Q);
  kernel<<<grid, THREADS, smem, a.s>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0),
      a.Sq, a.Skv, a.H, a.KV, a.causal, a.kv_offset, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<HD, DKV_Q>(&tq, a.q, a.H, a.Sq, a.B) ||
      !encode<HD, DKV_Q>(&tdo, a.dout, a.H, a.Sq, a.B) ||
      !encode<HD, DKV_K>(&tk, a.k, a.KV, a.Skv, a.B) ||
      !encode<HD, DKV_K>(&tv, a.v, a.KV, a.Skv, a.B))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_sm90<HD>;
  constexpr size_t smem = dkv_smem<HD>();
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(a.KV, a.B, (a.Skv + DKV_K - 1) / DKV_K);
  kernel<<<grid, THREADS, smem, a.s>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.kv_offset, a.scale);
  return (int)cudaGetLastError();
}

template <bool DQ>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return DQ ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32: return DQ ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64: return DQ ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128: return DQ ? launch_dq<128>(a) : launch_dkv<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_attention_bwd.cu's interface, bf16 only (any other dtype is
// refused): q, dout (B, Sq, H, hd); k, v (B, Skv, KV, hd), contiguous bf16,
// 16-byte aligned; lse, delta (B, H, Sq) fp32.  hd is 16, 32, 64 or 128; the
// wrapper checks that B and the 128-row q and k tiles fit gridDim.y/z.
// Each returns cudaGetLastError() after its launch (0 on success).

// K8: dq (B, Sq, H, hd) in bf16.
extern "C" int flash_bwd_dq_sm90_launch(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dq, int B, int Sq, int Skv,
                                        int H, int KV, int hd, int dtype,
                                        int causal, int kv_offset,
                                        float scale, void* stream) {
  if (dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Skv, H, KV,
               causal, kv_offset, scale, static_cast<cudaStream_t>(stream)};
  return launch_hd<true>(hd, a);
}

// K9: dk, dv (B, Skv, KV, hd) in bf16.
extern "C" int flash_bwd_dkv_sm90_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* delta,
                                         void* dk, void* dv, int B, int Sq,
                                         int Skv, int H, int KV, int hd,
                                         int dtype, int causal, int kv_offset,
                                         float scale, void* stream) {
  if (dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, KV,
               causal, kv_offset, scale, static_cast<cudaStream_t>(stream)};
  return launch_hd<false>(hd, a);
}
