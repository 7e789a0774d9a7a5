// K4 and K5 on Hopper: FlashAttention-2 backward (causal / sliding window,
// GQA, global position offsets), probabilities recomputed tile by tile from
// the saved lse, in two routes chosen by dtype.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:325
// _bwd_impl (pallas_call :371, :379 and :421, :429, the first of each pair
// with scalar prefetch of (q_off, k_off)):
//   K4 flash_attention_dq  (body _dq_kernel):  dq = sum_k ds k, q-major;
//   K5 flash_attention_dkv (body _dkv_kernel): dv = sum_q p^T dO and
//      dk = sum_q ds^T q, kv-major, folding the G query heads of a kv head.
// with p = exp(scale * q k^T (masked) - lse) and
// ds = p * (dO v^T - delta) * scale, delta = rowsum(dO * O) precomputed by
// the caller in f32 (a jnp op outside Pallas on the TPU too). Keeping the
// TPU's split keeps its determinism: every output element is summed by one
// thread in a fixed order, with no atomics -- K4 owns a query tile and walks
// its kv tiles, K5 owns a kv tile and walks the G heads, then their live
// query tiles -- so two launches give the same bits. The split recomputes S
// and dP in both kernels: 7 products where a fused backward has 5.
//
// Conventions of K3 (flash_attention_fwd.cu): positions are global, query
// row i at q_off + i and key j at k_off + j, for the masks and the live-tile
// loop bounds (flash_common.cuh); NEG_INF = -1e30 stays finite for keys the
// causal or window mask removes; keys and query rows past L do not exist
// and get p = 0 outright; the q and kv edges are masked independently (the
// tail-key bug the TPU code documents at flash_attention.py:244-253 cannot
// occur: a kv tile past the last query tile still writes its dk/dv). No
// padding in device memory: (B, L, N, dh) tensors are read through batch
// and row strides, the head dims past dh of the compiled width are
// zero-filled on load, and only real rows and dims are written. Outputs
// are in the input dtype.
//
// Bound on the H100: operations. At the training shape (4, 2048, 16/8,
// 128), causal, the ~2.1 M visible (query, key) pairs per head cost 6 * dh
// flops each in K4 (q k^T, dO v^T, ds k) and 8 * dh in K5 (k q^T, v dO^T,
// p^T dO, ds^T q): 0.1043 and 0.1390 ms at the bf16 tensor-core peak; at
// recurrentgemma's (4, 2048, 16/1, 256), 0.2086 and 0.2781 ms.
//
// bf16 route (entries flash_attention_dq / flash_attention_dkv, the main
// path): FlashAttention-2's shape on mma.sync m16n8k16 (bf16 in, f32
// accumulate), fragments by ldmatrix, tiles staged as bf16 with cp.async,
// double-buffered, in rows padded by 16 bytes (flash_mma.cuh).
//   K4: one block of DQ_WARPS warps covers 16 query rows a warp of one
//       query head. Each warp keeps its Q and dO A fragments, its rows' lse
//       and delta and its (16, dh) f32 dq accumulator in registers and walks
//       the live kv tiles of 64 keys: S = Q K^T and dP = dO V^T (K's and V's
//       B fragments by ldmatrix), P = exp2(S scale log2e - lse log2e)
//       masked, dS = P (dP - delta) scale in f32, packed to bf16 in registers
//       as the A fragment of dQ += dS K (K's B fragment by ldmatrix.trans).
//       Causal q tiles are issued heaviest first, as in K3.
//   K5: one block of DKV_WARPS warps covers 16 keys a warp of one kv head;
//       K and V stay in shared memory (their fragments are re-read by
//       ldmatrix each q tile: the dk and dv accumulators alone take 128
//       registers a thread at dh 128). It walks the G heads and their live
//       q tiles of 64 queries, Q, dO, lse and delta staged per tile. Per
//       tile and warp: S^T = K Q^T, P^T with lse per column, dV += P^T dO (P^T packed as the A fragment,
//       dO's B fragment by ldmatrix.trans), dP^T = V dO^T, dS^T = P^T
//       (dP^T - delta) scale, dK += dS^T Q. Causal kv tiles are issued
//       heaviest first: the first tiles, which see the most queries.
// Head dims compile at 16, 32, 64, 80, 112 and 128 (dh 120 runs at 128), and
// at 256 (any dh in (128, 256], recurrentgemma's 256 with one kv head): there
// the (16, 256) f32 accumulators (dq; dk and dv) and K4's register-resident
// Q and dO fragments would pass 255 registers a thread, and the staged
// tiles of the dh-128 shape 232,448 bytes of shared memory. So each block
// owns one 128-wide half of the output head dims (blockIdx.x = head x 2 +
// half) and recomputes S and dP over all 256 (K4 10 * dh flops a visible
// pair where the split-free route has 6, K5 12 where it has 8); K4 keeps Q
// and dO in shared memory and reads their fragments by ldmatrix per kv tile,
// with 4 warps (64 query rows) a block: 202,752 bytes. K5 keeps its 4 warps:
// 203,776 bytes. The accumulators are then as wide as at dh 128.
// Departures from the TPU kernels, within chip_smoke.py's TOL_K45 2e-2 and
// TOL_ROW 1e-2: P and dS are rounded to bf16 before their products (the TPU
// keeps them in f32), and the exponent runs in base 2 (exp2 of
// log2(e)-scaled operands). Left for later: wgmma with TMA staging and warp
// specialisation, and one fused kernel for dq, dk and dv.
//
// f32 route (entries flash_attention_dq_f32 / flash_attention_dkv_f32): the
// scalar kernels of the first port, kept for f32 inputs (the card-versus-CPU
// check in f32 and the f32 tests). 256 threads per block, 64 x 64 tiles
// staged in shared memory as f32 with a padded row stride; each thread owns
// a 4 x 4 block of a score tile and 4 rows of its accumulators at 1/16 of
// the head dims. At dh 256 the tiles are staged 128 head dims at a time
// (scores summed over both chunks) and each block owns one 128-wide half of
// the outputs, as on the bf16 route. A bf16 tensor never reaches them: the
// wrapper picks the route by dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using flash::NEG_INF;

// One call's operands (strides in elements). o1 is dq (K4) or dk (K5), o2
// dv (K5); vec: q, k, v, dO rows move as 16-byte chunks.
struct Args {
  const void *q, *k, *v, *dO, *lse, *delta;
  void *o1, *o2;
  int B, L, H, KV, dh;
  long long sqb, sql, skb, skl, svb, svl, sdob, sdol, s1b, s1l, s2b, s2l;
  int causal, window, q_off, k_off;
  float scale;
  int vec;
};

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using flash::acc_as_a;
using flash::bf16;
using flash::frag_a;
using flash::frag_b;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::LOG2E;
using flash::mma16816;

// warps per block, 16 rows (K4: queries, K5: keys) a warp: measured on the
// H100 at the training shape against 4 (K4) and 8 (K5) warps, and against
// K5 taking its 64 queries in two chunks of 32
constexpr int DQ_WARPS = 8;
constexpr int DKV_WARPS = 4;
constexpr int BK = 64;   // K4: keys per staged tile
constexpr int BQT = 64;  // K5: queries per staged tile
constexpr int STAGES = 2;
constexpr float NEG_INF_LOG2 = NEG_INF * LOG2E;  // a masked score in log2 units

// 4-byte copy global -> shared; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ bool masked(int causal, int window, int qp, int kp) {
  return (causal && kp > qp) || (window > 0 && qp - kp >= window);
}

template <int DHP, int WARPS>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO (the block's query rows), sK and sV (STAGES x BK rows each)
  return sizeof(bf16) * (size_t)(2 * 16 * WARPS + 2 * STAGES * BK) * (DHP + 8);
}

template <int DHP>
constexpr size_t dkv_smem_bytes() {
  // sK, sV (the block's keys), sQ and sdO (STAGES x BQT rows each); sL, sD
  // (STAGES x BQT f32 each)
  return sizeof(bf16) * (size_t)(2 * 16 * DKV_WARPS + 2 * STAGES * BQT) * (DHP + 8) +
         sizeof(float) * 2 * STAGES * BQT;
}

// ---------------------------------------------------------------------------
// K4: dq, q-major. DHP: the staged (padded) head dims; WARPS: warps a block;
// DOUT: the head dims of dq a block writes (DHP, or a half of 256)
// ---------------------------------------------------------------------------
template <int DHP, int WARPS, int DOUT>
__global__ void __launch_bounds__(32 * WARPS)
dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int L, int H, int KV, int dh, long long sqb, long long sql,
              long long skb, long long skl, long long svb, long long svl, long long sdob,
              long long sdol, long long sdqb, long long sdql, int causal, int window, int q_off,
              int k_off, float scale, int vec) {
  constexpr int NT = 32 * WARPS;
  constexpr int BQ = 16 * WARPS;  // query rows per block
  constexpr int SR = DHP + 8;
  constexpr int KS = DHP / 16;    // k-steps of Q K^T and dO V^T
  constexpr int NS = BK / 8;      // n-tiles of a warp's (16, BK) score tile
  constexpr int ND = DOUT / 8;    // n-tiles of its (16, DOUT) slice of dq
  constexpr int NH = DHP / DOUT;  // slices of the head dims, one a block
  constexpr bool QREG = DHP <= 128;  // Q's and dO's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * SR;
  bf16* sK = sdO + BQ * SR;  // stage s at sK + s * BK * SR
  bf16* sV = sK + STAGES * BK * SR;

  const int h = blockIdx.x / NH, d0 = (blockIdx.x % NH) * DOUT, b = blockIdx.y;
  const int iq = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q0 = iq * BQ;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragment's row group and column pair
  const float scale_log2 = scale * LOG2E;

  const bf16* kb = k + (long long)b * skb + (long long)kvh * dh;
  const bf16* vb = v + (long long)b * svb + (long long)kvh * dh;

  int kt_begin, kt_end;
  flash::live_tiles(q0, min(L, q0 + BQ) - 1, L, BK, causal, window, q_off - k_off, &kt_begin,
                    &kt_end);

  // Q, dO and the first STAGES - 1 live tiles, one copy group per tile (Q
  // and dO join the first); every loop turn commits one group, maybe empty
  flash::load_tile<NT, BQ, DHP>(sQ, q + (long long)b * sqb + (long long)h * dh, sql, q0, L, dh,
                                vec);
  flash::load_tile<NT, BQ, DHP>(sdO, dO + (long long)b * sdob + (long long)h * dh, sdol, q0, L,
                                dh, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_begin + i < kt_end) {
      flash::load_tile<NT, BK, DHP>(sK + i * BK * SR, kb, skl, (kt_begin + i) * BK, L, dh, vec);
      flash::load_tile<NT, BK, DHP>(sV + i * BK * SR, vb, svl, (kt_begin + i) * BK, L, dh, vec);
    }
    flash::cp_async_commit();
  }

  // this thread's rows: row0 + g (hr = 0) and row0 + g + 8 (hr = 1)
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ql = q0 + row0 + g + hr * 8;
    const long long at = ((long long)b * H + h) * L + ql;
    lse2[hr] = ql < L ? lse[at] * LOG2E : 0.f;
    dl[hr] = ql < L ? delta[at] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[QREG ? KS : 1][4], gf[QREG ? KS : 1][4];  // Q's and dO's A fragments

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin;
    const int nxt = kt + STAGES - 1;  // refill the stage the last turn read
    if (nxt < kt_end) {
      const int ns = (it + STAGES - 1) % STAGES;
      flash::load_tile<NT, BK, DHP>(sK + ns * BK * SR, kb, skl, nxt * BK, L, dh, vec);
      flash::load_tile<NT, BK, DHP>(sV + ns * BK * SR, vb, svl, nxt * BK, L, dh, vec);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<STAGES - 1>();  // this tile's group (and Q, dO) has landed
    __syncthreads();
    const bf16* cK = sK + (it % STAGES) * BK * SR;
    const bf16* cV = sV + (it % STAGES) * BK * SR;
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldsm_x4(qf[ks], frag_a(sQ, SR, row0, ks * 16, lane));
          ldsm_x4(gf[ks], frag_a(sdO, SR, row0, ks * 16, lane));
        }
      }
    }

    // S = Q K^T and dP = dO V^T: B fragments from K's and V's rows (keys)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], ga[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[ks][e];
          ga[e] = gf[ks][e];
        }
      } else {  // re-read from shared memory each kv tile
        ldsm_x4(qa, frag_a(sQ, SR, row0, ks * 16, lane));
        ldsm_x4(ga, frag_a(sdO, SR, row0, ks * 16, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, frag_b(cK, SR, n2 * 16, ks * 16, lane));
        mma16816(s[2 * n2], qa, bf[0], bf[1]);
        mma16816(s[2 * n2 + 1], qa, bf[2], bf[3]);
        ldsm_x4(bf, frag_b(cV, SR, n2 * 16, ks * 16, lane));
        mma16816(dp[2 * n2], ga, bf[0], bf[1]);
        mma16816(dp[2 * n2 + 1], ga, bf[2], bf[3]);
      }
    }

    // P and dS (into s); only tiles on an edge need the mask tests
    const int k0 = kt * BK;
    const bool edge = k0 + BK > L || (causal && k_off + k0 + BK - 1 > q_off + q0) ||
                      (window > 0 && q_off + q0 + BQ - 1 - (k_off + k0) >= window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kl = k0 + j * 8 + tg * 2 + (e & 1);
          if (kl >= L)
            x = -INFINITY;  // past the sequence: p = 0
          else if (masked(causal, window, q_off + q0 + row0 + g + hr * 8, k_off + kl))
            x = NEG_INF_LOG2;
        }
        const float p = exp2f(x - lse2[hr]);
        s[j][e] = p * (dp[j][e] - dl[hr]) * scale;
      }

    // dQ += dS K: two dS n-tiles are one A fragment, K's B fragment by
    // ldmatrix.trans (k runs down K's rows), the block's head dims only
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int d2 = 0; d2 < DOUT / 16; ++d2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, frag_a(cK, SR, kk * 16, d0 + d2 * 16, lane));
        mma16816(acc[2 * d2], a, bf[0], bf[1]);
        mma16816(acc[2 * d2 + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  flash::cp_async_wait<0>();  // no copy left in flight (a block without live tiles)

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ql = q0 + row0 + g + hr * 8;
    if (ql >= L) continue;
    bf16* row = dq + (long long)b * sdqb + (long long)ql * sdql + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = d0 + j * 8 + tg * 2;
      if (d < dh) row[d] = __float2bfloat16(acc[j][2 * hr]);
      if (d + 1 < dh) row[d + 1] = __float2bfloat16(acc[j][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dk, dv, kv-major with the G query heads folded in. DOUT: the head dims
// of dk and dv a block writes (DHP, or a half of 256)
// ---------------------------------------------------------------------------
template <int DHP, int DOUT>
__global__ void __launch_bounds__(32 * DKV_WARPS)
dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, int KV, int dh,
               long long sqb, long long sql, long long skb, long long skl, long long svb,
               long long svl, long long sdob, long long sdol, long long sdkb, long long sdkl,
               long long sdvb, long long sdvl, int causal, int window, int q_off, int k_off,
               float scale, int vec) {
  constexpr int NT = 32 * DKV_WARPS;
  constexpr int BKB = 16 * DKV_WARPS;  // keys per block
  constexpr int SR = DHP + 8;
  constexpr int KS = DHP / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NQ = BQT / 8;     // n-tiles of a warp's (16, BQT) transposed score tile
  constexpr int ND = DOUT / 8;    // n-tiles of its (16, DOUT) slices of dk and dv
  constexpr int NH = DHP / DOUT;  // slices of the head dims, one a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKB * SR;
  bf16* sQ = sV + BKB * SR;  // stage s at sQ + s * BQT * SR
  bf16* sdO = sQ + STAGES * BQT * SR;
  float* sL = reinterpret_cast<float*>(sdO + STAGES * BQT * SR);  // stage s at sL + s * BQT
  float* sD = sL + STAGES * BQT;

  const int kvh = blockIdx.x / NH, d0 = (blockIdx.x % NH) * DOUT, b = blockIdx.y;
  const int ik = blockIdx.z;  // causal: the first kv tiles see the most queries
  const int k0 = ik * BKB;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tg = lane & 3;
  const float scale_log2 = scale * LOG2E;

  // live query tiles: causal starts at the tile of the first query that
  // sees k0; a window ends at the tile of the last query that still sees
  // the block's keys
  int qt_begin, qt_end;
  flash::live_q_tiles(k0, min(L, k0 + BKB) - 1, L, BQT, causal, window, q_off - k_off,
                      &qt_begin, &qt_end);
  const int nqt = max(0, qt_end - qt_begin);
  const int total = G * nqt;  // (head, q tile) turns: heads outer, tiles inner

  // K and V join the first copy group
  flash::load_tile<NT, BKB, DHP>(sK, k + (long long)b * skb + (long long)kvh * dh, skl, k0, L, dh,
                                 vec);
  flash::load_tile<NT, BKB, DHP>(sV, v + (long long)b * svb + (long long)kvh * dh, svl, k0, L, dh,
                                 vec);
  // Q, dO, lse and delta of turn t into stage st
  auto stage = [&](int t, int st) {
    const int h = kvh * G + t / nqt, q0 = (qt_begin + t % nqt) * BQT;
    flash::load_tile<NT, BQT, DHP>(sQ + st * BQT * SR, q + (long long)b * sqb + (long long)h * dh,
                                   sql, q0, L, dh, vec);
    flash::load_tile<NT, BQT, DHP>(sdO + st * BQT * SR,
                                   dO + (long long)b * sdob + (long long)h * dh, sdol, q0, L, dh,
                                   vec);
    const long long at = ((long long)b * H + h) * L;
    for (int i = threadIdx.x; i < 2 * BQT; i += NT) {
      const int r = i % BQT, l = q0 + r;
      const float* src = (i < BQT ? lse : delta) + at;
      cp_async4((i < BQT ? sL : sD) + st * BQT + r, l < L ? src + l : src, l < L ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) stage(i, i);
    flash::cp_async_commit();
  }

  // this thread's keys: row0 + g (elements 0, 1) and row0 + g + 8 (2, 3)
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < total; ++t) {
    const int nxt = t + STAGES - 1;
    if (nxt < total) stage(nxt, nxt % STAGES);
    flash::cp_async_commit();
    flash::cp_async_wait<STAGES - 1>();  // this turn's group (and K, V) has landed
    __syncthreads();
    const bf16* cQ = sQ + (t % STAGES) * BQT * SR;
    const bf16* cdO = sdO + (t % STAGES) * BQT * SR;
    const float* cL = sL + (t % STAGES) * BQT;
    const float* cD = sD + (t % STAGES) * BQT;
    const int q0 = (qt_begin + t % nqt) * BQT;
    const bool edge = q0 + BQT > L || k0 + BKB > L ||
                      (causal && k_off + k0 + BKB - 1 > q_off + q0) ||
                      (window > 0 && q_off + q0 + BQT - 1 - (k_off + k0) >= window);

    // S^T = K Q^T: A from K's rows, B from Q's rows (queries)
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(sK, SR, row0, ks * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, frag_b(cQ, SR, n2 * 16, ks * 16, lane));
        mma16816(s[2 * n2], a, bf[0], bf[1]);
        mma16816(s[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
    // P^T, lse per column; keys and queries past L get p = 0
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tg * 2 + (e & 1);
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int ql = q0 + c, kl = k0 + row0 + g + (e >> 1) * 8;
          if (ql >= L || kl >= L)
            x = -INFINITY;
          else if (masked(causal, window, q_off + ql, k_off + kl))
            x = NEG_INF_LOG2;
        }
        s[j][e] = exp2f(x - cL[c] * LOG2E);
      }
    // dV += P^T dO: k runs over the tile's queries, dO's B fragment by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int d2 = 0; d2 < DOUT / 16; ++d2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, frag_a(cdO, SR, kk * 16, d0 + d2 * 16, lane));
        mma16816(dva[2 * d2], a, bf[0], bf[1]);
        mma16816(dva[2 * d2 + 1], a, bf[2], bf[3]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale (into s)
    float dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, frag_a(sV, SR, row0, ks * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, frag_b(cdO, SR, n2 * 16, ks * 16, lane));
        mma16816(dp[2 * n2], a, bf[0], bf[1]);
        mma16816(dp[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - cD[j * 8 + tg * 2 + (e & 1)]) * scale;
    // dK += dS^T Q: Q's B fragment by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int d2 = 0; d2 < DOUT / 16; ++d2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, frag_a(cQ, SR, kk * 16, d0 + d2 * 16, lane));
        mma16816(dka[2 * d2], a, bf[0], bf[1]);
        mma16816(dka[2 * d2 + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  flash::cp_async_wait<0>();  // no copy left in flight (a block without live tiles)

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kl = k0 + row0 + g + hr * 8;
    if (kl >= L) continue;
    bf16* krow = dk + (long long)b * sdkb + (long long)kl * sdkl + (long long)kvh * dh;
    bf16* vrow = dv + (long long)b * sdvb + (long long)kl * sdvl + (long long)kvh * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = d0 + j * 8 + tg * 2;
      if (d < dh) {
        krow[d] = __float2bfloat16(dka[j][2 * hr]);
        vrow[d] = __float2bfloat16(dva[j][2 * hr]);
      }
      if (d + 1 < dh) {
        krow[d + 1] = __float2bfloat16(dka[j][2 * hr + 1]);
        vrow[d + 1] = __float2bfloat16(dva[j][2 * hr + 1]);
      }
    }
  }
}

template <int DHP, int WARPS = DQ_WARPS, int DOUT = DHP>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DHP, WARPS>();
  static_assert(smem <= 232448, "K4's staged tiles exceed a block's shared memory");
  auto kernel = dq_kernel_mma<DHP, WARPS, DOUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = 16 * WARPS;
  dim3 grid(a.H * (DHP / DOUT), a.B, (a.L + BQ - 1) / BQ);
  kernel<<<grid, 32 * WARPS, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dO,
      (const float*)a.lse, (const float*)a.delta, (bf16*)a.o1, a.L, a.H, a.KV, a.dh, a.sqb,
      a.sql, a.skb, a.skl, a.svb, a.svl, a.sdob, a.sdol, a.s1b, a.s1l, a.causal, a.window,
      a.q_off, a.k_off, a.scale, a.vec);
  return (int)cudaGetLastError();
}

template <int DHP, int DOUT = DHP>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DHP>();
  static_assert(smem <= 232448, "K5's staged tiles exceed a block's shared memory");
  auto kernel = dkv_kernel_mma<DHP, DOUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BKB = 16 * DKV_WARPS;
  dim3 grid(a.KV * (DHP / DOUT), a.B, (a.L + BKB - 1) / BKB);
  kernel<<<grid, 32 * DKV_WARPS, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dO,
      (const float*)a.lse, (const float*)a.delta, (bf16*)a.o1, (bf16*)a.o2, a.L, a.H, a.KV, a.dh,
      a.sqb, a.sql, a.skb, a.skl, a.svb, a.svl, a.sdob, a.sdol, a.s1b, a.s1l, a.s2b, a.s2l,
      a.causal, a.window, a.q_off, a.k_off, a.scale, a.vec);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 16) return DKV ? launch_dkv<16>(a, s) : launch_dq<16>(a, s);
  if (a.dh <= 32) return DKV ? launch_dkv<32>(a, s) : launch_dq<32>(a, s);
  if (a.dh <= 64) return DKV ? launch_dkv<64>(a, s) : launch_dq<64>(a, s);
  if (a.dh <= 80) return DKV ? launch_dkv<80>(a, s) : launch_dq<80>(a, s);
  if (a.dh <= 112) return DKV ? launch_dkv<112>(a, s) : launch_dq<112>(a, s);
  if (a.dh <= 128) return DKV ? launch_dkv<128>(a, s) : launch_dq<128>(a, s);
  // two 128-wide halves of the outputs; K4 at 4 warps
  if (a.dh <= 256) return DKV ? launch_dkv<256, 128>(a, s) : launch_dq<256, 4, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 route: scalar FMAs
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// Head dims staged at a time: all of them up to 128; at 256 two chunks of
// 128, each block then writing one chunk's slice of the outputs.
__host__ __device__ constexpr int chunk_of(int dhp) { return dhp < 128 ? dhp : 128; }
// the first head dim of the last chunk (what the score loop leaves staged)
template <int DHP>
__host__ __device__ constexpr int c_last() { return DHP - chunk_of(DHP); }

// rows x DC tile of (B, L, N, dh) at sequence offset l0, zero past L / dh
// (base and dh taken from the chunk's first head dim)
template <int DC>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long sl, int l0,
                                          int L, int dh) {
  constexpr int QS = DC + 1;
  for (int i = threadIdx.x; i < 64 * DC; i += NT) {
    const int r = i / DC, d = i % DC, l = l0 + r;
    dst[r * QS + d] = (l < L && d < dh) ? base[(long long)l * sl + d] : 0.f;
  }
}

template <int DHP>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO, sK, sV: (64, DC + 1); sS: (64, 65); sL, sD: 64 -- all f32
  return sizeof(float) * (size_t)(4 * 64 * (chunk_of(DHP) + 1) + 64 * (BK + 1) + 2 * 64);
}

template <int DHP>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sdO: (64, DC + 1); sP, sS: (64, 65); sL, sD: 64
  return sizeof(float) * (size_t)(4 * 64 * (chunk_of(DHP) + 1) + 2 * 64 * (BQ + 1) + 2 * 64);
}

// K4: dq, q-major
template <int DHP>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int L, int H, int KV, int dh,
          long long sqb, long long sql, long long skb, long long skl, long long svb,
          long long svl, long long sdob, long long sdol, long long sdqb, long long sdql,
          int causal, int window, int q_off, int k_off, float scale) {
  constexpr int DC = chunk_of(DHP);  // head dims staged at a time
  constexpr int NCH = DHP / DC;      // chunks; the block writes chunk c_out of dq
  constexpr int QS = DC + 1;
  constexpr int PS = BK + 1;
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * QS;
  float* sK = sdO + BQ * QS;
  float* sV = sK + BK * QS;
  float* sS = sV + BK * QS;
  float* sL = sS + BQ * PS;
  float* sD = sL + BQ;

  const int iq = blockIdx.x, h = blockIdx.y / NCH, b = blockIdx.z;
  const int c_out = (blockIdx.y % NCH) * DC;
  const int kvh = h / (H / KV);
  const int q0 = iq * BQ;
  const int t = threadIdx.x;
  const int rg = t >> 4;  // query rows 4*rg .. 4*rg+3
  const int cg = t & 15;  // key columns cg + 16*j, head dims c_out + cg + 16*j

  const float* kb = k + (long long)b * skb + (long long)kvh * dh;
  const float* vb = v + (long long)b * svb + (long long)kvh * dh;
  const float* qb = q + (long long)b * sqb + (long long)h * dh;
  const float* gb = dO + (long long)b * sdob + (long long)h * dh;
  if constexpr (NCH == 1) {  // Q and dO stay staged for every kv tile
    load_tile<DC>(sQ, qb, sql, q0, L, dh);
    load_tile<DC>(sdO, gb, sdol, q0, L, dh);
  }
  const float* lse_row = lse + ((long long)b * H + h) * L;
  const float* delta_row = delta + ((long long)b * H + h) * L;
  for (int r = t; r < BQ; r += NT) {
    const int l = q0 + r;
    sL[r] = l < L ? lse_row[l] : 0.f;
    sD[r] = l < L ? delta_row[l] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // live kv tiles, as in K3
  int kt_begin, kt_end;
  flash::live_tiles(q0, min(L, q0 + BQ) - 1, L, BK, causal, window, q_off - k_off, &kt_begin,
                    &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ch = 0; ch < NCH; ++ch) {
      const int c0 = ch * DC, dc = min(DC, dh - c0);
      __syncthreads();  // previous reads of the staged tiles are done (and sQ.. loads)
      if constexpr (NCH > 1) {
        load_tile<DC>(sQ, qb + c0, sql, q0, L, dh - c0);
        load_tile<DC>(sdO, gb + c0, sdol, q0, L, dh - c0);
      }
      load_tile<DC>(sK, kb + c0, skl, k0, L, dh - c0);
      load_tile<DC>(sV, vb + c0, svl, k0, L, dh - c0);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < dc; ++d) {
        float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sQ[(4 * rg + i) * QS + d];
          gv[i] = sdO[(4 * rg + i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sK[(cg + 16 * j) * QS + d];
          vv[j] = sV[(cg + 16 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * rg + i, ql = q0 + r, qp = q_off + ql;  // global positions
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = k0 + cg + 16 * j, kp = k_off + kl;
        float ds = 0.f;
        if (kl < L && ql < L) {
          float x = s[i][j] * scale;
          if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) x = NEG_INF;
          const float p = expf(x - sL[r]);
          ds = p * (dp[i][j] - sD[r]) * scale;
        }
        sS[r * PS + cg + 16 * j] = ds;
      }
    }
    if (NCH > 1 && c_out != c_last<DHP>()) {  // sK holds the last chunk: stage dq's
      __syncthreads();
      load_tile<DC>(sK, kb + c_out, skl, k0, L, dh - c_out);
    }
    __syncthreads();

    const int n_live = min(BK, L - k0);
#pragma unroll 2
    for (int c = 0; c < n_live; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(4 * rg + i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kk = sK[c * QS + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + 4 * rg + i;
    if (l >= L) continue;
    float* row = dq + (long long)b * sdqb + (long long)l * sdql + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = c_out + cg + 16 * j;
      if (d < dh) row[d] = acc[i][j];
    }
  }
}

// K5: dk, dv, kv-major with the G query heads folded in
template <int DHP>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dO, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int L,
           int H, int KV, int dh, long long sqb, long long sql, long long skb, long long skl,
           long long svb, long long svl, long long sdob, long long sdol, long long sdkb,
           long long sdkl, long long sdvb, long long sdvl, int causal, int window, int q_off,
           int k_off, float scale) {
  constexpr int DC = chunk_of(DHP);  // head dims staged at a time
  constexpr int NCH = DHP / DC;      // chunks; the block writes chunk c_out of dk, dv
  constexpr int QS = DC + 1;
  constexpr int PS = BQ + 1;
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * QS;
  float* sQ = sV + BK * QS;
  float* sdO = sQ + BQ * QS;
  float* sP = sdO + BQ * QS;
  float* sS = sP + BK * PS;
  float* sL = sS + BK * PS;
  float* sD = sL + BQ;

  const int ik = blockIdx.x, kvh = blockIdx.y / NCH, b = blockIdx.z;
  const int c_out = (blockIdx.y % NCH) * DC;
  const int G = H / KV;
  const int k0 = ik * BK;
  const int t = threadIdx.x;
  const int rg = t >> 4;  // kv rows 4*rg .. 4*rg+3
  const int cg = t & 15;  // query columns cg + 16*j, head dims c_out + cg + 16*j

  const float* kb = k + (long long)b * skb + (long long)kvh * dh;
  const float* vb = v + (long long)b * svb + (long long)kvh * dh;
  if constexpr (NCH == 1) {  // K and V stay staged for every query tile
    load_tile<DC>(sK, kb, skl, k0, L, dh);
    load_tile<DC>(sV, vb, svl, k0, L, dh);
  }

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  // live query tiles: causal starts at the tile of the first query that
  // sees k0; a window ends at the tile of the last query that still sees
  // the tile
  int qt_begin, qt_end;
  flash::live_q_tiles(k0, min(L, k0 + BK) - 1, L, BQ, causal, window, q_off - k_off, &qt_begin,
                      &qt_end);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + (long long)b * sqb + (long long)h * dh;
    const float* gb = dO + (long long)b * sdob + (long long)h * dh;
    const float* lse_row = lse + ((long long)b * H + h) * L;
    const float* delta_row = delta + ((long long)b * H + h) * L;
    for (int iq = qt_begin; iq < qt_end; ++iq) {
      const int q0 = iq * BQ;
      // transposed tile: kv row 4*rg+i against query column cg + 16*j
      float s[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dpt[i][j] = 0.f;
      for (int ch = 0; ch < NCH; ++ch) {
        const int c0 = ch * DC, dc = min(DC, dh - c0);
        __syncthreads();  // previous reads of the staged tiles are done
        if constexpr (NCH > 1) {
          load_tile<DC>(sK, kb + c0, skl, k0, L, dh - c0);
          load_tile<DC>(sV, vb + c0, svl, k0, L, dh - c0);
        }
        load_tile<DC>(sQ, qb + c0, sql, q0, L, dh - c0);
        load_tile<DC>(sdO, gb + c0, sdol, q0, L, dh - c0);
        if (ch == 0) {
          for (int r = t; r < BQ; r += NT) {
            const int l = q0 + r;
            sL[r] = l < L ? lse_row[l] : 0.f;
            sD[r] = l < L ? delta_row[l] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int d = 0; d < dc; ++d) {
          float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = sK[(4 * rg + i) * QS + d];
            vv[i] = sV[(4 * rg + i) * QS + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qv[j] = sQ[(cg + 16 * j) * QS + d];
            gv[j] = sdO[(cg + 16 * j) * QS + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
            }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i, kl = k0 + r, kp = k_off + kl;  // global positions
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j, ql = q0 + c, qp = q_off + ql;
          float p = 0.f, ds = 0.f;
          if (kl < L && ql < L) {
            float x = s[i][j] * scale;
            if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) x = NEG_INF;
            p = expf(x - sL[c]);
            ds = p * (dpt[i][j] - sD[c]) * scale;
          }
          sP[r * PS + c] = p;
          sS[r * PS + c] = ds;
        }
      }
      if (NCH > 1 && c_out != c_last<DHP>()) {  // sQ, sdO hold the last chunk
        __syncthreads();
        load_tile<DC>(sQ, qb + c_out, sql, q0, L, dh - c_out);
        load_tile<DC>(sdO, gb + c_out, sdol, q0, L, dh - c_out);
      }
      __syncthreads();

      const int n_live = min(BQ, L - q0);
#pragma unroll 2
      for (int c = 0; c < n_live; ++c) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(4 * rg + i) * PS + c];
          sv[i] = sS[(4 * rg + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float gg = sdO[c * QS + cg + 16 * j];
          const float qq = sQ[c * QS + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][j] = fmaf(pv[i], gg, dva[i][j]);
            dka[i][j] = fmaf(sv[i], qq, dka[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = k0 + 4 * rg + i;
    if (l >= L) continue;
    float* krow = dk + (long long)b * sdkb + (long long)l * sdkl + (long long)kvh * dh;
    float* vrow = dv + (long long)b * sdvb + (long long)l * sdvl + (long long)kvh * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = c_out + cg + 16 * j;
      if (d < dh) {
        krow[d] = dka[i][j];
        vrow[d] = dva[i][j];
      }
    }
  }
}

template <int DHP>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.L + BQ - 1) / BQ, a.H * (DHP / chunk_of(DHP)), a.B);
  dq_kernel<DHP><<<grid, NT, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dO,
      (const float*)a.lse, (const float*)a.delta, (float*)a.o1, a.L, a.H, a.KV, a.dh, a.sqb,
      a.sql, a.skb, a.skl, a.svb, a.svl, a.sdob, a.sdol, a.s1b, a.s1l, a.causal, a.window,
      a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int DHP>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.L + BK - 1) / BK, a.KV * (DHP / chunk_of(DHP)), a.B);
  dkv_kernel<DHP><<<grid, NT, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dO,
      (const float*)a.lse, (const float*)a.delta, (float*)a.o1, (float*)a.o2, a.L, a.H, a.KV,
      a.dh, a.sqb, a.sql, a.skb, a.skl, a.svb, a.svl, a.sdob, a.sdol, a.s1b, a.s1l, a.s2b, a.s2l,
      a.causal, a.window, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return DKV ? launch_dkv<32>(a, s) : launch_dq<32>(a, s);
  if (a.dh <= 64) return DKV ? launch_dkv<64>(a, s) : launch_dq<64>(a, s);
  if (a.dh <= 128) return DKV ? launch_dkv<128>(a, s) : launch_dq<128>(a, s);
  if (a.dh <= 256) return DKV ? launch_dkv<256>(a, s) : launch_dq<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32

// K4's operands (o1 = dq); K5 adds o2 = dv and its strides
Args make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* o1, int B, int L, int H, int KV, int dh, long long sqb,
               long long sql, long long skb, long long skl, long long svb, long long svl,
               long long sdob, long long sdol, long long s1b, long long s1l, int causal,
               int window, int q_off, int k_off, float scale, int vec) {
  return Args{q,   k,   v,   dO,   lse,  delta, o1,  nullptr, B,      L,      H,     KV,
              dh,  sqb, sql, skb,  skl,  svb,   svl, sdob,    sdol,   s1b,    s1l,   0,
              0,   causal, window, q_off, k_off, scale, vec};
}

// q, k, v, dO rows in 16-byte chunks (the bf16 route's cp.async)
int rows_vec(const void* q, const void* k, const void* v, const void* dO, int dh, long long sqb,
             long long sql, long long skb, long long skl, long long svb, long long svl,
             long long sdob, long long sdol) {
  return dh % 8 == 0 && flash::aligned16(q, 2, {sqb, sql}) && flash::aligned16(k, 2, {skb, skl}) &&
         flash::aligned16(v, 2, {svb, svl}) && flash::aligned16(dO, 2, {sdob, sdol});
}

bool bad_shape(int B, int L, int KV, int H) { return B < 1 || L < 1 || KV < 1 || H % KV != 0; }

}  // namespace

// K4, bf16 route (tensor cores): q, k, v, dO, dq bf16; lse, delta (B, H, L)
// f32 contiguous. Strides are in elements. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dq, int B, int L,
                                  int H, int KV, int dh, long long sqb, long long sql,
                                  long long skb, long long skl, long long svb, long long svl,
                                  long long sdob, long long sdol, long long sdqb,
                                  long long sdql, int causal, int window, int q_off,
                                  int k_off, float scale, void* stream) {
  if (bad_shape(B, L, KV, H)) return (int)cudaErrorInvalidValue;
  const int vec = rows_vec(q, k, v, dO, dh, sqb, sql, skb, skl, svb, svl, sdob, sdol);
  return tc::dispatch<false>(make_args(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, sqb, sql,
                                     skb, skl, svb, svl, sdob, sdol, sdqb, sdql, causal, window,
                                     q_off, k_off, scale, vec),
                             (cudaStream_t)stream);
}

// K4, f32 route (scalar): every tensor f32. Returns a cudaError_t.
extern "C" int flash_attention_dq_f32(const void* q, const void* k, const void* v,
                                      const void* dO, const void* lse, const void* delta,
                                      void* dq, int B, int L, int H, int KV, int dh,
                                      long long sqb, long long sql, long long skb, long long skl,
                                      long long svb, long long svl, long long sdob,
                                      long long sdol, long long sdqb, long long sdql, int causal,
                                      int window, int q_off, int k_off, float scale,
                                      void* stream) {
  if (bad_shape(B, L, KV, H)) return (int)cudaErrorInvalidValue;
  return f32::dispatch<false>(make_args(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, sqb, sql,
                                      skb, skl, svb, svl, sdob, sdol, sdqb, sdql, causal, window,
                                      q_off, k_off, scale, 0),
                              (cudaStream_t)stream);
}

// K5, bf16 route (tensor cores): q, k, v, dO, dk, dv bf16; lse, delta as
// for K4. Returns a cudaError_t.
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int L, int H, int KV, int dh, long long sqb, long long sql,
                                   long long skb, long long skl, long long svb, long long svl,
                                   long long sdob, long long sdol, long long sdkb,
                                   long long sdkl, long long sdvb, long long sdvl, int causal,
                                   int window, int q_off, int k_off, float scale, void* stream) {
  if (bad_shape(B, L, KV, H)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dO, lse, delta, dk, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl,
                   sdob, sdol, sdkb, sdkl, causal, window, q_off, k_off, scale,
                   rows_vec(q, k, v, dO, dh, sqb, sql, skb, skl, svb, svl, sdob, sdol));
  a.o2 = dv;
  a.s2b = sdvb;
  a.s2l = sdvl;
  return tc::dispatch<true>(a, (cudaStream_t)stream);
}

// K5, f32 route (scalar): every tensor f32. Returns a cudaError_t.
extern "C" int flash_attention_dkv_f32(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int L, int H, int KV, int dh,
                                       long long sqb, long long sql, long long skb,
                                       long long skl, long long svb, long long svl,
                                       long long sdob, long long sdol, long long sdkb,
                                       long long sdkl, long long sdvb, long long sdvl,
                                       int causal, int window, int q_off, int k_off, float scale,
                                       void* stream) {
  if (bad_shape(B, L, KV, H)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dO, lse, delta, dk, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl,
                   sdob, sdol, sdkb, sdkl, causal, window, q_off, k_off, scale, 0);
  a.o2 = dv;
  a.s2b = sdvb;
  a.s2l = sdvl;
  return f32::dispatch<true>(a, (cudaStream_t)stream);
}
