// K4 and K5 on Hopper: FlashAttention-2 backward (causal / sliding window,
// GQA), probabilities recomputed tile by tile from the saved lse.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:_bwd_impl
// and their offset variants (:371, :421, scalar prefetch of (q_off, k_off)):
//   K4 flash_attention_dq  (body _dq_kernel):  dq = sum_k ds k, q-major;
//   K5 flash_attention_dkv (body _dkv_kernel): dv = sum_q p^T dO and
//      dk = sum_q ds^T q, kv-major, folding the G query heads of a kv head.
// with p = exp(scale * q k^T (masked) - lse) and
// ds = p * (dO v^T - delta) * scale, delta = rowsum(dO * O) precomputed by
// the caller in f32 (a jnp op outside Pallas on the TPU too). Keeping the
// TPU's split keeps its determinism: every output element is summed by one
// thread in a fixed order, with no atomics -- K4 owns a query tile, K5 owns
// a kv tile and loops over the G heads and the live query tiles itself.
//
// Conventions of K3 (flash_attention_fwd.cu): positions are global, query
// row i at q_off + i and key j at k_off + j, for the masks and the live-tile
// loop bounds (flash_common.cuh); NEG_INF = -1e30 stays finite for keys the
// causal or window mask removes; keys and query rows past L do not exist
// and get p = 0 outright; the q and kv edges are masked
// independently (the tail-key bug the TPU code documents at
// flash_attention.py:244-253 cannot occur: a kv tile past the last query
// tile still writes its dk/dv). No padding in device memory: (B, L, N, dh)
// tensors are read through batch and row strides, the head dims beyond dh
// of the padded width DHP in {32, 64, 128} are zero-filled on load, and
// only real rows and dims are written. Outputs are in the input dtype.
//
// Design: 256 threads per block, 64 x 64 tiles staged in shared memory as
// f32 with a padded row stride (conflict-free column reads). Each thread
// owns a 4 x 4 block of a score tile (4 rows, 4 strided columns) and 4 rows
// of its output accumulators at 1/16 of the head dims, as in K3.
//   K4: one block per (64-row query tile, query head, batch row); q, dO,
//       lse, delta stay resident; the block walks only the live kv tiles
//       (K3's causal / window loop bounds) and accumulates dq in registers.
//   K5: one block per (64-key kv tile, kv head, batch row); k, v stay
//       resident; for each of the G query heads it walks the live query
//       tiles (causal: from the kv tile on; window: up to the last query
//       that still sees the tile) and accumulates dk and dv in registers.
//
// Bound on the H100: operations. At the training slice's shape
// (4, 2048, 16/8, 128), causal, the ~8.4 M visible (query, key) pairs per
// head cost 6 * dh flops each in K4 (q k^T, dO v^T, ds k) and 8 * dh in K5
// (q k^T, dO v^T, p^T dO, ds^T q): 0.10 and 0.14 ms at the bf16
// tensor-core peak. These kernels use scalar f32 FMAs from shared memory,
// so, like K3, they sit far above the bound; mma.sync / wgmma with TMA
// staging is the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::NEG_INF;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows x DHP tile of (B, L, N, dh) at sequence offset l0, zero past L / dh
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long sl, int l0, int L,
                                          int dh) {
  constexpr int QS = DHP + 1;
  for (int i = threadIdx.x; i < 64 * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP, l = l0 + r;
    dst[r * QS + d] = (l < L && d < dh) ? to_f(base[(long long)l * sl + d]) : 0.f;
  }
}

template <int DHP>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO, sK, sV: (64, DHP + 1); sS: (64, 65); sL, sD: 64 -- all f32
  return sizeof(float) * (size_t)(4 * 64 * (DHP + 1) + 64 * (BK + 1) + 2 * 64);
}

template <int DHP>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sdO: (64, DHP + 1); sP, sS: (64, 65); sL, sD: 64
  return sizeof(float) * (size_t)(4 * 64 * (DHP + 1) + 2 * 64 * (BQ + 1) + 2 * 64);
}

// ---------------------------------------------------------------------------
// K4: dq, q-major
// ---------------------------------------------------------------------------
template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int L, int H, int KV, int dh,
          long long sqb, long long sql, long long skb, long long skl, long long svb,
          long long svl, long long sdob, long long sdol, long long sdqb, long long sdql,
          int causal, int window, int q_off, int k_off, float scale) {
  constexpr int QS = DHP + 1;
  constexpr int PS = BK + 1;
  constexpr int NJ = DHP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * QS;
  float* sK = sdO + BQ * QS;
  float* sV = sK + BK * QS;
  float* sS = sV + BK * QS;
  float* sL = sS + BQ * PS;
  float* sD = sL + BQ;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = iq * BQ;
  const int t = threadIdx.x;
  const int rg = t >> 4;  // query rows 4*rg .. 4*rg+3
  const int cg = t & 15;  // key columns cg + 16*j, head dims cg + 16*j

  const T* kb = k + (long long)b * skb + (long long)kvh * dh;
  const T* vb = v + (long long)b * svb + (long long)kvh * dh;
  load_tile<T, DHP>(sQ, q + (long long)b * sqb + (long long)h * dh, sql, q0, L, dh);
  load_tile<T, DHP>(sdO, dO + (long long)b * sdob + (long long)h * dh, sdol, q0, L, dh);
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
    __syncthreads();  // previous tile's sK/sV/sS reads are done (and sQ.. loads)
    load_tile<T, DHP>(sK, kb, skl, k0, L, dh);
    load_tile<T, DHP>(sV, vb, svl, k0, L, dh);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
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
    T* row = dq + (long long)b * sdqb + (long long)l * sdql + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < dh) row[d] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dk, dv, kv-major with the G query heads folded in
// ---------------------------------------------------------------------------
template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dO, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L,
           int H, int KV, int dh, long long sqb, long long sql, long long skb, long long skl,
           long long svb, long long svl, long long sdob, long long sdol, long long sdkb,
           long long sdkl, long long sdvb, long long sdvl, int causal, int window, int q_off,
           int k_off, float scale) {
  constexpr int QS = DHP + 1;
  constexpr int PS = BQ + 1;
  constexpr int NJ = DHP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * QS;
  float* sQ = sV + BK * QS;
  float* sdO = sQ + BQ * QS;
  float* sP = sdO + BQ * QS;
  float* sS = sP + BK * PS;
  float* sL = sS + BK * PS;
  float* sD = sL + BQ;

  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = ik * BK;
  const int t = threadIdx.x;
  const int rg = t >> 4;  // kv rows 4*rg .. 4*rg+3
  const int cg = t & 15;  // query columns cg + 16*j, head dims cg + 16*j

  load_tile<T, DHP>(sK, k + (long long)b * skb + (long long)kvh * dh, skl, k0, L, dh);
  load_tile<T, DHP>(sV, v + (long long)b * svb + (long long)kvh * dh, svl, k0, L, dh);

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
    const T* qb = q + (long long)b * sqb + (long long)h * dh;
    const T* gb = dO + (long long)b * sdob + (long long)h * dh;
    const float* lse_row = lse + ((long long)b * H + h) * L;
    const float* delta_row = delta + ((long long)b * H + h) * L;
    for (int iq = qt_begin; iq < qt_end; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // previous tile's sQ/sdO/sP/sS reads are done
      load_tile<T, DHP>(sQ, qb, sql, q0, L, dh);
      load_tile<T, DHP>(sdO, gb, sdol, q0, L, dh);
      for (int r = t; r < BQ; r += NT) {
        const int l = q0 + r;
        sL[r] = l < L ? lse_row[l] : 0.f;
        sD[r] = l < L ? delta_row[l] : 0.f;
      }
      __syncthreads();

      // transposed tile: kv row 4*rg+i against query column cg + 16*j
      float s[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < dh; ++d) {
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
    T* krow = dk + (long long)b * sdkb + (long long)l * sdkl + (long long)kvh * dh;
    T* vrow = dv + (long long)b * sdvb + (long long)l * sdvl + (long long)kvh * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < dh) {
        krow[d] = from_f<T>(dka[i][j]);
        vrow[d] = from_f<T>(dva[i][j]);
      }
    }
  }
}

template <typename T, int DHP>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
              const void* delta, void* dq, int B, int L, int H, int KV, int dh,
              const long long* st, int causal, int window, int q_off, int k_off, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  dq_kernel<T, DHP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (const float*)lse,
      (const float*)delta, (T*)dq, L, H, KV, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], causal, window, q_off, k_off, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DHP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int KV, int dh,
               const long long* st, int causal, int window, int q_off, int k_off, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BK - 1) / BK, KV, B);
  dkv_kernel<T, DHP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, L, H, KV, dh, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window, q_off, k_off, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                const void* delta, void* dq, int B, int L, int H, int KV, int dh,
                const long long* st, int causal, int window, int q_off, int k_off,
                float scale, cudaStream_t s) {
  if (dh <= 32)
    return launch_dq<T, 32>(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, st, causal, window,
                            q_off, k_off, scale, s);
  if (dh <= 64)
    return launch_dq<T, 64>(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, st, causal, window,
                            q_off, k_off, scale, s);
  if (dh <= 128)
    return launch_dq<T, 128>(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, st, causal, window,
                             q_off, k_off, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                 const void* delta, void* dk, void* dv, int B, int L, int H, int KV, int dh,
                 const long long* st, int causal, int window, int q_off, int k_off,
                 float scale, cudaStream_t s) {
  if (dh <= 32)
    return launch_dkv<T, 32>(q, k, v, dO, lse, delta, dk, dv, B, L, H, KV, dh, st, causal,
                             window, q_off, k_off, scale, s);
  if (dh <= 64)
    return launch_dkv<T, 64>(q, k, v, dO, lse, delta, dk, dv, B, L, H, KV, dh, st, causal,
                             window, q_off, k_off, scale, s);
  if (dh <= 128)
    return launch_dkv<T, 128>(q, k, v, dO, lse, delta, dk, dv, B, L, H, KV, dh, st, causal,
                              window, q_off, k_off, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq). lse, delta (B, H, L)
// f32 contiguous. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dq, int B, int L,
                                  int H, int KV, int dh, long long sqb, long long sql,
                                  long long skb, long long skl, long long svb, long long svl,
                                  long long sdob, long long sdol, long long sdqb,
                                  long long sdql, int causal, int window, int q_off,
                                  int k_off, float scale, int dtype, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const long long st[10] = {sqb, sql, skb, skl, svb, svl, sdob, sdol, sdqb, sdql};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, st, causal, window,
                              q_off, k_off, scale, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dO, lse, delta, dq, B, L, H, KV, dh, st, causal,
                                      window, q_off, k_off, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above (q, k, v, dO, dk, dv). Returns a cudaError_t.
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int L, int H, int KV, int dh, long long sqb, long long sql,
                                   long long skb, long long skl, long long svb, long long svl,
                                   long long sdob, long long sdol, long long sdkb,
                                   long long sdkl, long long sdvb, long long sdvl, int causal,
                                   int window, int q_off, int k_off, float scale, int dtype,
                                   void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {sqb, sql, skb, skl, svb, svl, sdob, sdol, sdkb, sdkl, sdvb, sdvl};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dO, lse, delta, dk, dv, B, L, H, KV, dh, st, causal,
                               window, q_off, k_off, scale, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dO, lse, delta, dk, dv, B, L, H, KV, dh, st,
                                       causal, window, q_off, k_off, scale, s);
  return (int)cudaErrorInvalidValue;
}
