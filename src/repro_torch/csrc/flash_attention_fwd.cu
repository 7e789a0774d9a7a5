// K3 on Hopper: FlashAttention-2 forward (causal / sliding window, GQA).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_impl
// (body _fwd_kernel). Same function: o = softmax(scale * q k^T + mask) v per
// query head, the kv head of query head h being h // G, and the row
// statistic lse = m + log(l) that the backward recomputes probabilities
// from. NEG_INF = -1e30 stays finite and the denominator is floored at
// 1e-30, so a row whose first live tile is fully masked is erased by the
// first unmasked tile (corr = exp(-1e30 - m) = 0) instead of turning NaN.
//
// Design: one thread block per (64-row query tile, query head, batch row).
// The block walks only the kv tiles the causal and window limits leave
// live -- the counterpart of _tile_live, computed as loop bounds rather
// than tested per tile -- staging each 64-key tile of K and V in shared
// memory as f32 and keeping the online softmax (m, l) and the output
// accumulator in registers. 256 threads; each owns a 4 x 4 block of the
// 64 x 64 score tile (4 rows, 4 strided columns) and the same 4 rows of
// the output at 1/16 of the head dims, so every shared-memory operand is
// reused 4 times per load.
//
// Layout: q (B, L, H, dh), k/v (B, L, KV, dh), o like q, read and written
// in place through batch and row strides (head stride dh, dim stride 1).
// No padding in device memory: the ragged sequence edge and the head dims
// beyond dh (the tile is compiled for a padded width DHP in {32, 64, 128,
// 256}) are masked on load. Keys past L get -inf (excluded outright);
// keys the causal or window mask removes get NEG_INF, as on the TPU.
//
// Bound on the H100: operations. At internlm2-1.8b's prefill shape
// (1, 1024, 16/8, 128) the causal half of the scores is ~4.3 GFLOP, about
// 4.3 us at the bf16 tensor-core peak. This kernel uses scalar f32 FMAs
// (67 TFLOP/s peak, and shared-memory bandwidth below that), so it is
// expected to sit well above the bound; tensor cores (mma.sync / wgmma)
// and TMA staging are the later work that closes the gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr float DENOM_FLOOR = 1e-30f;

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

template <int DHP>
constexpr size_t smem_bytes() {
  // sQ, sK: (64, DHP + 1); sV: (64, DHP); sP: (64, 65) -- all f32
  return sizeof(float) * (size_t)(BQ * (DHP + 1) + BK * (DHP + 1) + BK * DHP + BQ * (BK + 1));
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int L, int H, int KV, int dh,
           long long sqb, long long sql, long long skb, long long skl, long long svb,
           long long svl, long long sob, long long sol, int causal, int window, float scale) {
  constexpr int QS = DHP + 1;  // padded row stride: conflict-free column reads
  constexpr int PS = BK + 1;
  constexpr int NJ = DHP / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * DHP;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = iq * BQ;
  const int t = threadIdx.x;
  const int rg = t >> 4;  // rows 4*rg .. 4*rg+3
  const int cg = t & 15;  // score columns cg + 16*j, output dims cg + 16*j

  const T* qb = q + (long long)b * sqb + (long long)h * dh;
  const T* kb = k + (long long)b * skb + (long long)kvh * dh;
  const T* vb = v + (long long)b * svb + (long long)kvh * dh;

  for (int i = t; i < BQ * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP, l = q0 + r;
    sQ[r * QS + d] = (l < L && d < dh) ? to_f(qb[(long long)l * sql + d]) : 0.f;
  }

  float m[4], lsum[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // live kv tiles (the _tile_live bounds): causal stops at the tile of the
  // last real query row; a window starts at the tile of the first key the
  // first row of this tile can still see.
  const int q_last = min(L, q0 + BQ) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (L + BK - 1) / BK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    for (int i = t; i < BK * DHP; i += NT) {
      const int r = i / DHP, d = i % DHP, l = k0 + r;
      const bool in = l < L && d < dh;
      sK[r * QS + d] = in ? to_f(kb[(long long)l * skl + d]) : 0.f;
      sV[r * DHP + d] = in ? to_f(vb[(long long)l * svl + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * rg + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= L)
          x = -INFINITY;  // past the sequence: no key at all
        else if ((causal && kp > qp) || (window > 0 && qp - kp >= window))
          x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the row's 64 scores live in the 16 lanes sharing rg
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(4 * rg + i) * PS + cg + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      lsum[i] = corr * lsum[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int n_live = min(BK, L - k0);  // keys past L have p == 0
#pragma unroll 2
    for (int c = 0; c < n_live; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * rg + i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * DHP + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + 4 * rg + i;
    if (l >= L) continue;
    const float den = fmaxf(lsum[i], DENOM_FLOOR);
    T* orow = o + (long long)b * sob + (long long)l * sol + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < dh) orow[d] = from_f<T>(acc[i][j] / den);
    }
    if (cg == 0) lse[((long long)b * H + h) * L + l] = m[i] + logf(den);
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L, int H,
           int KV, int dh, long long sqb, long long sql, long long skb, long long skl,
           long long svb, long long svl, long long sob, long long sol, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  fwd_kernel<T, DHP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, L, H, KV, dh, sqb, sql, skb, skl,
      svb, svl, sob, sol, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L, int H,
             int KV, int dh, long long sqb, long long sql, long long skb, long long skl,
             long long svb, long long svl, long long sob, long long sol, int causal, int window,
             float scale, cudaStream_t s) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl, sob, sol,
                         causal, window, scale, s);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl, sob, sol,
                         causal, window, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl, sob,
                          sol, causal, window, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl, sob,
                          sol, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   int B, int L, int H, int KV, int dh, long long sqb,
                                   long long sql, long long skb, long long skl, long long svb,
                                   long long svl, long long sob, long long sol, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl, sob,
                           sol, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, B, L, H, KV, dh, sqb, sql, skb, skl, svb, svl,
                                   sob, sol, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
