// K6 on Hopper: single-query flash decode over a dense slot cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode_kernel (body _decode_kernel). One query row per sequence
// attends to its slot's cache; the mask comes from the cache metadata, not
// iota: key slot j of row b is visible iff slot_pos[b, j] >= 0 and
// slot_pos[b, j] <= q_pos[b] (causal) and q_pos[b] - slot_pos[b, j] <
// window (sliding window, where the cache is a ring). Masked scores get
// the finite NEG_INF = -1e30 and the denominator is floored at 1e-30, as
// on the TPU. A parked slot (q_pos = -1) masks every key: its output is
// the finite mean of V over the slab, which the engine discards.
//
// Design: one thread block per (kv head, batch row). The G query heads that
// share the kv head are the rows of the block's little matrix, as in the
// TPU layout (flash_decode.py:163-164), so GQA reads each K/V row once for
// all G heads. The block walks the S cache slots in 64-key tiles staged in
// shared memory as f32, with the online softmax (m, l, corr) and the
// (G, dh) accumulator in shared memory. Head dims beyond dh are masked on
// load (compiled widths 32/64/128/256); slots past S are excluded (-inf).
//
// Bound on the H100: bytes. Every step reads the whole K/V slab of its
// slots: at 8 slots x 1089 x 8 kv heads x 128 x bf16 that is ~35.7 MB,
// ~10.6 us at 3.35 TB/s. With one block per (slot, kv head) -- 64 blocks
// on 132 SMs -- and a load-then-compute loop without overlap, this kernel
// reaches only a fraction of that rate. Splitting S across blocks
// (flash-decoding) and pipelining the tile loads are the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BK = 64;
constexpr int NT = 128;
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
size_t smem_bytes(int G) {
  // sQ (G, DHP), sAcc (G, DHP), sK (BK, DHP+1), sV (BK, DHP), sS (G, BK),
  // sM/sL/sC (G) -- f32; sPos (BK) int
  return sizeof(float) * ((size_t)2 * G * DHP + BK * (DHP + 1) + BK * DHP + G * BK + 3 * G) +
         sizeof(int) * BK;
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, const int* __restrict__ slot_pos, T* __restrict__ o,
              int S, int H, int KV, int dh, long long sqb, long long skb, long long sks,
              long long svb, long long svs, long long spb, long long sob, int causal, int window,
              float scale) {
  constexpr int KS = DHP + 1;
  const int G = H / KV;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sAcc = sQ + G * DHP;
  float* sK = sAcc + G * DHP;
  float* sV = sK + BK * KS;
  float* sS = sV + BK * DHP;
  float* sM = sS + G * BK;
  float* sL = sM + G;
  float* sC = sL + G;
  int* sPos = (int*)(sC + G);

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* qb = q + (long long)b * sqb + (long long)kvh * G * dh;
  const T* kb = k + (long long)b * skb + (long long)kvh * dh;
  const T* vb = v + (long long)b * svb + (long long)kvh * dh;
  const int* pb = slot_pos + (long long)b * spb;
  const int qp = q_pos[b];

  for (int i = t; i < G * DHP; i += NT) {
    const int g = i / DHP, d = i % DHP;
    sQ[i] = d < dh ? to_f(qb[(long long)g * dh + d]) : 0.f;
    sAcc[i] = 0.f;
  }
  for (int g = t; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // previous tile fully consumed (and init visible)
    for (int i = t; i < BK * DHP; i += NT) {
      const int r = i / DHP, d = i % DHP, j = s0 + r;
      const bool in = j < S && d < dh;
      sK[r * KS + d] = in ? to_f(kb[(long long)j * sks + d]) : 0.f;
      sV[r * DHP + d] = in ? to_f(vb[(long long)j * svs + d]) : 0.f;
    }
    for (int r = t; r < BK; r += NT) sPos[r] = s0 + r < S ? pb[s0 + r] : 0;
    __syncthreads();

    for (int i = t; i < G * BK; i += NT) {
      const int g = i / BK, r = i % BK, j = s0 + r;
      float x;
      if (j >= S) {
        x = -INFINITY;  // past the slab: no slot at all
      } else {
        const float* qr = sQ + g * DHP;
        const float* kr = sK + r * KS;
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int sp = sPos[r];
        bool live = sp >= 0;
        if (causal) live = live && sp <= qp;
        if (window > 0) live = live && qp - sp < window;
        x = live ? dot * scale : NEG_INF;
      }
      sS[i] = x;
    }
    __syncthreads();

    // online softmax: one warp per row, two scores per lane
    for (int g = warp; g < G; g += NT / 32) {
      const float a0 = sS[g * BK + lane], a1 = sS[g * BK + lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      sS[g * BK + lane] = p0;
      sS[g * BK + lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[g] = corr;
        sL[g] = corr * sL[g] + ps;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    const int n_live = min(BK, S - s0);
    for (int i = t; i < G * DHP; i += NT) {
      const int g = i / DHP, d = i % DHP;
      const float* pr = sS + g * BK;
      float a = sAcc[i] * sC[g];
#pragma unroll 4
      for (int r = 0; r < n_live; ++r) a = fmaf(pr[r], sV[r * DHP + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  T* ob = o + (long long)b * sob + (long long)kvh * G * dh;
  for (int i = t; i < G * DHP; i += NT) {
    const int g = i / DHP, d = i % DHP;
    if (d < dh) ob[(long long)g * dh + d] = from_f<T>(sAcc[i] / fmaxf(sL[g], DENOM_FLOOR));
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* slot_pos,
           void* o, int B, int S, int H, int KV, int dh, long long sqb, long long skb,
           long long sks, long long svb, long long svs, long long spb, long long sob, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DHP>(H / KV);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  decode_kernel<T, DHP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)q_pos, (const int*)slot_pos, (T*)o, S, H,
      KV, dh, sqb, skb, sks, svb, svs, spb, sob, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qp, const void* sp, void* o,
             int B, int S, int H, int KV, int dh, long long sqb, long long skb, long long sks,
             long long svb, long long svs, long long spb, long long sob, int causal, int window,
             float scale, cudaStream_t s) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, qp, sp, o, B, S, H, KV, dh, sqb, skb, sks, svb, svs, spb, sob,
                         causal, window, scale, s);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, qp, sp, o, B, S, H, KV, dh, sqb, skb, sks, svb, svs, spb, sob,
                         causal, window, scale, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, qp, sp, o, B, S, H, KV, dh, sqb, skb, sks, svb, svs, spb, sob,
                          causal, window, scale, s);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, qp, sp, o, B, S, H, KV, dh, sqb, skb, sks, svb, svs, spb, sob,
                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* q_pos,
                            const void* slot_pos, void* o, int B, int S, int H, int KV, int dh,
                            long long sqb, long long skb, long long sks, long long svb,
                            long long svs, long long spb, long long sob, int causal, int window,
                            float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, q_pos, slot_pos, o, B, S, H, KV, dh, sqb, skb, sks, svb, svs,
                           spb, sob, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, q_pos, slot_pos, o, B, S, H, KV, dh, sqb, skb, sks,
                                   svb, svs, spb, sob, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
