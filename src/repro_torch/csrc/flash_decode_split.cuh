// The split-over-keys decode body shared by K6 (a dense slot cache), K7
// (an fp page pool) and K8 (an int8 / int4 page pool with f32 scales).
//
// Grid (split, kv head, slot). A block takes the contiguous key range of
// its split (the source's `range`), walks it in tiles of 64 keys (32 where
// a staged row is wider than 256 bytes), and stages each tile's K and V
// rows -- in their stored type: bf16 / f32, or the raw int bytes with their
// scale rows -- and the keys' positions with cp.async, double-buffered, so
// that the next tile's copies run under this tile's arithmetic. The Lq x G
// query rows that share the kv head are the rows of the block's little
// matrix (row l*G + g is query l, head g, with its own q_pos[b, l]), so
// GQA and speculative-verify rows read each K/V row once. Scores and P V
// read the staged rows into registers and convert them to f32 there (the
// source's `dot` and `pair`); the online softmax (m, l) and the (rows, dh)
// accumulator stay in f32 and go out unnormalised to scratch the wrapper
// allocates. A second kernel merges the splits in split order with the
// max-merge of ring_attention.py:133: o = sum_s w_s acc_s / max(sum_s w_s
// l_s, 1e-30), w_s = exp(m_s - max_s m_s). No atomics: two launches on the
// same inputs give the same bits.
//
// Masks: a key is visible to row r iff its position p is >= 0, p <=
// q_pos (causal) and q_pos - p < window; a masked score is the finite
// NEG_INF = -1e30, so a fully masked (parked) row stays finite and
// averages V over the keys its splits hold. A slot with no key at all (an
// unmapped page, or past the split's range) scores -inf and weighs 0; a
// split without a key keeps m = -inf, l = 0 and gets weight 0 in the merge
// (every weight 0, o = 0, where no split holds a key).
//
// A source (Dense in flash_decode.cu, Paged and Quant in
// flash_paged_decode.cu) provides:
//   Q                              the query / output type
//   row_bytes<DHP>()               bytes of a staged row at compile width DHP
//   scales(), table_len()          staged scales per row, block-table entries
//   range(sp, b, sTab, &k0, &k1)   the split's keys [k0, k1) (may fill sTab)
//   next_tile(k, k0, k1, bk, sTab) the first tile start >= k with a key, or k1
//   load_tile<DHP, BK>(stage, k, k0, k1, b, kvh, sTab)
//                                  start one tile's copies (NO_KEY positions)
//   dot<DHP>(q row, stage, j)      q . K row j in f32
//   prep(d), pair<DHP>(stage, j, d, prep)
//                                  V row j's elements d, d+1 in f32
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace decode_split {

using flash::DENOM_FLOOR;
using flash::NEG_INF;

constexpr int NT = 128;
constexpr size_t MAX_SMEM = 232448;
constexpr int NO_KEY = INT_MIN;  // position of a tile slot that holds no key

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

// keys per tile: 64, or 32 where a staged row is wider than 256 bytes
__host__ __device__ constexpr int tile_keys(int row_bytes) { return row_bytes <= 256 ? 64 : 32; }

// What every launch takes, whatever its keys' layout. q (B, Lq, H, dh) and
// o by strides (b, l; heads and dh contiguous); q_pos (B, Lq) contiguous;
// part_acc (nsplit, B, KV, Lq*G, dh) and part_ml (..., 2) f32 scratch.
struct Common {
  const void* q;
  const int* q_pos;
  void* o;
  float* part_acc;
  float* part_ml;
  int B, Lq, H, KV, dh, nsplit;
  long long sqb, sql, sob, sol;
  int causal, window;
  float scale;
};

// One stage of a tile in shared memory
struct Stage {
  unsigned char *k, *v;  // BK rows of row_bytes + 16 bytes (a 16-byte pad:
                         // 8 neighbouring rows hit 8 bank groups)
  int* pos;              // BK positions, NO_KEY where there is no key
  float *ks, *vs;        // BK x scales() (quantised pools only)
};

// 16 bytes of a shared-memory row (8 bf16 or 4 f32) as f32
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void chunk_f32(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

// two neighbouring elements of a shared-memory row as f32
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// K and V rows of bf16 / f32 elements at the element offsets ko / vo (the
// row's first element; `in` false: none) into row r of a stage: 16-byte
// cp.async chunks where rows are aligned (vec), else element by element;
// zero past w and where there is no row
template <typename T, int DHP>
__device__ __forceinline__ void stage_fp_rows(const Stage& st, const T* k, const T* v, int r,
                                              int d, bool in, long long ko, long long vo, int w,
                                              bool vec) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int SRB = DHP * (int)sizeof(T) + 16;
  T* dk = reinterpret_cast<T*>(st.k + r * SRB) + d;
  T* dv = reinterpret_cast<T*>(st.v + r * SRB) + d;
  in = in && d < w;
  if (vec) {
    flash::cp_async16(dk, in ? k + ko + d : k, in ? 16 : 0);
    flash::cp_async16(dv, in ? v + vo + d : v, in ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const bool ok = in && d + e < w;
      dk[e] = ok ? k[ko + d + e] : from_f<T>(0.f);
      dv[e] = ok ? v[vo + d + e] : from_f<T>(0.f);
    }
  }
}

// q . K row j over DHP bf16 / f32 elements, in f32
template <typename T, int DHP>
__device__ __forceinline__ float dot_fp(const float* qr, const Stage& st, int j) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int SRB = DHP * (int)sizeof(T) + 16;
  const T* kr = reinterpret_cast<const T*>(st.k + j * SRB);
  float dot = 0.f;
#pragma unroll 4
  for (int c = 0; c < DHP / EPC; ++c) {
    float kf[EPC];
    chunk_f32(kr + c * EPC, kf);
#pragma unroll
    for (int e = 0; e < EPC; ++e) dot = fmaf(qr[c * EPC + e], kf[e], dot);
  }
  return dot;
}

template <typename T, int DHP>
__device__ __forceinline__ float2 pair_fp(const Stage& st, int j, int d) {
  constexpr int SRB = DHP * (int)sizeof(T) + 16;
  return pair_f32(reinterpret_cast<const T*>(st.v + j * SRB) + d);
}

inline size_t smem_bytes(int srb, int bk, int dhp, int R, int ns, int ntab) {
  // sK, sV: 2 stages x (BK, SRB) bytes; sQ, sAcc (R, DHP), sS (R, BK), sM,
  // sL, sC (R), scales 2 stages x 2 x (BK, ns) f32; sPos (2, BK), sQp (R),
  // sTab (ntab) int
  return (size_t)4 * bk * srb +
         sizeof(float) * ((size_t)2 * R * dhp + (size_t)R * bk + 3 * (size_t)R +
                          (size_t)4 * bk * ns) +
         sizeof(int) * ((size_t)2 * bk + R + ntab);
}

template <class Src, int DHP>
__global__ void __launch_bounds__(NT) split_kernel(Common c, Src src) {
  using T = typename Src::Q;
  constexpr int SRB = Src::template row_bytes<DHP>() + 16;
  constexpr int BK = tile_keys(SRB - 16);
  const int G = c.H / c.KV, R = c.Lq * G, NS = src.scales();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;  // stage s at sK + s * BK * SRB
  unsigned char* sV = sK + 2 * BK * SRB;
  float* sQ = reinterpret_cast<float*>(sV + 2 * BK * SRB);
  float* sAcc = sQ + R * DHP;
  float* sS = sAcc + R * DHP;
  float* sM = sS + R * BK;
  float* sL = sM + R;
  float* sC = sL + R;
  float* sSc = sC + R;  // stage s: K scales at sSc + 2s*BK*NS, V at (2s+1)*BK*NS
  int* sPos = reinterpret_cast<int*>(sSc + 4 * BK * NS);  // stage s at sPos + s * BK
  int* sQp = sPos + 2 * BK;
  int* sTab = sQp + R;
  auto stage = [&](int s) {
    return Stage{sK + s * BK * SRB, sV + s * BK * SRB, sPos + s * BK, sSc + 2 * s * BK * NS,
                 sSc + (2 * s + 1) * BK * NS};
  };

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* q = static_cast<const T*>(c.q);
  for (int i = t; i < R * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int l = r / G, g = r % G;
    sQ[i] = d < c.dh ? to_f(q[(long long)b * c.sqb + (long long)l * c.sql +
                              (long long)(kvh * G + g) * c.dh + d])
                     : 0.f;
    sAcc[i] = 0.f;
  }
  for (int r = t; r < R; r += NT) {
    sM[r] = -INFINITY;  // a split that holds no key keeps m = -inf, l = 0
    sL[r] = 0.f;
    sQp[r] = c.q_pos[(long long)b * c.Lq + r / G];
  }
  int key_begin, key_end;
  src.range(sp, b, sTab, &key_begin, &key_end);
  __syncthreads();

  int k0 = src.next_tile(key_begin, key_begin, key_end, BK, sTab);
  if (k0 < key_end)
    src.template load_tile<DHP, BK>(stage(0), k0, key_begin, key_end, b, kvh, sTab);
  flash::cp_async_commit();
  for (int st = 0; k0 < key_end; st ^= 1) {
    const int k1 = src.next_tile(k0 + BK, key_begin, key_end, BK, sTab);
    if (k1 < key_end) {  // the next tile's copies run under this tile's arithmetic
      src.template load_tile<DHP, BK>(stage(st ^ 1), k1, key_begin, key_end, b, kvh, sTab);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const Stage cur = stage(st);

    // scores: (row, key) pairs; a warp reads 32 neighbouring K rows chunk by chunk
    for (int i = t; i < R * BK; i += NT) {
      const int r = i / BK, j = i % BK;
      const int kpos = cur.pos[j];
      float x = -INFINITY;  // no key: unmapped page or past the range
      if (kpos != NO_KEY) {
        const float dot = src.template dot<DHP>(sQ + r * DHP, cur, j);
        const int qp = sQp[r];
        bool live = kpos >= 0;
        if (c.causal) live = live && kpos <= qp;
        if (c.window > 0) live = live && qp - kpos < c.window;
        x = live ? dot * c.scale : NEG_INF;
      }
      sS[i] = x;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < R; r += NT / 32) {
      float a[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        a[u] = sS[r * BK + lane + 32 * u];
        mx = fmaxf(mx, a[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);  // finite: the tile holds a key
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(a[u] - m_new);
        sS[r * BK + lane + 32 * u] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = corr * sL[r] + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V: (row, dim pair) items
    for (int i = t; i < R * (DHP / 2); i += NT) {
      const int r = i / (DHP / 2), d = (i % (DHP / 2)) * 2;
      const float* pr = sS + r * BK;
      const float corr = sC[r];
      const auto pre = src.prep(d);
      float a0 = sAcc[r * DHP + d] * corr, a1 = sAcc[r * DHP + d + 1] * corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float2 vv = src.template pair<DHP>(cur, j, d, pre);
        a0 = fmaf(pr[j], vv.x, a0);
        a1 = fmaf(pr[j], vv.y, a1);
      }
      sAcc[r * DHP + d] = a0;
      sAcc[r * DHP + d + 1] = a1;
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
    k0 = k1;
  }
  flash::cp_async_wait<0>();

  // the split's partial (m, l, unnormalised acc) of each row
  const long long row0 = ((long long)(sp * c.B + b) * c.KV + kvh) * R;
  for (int i = t; i < R * c.dh; i += NT) {
    const int r = i / c.dh, d = i % c.dh;
    c.part_acc[(row0 + r) * c.dh + d] = sAcc[r * DHP + d];
  }
  for (int r = t; r < R; r += NT) {
    c.part_ml[(row0 + r) * 2] = sM[r];
    c.part_ml[(row0 + r) * 2 + 1] = sL[r];
  }
}

// o of one (kv head, slot) from its splits' partials, in split order
template <typename T>
__global__ void __launch_bounds__(NT)
merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
             T* __restrict__ o, int nsplit, int B, int Lq, int H, int KV, int dh, long long sob,
             long long sol) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, R = Lq * G;
  extern __shared__ float sW[];  // (nsplit, R) weights, then (R) denominators
  float* sDen = sW + nsplit * R;
  auto row = [&](int s, int r) { return ((long long)(s * B + b) * KV + kvh) * R + r; };
  for (int r = threadIdx.x; r < R; r += NT) {
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_ml[row(s, r) * 2]);
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      // no key in any split (M = -inf): every weight 0, o = 0
      const float w = M == -INFINITY ? 0.f : expf(part_ml[row(s, r) * 2] - M);
      sW[s * R + r] = w;
      L += w * part_ml[row(s, r) * 2 + 1];
    }
    sDen[r] = fmaxf(L, DENOM_FLOOR);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * dh; i += NT) {
    const int r = i / dh, d = i % dh;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc = fmaf(sW[s * R + r], part_acc[row(s, r) * dh + d], acc);
    const int l = r / G, g = r % G;
    o[(long long)b * sob + (long long)l * sol + (long long)(kvh * G + g) * dh + d] =
        from_f<T>(acc / sDen[r]);
  }
}

// the split kernel, then the merge, on one stream; a cudaError_t (0 = launched)
template <class Src, int DHP>
int launch(const Common& c, const Src& src, cudaStream_t stream) {
  using T = typename Src::Q;
  constexpr int RB = Src::template row_bytes<DHP>();
  const int R = c.Lq * (c.H / c.KV);
  const size_t smem = smem_bytes(RB + 16, tile_keys(RB), DHP, R, src.scales(), src.table_len());
  const size_t msmem = sizeof(float) * (size_t)(c.nsplit + 1) * R;
  if (smem > MAX_SMEM || msmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(split_kernel<Src, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<Src, DHP><<<dim3(c.nsplit, c.KV, c.B), NT, smem, stream>>>(c, src);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<T><<<dim3(c.KV, c.B), NT, msmem, stream>>>(c.part_acc, c.part_ml,
                                                          static_cast<T*>(c.o), c.nsplit, c.B,
                                                          c.Lq, c.H, c.KV, c.dh, c.sob, c.sol);
  return (int)cudaGetLastError();
}

// the compiled width: dh up to 32, 64, 128 or 256 (dims past dh are zero)
template <class Src>
int by_width(const Common& c, const Src& src, cudaStream_t s) {
  if (c.dh <= 32) return launch<Src, 32>(c, src, s);
  if (c.dh <= 64) return launch<Src, 64>(c, src, s);
  if (c.dh <= 128) return launch<Src, 128>(c, src, s);
  if (c.dh <= 256) return launch<Src, 256>(c, src, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_split
