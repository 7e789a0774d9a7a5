// K7 and K8 on Hopper: flash decode through a paged KV pool, with fp pages
// (K7) or int8 / int4 pages and f32 absmax scales (K8).
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
// flash_paged_decode_kernel (body _paged_decode_kernel) and
// flash_paged_decode_quant_kernel (bodies _quant_paged_decode_kernel and
// _dequant_tile). Logical key j of batch row b lives in physical page
// block_table[b, j / ps] at row j % ps; a table entry of -1 is an unmapped
// page, skipped whole (never read through). Inside a mapped page the mask
// comes from page_pos: key j is visible to query row l iff its position p
// is >= 0, p <= q_pos[b, l] (causal) and q_pos[b, l] - p < window. Masked
// scores get the finite NEG_INF = -1e30 and the denominator is floored at
// 1e-30, as on the TPU, so a fully masked (parked) row stays finite: like
// the TPU kernel, it averages V over the mapped pages. The Lq x G query
// rows that share a kv head are the rows of one block's little matrix (row
// l*G + g is query l, head g, with its own q_pos[b, l]), so GQA and the
// Lq > 1 speculative-verify rows read each K/V row once. Pools are read in
// place, (n_pages, ps, KV, w), by strides: nothing is padded or transposed
// per call; head dims beyond dh are zero on the way into shared memory.
//
// Bound on the H100: bytes. A decode step reads the live pages of every
// slot once: at 8 slots x 17 pages of 64 tokens x 8 kv heads x 128 x bf16,
// K and V, that is ~35 MB, ~10.4 us at 3.35 TB/s (int8 pages about half of
// it plus the scales, int4 about a quarter).
//
// K7 (flash_paged_decode) is split over the keys. Its grid is (split, kv
// head, slot); split s covers the block-table entries [s * pps, (s + 1) *
// pps), a contiguous, page-aligned range, and the split count comes from
// the shapes alone (the wrapper: B, KV, nb and the SM count, for at least
// two blocks per SM), never from the table's contents. A block resolves
// its range's pages once into shared memory, walks the range in tiles of
// 64 keys (32 where a row is wider than 256 bytes) that hold a mapped page,
// and stages each tile's K and V rows with 16-byte cp.async copies,
// double-buffered so that the next tile's copies run under this tile's
// arithmetic. It keeps the online softmax (m, l) and the (rows, dh)
// accumulator of its rows in f32 and writes them, unnormalised, to scratch
// the wrapper allocates. A second small kernel merges the splits in split
// order with the max-merge of ring_attention.py:133 (weights exp(m_s - M),
// a split without a mapped page has m = -inf and l = 0 and so weight 0)
// and writes o in the output dtype. No atomics: two launches on the same
// inputs give the same bits. The two launches count as one K7 launch.
//
// K8 (flash_paged_decode_quant) keeps its first design: one block per
// (kv head, slot) walks the nb*ps logical keys in 64-key tiles, each key
// fetched through the block table; each tile first resolves its 64 keys'
// row offsets into shared memory, tiles without a mapped page are skipped,
// and each element is dequantised on load, int -> f32 -> x scale, the same
// f32 arithmetic as its plain version (the dequantised K/V is never rounded
// to bf16); int4 bytes hold dim 2j in the low and 2j+1 in the high nibble,
// each sign-extended. Its online softmax (m, l, corr) and (rows, dh)
// accumulator live in shared memory, in f32. 64 blocks on 132 SMs and a
// load-then-compute loop: K7's split is its next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::DENOM_FLOOR;
using flash::NEG_INF;

constexpr int NT = 128;
constexpr size_t MAX_SMEM = 232448;

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

// ---------------------------------------------------------------------------
// K7: split over the keys, then merged
// ---------------------------------------------------------------------------
namespace split {

constexpr int NO_KEY = INT_MIN;  // sPos of a key on an unmapped page or past the range

// keys per tile: 64, or 32 where a row (DHP elements of T) is wider than 256 bytes
template <typename T, int DHP>
__host__ __device__ constexpr int tile_keys() {
  return DHP * (int)sizeof(T) <= 256 ? 64 : 32;
}

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

template <typename T, int DHP>
size_t smem_bytes(int R, int pps) {
  constexpr int BK = tile_keys<T, DHP>();
  constexpr int SR = DHP + 16 / (int)sizeof(T);
  // sK, sV: 2 stages x (BK, SR) T; sQ, sAcc (R, DHP), sS (R, BK), sM, sL,
  // sC (R) f32; sPos (2, BK), sQp (R), sTab (pps) int
  return sizeof(T) * (size_t)4 * BK * SR +
         sizeof(float) * ((size_t)2 * R * DHP + (size_t)R * BK + 3 * (size_t)R) +
         sizeof(int) * ((size_t)2 * BK + R + pps);
}

// the first tile start >= k0 (stepping by bk from the range's start) whose
// keys touch a mapped page of the range, or key_end
__device__ __forceinline__ int next_tile(const int* sTab, int k0, int key_begin, int key_end,
                                         int ps, int bk) {
  for (; k0 < key_end; k0 += bk) {
    const int last = min(k0 + bk, key_end) - 1;
    for (int e = (k0 - key_begin) / ps; e <= (last - key_begin) / ps; ++e)
      if (sTab[e] >= 0) return k0;
  }
  return key_end;
}

struct Pools {
  const void *k, *v;
  long long skp, sko, svp, svo;  // element strides of the page and in-page row axes
};

// K and V rows of the tile at k0 into one stage (rows of SR elements, zero
// where there is no key or past w), and each key's position (NO_KEY where
// there is no key)
template <typename T, int DHP, int BK>
__device__ __forceinline__ void load_tile(T* sK, T* sV, int* sPos, const Pools& pl,
                                          const int* sTab, const int* __restrict__ ppos,
                                          long long spp, int k0, int key_begin, int key_end,
                                          int ps, int w, int kvh, bool vec) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int SR = DHP + EPC;
  constexpr int CH = DHP / EPC;
  const T* kp = (const T*)pl.k;
  const T* vp = (const T*)pl.v;
  for (int i = threadIdx.x; i < BK * CH; i += NT) {
    const int r = i / CH, d = (i % CH) * EPC, key = k0 + r;
    const int page = key < key_end ? sTab[(key - key_begin) / ps] : -1;
    const long long off = key % ps;
    const bool in = page >= 0 && d < w;
    const long long ko = page * pl.skp + off * pl.sko + (long long)kvh * w + d;
    const long long vo = page * pl.svp + off * pl.svo + (long long)kvh * w + d;
    T* dk = sK + r * SR + d;
    T* dv = sV + r * SR + d;
    if (vec) {
      flash::cp_async16(dk, in ? kp + ko : kp, in ? 16 : 0);
      flash::cp_async16(dv, in ? vp + vo : vp, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const bool ok = in && d + e < w;
        dk[e] = ok ? kp[ko + e] : from_f<T>(0.f);
        dv[e] = ok ? vp[vo + e] : from_f<T>(0.f);
      }
    }
  }
  for (int r = threadIdx.x; r < BK; r += NT) {
    const int key = k0 + r;
    const int page = key < key_end ? sTab[(key - key_begin) / ps] : -1;
    sPos[r] = page >= 0 ? ppos[(long long)page * spp + key % ps] : NO_KEY;
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const T* __restrict__ q, Pools pl, const int* __restrict__ q_pos,
                          const int* __restrict__ bt, const int* __restrict__ ppos,
                          float* __restrict__ part_acc, float* __restrict__ part_ml, int B,
                          int Lq, int H, int KV, int dh, int ps, int nb, int pps, long long sqb,
                          long long sql, long long sbt, long long spp, int causal, int window,
                          float scale, int vec) {
  constexpr int BK = tile_keys<T, DHP>();
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int SR = DHP + EPC;  // a 16-byte pad: 8 neighbouring rows hit 8 bank groups
  constexpr int CH = DHP / EPC;
  const int G = H / KV, R = Lq * G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // stage s at sK + s * BK * SR
  T* sV = sK + 2 * BK * SR;
  float* sQ = reinterpret_cast<float*>(sV + 2 * BK * SR);
  float* sAcc = sQ + R * DHP;
  float* sS = sAcc + R * DHP;
  float* sM = sS + R * BK;
  float* sL = sM + R;
  float* sC = sL + R;
  int* sPos = reinterpret_cast<int*>(sC + R);  // stage s at sPos + s * BK
  int* sQp = sPos + 2 * BK;
  int* sTab = sQp + R;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int e_begin = sp * pps, e_end = min(nb, e_begin + pps);
  const int key_begin = e_begin * ps, key_end = e_end * ps;

  for (int i = t; i < R * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int l = r / G, g = r % G;
    sQ[i] = d < dh ? to_f(q[(long long)b * sqb + (long long)l * sql +
                            (long long)(kvh * G + g) * dh + d])
                   : 0.f;
    sAcc[i] = 0.f;
  }
  for (int r = t; r < R; r += NT) {
    sM[r] = -INFINITY;  // a split that sees no mapped page keeps m = -inf, l = 0
    sL[r] = 0.f;
    sQp[r] = q_pos[(long long)b * Lq + r / G];
  }
  for (int e = t; e < e_end - e_begin; e += NT) sTab[e] = bt[(long long)b * sbt + e_begin + e];
  __syncthreads();

  int k0 = next_tile(sTab, key_begin, key_begin, key_end, ps, BK);
  if (k0 < key_end)
    load_tile<T, DHP, BK>(sK, sV, sPos, pl, sTab, ppos, spp, k0, key_begin, key_end, ps, dh, kvh,
                          vec);
  flash::cp_async_commit();
  for (int st = 0; k0 < key_end; st ^= 1) {
    const int k1 = next_tile(sTab, k0 + BK, key_begin, key_end, ps, BK);
    if (k1 < key_end) {  // the next tile's copies run under this tile's arithmetic
      load_tile<T, DHP, BK>(sK + (st ^ 1) * BK * SR, sV + (st ^ 1) * BK * SR, sPos + (st ^ 1) * BK,
                            pl, sTab, ppos, spp, k1, key_begin, key_end, ps, dh, kvh, vec);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + st * BK * SR;
    const T* cV = sV + st * BK * SR;
    const int* cPos = sPos + st * BK;

    // scores: (row, key) pairs; a warp reads 32 neighbouring K rows chunk by chunk
    for (int i = t; i < R * BK; i += NT) {
      const int r = i / BK, j = i % BK;
      const int kpos = cPos[j];
      float x = -INFINITY;  // no key: unmapped page or past the range
      if (kpos != NO_KEY) {
        const float* qr = sQ + r * DHP;
        const T* kr = cK + j * SR;
        float dot = 0.f;
#pragma unroll 4
        for (int c = 0; c < CH; ++c) {
          float kf[EPC];
          chunk_f32(kr + c * EPC, kf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(qr[c * EPC + e], kf[e], dot);
        }
        const int qp = sQp[r];
        bool live = kpos >= 0;
        if (causal) live = live && kpos <= qp;
        if (window > 0) live = live && qp - kpos < window;
        x = live ? dot * scale : NEG_INF;
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
      const float m_new = fmaxf(m_prev, mx);  // finite: the tile holds a mapped key
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
      float a0 = sAcc[r * DHP + d] * corr, a1 = sAcc[r * DHP + d + 1] * corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float2 vv = pair_f32(cV + j * SR + d);
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
  const long long row0 = ((long long)(sp * B + b) * KV + kvh) * R;
  for (int i = t; i < R * dh; i += NT) {
    const int r = i / dh, d = i % dh;
    part_acc[(row0 + r) * dh + d] = sAcc[r * DHP + d];
  }
  for (int r = t; r < R; r += NT) {
    part_ml[(row0 + r) * 2] = sM[r];
    part_ml[(row0 + r) * 2 + 1] = sL[r];
  }
}

// o of one (kv head, slot) from its splits' partials, in split order:
// o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max_s m_s)
template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          T* __restrict__ o, int nsplit, int B, int Lq, int H, int KV, int dh,
                          long long sob, long long sol) {
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
      // no mapped page anywhere (M = -inf): every weight 0, o = 0
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

struct Args {
  const void* q;
  Pools pl;
  const void *q_pos, *bt, *ppos;
  void *o, *part_acc, *part_ml;
  int B, Lq, H, KV, dh, ps, nb, nsplit, pps;
  long long sqb, sql, sbt, spp, sob, sol;
  int causal, window;
  float scale;
  int vec;
};

template <typename T, int DHP>
int launch(const Args& a, cudaStream_t stream) {
  const int R = a.Lq * (a.H / a.KV);
  const size_t smem = smem_bytes<T, DHP>(R, a.pps);
  const size_t msmem = sizeof(float) * (size_t)(a.nsplit + 1) * R;
  if (smem > MAX_SMEM || msmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_split_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<T, DHP><<<dim3(a.nsplit, a.KV, a.B), NT, smem, stream>>>(
      (const T*)a.q, a.pl, (const int*)a.q_pos, (const int*)a.bt, (const int*)a.ppos,
      (float*)a.part_acc, (float*)a.part_ml, a.B, a.Lq, a.H, a.KV, a.dh, a.ps, a.nb, a.pps, a.sqb,
      a.sql, a.sbt, a.spp, a.causal, a.window, a.scale, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<T><<<dim3(a.KV, a.B), NT, msmem, stream>>>(
      (const float*)a.part_acc, (const float*)a.part_ml, (T*)a.o, a.nsplit, a.B, a.Lq, a.H, a.KV,
      a.dh, a.sob, a.sol);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<T, 32>(a, s);
  if (a.dh <= 64) return launch<T, 64>(a, s);
  if (a.dh <= 128) return launch<T, 128>(a, s);
  if (a.dh <= 256) return launch<T, 256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

// ---------------------------------------------------------------------------
// K8: one block per (kv head, slot), dequantised on load
// ---------------------------------------------------------------------------
namespace quant {

constexpr int BK = 64;
enum { INT8 = 1, INT4 = 2 };

// One pool (K or V): int pages and their f32 scales, with element strides
// of the page and in-page row axes (the kv-head and dh axes are contiguous).
struct Pool {
  const void* pages;
  const float* scale;
  long long s_page, s_off, ss_page, ss_off;
};

// Element d of one K/V row as f32, dequantised with the row's scale of
// d's group ``g``.
template <int MODE>
__device__ __forceinline__ float load_elem(const Pool& p, long long row, long long srow, int d,
                                           int g) {
  const int8_t* pg = (const int8_t*)p.pages;
  int x;
  if constexpr (MODE == INT8) {
    x = pg[row + d];
  } else {
    const int b = pg[row + (d >> 1)];
    x = (d & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
  }
  return (float)x * p.scale[srow + g];
}

template <int DHP>
size_t smem_bytes(int R) {
  // sQ (R, DHP), sAcc (R, DHP), sK (BK, DHP+1), sV (BK, DHP), sS (R, BK),
  // sM/sL/sC (R) -- f32; sPos, sPage (BK), sQpos (R) -- int
  return sizeof(float) * ((size_t)2 * R * DHP + BK * (DHP + 1) + BK * DHP + (size_t)R * BK +
                          3 * (size_t)R) +
         sizeof(int) * (2 * BK + (size_t)R);
}

template <typename T, int MODE, int DHP>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, Pool kp, Pool vp, const int* __restrict__ q_pos,
                    const int* __restrict__ bt, const int* __restrict__ ppos, T* __restrict__ o,
                    int Lq, int H, int KV, int dh, int ps, int nb, int ngr, long long sqb,
                    long long sql, long long sbt, long long spp, long long sob, long long sol,
                    int causal, int window, float scale) {
  constexpr int KS = DHP + 1;
  const int G = H / KV;
  const int R = Lq * G;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sAcc = sQ + R * DHP;
  float* sK = sAcc + R * DHP;
  float* sV = sK + BK * KS;
  float* sS = sV + BK * DHP;
  float* sM = sS + R * BK;
  float* sL = sM + R;
  float* sC = sL + R;
  int* sPos = (int*)(sC + R);
  int* sPage = sPos + BK;
  int* sQp = sPage + BK;
  // per key of the tile: element offsets of its K/V row and scale row
  __shared__ long long sRow[4][BK];
  __shared__ int sGrp[DHP];  // scale group of each head-dim element

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int* btb = bt + (long long)b * sbt;
  const int nkeys = nb * ps;
  const int w = MODE == INT4 ? dh / 2 : dh;  // stored width of a K/V row
  const int group = dh / ngr;

  for (int i = t; i < R * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int l = r / G, g = r % G;
    sQ[i] = d < dh ? to_f(q[(long long)b * sqb + (long long)l * sql +
                            (long long)(kvh * G + g) * dh + d])
                   : 0.f;
    sAcc[i] = 0.f;
  }
  for (int r = t; r < R; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
    sQp[r] = q_pos[(long long)b * Lq + r / G];
  }
  for (int d = t; d < DHP; d += NT) sGrp[d] = min(d, dh - 1) / group;

  for (int s0 = 0; s0 < nkeys; s0 += BK) {
    int page = -1;
    if (t < BK && s0 + t < nkeys) page = btb[(s0 + t) / ps];
    // also the barrier that retires the previous tile (and the init)
    if (!__syncthreads_or(page >= 0)) continue;  // no mapped page in the tile
    if (t < BK) {
      const long long off = (s0 + t) % ps;
      sPage[t] = page;
      sPos[t] = page >= 0 ? ppos[(long long)page * spp + off] : -1;
      sRow[0][t] = page * kp.s_page + off * kp.s_off + (long long)kvh * w;
      sRow[1][t] = page * vp.s_page + off * vp.s_off + (long long)kvh * w;
      sRow[2][t] = page * kp.ss_page + off * kp.ss_off + (long long)kvh * ngr;
      sRow[3][t] = page * vp.ss_page + off * vp.ss_off + (long long)kvh * ngr;
    }
    __syncthreads();
    for (int i = t; i < BK * DHP; i += NT) {
      const int r = i / DHP, d = i % DHP;
      float kx = 0.f, vx = 0.f;
      if (sPage[r] >= 0 && d < dh) {
        const int g = sGrp[d];
        kx = load_elem<MODE>(kp, sRow[0][r], sRow[2][r], d, g);
        vx = load_elem<MODE>(vp, sRow[1][r], sRow[3][r], d, g);
      }
      sK[r * KS + d] = kx;
      sV[r * DHP + d] = vx;
    }
    __syncthreads();

    for (int i = t; i < R * BK; i += NT) {
      const int r = i / BK, j = i % BK;
      float x;
      if (sPage[j] < 0) {
        x = -INFINITY;  // unmapped page (or past the table): no key at all
      } else {
        const float* qr = sQ + r * DHP;
        const float* kr = sK + j * KS;
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int sp = sPos[j], qp = sQp[r];
        bool live = sp >= 0;
        if (causal) live = live && sp <= qp;
        if (window > 0) live = live && qp - sp < window;
        x = live ? dot * scale : NEG_INF;
      }
      sS[i] = x;
    }
    __syncthreads();

    // online softmax: one warp per row, two scores per lane
    for (int r = warp; r < R; r += NT / 32) {
      const float a0 = sS[r * BK + lane], a1 = sS[r * BK + lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      sS[r * BK + lane] = p0;
      sS[r * BK + lane + 32] = p1;
      float psum = p0 + p1;
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

    for (int i = t; i < R * DHP; i += NT) {
      const int r = i / DHP, d = i % DHP;
      const float* pr = sS + r * BK;
      float a = sAcc[i] * sC[r];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) a = fmaf(pr[j], sV[j * DHP + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = t; i < R * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int l = r / G, g = r % G;
    if (d < dh)
      o[(long long)b * sob + (long long)l * sol + (long long)(kvh * G + g) * dh + d] =
          from_f<T>(sAcc[i] / fmaxf(sL[r], DENOM_FLOOR));
  }
}

struct Args {
  const void* q;
  Pool kp, vp;
  const void *q_pos, *bt, *ppos;
  void* o;
  int B, Lq, H, KV, dh, ps, nb, ngr;
  long long sqb, sql, sbt, spp, sob, sol;
  int causal, window;
  float scale;
};

template <typename T, int MODE, int DHP>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DHP>(a.Lq * (a.H / a.KV));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, MODE, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KV, a.B);
  paged_decode_kernel<T, MODE, DHP><<<grid, NT, smem, stream>>>(
      (const T*)a.q, a.kp, a.vp, (const int*)a.q_pos, (const int*)a.bt, (const int*)a.ppos,
      (T*)a.o, a.Lq, a.H, a.KV, a.dh, a.ps, a.nb, a.ngr, a.sqb, a.sql, a.sbt, a.spp, a.sob, a.sol,
      a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int by_width(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<T, MODE, 32>(a, s);
  if (a.dh <= 64) return launch<T, MODE, 64>(a, s);
  if (a.dh <= 128) return launch<T, MODE, 128>(a, s);
  if (a.dh <= 256) return launch<T, MODE, 256>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int by_dtype(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return by_width<float, MODE>(a, s);
  if (dtype == 1) return by_width<__nv_bfloat16, MODE>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace quant

bool bad_shape(int B, int Lq, int H, int KV, int ps, int nb) {
  return B < 1 || Lq < 1 || KV < 1 || H % KV != 0 || ps < 1 || nb < 1;
}

}  // namespace

// K7. dtype: 0 = float32, 1 = bfloat16 (q, pages and output). Strides are
// in elements. part_acc (nsplit, B, KV, Lq*G, dh) and part_ml (nsplit, B,
// KV, Lq*G, 2) f32 are the wrapper's scratch; split s covers block-table
// entries [s * pps, (s + 1) * pps). Returns a cudaError_t (0 = launched).
extern "C" int flash_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* q_pos, const void* block_table,
                                  const void* page_pos, void* o, void* part_acc, void* part_ml,
                                  int B, int Lq, int H, int KV, int dh, int ps, int nb,
                                  int nsplit, int pps, long long sqb, long long sql,
                                  long long skp, long long sko, long long svp, long long svo,
                                  long long sbt, long long spp, long long sob, long long sol,
                                  int causal, int window, float scale, int dtype, void* stream) {
  if (bad_shape(B, Lq, H, KV, ps, nb) || pps < 1 || nsplit != (nb + pps - 1) / pps)
    return (int)cudaErrorInvalidValue;
  const long long eb = dtype == 0 ? 4 : 2;
  const int vec = (dh * eb) % 16 == 0 && flash::aligned16(k_pages, eb, {skp, sko}) &&
                  flash::aligned16(v_pages, eb, {svp, svo});
  const split::Args a{q,
                      split::Pools{k_pages, v_pages, skp, sko, svp, svo},
                      q_pos,
                      block_table,
                      page_pos,
                      o,
                      part_acc,
                      part_ml,
                      B, Lq, H, KV, dh, ps, nb, nsplit, pps,
                      sqb, sql, sbt, spp, sob, sol,
                      causal, window, scale, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return split::by_width<float>(a, s);
  if (dtype == 1) return split::by_width<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// K8. bits: 8 (pages (n_pages, ps, KV, dh) int8) or 4 (pages (..., dh/2),
// two nibbles a byte); scales (n_pages, ps, KV, ngr) f32. dtype as K7's
// (q and output). Returns a cudaError_t (0 = launched).
extern "C" int flash_paged_decode_quant(const void* q, const void* k_pages, const void* v_pages,
                                        const void* k_scale, const void* v_scale,
                                        const void* q_pos, const void* block_table,
                                        const void* page_pos, void* o, int B, int Lq, int H,
                                        int KV, int dh, int ps, int nb, int ngr, int bits,
                                        long long sqb, long long sql, long long skp, long long sko,
                                        long long svp, long long svo, long long sksp,
                                        long long skso, long long svsp, long long svso,
                                        long long sbt, long long spp, long long sob, long long sol,
                                        int causal, int window, float scale, int dtype,
                                        void* stream) {
  if (bad_shape(B, Lq, H, KV, ps, nb) || ngr < 1 || dh % ngr != 0 ||
      (bits == 4 && dh % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const quant::Args a{q,
                      quant::Pool{k_pages, (const float*)k_scale, skp, sko, sksp, skso},
                      quant::Pool{v_pages, (const float*)v_scale, svp, svo, svsp, svso},
                      q_pos,
                      block_table,
                      page_pos,
                      o,
                      B, Lq, H, KV, dh, ps, nb, ngr,
                      sqb, sql, sbt, spp, sob, sol,
                      causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8) return quant::by_dtype<quant::INT8>(a, dtype, s);
  if (bits == 4) return quant::by_dtype<quant::INT4>(a, dtype, s);
  return (int)cudaErrorInvalidValue;
}
