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
// the TPU kernel, it averages V over the mapped pages.
//
// Design: K6's (csrc/flash_decode.cu). One thread block per (kv head,
// batch row); the Lq x G query rows that share the kv head are the rows of
// the block's little matrix (row l*G + g is query l, head g, with its own
// q_pos[b, l]), so GQA and the Lq > 1 speculative-verify rows read each K/V
// row once. The block walks the nb*ps logical keys in 64-key tiles, each
// key fetched through the block table straight from the pool as laid out
// in device memory, (n_pages, ps, KV, w), by strides: nothing is padded or
// transposed per call; each tile first resolves its 64 keys' row offsets
// into shared memory. Tiles without a mapped page are skipped; head dims
// beyond dh are masked on load (compiled widths 32/64/128/256). K8
// dequantises each element on load, int -> f32 -> x scale, the same f32
// arithmetic as its plain version (the dequantised K/V is never rounded to
// bf16); int4 bytes hold dim 2j in the low and 2j+1 in the high nibble,
// each sign-extended. The online softmax (m, l, corr) and the (rows, dh)
// accumulator live in shared memory, in f32. The score scale is an
// argument: the svd pool scores rank-r coefficients with the original head
// dim's dh^-1/2.
//
// Bound on the H100: bytes. A decode step reads the live pages of every
// slot once: at 8 slots x 17 pages of 64 tokens x 8 kv heads x 128 x bf16,
// K and V, that is ~35.6 MB, ~10.6 us at 3.35 TB/s (int8 pages about half
// of it plus the scales, int4 about a quarter). Like K6, this first
// version has one block per (slot, kv head) -- 64 blocks on 132 SMs -- and
// a load-then-compute loop without overlap, so it reaches only a fraction
// of that rate. Splitting the keys across blocks and pipelining the page
// loads are the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;
constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;
constexpr float DENOM_FLOOR = 1e-30f;
constexpr size_t MAX_SMEM = 232448;
enum { FP = 0, INT8 = 1, INT4 = 2 };

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

// One pool (K or V): pages and, for K8, their scales, with element strides
// of the page and in-page row axes (the kv-head and dh axes are contiguous).
struct Pool {
  const void* pages;
  const float* scale;
  long long s_page, s_off, ss_page, ss_off;
};

// Element d of one K/V row as f32: fp pages are read as they are; int8 and
// int4 pages are dequantised with the row's scale of d's group ``g``.
template <typename T, int MODE>
__device__ __forceinline__ float load_elem(const Pool& p, long long row, long long srow, int d,
                                           int g) {
  if constexpr (MODE == FP) {
    return to_f(((const T*)p.pages)[row + d]);
  } else {
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
  const int group = MODE == FP ? 1 : dh / ngr;

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
  for (int d = t; d < DHP; d += NT) sGrp[d] = MODE == FP ? 0 : min(d, dh - 1) / group;

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
        kx = load_elem<T, MODE>(kp, sRow[0][r], sRow[2][r], d, g);
        vx = load_elem<T, MODE>(vp, sRow[1][r], sRow[3][r], d, g);
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
  if (a.B < 1 || a.Lq < 1 || a.KV < 1 || a.H % a.KV != 0 || a.ps < 1 || a.nb < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_width<float, MODE>(a, s);
  if (dtype == 1) return by_width<__nv_bfloat16, MODE>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7. dtype: 0 = float32, 1 = bfloat16 (q, pages and output). Strides are
// in elements. Returns a cudaError_t (0 = launched).
extern "C" int flash_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                  const void* q_pos, const void* block_table,
                                  const void* page_pos, void* o, int B, int Lq, int H, int KV,
                                  int dh, int ps, int nb, long long sqb, long long sql,
                                  long long skp, long long sko, long long svp, long long svo,
                                  long long sbt, long long spp, long long sob, long long sol,
                                  int causal, int window, float scale, int dtype, void* stream) {
  Args a{q,
         Pool{k_pages, nullptr, skp, sko, 0, 0},
         Pool{v_pages, nullptr, svp, svo, 0, 0},
         q_pos,
         block_table,
         page_pos,
         o,
         B, Lq, H, KV, dh, ps, nb, 1,
         sqb, sql, sbt, spp, sob, sol,
         causal, window, scale};
  return by_dtype<FP>(a, dtype, (cudaStream_t)stream);
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
  if (ngr < 1 || dh % ngr != 0 || (bits == 4 && dh % 2 != 0)) return (int)cudaErrorInvalidValue;
  Args a{q,
         Pool{k_pages, (const float*)k_scale, skp, sko, sksp, skso},
         Pool{v_pages, (const float*)v_scale, svp, svo, svsp, svso},
         q_pos,
         block_table,
         page_pos,
         o,
         B, Lq, H, KV, dh, ps, nb, ngr,
         sqb, sql, sbt, spp, sob, sol,
         causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8) return by_dtype<INT8>(a, dtype, s);
  if (bits == 4) return by_dtype<INT4>(a, dtype, s);
  return (int)cudaErrorInvalidValue;
}
