// K3 on Hopper: FlashAttention-2 forward (causal / sliding window, GQA,
// global position offsets), in two routes chosen by dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_impl
// (body _fwd_kernel) and its offset variant (:313, scalar prefetch of
// (q_off, k_off)). Same function: o = softmax(scale * q k^T + mask) v per
// query head, the kv head of query head h being h // G, and the row
// statistic lse = m + log(l) that the backward recomputes probabilities
// from. Positions are global: query row i sits at q_off + i and key j at
// k_off + j (0, 0 outside ring context parallelism); keys past the local
// length L do not exist (-inf). NEG_INF = -1e30 stays finite for keys the
// causal or window mask removes and the denominator is floored at 1e-30,
// so a row whose first live tile is fully masked is erased by the first
// unmasked tile (corr = exp(-1e30 - m) = 0) instead of turning NaN, and a
// row that sees no key at all keeps lse <= NEG_INF / 2 with a finite o (an
// average of V over its live tiles), which is all the ring merge needs.
// The live kv tiles -- the counterpart of _tile_live -- are loop bounds,
// not per-tile tests (flash_common.cuh:live_tiles).
//
// Layout: q (B, L, H, dh), k/v (B, L, KV, dh), o like q, read and written
// in place through batch and row strides (head stride dh, dim stride 1);
// lse (B, H, L) f32. No padding in device memory: the ragged sequence edge
// and the head dims past dh are zero-filled on the way into shared memory.
//
// Bound on the H100: operations. At internlm2-1.8b's prefill shape
// (1, 1024, 16/8, 128) the causal half of the scores is ~4.3 GFLOP, 4.3 us
// at the bf16 tensor-core peak; at the training shape (4, 2048, 16/8, 128)
// ~69 GFLOP, 0.07 ms.
//
// bf16 route (entry flash_attention_fwd, the main path): FlashAttention-2's
// shape on mma.sync. One block of 8 warps covers 128 query rows of one
// head; each warp owns 16 rows, so its row max, row sum and (16, dh) output
// accumulator stay in its registers, and so do Q's A fragments (dh <= 128).
// S = Q K^T is mma.sync.m16n8k16 in bf16 with f32 accumulation, fragments
// loaded by ldmatrix; P is converted to bf16 in registers and the S
// accumulator layout is reused as the A fragment of P V, V's B fragment
// coming from ldmatrix.trans, so P never touches shared memory. K and V
// tiles (64 keys; 32 at dh 256, for registers) are staged as bf16 with
// cp.async, double-buffered, in rows padded by 16 bytes (8 rows of an
// ldmatrix hit 8 distinct bank groups).
// Head dims compile at 16, 32, 64, 80, 112, 128 and 256 (dh 120 runs at
// 128). Causal q tiles are issued heaviest first (the tile index is the
// slowest grid dimension, walked from the last tile). wgmma, TMA and warp
// specialisation are the next step.
// Departures from the TPU kernel, within chip_smoke.py's TOL_O 2e-2 and
// TOL_ROW 1e-2: P is rounded to bf16 before P V (the TPU keeps P in f32),
// and the softmax runs in base 2 (exp2 of log2(e)-scaled scores).
//
// f32 route (entry flash_attention_fwd_f32): the scalar kernel of the first
// port, kept for f32 inputs (the card-versus-CPU check in f32 and the f32
// tests). One block of 256 threads per 64-row query tile; each thread owns
// a 4 x 4 block of the 64 x 64 score tile and the same 4 rows of the output
// at 1/16 of the head dims, K/V staged in shared memory as f32. A bf16
// tensor never reaches it: the wrapper picks the route by dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using flash::DENOM_FLOOR;
using flash::NEG_INF;
typedef __nv_bfloat16 bf16;

// One call's operands (strides in elements); vec: rows move as 16-byte chunks
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, L, H, KV, dh;
  long long sqb, sql, skb, skl, svb, svl, sob, sol;
  int causal, window, q_off, k_off;
  float scale;
  int vec;
};

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

// 8 warps of 16 query rows and two copy stages (measured on the H100
// against 4 warps and 3-4 stages)
constexpr int NW = 8;
constexpr int BQ = 16 * NW;  // query rows per block
constexpr int NT = 32 * NW;
constexpr int STAGES = 2;
constexpr float LN2 = 0.6931471805599453f;
using flash::acc_as_a;
using flash::frag_a;
using flash::frag_b;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::LOG2E;
using flash::mma16816;

template <int DHP, int BK>
constexpr size_t smem_bytes() {
  // sQ (BQ rows), sK and sV (STAGES x BK rows each), rows of DHP + 8 bf16
  return sizeof(bf16) * (size_t)(BQ + 2 * STAGES * BK) * (DHP + 8);
}

// BK: keys per tile, 64, or 32 at dh 256 (for registers)
template <int DHP, int BK>
__global__ void __launch_bounds__(NT)
fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int L,
               int H, int KV, int dh, long long sqb, long long sql, long long skb, long long skl,
               long long svb, long long svl, long long sob, long long sol, int causal, int window,
               int q_off, int k_off, float scale_log2, int vec) {
  constexpr bool QREG = DHP <= 128;  // Q's A fragments in registers (dh 256: too many)
  constexpr int SR = DHP + 8;
  constexpr int KS = DHP / 16;  // k-steps of Q K^T
  constexpr int NS = BK / 8;    // n-tiles of a warp's (16, BK) score tile
  constexpr int ND = DHP / 8;   // n-tiles of its (16, DHP) output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * SR;  // stage s at sK + s * BK * SR
  bf16* sV = sK + STAGES * BK * SR;

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q0 = iq * BQ;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragment's row group and column pair

  const bf16* qb = q + (long long)b * sqb + (long long)h * dh;
  const bf16* kb = k + (long long)b * skb + (long long)kvh * dh;
  const bf16* vb = v + (long long)b * svb + (long long)kvh * dh;

  int kt_begin, kt_end;
  flash::live_tiles(q0, min(L, q0 + BQ) - 1, L, BK, causal, window, q_off - k_off, &kt_begin,
                    &kt_end);

  // Q and the first STAGES - 1 live tiles, one copy group per tile (Q
  // joins the first); every loop turn commits one group, maybe empty
  flash::load_tile<NT, BQ, DHP>(sQ, qb, sql, q0, L, dh, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_begin + i < kt_end) {
      flash::load_tile<NT, BK, DHP>(sK + i * BK * SR, kb, skl, (kt_begin + i) * BK, L, dh, vec);
      flash::load_tile<NT, BK, DHP>(sV + i * BK * SR, vb, svl, (kt_begin + i) * BK, L, dh, vec);
    }
    flash::cp_async_commit();
  }

  // this thread's rows: row0 + g (hr = 0) and row0 + g + 8 (hr = 1)
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  uint32_t qf[QREG ? KS : 1][4];    // Q's A fragments, when held in registers

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin;
    const int nxt = kt + STAGES - 1;  // refill the stage the last turn read
    if (nxt < kt_end) {
      const int ns = (it + STAGES - 1) % STAGES;
      flash::load_tile<NT, BK, DHP>(sK + ns * BK * SR, kb, skl, nxt * BK, L, dh, vec);
      flash::load_tile<NT, BK, DHP>(sV + ns * BK * SR, vb, svl, nxt * BK, L, dh, vec);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<STAGES - 1>();  // this tile's group (and Q) has landed
    __syncthreads();
    const bf16* cK = sK + (it % STAGES) * BK * SR;
    const bf16* cV = sV + (it % STAGES) * BK * SR;
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], frag_a(sQ, SR, row0, ks * 16, lane));
      }
    }

    // S = Q K^T: A from Q (16 x 16 per k-step), B from K's rows (keys)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {
        ldsm_x4(qa, frag_a(sQ, SR, row0, ks * 16, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kf[4];
        ldsm_x4(kf, frag_b(cK, SR, n2 * 16, ks * 16, lane));
        mma16816(s[2 * n2], qa, kf[0], kf[1]);
        mma16816(s[2 * n2 + 1], qa, kf[2], kf[3]);
      }
    }

    // scale into log2 units and mask; only tiles on an edge need the tests
    const int k0 = kt * BK;
    const bool edge = k0 + BK > L || (causal && k_off + k0 + BK - 1 > q_off + q0) ||
                      (window > 0 && q_off + q0 + BQ - 1 - (k_off + k0) >= window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kl = k0 + j * 8 + tg * 2 + (e & 1), kp = k_off + kl;
          const int qp = q_off + q0 + row0 + g + (e >> 1) * 8;
          if (kl >= L)
            x = -INFINITY;  // past the sequence: no key at all
          else if ((causal && kp > qp) || (window > 0 && qp - kp >= window))
            x = NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax per row; a row's BK scores live in the 4 lanes of a group
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f(s[j][2 * hr] - m_new), p1 = exp2f(s[j][2 * hr + 1] - m_new);
        s[j][2 * hr] = p0;
        s[j][2 * hr + 1] = p1;
        ps += p0 + p1;
      }
      l[hr] = l[hr] * corr + ps;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * hr] *= corr;
        acc[j][2 * hr + 1] *= corr;
      }
    }

    // O += P V: the S accumulators of two n-tiles are P's A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int d2 = 0; d2 < DHP / 16; ++d2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, frag_a(cV, SR, kk * 16, d2 * 16, lane));
        mma16816(acc[2 * d2], a, vf[0], vf[1]);
        mma16816(acc[2 * d2 + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  flash::cp_async_wait<0>();  // no copy left in flight (a block without live tiles)

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int ql = q0 + row0 + g + hr * 8;
    if (ql >= L) continue;
    const float den = fmaxf(sum, DENOM_FLOOR);
    bf16* orow = o + (long long)b * sob + (long long)ql * sol + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + tg * 2;
      if (d < dh) orow[d] = __float2bfloat16(acc[j][2 * hr] / den);
      if (d + 1 < dh) orow[d + 1] = __float2bfloat16(acc[j][2 * hr + 1] / den);
    }
    if (tg == 0) lse[((long long)b * H + h) * L + ql] = m[hr] * LN2 + logf(den);
  }
}

template <int DHP>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BK = DHP > 128 ? 32 : 64;
  constexpr size_t smem = smem_bytes<DHP, BK>();
  auto kernel = fwd_kernel_mma<DHP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, a.B, (a.L + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, (float*)a.lse, a.L, a.H,
      a.KV, a.dh, a.sqb, a.sql, a.skb, a.skl, a.svb, a.svl, a.sob, a.sol, a.causal, a.window,
      a.q_off, a.k_off, a.scale * LOG2E, a.vec);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 16) return launch<16>(a, s);
  if (a.dh <= 32) return launch<32>(a, s);
  if (a.dh <= 64) return launch<64>(a, s);
  if (a.dh <= 80) return launch<80>(a, s);
  if (a.dh <= 112) return launch<112>(a, s);
  if (a.dh <= 128) return launch<128>(a, s);
  if (a.dh <= 256) return launch<256>(a, s);
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

template <int DHP>
constexpr size_t smem_bytes() {
  // sQ, sK: (64, DHP + 1); sV: (64, DHP); sP: (64, 65) -- all f32
  return sizeof(float) * (size_t)(BQ * (DHP + 1) + BK * (DHP + 1) + BK * DHP + BQ * (BK + 1));
}

template <int DHP>
__global__ void __launch_bounds__(NT)
fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int L, int H, int KV, int dh, long long sqb, long long sql, long long skb,
               long long skl, long long svb, long long svl, long long sob, long long sol,
               int causal, int window, int q_off, int k_off, float scale) {
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

  const float* qb = q + (long long)b * sqb + (long long)h * dh;
  const float* kb = k + (long long)b * skb + (long long)kvh * dh;
  const float* vb = v + (long long)b * svb + (long long)kvh * dh;

  for (int i = t; i < BQ * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP, l = q0 + r;
    sQ[r * QS + d] = (l < L && d < dh) ? qb[(long long)l * sql + d] : 0.f;
  }

  float m[4], lsum[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int kt_begin, kt_end;
  flash::live_tiles(q0, min(L, q0 + BQ) - 1, L, BK, causal, window, q_off - k_off, &kt_begin,
                    &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    for (int i = t; i < BK * DHP; i += NT) {
      const int r = i / DHP, d = i % DHP, l = k0 + r;
      const bool in = l < L && d < dh;
      sK[r * QS + d] = in ? kb[(long long)l * skl + d] : 0.f;
      sV[r * DHP + d] = in ? vb[(long long)l * svl + d] : 0.f;
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
      const int qp = q_off + q0 + 4 * rg + i;  // global positions
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = k0 + cg + 16 * j, kp = k_off + kl;
        float x = s[i][j] * scale;
        if (kl >= L)
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
    float* orow = o + (long long)b * sob + (long long)l * sol + (long long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < dh) orow[d] = acc[i][j] / den;
    }
    if (cg == 0) lse[((long long)b * H + h) * L + l] = m[i] + logf(den);
  }
}

template <int DHP>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel_f32<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  fwd_kernel_f32<DHP><<<grid, NT, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o, (float*)a.lse, a.L,
      a.H, a.KV, a.dh, a.sqb, a.sql, a.skb, a.skl, a.svb, a.svl, a.sob, a.sol, a.causal, a.window,
      a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 32) return launch<32>(a, s);
  if (a.dh <= 64) return launch<64>(a, s);
  if (a.dh <= 128) return launch<128>(a, s);
  if (a.dh <= 256) return launch<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32

}  // namespace

// K3, bf16 route (tensor cores): q, k, v, o bf16; lse f32. Strides are in
// elements. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   int B, int L, int H, int KV, int dh, long long sqb,
                                   long long sql, long long skb, long long skl, long long svb,
                                   long long svl, long long sob, long long sol, int causal,
                                   int window, int q_off, int k_off, float scale, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int vec = dh % 8 == 0 && flash::aligned16(q, 2, {sqb, sql}) &&
                  flash::aligned16(k, 2, {skb, skl}) && flash::aligned16(v, 2, {svb, svl});
  const Args a{q,   k,   v,   o,   lse, B,   L,      H,      KV,    dh,    sqb,   sql,
               skb, skl, svb, svl, sob, sol, causal, window, q_off, k_off, scale, vec};
  return tc::dispatch(a, (cudaStream_t)stream);
}

// K3, f32 route (scalar): q, k, v, o, lse f32. Returns a cudaError_t.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int L, int H, int KV, int dh,
                                       long long sqb, long long sql, long long skb,
                                       long long skl, long long svb, long long svl,
                                       long long sob, long long sol, int causal, int window,
                                       int q_off, int k_off, float scale, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   lse, B,   L,      H,      KV,    dh,    sqb,   sql,
               skb, skl, svb, svl, sob, sol, causal, window, q_off, k_off, scale, 0};
  return f32::dispatch(a, (cudaStream_t)stream);
}
