// K1 on Hopper: the PAMM compress core, csim arg-max (paper Alg. 1, lines 6-11).
//
// Replaces the TPU kernel src/repro/kernels/pamm_compress.py:csim_argmax
// (body _kernel). Same function: for each row x_i of x (b, n) and the k
// generator rows c_j (k, n), the signed cosine similarity at
// argmax_j |csim(x_i, c_j)|, that index (int32), and ||x_i||. Ties go to
// the lowest j, as jnp.argmax does. A generator of norm 0 gets inverse
// norm 0, so it can only win when every csim of the row is 0; a zero row
// of x gets csim 0 and index 0. The alpha / eps / beta epilogue stays in
// the wrapper (kernels/ops.py), as on the TPU.
//
// Two routes, chosen by dtype. Both walk the generators in chunks and keep
// a running best per row (|cs|, j, cs), updated chunk by chunk with a
// strict '>' in increasing j, so an earlier chunk keeps its tie and nothing
// assumes that k fits on chip.
//
// bf16, on tensor cores (csim_argmax_mma). One block of four warps per 64
// rows of x (128 blocks at the slice's b = 8192, one an SM); a warp owns 16
// rows. The block streams its x rows and the chunk's 16 generators through
// shared memory in stages of 128 columns, as 16-byte cp.async copies, four
// stages deep (three in flight, 48 KB of x, while one is read), rows padded
// by 16 bytes so an ldmatrix hits 8 distinct bank groups. Each 16-column
// step is one ldmatrix of x (the A fragment), one of the generators (the B
// fragments of two 8-generator n-tiles) and two mma.sync m16n8k16 (bf16
// in, f32 accumulate; the products of bf16 values are exact in f32, only
// the order of the sums differs from the plain version); even and odd steps
// keep separate accumulators, added at the end. The same fragments give
// each lane its share of ||x_row||^2 (first chunk only) and of the chunk's
// ||c_j||^2, so x is read from device memory once a chunk and the
// generators' norms need no prologue; the four lanes of a row reduce by
// shuffles. The chunk is 16 generators, the main path's k; a larger k walks
// chunks and streams x again for each. Rows that start off a 16-byte
// boundary (n not a multiple of 8) take element loads into the same tiles.
// 48 registers, 87,040 bytes of dynamic shared memory, no spills (ptxas,
// sm_90a).
//
// f32 (csim_argmax_kernel, scalar). One block of 256 threads per 32-row
// tile; chunks of 32 generators; 64-column tiles staged as f32. Thread (r,
// p) = (t / 8, t % 8) owns row r and the generators p, p+8, p+16, p+24 of
// the chunk, keeps their four dot products in registers and its share of
// the row norm and of the chunk's generator norms; the eight lanes of a row
// reduce by shuffles. It is the route of the card-vs-CPU check and the f32
// card tests.
//
// Entry point (csim_argmax_batched): E independent problems, x (E, b,
// n) and c (E, k, n) -> cs, idx, norm (E, b), E 1 for one problem and the
// MoE site's experts in one launch (the TPU runs the vmapped pallas_call with a leading grid
// axis). The expert is the outermost grid axis (blockIdx.y); each block
// offsets its pointers to its expert's rows and runs the body above
// unchanged, so expert e of a batched launch gives the bits of a launch at
// E 1 on x[e], c[e]. At the MoE site's shape (E 40 x b 2048 x n 1536,
// k 4, bf16) x is 252 MB read once: 0.075 ms at 3.35 TB/s; rows of an
// expert's capacity padding are zero and still read.
//
// The split route (a row-parallel site under tensor parallelism: each
// model rank holds a slice of every row's columns). Pass A, csim_partial,
// runs the same two bodies, templated on PARTIAL, over the rank's slice x
// (b, n/tp) and generator slice c (k, n/tp) and writes the raw dot products
// and this slice's ||x_i||^2 into one f32 buffer (b, k + 1), row i holding
// its k dots then its squared norm; it skips the running best. The caller
// sums that buffer over the model group (one all-reduce of b (k + 1) f32,
// 0.56 MB at internlm2's ffn.down, where gathering x would move 64 MiB).
// Pass B, csim_finish (one thread a row, 256 a block), reads the summed
// buffer and the generator rows idx (k,) and writes cs, idx and norm as
// the epilogue above does: ||x_i|| = sqrt(sq_i), a generator's norm
// sqrt(sq[idx_j]) (the generators are rows of x), inverse norms clamped at
// 1e-20 and 0 for a generator of norm 0, the arg-max of |csim| the lowest j
// on a tie. At internlm2's ffn.down on a model rank of 2 (b 8192, n 4096,
// k 16, bf16) pass A reads 67 MB, 0.020 ms at 3.35 TB/s; pass B moves
// 0.66 MB, 0.0002 ms.
//
// Bound on the H100: bytes. At the slice's shape (b 8192, n 2048, k 16,
// bf16) x is 33.5 MB, read once: 0.0101 ms at 3.35 TB/s; the dots are
// 2*b*n*k = 0.54 GFLOP, 0.0005 ms on the tensor cores. Each block also
// reads the 64 KB of generators, from L2. What limits it now is the stream
// itself: 0.028-0.030 ms on the device with the L2 flushed (chip_smoke.py),
// about a plain torch.sum over the same bytes (0.026 ms,
// tools/pamm_probe.py); loads alone take 0.0255. Wider stages and more or
// fewer warps a block move it by a microsecond or two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using flash::bf16;
constexpr float NORM_EPS = 1e-20f;

// (a_abs, a_j) <- the better of itself and (b_abs, b_j): larger |cs|, then
// the lower index.
__device__ __forceinline__ void take_better(float& a_abs, int& a_j, float& a_cs, float b_abs,
                                            int b_j, float b_cs) {
  if (b_abs > a_abs || (b_abs == a_abs && b_j < a_j)) {
    a_abs = b_abs;
    a_j = b_j;
    a_cs = b_cs;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int TW = 4;                     // warps a block, 16 rows each
constexpr int TNT = 32 * TW;
constexpr int TBM = 16 * TW;              // rows of x a block
constexpr int TKC = 16;                   // generators a chunk
constexpr int TBK = 128;                  // hidden columns a stage
constexpr int TSR = TBK + 8;              // a staged row, padded by 16 bytes
constexpr int STAGES = 4;
constexpr int STAGE = (TBM + TKC) * TSR;  // elements of one stage: x rows, then generators
constexpr size_t MMA_SMEM = sizeof(bf16) * STAGES * STAGE;

// One stage: columns [n0, n0 + TBK) of the block's x rows and of the
// chunk's generators, zero past b, k and n. ``vec``: 16-byte cp.async
// chunks (n % 8 == 0, 16-byte aligned bases), else element loads.
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ x,
                                           const bf16* __restrict__ c, int row0, int j0, int n0,
                                           int b, int n, int k, bool vec) {
  constexpr int CHR = TBK / 8;  // 16-byte chunks a staged row
  for (int i = threadIdx.x; i < (TBM + TKC) * CHR; i += TNT) {
    const int r = i / CHR, d = (i % CHR) * 8, col = n0 + d;
    const bool is_x = r < TBM;
    const int gr = is_x ? row0 + r : j0 + r - TBM;
    const bool in_row = gr < (is_x ? b : k);
    const bf16* src = (is_x ? x : c) + (long long)gr * n + col;
    bf16* to = st + r * TSR + d;
    if (vec) {
      const bool in = in_row && col < n;
      flash::cp_async16(to, in ? src : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = (in_row && col + e < n) ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// s += lo^2 + hi^2 of two bf16 in one register
__device__ __forceinline__ float sumsq2(uint32_t v, float s) {
  const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xffff0000u);
  return fmaf(hi, hi, fmaf(lo, lo, s));
}

// PARTIAL: pass A of the split route -- the dots and ||x||^2 of this slice
// into part (b, k + 1), no running best (cs_out, idx_out, norm_out unused).
template <bool PARTIAL>
__global__ void __launch_bounds__(TNT)
csim_argmax_mma(const bf16* __restrict__ x, const bf16* __restrict__ c, float* __restrict__ cs_out,
                int* __restrict__ idx_out, float* __restrict__ norm_out,
                float* __restrict__ part, int b, int n, int k, bool vec) {
  extern __shared__ uint4 smem_u4[];
  bf16* sm = reinterpret_cast<bf16*>(smem_u4);
  {  // this block's expert
    const long long e = blockIdx.y;
    x += e * b * n;
    c += e * k * n;
    cs_out += e * b;
    idx_out += e * b;
    norm_out += e * b;
    part += e * b * (k + 1);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;  // rows g and g + 8 of the warp's 16
  const int row0 = blockIdx.x * TBM;
  const int ntiles = (n + TBK - 1) / TBK;

  float sq[2] = {0.f, 0.f};  // this lane's share of ||x||^2 of rows g, g + 8
  float norm[2] = {0.f, 0.f}, inv_na[2] = {0.f, 0.f};
  float best_abs[2] = {-1.f, -1.f}, best_cs[2] = {0.f, 0.f};
  int best_j[2] = {0, 0};

  for (int j0 = 0; j0 < k; j0 += TKC) {
    // [step parity][n-tile][fragment]: n-tile t holds generators 8t + 2tg,
    // 8t + 2tg + 1 of rows g (elements 0, 1) and g + 8 (2, 3)
    float acc[2][2][4] = {};
    float csq[2] = {0.f, 0.f};  // this lane's share of ||c||^2 of generators g, 8 + g
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ntiles) load_stage(sm + st * STAGE, x, c, row0, j0, st * TBK, b, n, k, vec);
      flash::cp_async_commit();
    }
    for (int it = 0; it < ntiles; ++it) {
      flash::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage it has landed; every warp is done with stage it - 1
      const int nx = it + STAGES - 1;
      if (nx < ntiles)
        load_stage(sm + (nx % STAGES) * STAGE, x, c, row0, j0, nx * TBK, b, n, k, vec);
      flash::cp_async_commit();
      const bf16* sX = sm + (it % STAGES) * STAGE;
      const bf16* sC = sX + TBM * TSR;
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
        uint32_t a[4], bb[4];
        flash::ldsm_x4(a, flash::frag_a(sX, TSR, warp * 16, kk * 16, lane));
        flash::ldsm_x4(bb, flash::frag_b(sC, TSR, 0, kk * 16, lane));
        flash::mma16816(acc[kk & 1][0], a, bb[0], bb[1]);
        flash::mma16816(acc[kk & 1][1], a, bb[2], bb[3]);
        if (j0 == 0) {
          sq[0] = sumsq2(a[2], sumsq2(a[0], sq[0]));
          sq[1] = sumsq2(a[3], sumsq2(a[1], sq[1]));
        }
        if (!PARTIAL) {
          csq[0] = sumsq2(bb[1], sumsq2(bb[0], csq[0]));
          csq[1] = sumsq2(bb[3], sumsq2(bb[2], csq[1]));
        }
      }
    }
    flash::cp_async_wait<0>();
    __syncthreads();  // the stages are free for the next chunk

    if (PARTIAL) {  // this chunk's dots, and ||x||^2 after the first
      if (j0 == 0) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int h = 0; h < 2; ++h) sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], off);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + warp * 16 + g + 8 * h;
        if (row >= b) continue;
        float* out = part + (long long)row * (k + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nt = i >> 1, e = 2 * h + (i & 1);
          const int j = j0 + 8 * nt + 2 * tg + (i & 1);
          if (j < k) out[j] = acc[0][nt][e] + acc[1][nt][e];
        }
        if (j0 == 0 && tg == 0) out[k] = sq[h];
      }
      continue;
    }

    // the four lanes of a row (and of a generator) sum their shares
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        csq[h] += __shfl_xor_sync(0xffffffffu, csq[h], off);
        if (j0 == 0) sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], off);
      }
    }
    if (j0 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        norm[h] = sqrtf(sq[h]);
        inv_na[h] = 1.f / fmaxf(norm[h], NORM_EPS);
      }
    }
    // inverse norms of this lane's generators 2tg, 2tg + 1, 8 + 2tg, 9 + 2tg
    // (generator g' < 8 sits in lanes 4g'.., slot 0; 8 + g' in slot 1)
    float invc[4];
    const float q[4] = {__shfl_sync(0xffffffffu, csq[0], 8 * tg),
                        __shfl_sync(0xffffffffu, csq[0], 8 * tg + 4),
                        __shfl_sync(0xffffffffu, csq[1], 8 * tg),
                        __shfl_sync(0xffffffffu, csq[1], 8 * tg + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float nc = sqrtf(q[i]);
      invc[i] = nc > 0.f ? 1.f / fmaxf(nc, NORM_EPS) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c_abs = -1.f, c_cs = 0.f;
      int c_j = INT_MAX;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // increasing j
        const int nt = i >> 1, e = 2 * h + (i & 1);
        const int j = j0 + 8 * nt + 2 * tg + (i & 1);
        if (j < k) {
          const float cs = (acc[0][nt][e] + acc[1][nt][e]) * inv_na[h] * invc[i];
          take_better(c_abs, c_j, c_cs, fabsf(cs), j, cs);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o_abs = __shfl_xor_sync(0xffffffffu, c_abs, off);
        const int o_j = __shfl_xor_sync(0xffffffffu, c_j, off);
        const float o_cs = __shfl_xor_sync(0xffffffffu, c_cs, off);
        take_better(c_abs, c_j, c_cs, o_abs, o_j, o_cs);
      }
      if (c_abs > best_abs[h]) {  // strict: an earlier chunk keeps its tie
        best_abs[h] = c_abs;
        best_j[h] = c_j;
        best_cs[h] = c_cs;
      }
    }
  }

  if (!PARTIAL && tg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + warp * 16 + g + 8 * h;
      if (row < b) {
        cs_out[row] = best_cs[h];
        idx_out[row] = best_j[h];
        norm_out[row] = norm[h];
      }
    }
  }
}

template <bool PARTIAL>
int launch_mma(const void* x, const void* c, void* cs, void* idx, void* norm, void* part, int E,
               int b, int n, int k, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(csim_argmax_mma<PARTIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec = flash::aligned16(x, 2, {n}) && flash::aligned16(c, 2, {n});
  csim_argmax_mma<PARTIAL><<<dim3((b + TBM - 1) / TBM, E), TNT, MMA_SMEM, stream>>>(
      (const bf16*)x, (const bf16*)c, (float*)cs, (int*)idx, (float*)norm, (float*)part, b, n,
      k, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar
// ---------------------------------------------------------------------------
constexpr int BM = 32;  // rows of x per block
constexpr int KC = 32;  // generators per chunk
constexpr int BN = 64;  // hidden columns per tile
constexpr int NT = 256;

template <bool PARTIAL>
__global__ void __launch_bounds__(NT)
csim_argmax_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   float* __restrict__ cs_out, int* __restrict__ idx_out,
                   float* __restrict__ norm_out, float* __restrict__ part, int b, int n, int k) {
  __shared__ float sX[BM][BN + 1];
  __shared__ float sC[KC][BN + 1];
  __shared__ float sInvC[KC];

  {  // this block's expert
    const long long e = blockIdx.y;
    x += e * b * n;
    c += e * k * n;
    cs_out += e * b;
    idx_out += e * b;
    norm_out += e * b;
    part += e * b * (k + 1);
  }
  const int t = threadIdx.x;
  const int r = t >> 3;  // row of the tile; also the generator row it norms
  const int p = t & 7;   // column phase; generators p + 8 i of the chunk
  const int row0 = blockIdx.x * BM;

  float sq = 0.f;  // this lane's share of ||x_row||^2
  float norm = 0.f, inv_na = 0.f;
  float best_abs = -1.f, best_cs = 0.f;
  int best_j = 0;

  for (int j0 = 0; j0 < k; j0 += KC) {
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    float csq = 0.f;  // this lane's share of ||c_{j0 + r}||^2
    for (int n0 = 0; n0 < n; n0 += BN) {
      __syncthreads();  // the previous tile's reads are done
      for (int i = t; i < BM * BN; i += NT) {
        const int rr = i / BN, cc = i % BN, gr = row0 + rr, gc = n0 + cc;
        sX[rr][cc] = (gr < b && gc < n) ? x[(long long)gr * n + gc] : 0.f;
      }
      for (int i = t; i < KC * BN; i += NT) {
        const int rr = i / BN, cc = i % BN, gj = j0 + rr, gc = n0 + cc;
        sC[rr][cc] = (gj < k && gc < n) ? c[(long long)gj * n + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < BN; ++cc) {
        const float xv = sX[r][cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[i] = fmaf(xv, sC[p + 8 * i][cc], dot[i]);
      }
#pragma unroll
      for (int cc = p; cc < BN; cc += 8) {
        const float cv = sC[r][cc];
        csq = fmaf(cv, cv, csq);
        if (j0 == 0) {
          const float xv = sX[r][cc];
          sq = fmaf(xv, xv, sq);
        }
      }
    }
    // the eight lanes of a row (or generator) sit in one warp
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      csq += __shfl_xor_sync(0xffffffffu, csq, off);
      if (j0 == 0) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (PARTIAL) {  // this chunk's dots, and ||x||^2 after the first
      const int row = row0 + r;
      if (row < b) {
        float* out = part + (long long)row * (k + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + p + 8 * i;
          if (j < k) out[j] = dot[i];
        }
        if (j0 == 0 && p == 0) out[k] = sq;
      }
      continue;
    }
    if (j0 == 0) {
      norm = sqrtf(sq);
      inv_na = 1.f / fmaxf(norm, NORM_EPS);
    }
    if (p == 0) {
      const float nc = sqrtf(csq);
      sInvC[r] = nc > 0.f ? 1.f / fmaxf(nc, NORM_EPS) : 0.f;
    }
    __syncthreads();

    float c_abs = -1.f, c_cs = 0.f;
    int c_j = INT_MAX;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + p + 8 * i;
      if (j < k) {
        const float cs = dot[i] * inv_na * sInvC[p + 8 * i];
        take_better(c_abs, c_j, c_cs, fabsf(cs), j, cs);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float o_abs = __shfl_xor_sync(0xffffffffu, c_abs, off);
      const int o_j = __shfl_xor_sync(0xffffffffu, c_j, off);
      const float o_cs = __shfl_xor_sync(0xffffffffu, c_cs, off);
      take_better(c_abs, c_j, c_cs, o_abs, o_j, o_cs);
    }
    if (c_abs > best_abs) {  // strict: an earlier chunk keeps its tie
      best_abs = c_abs;
      best_j = c_j;
      best_cs = c_cs;
    }
  }

  const int row = row0 + r;
  if (!PARTIAL && p == 0 && row < b) {
    cs_out[row] = best_cs;
    idx_out[row] = best_j;
    norm_out[row] = norm;
  }
}

template <bool PARTIAL>
int launch_f32(const void* x, const void* c, void* cs, void* idx, void* norm, void* part, int E,
               int b, int n, int k, cudaStream_t stream) {
  csim_argmax_kernel<PARTIAL><<<dim3((b + BM - 1) / BM, E), NT, 0, stream>>>(
      (const float*)x, (const float*)c, (float*)cs, (int*)idx, (float*)norm, (float*)part, b, n,
      k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pass B of the split route: the arg-max from the summed dots
// ---------------------------------------------------------------------------
constexpr int FT = 256;  // rows a block; also generators staged a round

__global__ void __launch_bounds__(FT)
csim_finish_kernel(const float* __restrict__ part, const int* __restrict__ gen_rows,
                   float* __restrict__ cs_out, int* __restrict__ idx_out,
                   float* __restrict__ norm_out, int b, int k) {
  __shared__ float sInvC[FT];
  const int row = blockIdx.x * FT + threadIdx.x;
  const long long w = k + 1;
  float norm = 0.f, inv_na = 0.f;
  if (row < b) {
    norm = sqrtf(part[row * w + k]);
    inv_na = 1.f / fmaxf(norm, NORM_EPS);
  }
  float best_abs = -1.f, best_cs = 0.f;
  int best_j = 0;
  for (int j0 = 0; j0 < k; j0 += FT) {
    __syncthreads();  // the previous round's reads are done
    const int j = j0 + threadIdx.x;
    if (j < k) {  // a generator is row gen_rows[j] of x: its ||c||^2 is that row's
      const int gr = min(max(gen_rows[j], 0), b - 1);
      const float nc = sqrtf(part[gr * w + k]);
      sInvC[threadIdx.x] = nc > 0.f ? 1.f / fmaxf(nc, NORM_EPS) : 0.f;
    }
    __syncthreads();
    if (row < b) {
      const float* dots = part + row * w + j0;
      const int jn = min(FT, k - j0);
      for (int jj = 0; jj < jn; ++jj) {  // increasing j, strict '>': the lowest j on a tie
        const float cs = dots[jj] * inv_na * sInvC[jj];
        if (fabsf(cs) > best_abs) {
          best_abs = fabsf(cs);
          best_j = j0 + jj;
          best_cs = cs;
        }
      }
    }
  }
  if (row < b) {
    cs_out[row] = best_cs;
    idx_out[row] = best_j;
    norm_out[row] = norm;
  }
}

}  // namespace

// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor cores). x (E, b,
// n) and c (E, k, n) row-major and contiguous; cs, norm (E, b) f32 and idx
// (E, b) int32 written. Returns a cudaError_t (0 = launched).
extern "C" int csim_argmax_batched(const void* x, const void* c, void* cs, void* idx, void* norm,
                                   int E, int b, int n, int k, int dtype, void* stream) {
  if (E < 1 || E > 65535 || b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32<false>(x, c, cs, idx, norm, nullptr, E, b, n, k, s);
  if (dtype == 1) return launch_mma<false>(x, c, cs, idx, norm, nullptr, E, b, n, k, s);
  return (int)cudaErrorInvalidValue;
}

// Pass A of the split route. x (b, n) and c (k, n), this rank's column
// slices, row-major and contiguous, of one dtype (0 float32, 1 bfloat16);
// part (b, k + 1) f32 written: row i's k dot products, then its ||x_i||^2.
extern "C" int csim_partial(const void* x, const void* c, void* part, int b, int n, int k,
                            int dtype, void* stream) {
  if (b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32<true>(x, c, nullptr, nullptr, nullptr, part, 1, b, n, k, s);
  if (dtype == 1) return launch_mma<true>(x, c, nullptr, nullptr, nullptr, part, 1, b, n, k, s);
  return (int)cudaErrorInvalidValue;
}

// Pass B of the split route. part (b, k + 1) f32, summed over the model
// group; gen_rows (k,) int32, the generators' rows of x; cs, norm (b,) f32
// and idx (b,) int32 written, as csim_argmax_batched writes them.
extern "C" int csim_finish(const void* part, const void* gen_rows, void* cs, void* idx,
                           void* norm, int b, int k, void* stream) {
  if (b < 1 || k < 1) return (int)cudaErrorInvalidValue;
  csim_finish_kernel<<<(b + FT - 1) / FT, FT, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const int*)gen_rows, (float*)cs, (int*)idx, (float*)norm, b, k);
  return (int)cudaGetLastError();
}
