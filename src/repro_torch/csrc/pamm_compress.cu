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
// Design: one thread block per 32-row tile of x, 256 threads. The block
// walks the generators in chunks of 32 and, inside a chunk, the hidden
// axis in 64-column tiles staged in shared memory as f32 (x tile and
// generator tile). Thread (r, p) = (t / 8, t % 8) owns row r and the
// generators p, p+8, p+16, p+24 of the chunk, and keeps their four dot
// products in registers. The same threads accumulate the row norm (first
// chunk only) and the chunk's generator norms over columns p, p+8, ...;
// the eight lanes of a row then reduce by shuffles. The running best per
// row (|cs|, j, cs) is updated chunk by chunk with a strict '>', in
// increasing j, so nothing assumes that k fits in shared memory.
//
// Bound on the H100: bytes. At the slice's shape (b 8192, n 2048, k 16,
// bf16) x is 33.5 MB, read once: ~0.010 ms at 3.35 TB/s; the dots are
// 2*b*n*k = 0.54 GFLOP, far below the compute bound. With k <= 32 each
// block reads its x tile once and the generators (64 KB) come from L2.
// Loads are scalar and not pipelined; vectorised, double-buffered tile
// loads are the later work that closes the gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;  // rows of x per block
constexpr int KC = 32;  // generators per chunk
constexpr int BN = 64;  // hidden columns per tile
constexpr int NT = 256;
constexpr float NORM_EPS = 1e-20f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T>
__global__ void __launch_bounds__(NT)
csim_argmax_kernel(const T* __restrict__ x, const T* __restrict__ c, float* __restrict__ cs_out,
                   int* __restrict__ idx_out, float* __restrict__ norm_out, int b, int n, int k) {
  __shared__ float sX[BM][BN + 1];
  __shared__ float sC[KC][BN + 1];
  __shared__ float sInvC[KC];

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
        sX[rr][cc] = (gr < b && gc < n) ? to_f(x[(long long)gr * n + gc]) : 0.f;
      }
      for (int i = t; i < KC * BN; i += NT) {
        const int rr = i / BN, cc = i % BN, gj = j0 + rr, gc = n0 + cc;
        sC[rr][cc] = (gj < k && gc < n) ? to_f(c[(long long)gj * n + gc]) : 0.f;
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
    int c_j = 0x7fffffff;
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
  if (p == 0 && row < b) {
    cs_out[row] = best_cs;
    idx_out[row] = best_j;
    norm_out[row] = norm;
  }
}

template <typename T>
int launch(const void* x, const void* c, void* cs, void* idx, void* norm, int b, int n, int k,
           cudaStream_t stream) {
  dim3 grid((b + BM - 1) / BM);
  csim_argmax_kernel<T><<<grid, NT, 0, stream>>>((const T*)x, (const T*)c, (float*)cs, (int*)idx,
                                                 (float*)norm, b, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (b, n) and c (k, n) row-major and
// contiguous; cs, norm (b,) f32 and idx (b,) int32 written. Returns a
// cudaError_t (0 = launched).
extern "C" int csim_argmax(const void* x, const void* c, void* cs, void* idx, void* norm, int b,
                           int n, int k, int dtype, void* stream) {
  if (b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, c, cs, idx, norm, b, n, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, c, cs, idx, norm, b, n, k, s);
  return (int)cudaErrorInvalidValue;
}
