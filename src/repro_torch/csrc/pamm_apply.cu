// K2 on Hopper: the PAMM apply core, a deterministic segment sum
// (paper Alg. 1 APPROXMM line 6, 'index_add'), split over the rows.
//
// Replaces the TPU kernel src/repro/kernels/pamm_apply.py:segment_matmul
// (body _kernel). Same function: Btilde = onehot(f)^T (alpha * dZ), i.e.
// Btilde[j, :] = sum over rows i with f_i = j of alpha_i * dZ_i, (k, m)
// f32 from f (b,) int32, alpha (b,) f32 and dZ (b, m). The TPU builds the
// one-hot tile in VMEM and contracts it on the MXU because a scatter-add is
// slow there; on Hopper the sum is a plain scatter into shared memory.
//
// Design. Grid (column tile, row split, k tile), 128 threads = 4 warps. A
// column tile is 32 x VEC columns, VEC = 8 bf16 or 4 f32: one 16-byte load
// a lane, neighbouring lanes on neighbouring columns, a warp on one row
// segment. A block takes the contiguous rows [s * per, (s + 1) * per) of
// its split (per and the split count come from the wrapper's _splits(b, m,
// k), a function of the shapes alone). It stages f and alpha of up to CH
// rows in shared memory; then warp w takes rows w, w + 4, w + 8, ... of the
// chunk in order, U rows' loads in flight at once, and adds alpha_i * dZ_i
// (one FMA an element, f32) into its own accumulator at row f_i - k0
// (KT generators x the tile's columns, in shared memory). A row whose f_i
// lies outside the block's k tile (or outside [0, k)) is neither loaded
// nor added. Each (warp, generator, column) cell is touched by one lane
// only, rows in increasing order. The block then sums its warps in the
// order w = 0..3 and writes its partial into scratch part (S, k, m) f32
// that the wrapper allocates (out itself when S = 1); a second kernel sums
// the S partials in the order s = 0..S-1. No float atomics: two launches on
// the same inputs give the same bits, the TPU kernel's guarantee (its grid
// runs in order). Another split count sums in another order, so the count
// depends on (b, m, k) and never on the card.
//
// Entry point (segment_matmul_batched): E independent problems, f and
// alpha (E, b), dZ (E, b, m) -> Btilde (E, k, m), E 1 for one problem and
// the MoE site's experts in one launch (the TPU runs the vmapped pallas_call with a leading grid
// axis). The expert is the outermost part of the grid's z axis (z = e *
// k tiles + k tile); a block offsets its pointers to its expert and runs
// the body above unchanged. The partials are (E, S, k, m) and the merge
// sums each expert's S in order, so the split count S (the wrapper's
// _splits_batched(E, b, m, k), from the shapes alone) fixes the bits, and expert
// e of a batched launch at S gives those of a launch at E 1 on f[e],
// alpha[e], dZ[e] at the same S. At the MoE site's shape (E 40 x b 2048, k 4, m 512,
// bf16 dZ) dZ is 84 MB read once: 0.025 ms at 3.35 TB/s.
//
// Where m is not a multiple of VEC (or dZ is not 16-byte aligned) the same
// kernel loads element by element, zero past m.
//
// Bound on the H100: bytes. At the slice's shape (b 8192, m 2048 for wq,
// 1024 for wk/wv, bf16 dZ) dZ is 33.5 / 16.8 MB read once: 0.0101 / 0.0050
// ms at 3.35 TB/s; the b*m FMAs are negligible. _splits aims at 264 blocks,
// two an SM (33 splits of 249 rows at m 2048, 66 of 125 at m 1024), each
// warp with U = 16 rows of 512 bytes in flight: 64 KB an SM. The scratch is
// S x k x m x 4 bytes, 4.125 MiB at both shapes, written and read back
// through L2. What limits it now is the stream: 0.029-0.031 / 0.023-0.024
// ms on the device with the L2 flushed (chip_smoke.py) against 0.026 /
// 0.019 for a plain torch.sum over dZ; the merge takes about 0.004-0.005
// of it and the shared-memory adds about 0.002 (tools/pamm_probe.py). The
// bf16 split
// kernel holds 126 registers (f32 117, the merge 26), no spills, and 69,632
// bytes of dynamic shared memory at k >= 16 (f32 36,864).
//
// No tensor cores, by design: the work is one FMA per 2 bytes of dZ, so
// bytes bound it, and a one-hot tile scaled by alpha in bf16 (the mma's
// input type) would round alpha to 8 mantissa bits, far outside the f32
// tolerance (1e-5 of max |Btilde|) the kernel is held to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int W = 4;     // warps a block
constexpr int NT = 32 * W;
constexpr int KT = 16;   // generators a k tile
constexpr int CH = 512;  // rows of f / alpha staged at once
constexpr int U = 16;    // rows in flight a warp
constexpr int MNT = 256; // merge threads a block

// VEC elements of T as 16 raw bytes: one vector load that leaves L1 alone
// (dZ is read once), or (vec false) element loads with zeros past m
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int col0, int m, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    uint4 r;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(row + col0));
    return r;
  }
  using Raw = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned int>::type;
  const Raw* src = reinterpret_cast<const Raw*>(row);
  Raw e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = col0 + i < m ? src[col0 + i] : Raw(0);
  uint4 r;
  memcpy(&r, e, 16);
  return r;
}

// element i of the 16 raw bytes as f32 (bf16: the high half of a word)
template <typename T>
__device__ __forceinline__ float elem(const unsigned (&w)[4], int i) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  else
    return __uint_as_float(w[i]);
}

// acc (this lane's cells of one generator: VEC / 4 groups of 4 columns,
// 128 floats apart) += a * z
template <typename T>
__device__ __forceinline__ void add_row(float* acc, uint4 z, float a) {
  constexpr int H = 4 / sizeof(T);  // VEC / 4
  const unsigned w[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float4* p = reinterpret_cast<float4*>(acc + h * 128);
    float4 v = *p;
    v.x = fmaf(a, elem<T>(w, 4 * h), v.x);
    v.y = fmaf(a, elem<T>(w, 4 * h + 1), v.y);
    v.z = fmaf(a, elem<T>(w, 4 * h + 2), v.z);
    v.w = fmaf(a, elem<T>(w, 4 * h + 3), v.w);
    *p = v;
  }
}

// One (column tile, split, k tile): the split's rows summed into a (k
// tile, column tile) partial, written at dst (S, k, m) row block s.
template <typename T>
__global__ void __launch_bounds__(NT)
segment_matmul_split(const int* __restrict__ f, const float* __restrict__ alpha,
                     const T* __restrict__ gz, float* __restrict__ dst, int b, int m, int k,
                     int per, bool vec) {
  constexpr int V = 16 / sizeof(T), H = V / 4, MT = 32 * V;
  extern __shared__ float4 smem4[];
  const int kte = k < KT ? k : KT;  // generators of a block's accumulator
  float* sAcc = reinterpret_cast<float*>(smem4);  // (W, kte, H, 32 lanes, 4)
  int* sF = reinterpret_cast<int*>(sAcc + W * kte * MT);
  float* sA = reinterpret_cast<float*>(sF + CH);

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int ktiles = (k + KT - 1) / KT, e = blockIdx.z / ktiles;
  const int m0 = blockIdx.x * MT, s = blockIdx.y, k0 = (blockIdx.z % ktiles) * KT;
  f += (long long)e * b;
  alpha += (long long)e * b;
  gz += (long long)e * b * m;
  dst += (long long)e * gridDim.y * k * m;  // this expert's (S, k, m) block
  const int kn = min(KT, k - k0);  // generators of this k tile
  const int r0 = s * per, r1 = min(b, r0 + per);
  const int col0 = m0 + lane * V;
  float* acc = sAcc + w * kte * MT + lane * 4;

  for (int i = t; i < W * kte * MT / 4; i += NT) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = r0; c0 < r1; c0 += CH) {
    const int nc = min(CH, r1 - c0);
    __syncthreads();  // the zeroing, or the last chunk's reads of sF / sA, are done
    for (int i = t; i < nc; i += NT) {
      sF[i] = f[c0 + i] - k0;
      sA[i] = alpha[c0 + i];
    }
    __syncthreads();
    if (col0 >= m) continue;
    const T* base = gz + (long long)c0 * m;
    for (int i = w; i < nc; i += W * U) {
      int j[U];
      uint4 z[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = i + W * u;
        j[u] = r < nc ? sF[r] : -1;
        z[u] = (j[u] >= 0 && j[u] < kn) ? load16(base + (long long)r * m, col0, m, vec)
                                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j[u] >= 0 && j[u] < kn) add_row<T>(acc + j[u] * MT, z[u], sA[i + W * u]);
    }
  }
  __syncthreads();

  // the warps' sums in the order w = 0..W-1, column by column
  for (int i = t; i < kn * MT; i += NT) {
    const int jj = i / MT, c = i % MT, col = m0 + c;
    if (col >= m) continue;
    const int cell = (jj * H + (c % V) / 4) * 128 + (c / V) * 4 + c % 4;
    float sum = sAcc[cell];
#pragma unroll
    for (int ww = 1; ww < W; ++ww) sum += sAcc[ww * kte * MT + cell];
    dst[((long long)s * k + k0 + jj) * m + col] = sum;
  }
}

// out (E, k, m) = each expert's S partials (E, S, k, m) summed in the
// order s = 0..S-1
__global__ void __launch_bounds__(MNT)
segment_matmul_merge(const float* __restrict__ part, float* __restrict__ out, int nsplit,
                     long long km, long long total) {
  const long long i = (long long)blockIdx.x * MNT + threadIdx.x;
  if (i >= total) return;
  const float* p = part + (i / km) * nsplit * km + i % km;
  float sum = p[0];
#pragma unroll 8
  for (int s = 1; s < nsplit; ++s) sum += p[s * km];
  out[i] = sum;
}

template <typename T>
int launch(const void* f, const void* alpha, const void* gz, void* out, void* part, int E, int b,
           int m, int k, int nsplit, int per, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T), MT = 32 * V;
  // the warps' accumulators, then f and alpha
  const size_t smem = sizeof(float) * ((size_t)W * (k < KT ? k : KT) * MT + 2 * CH);
  const long long tiles = (m + MT - 1) / MT, ktiles = (k + KT - 1) / KT;
  if (tiles > 0x7fffffffLL || nsplit > 65535 || E * ktiles > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(segment_matmul_split<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (uintptr_t)gz % 16 == 0 && m % V == 0;
  float* dst = static_cast<float*>(nsplit == 1 ? out : part);
  const dim3 grid((unsigned)tiles, nsplit, (unsigned)(E * ktiles));
  segment_matmul_split<T><<<grid, NT, smem, stream>>>((const int*)f, (const float*)alpha,
                                                      (const T*)gz, dst, b, m, k, per, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long km = (long long)k * m, total = E * km;
  segment_matmul_merge<<<(unsigned)((total + MNT - 1) / MNT), MNT, 0, stream>>>(
      (const float*)part, (float*)out, nsplit, km, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of gz): 0 = float32, 1 = bfloat16. f (E, b) int32 (rows outside
// [0, k) are skipped), alpha (E, b) f32, gz (E, b, m) row-major
// contiguous; each expert's rows split into nsplit ranges of per rows (the
// last may be shorter, none empty); part (E, nsplit, k, m) f32 scratch
// (unused when nsplit is 1); out (E, k, m) f32 written. The split kernel
// and the merge go on one stream. Returns a cudaError_t (0 = launched).
extern "C" int segment_matmul_batched(const void* f, const void* alpha, const void* gz, void* out,
                                      void* part, int E, int b, int m, int k, int nsplit, int per,
                                      int dtype, void* stream) {
  if (E < 1 || b < 1 || m < 1 || k < 1 || nsplit < 1 || per < 1 ||
      (long long)(nsplit - 1) * per >= b || (long long)nsplit * per < b)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(f, alpha, gz, out, part, E, b, m, k, nsplit, per, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(f, alpha, gz, out, part, E, b, m, k, nsplit, per, s);
  return (int)cudaErrorInvalidValue;
}
