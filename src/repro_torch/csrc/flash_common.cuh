// Shared by the attention kernels (K3, K4/K5, K6-K8): the finite mask value,
// the live-tile bounds of the causal / window masks at global positions,
// and the cp.async copies that stage tiles in shared memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float DENOM_FLOOR = 1e-30f;

// Local kv tiles [*begin, *end) of width bk that the query rows
// [q_first, q_last] (local indices) can see; delta = q_off - k_off turns a
// local key index into the query's frame: key kl is visible to row ql iff
// kl <= ql + delta (causal) and kl > ql + delta - window (window > 0).
// The counterpart of _tile_live, as loop bounds (flash_attention.py:71).
__device__ __forceinline__ void live_tiles(int q_first, int q_last, int L, int bk, int causal,
                                           int window, int delta, int* begin, int* end) {
  const int nk = (L + bk - 1) / bk;
  int e = nk;
  if (causal) {
    const int last = q_last + delta;
    e = last < 0 ? 0 : min(nk, last / bk + 1);
  }
  int b = 0;
  if (window > 0) {
    const int first = q_first + delta - window + 1;
    b = first > 0 ? min(nk, first / bk) : 0;
  }
  *begin = b;
  *end = e;
}

// Local query tiles [*begin, *end) of height bq that see some key of
// [k_first, k_last] (local indices); delta as above (kv-major walk).
__device__ __forceinline__ void live_q_tiles(int k_first, int k_last, int L, int bq, int causal,
                                             int window, int delta, int* begin, int* end) {
  const int nq = (L + bq - 1) / bq;
  int b = 0;
  if (causal) {
    const int first = k_first - delta;
    b = first > 0 ? min(nq, first / bq) : 0;
  }
  int e = nq;
  if (window > 0) {
    const int last = k_last - delta + window - 1;
    e = last < 0 ? 0 : min(nq, last / bq + 1);
  }
  *begin = b;
  *end = e;
}

// 16-byte copy global -> shared that bypasses L1; src_bytes 0 zero-fills
// the destination without reading (the ragged edge and the dh tail).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
// 4-byte copy global -> shared (through L1): a position or a scale
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// true iff p and every stride (in elements of elem_bytes bytes) keep the
// 16-byte chunks of a row aligned, so rows can move as cp.async chunks
__host__ __forceinline__ bool aligned16(const void* p, long long elem_bytes,
                                        std::initializer_list<long long> strides) {
  if ((uintptr_t)p % 16 != 0) return false;
  for (long long s : strides)
    if ((s * elem_bytes) % 16 != 0) return false;
  return true;
}

}  // namespace flash
