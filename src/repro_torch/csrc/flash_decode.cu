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
// Bound on the H100: bytes. Every step reads the whole K/V slab of its
// slots once: at 8 slots x 1089 x 8 kv heads x 128 x bf16 that is ~35.7
// MB, ~10.6 us at 3.35 TB/s, against ~0.5 MFLOP of arithmetic.
//
// Design: the split-over-keys body of flash_decode_split.cuh (K7's), over
// a dense slab. The grid is (split, kv head, slot); split s covers the
// contiguous slots [s * per, min(S, (s + 1) * per)), and `per` is a fixed
// number of keys (256, from the wrapper), so the split count is a function
// of S alone -- never of B, the card or the data -- and a batch row's sums
// run in one order whatever the batch: batched decode stays bit-identical
// per sequence to a batch-of-1 run. At the serving shape that is 5 splits
// and 320 blocks on 132 SMs. The G query heads of the kv head are the
// rows of a block's little matrix, so K/V is read once for GQA. Each split
// walks its slots in 64-key tiles (32 where a row is wider than 256 bytes)
// whose K and V rows, in bf16 or f32, and slot_pos entries are staged with
// cp.async (16-byte chunks for rows whose address is 16-byte aligned, else
// element by element; 4 bytes a position), double-buffered; every split
// holds a slot, so its max is
// finite and the merge never sees a split without a key. Head dims up to
// 256 (compiled widths 32 / 64 / 128 / 256; dims past dh are zero on the
// way into shared memory), nothing padded in device memory.
#include "flash_decode_split.cuh"

namespace {

using decode_split::NO_KEY;
using decode_split::Stage;

// the slab of row b: slot j's K row at k + b * skb + j * sks + kvh * dh
// (elements), its position at slot_pos[b * spb + j]
template <typename T>
struct Dense {
  using Q = T;
  const T *k, *v;
  const int* slot_pos;
  int S, per, dh;
  long long skb, sks, svb, svs, spb;
  int vec;

  template <int DHP>
  __host__ __device__ static constexpr int row_bytes() {
    return DHP * (int)sizeof(T);
  }
  __host__ __device__ int scales() const { return 0; }
  __host__ __device__ int table_len() const { return 0; }

  __device__ void range(int sp, int, int*, int* begin, int* end) const {
    *begin = sp * per;
    *end = min(S, *begin + per);
  }
  __device__ int next_tile(int k, int, int end, int, const int*) const { return min(k, end); }

  template <int DHP, int BK>
  __device__ void load_tile(const Stage& st, int k0, int, int end, int b, int kvh,
                            const int*) const {
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int CH = DHP / EPC;
    for (int i = threadIdx.x; i < BK * CH; i += decode_split::NT) {
      const int r = i / CH, d = (i % CH) * EPC, key = k0 + r;
      const long long ko = (long long)b * skb + (long long)key * sks + (long long)kvh * dh;
      const long long vo = (long long)b * svb + (long long)key * svs + (long long)kvh * dh;
      decode_split::stage_fp_rows<T, DHP>(st, k, v, r, d, key < end, ko, vo, dh, vec);
    }
    for (int r = threadIdx.x; r < BK; r += decode_split::NT) {
      const int key = k0 + r;
      if (key < end)
        flash::cp_async4(st.pos + r, slot_pos + (long long)b * spb + key);
      else
        st.pos[r] = NO_KEY;  // past the split: no slot
    }
  }
  template <int DHP>
  __device__ float dot(const float* qr, const Stage& st, int j) const {
    return decode_split::dot_fp<T, DHP>(qr, st, j);
  }
  __device__ int prep(int) const { return 0; }
  template <int DHP>
  __device__ float2 pair(const Stage& st, int j, int d, int) const {
    return decode_split::pair_fp<T, DHP>(st, j, d);
  }
};

template <typename T>
int run(const decode_split::Common& c, const void* k, const void* v, const void* slot_pos,
        int S, int per, long long skb, long long sks, long long svb, long long svs,
        long long spb, cudaStream_t s) {
  const long long eb = sizeof(T);
  const int vec = (c.dh * eb) % 16 == 0 && flash::aligned16(k, eb, {skb, sks}) &&
                  flash::aligned16(v, eb, {svb, svs});
  const Dense<T> src{(const T*)k, (const T*)v, (const int*)slot_pos, S, per, c.dh,
                     skb, sks, svb, svs, spb, vec};
  return decode_split::by_width(c, src, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. part_acc
// (nsplit, B, KV, G, dh) and part_ml (nsplit, B, KV, G, 2) f32 are the
// wrapper's scratch; split s covers slots [s * per, (s + 1) * per). Returns
// a cudaError_t (0 = launched).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* q_pos,
                            const void* slot_pos, void* o, void* part_acc, void* part_ml, int B,
                            int S, int H, int KV, int dh, int nsplit, int per, long long sqb,
                            long long skb, long long sks, long long svb, long long svs,
                            long long spb, long long sob, int causal, int window, float scale,
                            int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || per < 1 || nsplit != (S + per - 1) / per)
    return (int)cudaErrorInvalidValue;
  // one query row a slot: Lq 1, so the l strides of q and o are never used
  const decode_split::Common c{q,   (const int*)q_pos, o,      (float*)part_acc, (float*)part_ml,
                               B,   1, H, KV, dh, nsplit, sqb, 0, sob, 0,
                               causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run<float>(c, k, v, slot_pos, S, per, skb, sks, svb, svs, spb, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(c, k, v, slot_pos, S, per, skb, sks, svb, svs, spb, s);
  return (int)cudaErrorInvalidValue;
}
