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
// the TPU kernel, it averages V over the mapped pages, and a row whose
// table maps no page gives o = 0. The Lq x G query rows that share a kv
// head are the rows of one block's little matrix (row l*G + g is query l,
// head g, with its own q_pos[b, l]), so GQA and the Lq > 1
// speculative-verify rows read each K/V row once. Pools are read in place,
// (n_pages, ps, KV, w), by strides: nothing is padded or transposed per
// call; head dims beyond dh are zero on the way into shared memory.
//
// Bound on the H100: bytes. A decode step reads the live pages of every
// slot once: at 8 slots x 17 pages of 64 tokens x 8 kv heads x 128, K and
// V, that is ~35 MB in bf16 (~10.4 us at 3.35 TB/s), ~17.8 MB in int8 and
// ~8.9 MB in int4, plus 4 bytes of scale per row and group.
//
// Both are split over the keys with the body of flash_decode_split.cuh.
// The grid is (split, kv head, slot); split s covers the block-table
// entries [s * pps, (s + 1) * pps), a contiguous, page-aligned range, and
// the split count comes from the shapes alone (the wrapper's _splits: B,
// KV, nb and the SM count, for at least two blocks per SM), never from the
// table's contents. A block resolves its range's pages once into shared
// memory, walks the range in tiles of 64 keys (32 where a row is wider
// than 256 bytes) that hold a mapped page, and stages each tile with
// cp.async, double-buffered, so the next tile's copies run under this
// tile's arithmetic; the ordered merge of the splits is the second launch,
// and the two count as one launch.
//
// K7 (flash_paged_decode) stages bf16 / f32 rows in 16-byte chunks.
// K8 (flash_paged_decode_quant) stages the raw int bytes -- rows of dh
// (int8) or dh / 2 (int4) bytes, in 16-byte chunks where the rows are
// 16-byte aligned, else byte by byte (int4 at dh 80 or 120: 40 / 60-byte
// rows) -- and each row's ngr f32 scales in 4-byte copies, so a page row
// costs its stored bytes, not 4 bytes an element. Scores and P V
// dequantise in registers from shared memory, int -> f32 -> x the group's
// scale, element by element: the same f32 arithmetic as the plain version,
// never rounded to bf16 and no scale factored out of a partial dot. int4
// bytes hold dim 2j in the low and 2j+1 in the high nibble, each
// sign-extended.
#include "flash_decode_split.cuh"

namespace {

using decode_split::NO_KEY;
using decode_split::Stage;

// The page-aligned key range of a split, through the block table
struct PagedRange {
  const int* bt;    // (B, nb), row stride sbt
  const int* ppos;  // (n_pages, ps), row stride spp
  int ps, nb, pps;
  long long sbt, spp;

  __host__ __device__ int table_len() const { return pps; }

  // keys [begin, end) of entries [sp * pps, min(nb, (sp + 1) * pps)); the
  // entries' pages into sTab (visible after the caller's barrier)
  __device__ void range(int sp, int b, int* sTab, int* begin, int* end) const {
    const int e_begin = sp * pps, e_end = min(nb, e_begin + pps);
    for (int e = threadIdx.x; e < e_end - e_begin; e += decode_split::NT)
      sTab[e] = bt[(long long)b * sbt + e_begin + e];
    *begin = e_begin * ps;
    *end = e_end * ps;
  }

  // the first tile start >= k (stepping by bk from the range's start) whose
  // keys touch a mapped page of the range, or end
  __device__ int next_tile(int k, int begin, int end, int bk, const int* sTab) const {
    for (; k < end; k += bk) {
      const int last = min(k + bk, end) - 1;
      for (int e = (k - begin) / ps; e <= (last - begin) / ps; ++e)
        if (sTab[e] >= 0) return k;
    }
    return end;
  }

  // the page of a tile slot (-1: unmapped, or past the range)
  __device__ int page_of(int key, int begin, int end, const int* sTab) const {
    return key < end ? sTab[(key - begin) / ps] : -1;
  }

  // each slot's position (NO_KEY where there is no key)
  template <int BK>
  __device__ void load_pos(const Stage& st, int k0, int begin, int end, const int* sTab) const {
    for (int r = threadIdx.x; r < BK; r += decode_split::NT) {
      const int key = k0 + r, page = page_of(key, begin, end, sTab);
      if (page >= 0)
        flash::cp_async4(st.pos + r, ppos + (long long)page * spp + key % ps);
      else
        st.pos[r] = NO_KEY;
    }
  }
};

// K7: bf16 / f32 pages (n_pages, ps, KV, dh)
template <typename T>
struct Paged : PagedRange {
  using Q = T;
  const T *k, *v;
  long long skp, sko, svp, svo;  // element strides of the page and in-page row axes
  int dh, vec;

  template <int DHP>
  __host__ __device__ static constexpr int row_bytes() {
    return DHP * (int)sizeof(T);
  }
  __host__ __device__ int scales() const { return 0; }

  template <int DHP, int BK>
  __device__ void load_tile(const Stage& st, int k0, int begin, int end, int, int kvh,
                            const int* sTab) const {
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int CH = DHP / EPC;
    for (int i = threadIdx.x; i < BK * CH; i += decode_split::NT) {
      const int r = i / CH, d = (i % CH) * EPC, key = k0 + r;
      const int page = page_of(key, begin, end, sTab);
      const long long off = key % ps;
      decode_split::stage_fp_rows<T, DHP>(st, k, v, r, d, page >= 0,
                                          page * skp + off * sko + (long long)kvh * dh,
                                          page * svp + off * svo + (long long)kvh * dh, dh, vec);
    }
    load_pos<BK>(st, k0, begin, end, sTab);
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

// element e of 16 staged bytes (as 4 words) of an int8 or an int4 row,
// sign-extended; int4 byte j holds dim 2j in the low and 2j+1 in the high
// nibble
template <int BITS>
__device__ __forceinline__ int int_elem(const unsigned* w, int e) {
  if constexpr (BITS == 8) {
    return (int)(signed char)(w[e >> 2] >> (8 * (e & 3)));
  } else {
    const int byte = (int)(signed char)(w[e >> 3] >> (8 * ((e >> 1) & 3)));
    return (e & 1) ? byte >> 4 : ((byte & 0xF) ^ 8) - 8;
  }
}

// K8: int8 pages (n_pages, ps, KV, dh) or int4 pages (..., dh / 2) and f32
// scales (n_pages, ps, KV, ngr), one per dh / ngr-wide group
template <typename T, int BITS>
struct Quant : PagedRange {
  using Q = T;
  const int8_t *k, *v;
  const float *ks, *vs;
  long long skp, sko, svp, svo;      // byte strides of the pages' page and row axes
  long long sksp, skso, svsp, svso;  // element strides of the scales' page and row axes
  int w, ngr, group, vec;            // stored bytes a row, scale groups, group width

  template <int DHP>
  __host__ __device__ static constexpr int row_bytes() {
    return BITS == 8 ? DHP : DHP / 2;
  }
  __host__ __device__ int scales() const { return ngr; }

  template <int DHP, int BK>
  __device__ void load_tile(const Stage& st, int k0, int begin, int end, int, int kvh,
                            const int* sTab) const {
    constexpr int SRB = row_bytes<DHP>() + 16;
    constexpr int CH = row_bytes<DHP>() / 16;
    for (int i = threadIdx.x; i < BK * CH; i += decode_split::NT) {
      const int r = i / CH, cb = (i % CH) * 16, key = k0 + r;
      const int page = page_of(key, begin, end, sTab);
      const long long off = key % ps;
      const bool in = page >= 0 && cb < w;
      const long long ko = page * skp + off * sko + (long long)kvh * w + cb;
      const long long vo = page * svp + off * svo + (long long)kvh * w + cb;
      int8_t* dk = reinterpret_cast<int8_t*>(st.k + r * SRB + cb);
      int8_t* dv = reinterpret_cast<int8_t*>(st.v + r * SRB + cb);
      if (vec) {
        flash::cp_async16(dk, in ? k + ko : k, in ? 16 : 0);
        flash::cp_async16(dv, in ? v + vo : v, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const bool ok = in && cb + e < w;
          dk[e] = ok ? k[ko + e] : (int8_t)0;
          dv[e] = ok ? v[vo + e] : (int8_t)0;
        }
      }
    }
    for (int i = threadIdx.x; i < BK * ngr; i += decode_split::NT) {
      const int r = i / ngr, g = i % ngr, key = k0 + r;
      const int page = page_of(key, begin, end, sTab);
      const long long off = key % ps;
      if (page >= 0) {
        flash::cp_async4(st.ks + i, ks + page * sksp + off * skso + (long long)kvh * ngr + g);
        flash::cp_async4(st.vs + i, vs + page * svsp + off * svso + (long long)kvh * ngr + g);
      } else {  // no key: a zero scale keeps the row's 0 * p finite
        st.ks[i] = 0.f;
        st.vs[i] = 0.f;
      }
    }
    load_pos<BK>(st, k0, begin, end, sTab);
  }

  // q . K row j: each element int -> f32 -> x its group's scale, then the
  // f32 dot, in dim order (the group's scale follows d across boundaries)
  template <int DHP>
  __device__ float dot(const float* qr, const Stage& st, int j) const {
    constexpr int SRB = row_bytes<DHP>() + 16;
    constexpr int EPC = BITS == 8 ? 16 : 32;  // elements in 16 bytes
    const unsigned char* kr = st.k + j * SRB;
    const float* sc = st.ks + j * ngr;
    float s = sc[0];
    int g = 0, bound = ngr > 1 ? group : INT_MAX;
    float dot = 0.f;
#pragma unroll 2
    for (int c = 0; c < DHP / EPC; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + c * 16);
      const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int d = c * EPC + e;
        if (d == bound) {  // the next group (dims past dh stay in the last)
          ++g;
          s = sc[g];
          bound = g + 1 < ngr ? bound + group : INT_MAX;
        }
        dot = fmaf(qr[d], (float)int_elem<BITS>(wd, e) * s, dot);
      }
    }
    return dot;
  }

  // the scale groups of dims d and d + 1 (past dh: the last group)
  __device__ int2 prep(int d) const {
    return make_int2(min(d / group, ngr - 1), min((d + 1) / group, ngr - 1));
  }
  template <int DHP>
  __device__ float2 pair(const Stage& st, int j, int d, int2 grp) const {
    constexpr int SRB = row_bytes<DHP>() + 16;
    const unsigned char* vr = st.v + j * SRB;
    const float* sc = st.vs + j * ngr;
    int x0, x1;
    if constexpr (BITS == 8) {
      const char2 h = *reinterpret_cast<const char2*>(vr + d);
      x0 = h.x;
      x1 = h.y;
    } else {
      const int byte = (int)(signed char)vr[d >> 1];
      x0 = ((byte & 0xF) ^ 8) - 8;
      x1 = byte >> 4;
    }
    return make_float2((float)x0 * sc[grp.x], (float)x1 * sc[grp.y]);
  }
};

bool bad_shape(int B, int Lq, int H, int KV, int ps, int nb, int nsplit, int pps) {
  return B < 1 || Lq < 1 || KV < 1 || H % KV != 0 || ps < 1 || nb < 1 || pps < 1 ||
         nsplit != (nb + pps - 1) / pps;
}

template <typename T>
int run_k7(const decode_split::Common& c, const PagedRange& pr, const void* kp, const void* vp,
           long long skp, long long sko, long long svp, long long svo, cudaStream_t s) {
  const long long eb = sizeof(T);
  const int vec = (c.dh * eb) % 16 == 0 && flash::aligned16(kp, eb, {skp, sko}) &&
                  flash::aligned16(vp, eb, {svp, svo});
  const Paged<T> src{pr, (const T*)kp, (const T*)vp, skp, sko, svp, svo, c.dh, vec};
  return decode_split::by_width(c, src, s);
}

template <typename T, int BITS>
int run_k8(const decode_split::Common& c, const PagedRange& pr, const void* kp, const void* vp,
           const void* ks, const void* vs, long long skp, long long sko, long long svp,
           long long svo, long long sksp, long long skso, long long svsp, long long svso,
           int ngr, cudaStream_t s) {
  const int w = BITS == 8 ? c.dh : c.dh / 2;
  const int vec = w % 16 == 0 && flash::aligned16(kp, 1, {skp, sko}) &&
                  flash::aligned16(vp, 1, {svp, svo});
  const Quant<T, BITS> src{pr,   (const int8_t*)kp, (const int8_t*)vp, (const float*)ks,
                           (const float*)vs, skp, sko, svp, svo, sksp, skso, svsp, svso,
                           w,    ngr, c.dh / ngr, vec};
  return decode_split::by_width(c, src, s);
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
  if (bad_shape(B, Lq, H, KV, ps, nb, nsplit, pps)) return (int)cudaErrorInvalidValue;
  const decode_split::Common c{q,   (const int*)q_pos, o,     (float*)part_acc, (float*)part_ml,
                               B,   Lq, H, KV, dh, nsplit, sqb, sql, sob, sol,
                               causal, window, scale};
  const PagedRange pr{(const int*)block_table, (const int*)page_pos, ps, nb, pps, sbt, spp};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_k7<float>(c, pr, k_pages, v_pages, skp, sko, svp, svo, s);
  if (dtype == 1) return run_k7<__nv_bfloat16>(c, pr, k_pages, v_pages, skp, sko, svp, svo, s);
  return (int)cudaErrorInvalidValue;
}

// K8. bits: 8 (pages (n_pages, ps, KV, dh) int8) or 4 (pages (..., dh/2),
// two nibbles a byte); scales (n_pages, ps, KV, ngr) f32. dtype as K7's
// (q and output); scratch and splits as K7's. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_paged_decode_quant(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* q_pos, const void* block_table, const void* page_pos,
    void* o, void* part_acc, void* part_ml, int B, int Lq, int H, int KV, int dh, int ps, int nb,
    int ngr, int bits, int nsplit, int pps, long long sqb, long long sql, long long skp,
    long long sko, long long svp, long long svo, long long sksp, long long skso, long long svsp,
    long long svso, long long sbt, long long spp, long long sob, long long sol, int causal,
    int window, float scale, int dtype, void* stream) {
  if (bad_shape(B, Lq, H, KV, ps, nb, nsplit, pps) || ngr < 1 || dh % ngr != 0 ||
      (bits == 4 && dh % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const decode_split::Common c{q,   (const int*)q_pos, o,     (float*)part_acc, (float*)part_ml,
                               B,   Lq, H, KV, dh, nsplit, sqb, sql, sob, sol,
                               causal, window, scale};
  const PagedRange pr{(const int*)block_table, (const int*)page_pos, ps, nb, pps, sbt, spp};
  cudaStream_t s = (cudaStream_t)stream;
#define K8_RUN(T, BITS)                                                                      \
  return run_k8<T, BITS>(c, pr, k_pages, v_pages, k_scale, v_scale, skp, sko, svp, svo, sksp, \
                         skso, svsp, svso, ngr, s)
  if (dtype == 0 && bits == 8) K8_RUN(float, 8);
  if (dtype == 0 && bits == 4) K8_RUN(float, 4);
  if (dtype == 1 && bits == 8) K8_RUN(__nv_bfloat16, 8);
  if (dtype == 1 && bits == 4) K8_RUN(__nv_bfloat16, 4);
#undef K8_RUN
  return (int)cudaErrorInvalidValue;
}
