"""K6, K7 and K8: flash decode over the serving caches, as CUDA kernels
and their plain PyTorch versions.

Counterpart of ``repro/kernels/flash_decode.py``. Decode caches are
slot-addressed, so the mask comes from per-slot absolute positions (-1 =
empty; a ring buffer for sliding-window layers) against the query's
``q_pos``, never from iota. A parked slot (``q_pos = -1``) masks every
key; its output is finite and discarded by the engine.

* K6 (``flash_decode``): one query row (Lq = 1) over a dense slot cache
  ``(B, S, KV, dh)`` with ``slot_pos`` (B, S) (``csrc/flash_decode.cu``).
  The kernel splits the slots into ranges of a fixed 256 keys
  (:func:`_dense_splits`, a function of S alone) and merges the partials
  in a second launch.
* K7 (``flash_paged_decode``): decode through a page pool ``(n_pages,
  page_size, KV, dh)`` and a block table ``(B, nb)`` (-1 = unmapped page,
  skipped whole), with in-page masks from ``page_pos`` (n_pages,
  page_size); Lq >= 1 rows with per-row positions ``q_pos`` (B, Lq)
  (speculative verify) and a ``scale`` override (svd pools score rank-r
  coefficients with the original head dim's scale). The kernel splits
  the keys over blocks at page boundaries (:func:`_splits`) and merges
  the partials in a second launch, so its f32 sums run in another order
  than K6's over the same keys.
* K8 (``flash_paged_decode_quant``): K7 over int8 pages, or int4 pages
  (two nibbles per byte), with f32 absmax scales per (token, kv head,
  group), split as K7 and dequantised in f32 from the staged raw bytes
  (both in ``csrc/flash_paged_decode.cu``; the three kernels share the
  split body and merge of ``csrc/flash_decode_split.cuh``).
* ``flash_sharded_paged_decode`` / ``_quant``: K7 / K8 over per-replica
  shards of one pool -- pools (dp, n_pages/dp, page_size, KV, w), block
  table (dp, B/dp, nb) with page ids local to their shard, q and q_pos
  slot-major over the whole batch. No kernel of their own: the JAX Pallas
  path of these wrappers is itself only a fold and an offset around K7 /
  K8, and so is theirs. The shard axis folds into the page axis (a view),
  each shard's ids move by ``shard * n_pages/dp`` (-1 stays -1) and K7 /
  K8 launch once for the whole batch; the plain versions run the plain
  K7 / K8 math over each shard's slots and pool.

The host-side quantisation helpers (``quantize_kv`` / ``dequantize_kv`` /
``pack_int4`` / ``unpack_int4``) live here too, with the JAX package's
rounding (half to even) and nibble order (dim 2j low, 2j+1 high), so the
models and the serving cache share one convention.

The plain versions take any Lq >= 1 and are what the CPU tests hold
against the JAX kernels. On a fully masked row (a parked slot) the K7/K8
kernels, like the TPU ones, average V over the mapped pages only, the
plain versions over every gathered page (K7 gives 0 where no page is
mapped): all finite, all discarded.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# KV quantisation (cache.kv=int8 / int4(group=...))
# ---------------------------------------------------------------------------
def pack_int4(q):
    """Pack int8 values in [-7, 7] into nibbles: (..., d) -> (..., d//2).
    Adjacent dims pair into one byte (dim 2j low nibble, 2j+1 high)."""
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(p):
    """Inverse of :func:`pack_int4`, sign-extending each nibble (the int8
    shifts ``(b << 4) >> 4`` and ``b >> 4``, done in int32)."""
    b = p.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = b >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2).to(torch.int8)


def quantize_kv(x, bits: int, ngr: int):
    """Symmetric absmax quantisation of K/V rows: x (..., dh) -> (q int8
    (..., dh) [int4: packed (..., dh//2)], scale f32 (..., ngr)), one scale
    per ``dh // ngr``-wide group; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    dh = x.shape[-1]
    xg = x.float().reshape(*x.shape[:-1], ngr, dh // ngr)
    qmax = 127.0 if bits == 8 else 7.0
    scale = xg.abs().amax(dim=-1).clamp_min(1e-12) / qmax
    q = torch.clamp(torch.round(xg / scale[..., None]), -qmax, qmax)
    q = q.reshape(*x.shape[:-1], dh).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def quant_bits(width: int, dh: int) -> int:
    """A quantised pool's format from its pages' last dim: int8 pages hold
    dh values a row, int4 pages dh / 2 bytes (dh even)."""
    if width == dh:
        return 8
    if dh % 2 == 0 and width == dh // 2:
        return 4
    raise ValueError(f"int8 pages of width dh={dh} or int4 pages of width dh/2 "
                     f"(dh even); got width {width}")


def dequantize_kv(q, scale, dh: int):
    """(..., dh | dh//2 packed) int8 + (..., ngr) f32 -> (..., dh) f32."""
    if quant_bits(q.shape[-1], dh) == 4:
        q = unpack_int4(q)
    ngr = scale.shape[-1]
    xg = q.float().reshape(*q.shape[:-1], ngr, dh // ngr)
    return (xg * scale[..., None]).reshape(*q.shape[:-1], dh)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _decode_math(q, k, v, q_pos, slot_pos, *, causal: bool, window: int,
                 scale: float | None):
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Lq, KV, G, dh).float()
    s = torch.einsum("blkgd,bskd->blkgs", qg, k.float()) * scale
    qp = q_pos.reshape(B, -1)[:, :, None, None, None]
    sp = slot_pos[:, None, None, None, :]
    mask = sp >= 0
    if causal:
        mask = mask & (sp <= qp)
    if window > 0:
        mask = mask & (qp - sp < window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("blkgs,bskd->blkgd", p, v.float())
    return out.reshape(B, Lq, H, dh).to(q.dtype)


def flash_decode_ref(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                     window: int = 0, scale: float | None = None):
    """q (B, Lq, H, dh); k, v (B, S, KV, dh); q_pos (B,) or (B, Lq);
    slot_pos (B, S). Materializes (B, Lq, KV, G, S) scores in f32."""
    LAUNCHES["flash_decode_ref"] += 1
    return _decode_math(q, k, v, q_pos, slot_pos, causal=causal, window=window,
                        scale=scale)


def _check(q, k, v, q_pos, slot_pos):
    """K6's argument checks; returns the strides of q, k, v and slot_pos
    (each tensor's read once: the wrapper is on the decode step's host
    path)."""
    if q.device.type != "cuda":
        raise ValueError(f"K6 kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K6 kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"K6 kernel is the single-query path: q (B,1,H,dh), "
                         f"got {tuple(q.shape)}")
    B, _, H, dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"K6 kernel: k/v (B,S,KV,dh) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    S, KV = k.shape[1], k.shape[2]
    if H % KV or dh > 256:
        raise ValueError(f"K6 kernel: H={H} must be a multiple of KV={KV} "
                         f"and dh={dh} at most 256")
    if q_pos.shape != (B,) or slot_pos.shape != (B, S):
        raise ValueError(f"K6 kernel: q_pos (B,) and slot_pos (B,S); got "
                         f"{tuple(q_pos.shape)}, {tuple(slot_pos.shape)}")
    if q_pos.dtype != torch.int32 or slot_pos.dtype != torch.int32:
        raise ValueError("K6 kernel: q_pos and slot_pos must be int32")
    strides = [t.stride() for t in (q, k, v, slot_pos)]
    for name, x, xs in zip("qkv", (q, k, v), strides):
        if x.device != q.device or xs[3] != 1 or xs[2] != dh:
            raise ValueError(f"K6 kernel: {name} must lie on {q.device} with "
                             f"contiguous (heads, dh) rows; strides {xs}")
    if (q_pos.device != q.device or slot_pos.device != q.device
            or not q_pos.is_contiguous() or strides[3][1] != 1):
        raise ValueError("K6 kernel: q_pos/slot_pos must lie on q's device "
                         "with contiguous slots")
    return strides


DENSE_SPLIT_KEYS = 256


def _dense_splits(S: int) -> tuple[int, int]:
    """(split count, slots per split) of K6's slot range: a fixed 256
    slots a split, so the count is a function of S alone -- never of B,
    the card or the data. A batch row's sums then run in one order
    whatever the batch, and batched decode stays bit-identical per
    sequence to a batch-of-1 run (K7's :func:`_splits` depends on B and
    the SM count, so K6 does not use it)."""
    return -(-S // DENSE_SPLIT_KEYS), DENSE_SPLIT_KEYS


def flash_decode_cuda(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                      window: int = 0):
    """Launch K6 on q's current CUDA stream; returns (B, 1, H, dh). The
    slots are split over blocks (:func:`_dense_splits`); the per-split
    partials (acc, then (m, l) per row, in one f32 scratch allocated
    here) are merged by a second kernel, the two launches counted as
    one."""
    qs, ks, vs, sps = _check(q, k, v, q_pos, slot_pos)
    B, _, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    nsplit, per = _dense_splits(S)
    rows = nsplit * B * H
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    part = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             slot_pos.data_ptr(), o.data_ptr(), part.data_ptr(),
             part.data_ptr() + 4 * rows * dh, B, S, H, KV, dh, nsplit, per,
             qs[0], ks[0], ks[1], vs[0], vs[1], sps[0], H * dh, int(causal), int(window),
             dh ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return o


# ---------------------------------------------------------------------------
# K7 / K8: paged decode
# ---------------------------------------------------------------------------
def shard_offset_table(block_table, n_pages_shard: int):
    """A sharded block table (..., dp, B/dp, nb) of shard-local page ids as
    (..., B, nb) ids into the shard-folded pool (shard s's page j is page
    s n_pages_shard + j); -1 stays -1."""
    dp = block_table.shape[-3]
    off = torch.arange(dp, dtype=block_table.dtype, device=block_table.device)
    glob = torch.where(block_table >= 0,
                       block_table + (off * n_pages_shard)[:, None, None], -1)
    return glob.flatten(-3, -2)


def _gather_pages(k_pages, v_pages, block_table, page_pos):
    """The pool gathered through the block table as a dense (B, nb*ps, KV,
    w) cache. Unmapped blocks gather page 0 (which may belong to another
    sequence) and are masked wholesale by forcing their positions to -1."""
    B, nb = block_table.shape
    _, ps, KV, w = k_pages.shape
    btc = block_table.clamp_min(0).long()
    k = k_pages[btc].reshape(B, nb * ps, KV, w)
    v = v_pages[btc].reshape(B, nb * ps, KV, v_pages.shape[-1])
    spos = torch.where(block_table[..., None] >= 0, page_pos[btc], -1)
    return k, v, spos.reshape(B, nb * ps)


def flash_paged_decode_ref(q, k_pages, v_pages, q_pos, block_table, page_pos,
                           *, causal: bool = True, window: int = 0,
                           scale: float | None = None):
    """Plain K7: gather the pool through the block table, then the dense
    decode math. q (B, Lq, H, dh); pages (n_pages, ps, KV, dh); q_pos (B,)
    or (B, Lq); block_table (B, nb); page_pos (n_pages, ps)."""
    LAUNCHES["flash_paged_decode_ref"] += 1
    k, v, spos = _gather_pages(k_pages, v_pages, block_table, page_pos)
    return _decode_math(q, k, v, q_pos, spos, causal=causal, window=window,
                        scale=scale)


def flash_paged_decode_quant_ref(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                                 block_table, page_pos, *, causal: bool = True,
                                 window: int = 0):
    """Plain K8: dequantise the pools wholesale (int -> f32 -> x scale),
    then the plain K7 math: the same rounding as the kernel's per-tile
    dequantisation."""
    LAUNCHES["flash_paged_decode_quant_ref"] += 1
    dh = q.shape[-1]
    k = dequantize_kv(k_pages, k_scale, dh)
    v = dequantize_kv(v_pages, v_scale, dh)
    k, v, spos = _gather_pages(k, v, block_table, page_pos)
    return _decode_math(q, k, v, q_pos, spos, causal=causal, window=window,
                        scale=None)


def _gather_shards(k_pages, v_pages, block_table, page_pos):
    """:func:`_gather_pages` of each shard's slots through its own table
    and pool, the shards' rows in slot order."""
    parts = [_gather_pages(k_pages[s], v_pages[s], block_table[s], page_pos[s])
             for s in range(block_table.shape[0])]
    return tuple(torch.cat(p) for p in zip(*parts))


def flash_sharded_paged_decode_ref(q, k_pages, v_pages, q_pos, block_table, page_pos,
                                   *, causal: bool = True, window: int = 0,
                                   scale: float | None = None):
    """Plain sharded K7: every shard's slots gathered through its own
    table from its own pool, then the plain K7 math (row-independent, so
    per shard as the JAX ``vmap``). Pools (dp, n_pages/dp, ps, KV, w),
    block_table (dp, B/dp, nb), page_pos (dp, n_pages/dp, ps); q (B, Lq,
    H, dh) and q_pos (B,) or (B, Lq) slot-major."""
    LAUNCHES["flash_sharded_paged_decode_ref"] += 1
    k, v, spos = _gather_shards(k_pages, v_pages, block_table, page_pos)
    return _decode_math(q, k, v, q_pos, spos, causal=causal, window=window, scale=scale)


def flash_sharded_paged_decode_quant_ref(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                                         block_table, page_pos, *, causal: bool = True,
                                         window: int = 0):
    """Plain sharded K8: the pools dequantised, then the plain sharded K7
    math."""
    LAUNCHES["flash_sharded_paged_decode_quant_ref"] += 1
    dh = q.shape[-1]
    k = dequantize_kv(k_pages, k_scale, dh)
    v = dequantize_kv(v_pages, v_scale, dh)
    k, v, spos = _gather_shards(k, v, block_table, page_pos)
    return _decode_math(q, k, v, q_pos, spos, causal=causal, window=window, scale=None)


def _check_paged(name, q, k_pages, v_pages, q_pos, block_table, page_pos,
                 page_dtype, width):
    """Shared argument checks of K7 and K8; returns q_pos as (B, Lq)
    contiguous int32 and the strides of q, k_pages, v_pages, block_table
    and page_pos (each tensor's read once: the wrappers are on the decode
    step's host path)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or q.dim() != 4:
        raise ValueError(f"{name} kernel takes float32 or bfloat16 q (B,Lq,H,dh), "
                         f"got {q.dtype} {tuple(q.shape)}")
    B, Lq, H, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name} kernel: k/v pages (n_pages,ps,KV,w) of one shape, "
                         f"got {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    n_pages, ps, KV, w = k_pages.shape
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise ValueError(f"{name} kernel: pages must be {page_dtype}, got "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if w != width:
        raise ValueError(f"{name} kernel: pages of width {w} do not fit q's head "
                         f"dim {dh} (want {width})")
    if H % KV or dh > 256:
        raise ValueError(f"{name} kernel: H={H} must be a multiple of KV={KV} "
                         f"and dh={dh} at most 256")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or page_pos.shape != (n_pages, ps):
        raise ValueError(f"{name} kernel: block_table (B,nb) and page_pos "
                         f"(n_pages,ps); got {tuple(block_table.shape)}, "
                         f"{tuple(page_pos.shape)}")
    if q_pos.shape not in ((B,), (B, Lq)):
        raise ValueError(f"{name} kernel: q_pos (B,) or (B,Lq), got {tuple(q_pos.shape)}")
    for t in (q_pos, block_table, page_pos):
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name} kernel: q_pos, block_table and page_pos must "
                             f"be int32 on {q.device}")
    strides = [t.stride() for t in (q, k_pages, v_pages, block_table, page_pos)]
    qs, ks, vs, bts, pps = strides
    if bts[1] != 1 or pps[1] != 1:
        raise ValueError(f"{name} kernel: block_table and page_pos need contiguous rows")
    if qs[3] != 1 or qs[2] != dh:
        raise ValueError(f"{name} kernel: q needs contiguous (heads, dh) rows; "
                         f"strides {qs}")
    for nm, x, xs in (("k_pages", k_pages, ks), ("v_pages", v_pages, vs)):
        if x.device != q.device or xs[3] != 1 or xs[2] != w:
            raise ValueError(f"{name} kernel: {nm} must lie on {q.device} with "
                             f"contiguous (kv heads, w) rows; strides {xs}")
    if q_pos.numel() == B * Lq and q_pos.is_contiguous():
        return q_pos, strides          # (B,) at Lq 1 or (B, Lq): already the kernel's layout
    return q_pos.reshape(B, -1).expand(B, Lq).contiguous(), strides


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(B: int, KV: int, nb: int, device):
    """(split count, block-table entries per split) of K7's key range,
    from the shapes alone: enough splits for two blocks per SM, at most one
    per table entry. Never read from the table or page_pos: that would
    cost a host sync per layer."""
    splits = -(-2 * _sm_count(device.index) // (B * KV))
    per = -(-nb // max(1, min(nb, splits)))
    return -(-nb // per), per


def flash_paged_decode_cuda(q, k_pages, v_pages, q_pos, block_table, page_pos, *,
                            causal: bool = True, window: int = 0,
                            scale: float | None = None):
    """Launch K7 on q's current CUDA stream; returns (B, Lq, H, dh). The
    pool is read in place through its strides: no pad, no transpose. The
    keys are split over blocks (:func:`_splits`); the per-split partials
    (acc, then (m, l) per row, in one f32 scratch allocated here) are
    merged by a second kernel, the two launches counted as one."""
    qp, (qs, ks, vs, bts, pps) = _check_paged("K7", q, k_pages, v_pages, q_pos,
                                              block_table, page_pos, q.dtype, q.shape[-1])
    B, Lq, H, dh = q.shape
    _, ps, KV, _ = k_pages.shape
    nb = block_table.shape[1]
    nsplit, per = _splits(B, KV, nb, q.device)
    rows = nsplit * B * KV * Lq * (H // KV)
    o = torch.empty((B, Lq, H, dh), dtype=q.dtype, device=q.device)
    part = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_paged_decode")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), qp.data_ptr(),
             block_table.data_ptr(), page_pos.data_ptr(), o.data_ptr(),
             part.data_ptr(), part.data_ptr() + 4 * rows * dh,
             B, Lq, H, KV, dh, ps, nb, nsplit, per,
             qs[0], qs[1], ks[0], ks[1], vs[0], vs[1], bts[0], pps[0],
             Lq * H * dh, H * dh, int(causal), int(window),
             dh ** -0.5 if scale is None else float(scale), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_paged_decode", err)
    LAUNCHES["flash_paged_decode"] += 1
    return o


def flash_paged_decode_quant_cuda(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                                  block_table, page_pos, *, causal: bool = True,
                                  window: int = 0):
    """Launch K8 on q's current CUDA stream; returns (B, Lq, H, dh). int4
    iff the pages' last dim is dh/2; the scale group is dh / ngr. Split
    over the keys as K7 (:func:`_splits`), the two launches counted as
    one."""
    dh = q.shape[-1]
    width = k_pages.shape[-1] if k_pages.dim() == 4 else -1
    try:
        bits = quant_bits(width, dh)
    except ValueError as e:
        raise ValueError(f"K8 kernel: {e}") from None
    qp, (qs, ks, vs, bts, pps) = _check_paged("K8", q, k_pages, v_pages, q_pos,
                                              block_table, page_pos, torch.int8, width)
    B, Lq, H, _ = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    ngr = k_scale.shape[-1] if k_scale.dim() == 4 else 0
    kss, vss = k_scale.stride(), v_scale.stride()
    for nm, s, ss in (("k_scale", k_scale, kss), ("v_scale", v_scale, vss)):
        if (s.shape != (n_pages, ps, KV, ngr) or s.dtype != torch.float32
                or s.device != q.device or ss[3] != 1 or ss[2] != ngr):
            raise ValueError(f"K8 kernel: {nm} must be f32 (n_pages,ps,KV,ngr) with "
                             f"contiguous (kv heads, groups) rows on {q.device}")
    if ngr < 1 or dh % ngr:
        raise ValueError(f"K8 kernel: {ngr} scale groups must divide dh={dh}")
    nb = block_table.shape[1]
    nsplit, per = _splits(B, KV, nb, q.device)
    rows = nsplit * B * Lq * H
    o = torch.empty((B, Lq, H, dh), dtype=q.dtype, device=q.device)
    part = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_paged_decode_quant")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
             v_scale.data_ptr(), qp.data_ptr(), block_table.data_ptr(),
             page_pos.data_ptr(), o.data_ptr(), part.data_ptr(),
             part.data_ptr() + 4 * rows * dh,
             B, Lq, H, KV, dh, ps, nb, ngr, bits, nsplit, per,
             qs[0], qs[1], ks[0], ks[1], vs[0], vs[1], kss[0], kss[1], vss[0], vss[1],
             bts[0], pps[0], Lq * H * dh, H * dh,
             int(causal), int(window), dh ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_paged_decode_quant", err)
    LAUNCHES["flash_paged_decode_quant"] += 1
    return o


def _fold_shards(name, block_table, table, *pools):
    """The sharded wrappers' fold: each pool tensor (dp, n_pages/dp, ...)
    as a (n_pages, ...) view, and the block table with the shard offsets
    applied (``table``, when the caller made it once a step, must be
    that: (B, nb) int32)."""
    if block_table.dim() != 3 or any(p.shape[0] != block_table.shape[0] for p in pools):
        raise ValueError(f"{name}: a sharded block_table (dp,B/dp,nb) and pools with the "
                         f"same leading shard axis; got {tuple(block_table.shape)} and "
                         f"{[tuple(p.shape) for p in pools]}")
    dp, bs, nb = block_table.shape
    if table is None:
        table = shard_offset_table(block_table, pools[0].shape[1])
    elif table.shape != (dp * bs, nb) or table.dtype != block_table.dtype:
        raise ValueError(f"{name}: the offset table must be {(dp * bs, nb)} "
                         f"{block_table.dtype}, got {tuple(table.shape)} {table.dtype}")
    return [p.view(-1, *p.shape[2:]) for p in pools], table


def flash_sharded_paged_decode_cuda(q, k_pages, v_pages, q_pos, block_table, page_pos,
                                    *, causal: bool = True, window: int = 0,
                                    scale: float | None = None, table=None):
    """K7 over per-replica shards: the pools folded (views), the ids
    offset (or ``table``, the offset ids made once a step for every layer:
    ``models.attention.paged_write``), one K7 launch for the whole batch;
    returns (B, Lq, H, dh)."""
    (kg, vg, pg), table = _fold_shards("sharded K7", block_table, table,
                                       k_pages, v_pages, page_pos)
    o = flash_paged_decode_cuda(q, kg, vg, q_pos, table, pg, causal=causal,
                                window=window, scale=scale)
    LAUNCHES["flash_sharded_paged_decode"] += 1
    return o


def flash_sharded_paged_decode_quant_cuda(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                                          block_table, page_pos, *, causal: bool = True,
                                          window: int = 0, table=None):
    """K8 over per-replica shards, folded and offset as
    :func:`flash_sharded_paged_decode_cuda`; one K8 launch."""
    (kg, vg, ksg, vsg, pg), table = _fold_shards(
        "sharded K8", block_table, table, k_pages, v_pages, k_scale, v_scale, page_pos)
    o = flash_paged_decode_quant_cuda(q, kg, vg, ksg, vsg, q_pos, table, pg,
                                      causal=causal, window=window)
    LAUNCHES["flash_sharded_paged_decode_quant"] += 1
    return o
