"""GQA attention of the dense slice (``repro/models/attention.py``).

Covers the self-attention variants: grouped-query attention with any
H/KV ratio (MQA included), RoPE, optional per-head qk-norm (qwen3) and QKV
bias (qwen2), and sliding-window attention with a ring-buffer KV cache
(h2o-danube); and gated cross-attention over precomputed image
embeddings (llama-3.2-vision, the xattn kind).

Training and prefill attention go through K3 (forward) and, under
autograd, K4/K5 (backward); decode attention goes through K6 over the
dense slot cache, K7 over a paged pool (fp, or the rank-r coefficients of
an svd pool) and K8 over an int8 / int4 pool -- all by way of
:mod:`repro_torch.kernels.ops`: the plain PyTorch versions for CPU
tensors, the hand-written CUDA kernels for CUDA tensors. The Q/K/V
projections run through the ``attn.qkv`` site of the run's plan: one
compressed state per layer backs all three weight gradients (Fig. 2).

Cross-attention (:func:`cross_attn`) takes Q from the text stream
through ``attn.qkv`` (``wq`` alone) and K/V from the image embeddings
through a second site, ``attn.cross_kv``; it has no RoPE and no causal
mask. At training and prefill its Lq != Lk attention is the chunked
einsum :func:`sdpa`, as in the JAX package, which has no TPU kernel for
it either; decode (:func:`cross_attn_decode`) runs K6 non-causal over the
image K/V that prefill cached (:class:`XAttnCache`).

The KV caches are updated in place (``cache_insert``, ``paged_insert``,
``paged_insert_quant``): the JAX package returns a new cache and donates
the old buffers on the TPU, which the port gets for free by writing into
the slab or the pool. A decode-time write never synchronises with the
host: rows that must not land (a parked slot, an unmapped page) are
redirected onto another row's write of the same value (:class:`RowWrite`),
and a paged write's addresses are computed once per step for all layers
together, each layer's through its own block table.

A paged node may be split into per-replica shards (``sharded``; made by
``serve/cache.shard_slots`` for an engine on a data mesh): its pool
tensors carry a shard axis ahead of the page axis, its block table holds
slot-contiguous chunks of the batch with page ids local to their shard,
and a decode step writes and reads each chunk through its own shard's
table (K7 / K8 by way of the sharded wrappers in
:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.plan import SiteCtx, exact_ctx
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import quant_bits, quantize_kv, shard_offset_table
from repro_torch.kernels.ring_attention import ring_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.runtime.collectives import copy_to_model, seq_param, tp_enter, tp_exit
from repro_torch.runtime.sharding import model_group, ring_context

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg, dtype, *, cross: bool = False) -> dict:
    """``cross``: a cross-attention layer, which adds the scalar
    ``gate_attn`` (zero, so tanh(gate) = 0 and the layer starts as the
    identity)."""
    kv, d, dh, h = cfg.n_kv_heads, cfg.d_model, cfg.head_dim, cfg.n_heads
    params = {
        "wq": dense_init(gen, d, h * dh, dtype),
        "wk": dense_init(gen, d, kv * dh, dtype),
        "wv": dense_init(gen, d, kv * dh, dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        params["bq"], params["bk"], params["bv"] = zeros(h * dh), zeros(kv * dh), zeros(kv * dh)
    if cfg.qk_norm:
        params["q_norm"], params["k_norm"] = zeros(dh), zeros(dh)
    if cross:
        params["gate_attn"] = torch.zeros((), dtype=dtype, device=gen.device)
    return params


def _tp_heads(params, cfg, mg) -> dict:
    """This rank's attention parameters under tensor parallelism: wq / bq
    and wo hold its H/tp q heads already; the K/V leaves its KV/tp heads,
    or, when the model axis cannot split them, all KV heads, of which it
    takes the one its q heads read (``runtime.sharding``'s check: they
    fall in one group). Leaves whole on every rank whose gradient is a
    part on each (the K/V leaves then, q_norm / k_norm always) pass
    through :func:`copy_to_model`, which sums it over the model group."""
    out = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in out:
            out[name] = copy_to_model(out[name], mg)
    if mg.kv:
        return out
    dh = cfg.head_dim
    hl = cfg.n_heads // mg.tp
    g = cfg.n_heads // cfg.n_kv_heads
    kvh = mg.index * hl // g
    for name in ("wk", "wv", "bk", "bv"):
        if name in out:
            out[name] = copy_to_model(out[name], mg)[..., kvh * dh:(kvh + 1) * dh]
    return out


def _project_qkv(params, x, ctx: SiteCtx, cfg, key=None, kv_src=None):
    """Q from x; K, V from ``kv_src`` (None: x, self-attention). Self-
    attention shares one site, ``attn.qkv``; cross-attention takes Q
    through ``attn.qkv`` (``wq`` alone) and K, V through ``attn.cross_kv``,
    two sites whose draws differ by their site ids (the JAX order). The
    head counts come from the weights, so under tensor parallelism they
    are this rank's: column-parallel products over a whole x (and over
    the whole ``kv_src`` rows, the same on every rank)."""
    dh = cfg.head_dim
    mg = model_group()
    if mg is not None and mg.heads:
        params = _tp_heads(params, cfg, mg)
    h = params["wq"].shape[1] // dh
    kv = params["wk"].shape[1] // dh
    biases = [params.get("bq"), params.get("bk"), params.get("bv")]
    if kv_src is None:
        kv_src = x
        q, k, v = ctx.apply_shared(
            "attn.qkv", x, [params["wq"], params["wk"], params["wv"]], biases, key)
    else:
        (q,) = ctx.apply_shared("attn.qkv", x, [params["wq"]], biases[:1], key)
        k, v = ctx.apply_shared("attn.cross_kv", kv_src, [params["wk"], params["wv"]],
                                biases[1:], key)
    q = q.reshape(*x.shape[:-1], h, dh)
    k = k.reshape(*kv_src.shape[:-1], kv, dh)
    v = v.reshape(*kv_src.shape[:-1], kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked attention (cross-attention at training and prefill)
# ---------------------------------------------------------------------------
def sdpa(q, k, v, q_pos, k_pos, *, causal: bool, window: int, chunk: int):
    """q: (B,Lq,H,dh); k,v: (B,Lk,KV,dh); *_pos: (B, L*) (-1 = invalid).
    Position-masked attention over query chunks in f32 einsums; returns
    (B, Lq, H, dh). On the main path for cross-attention's Lq != Lk
    attention (:func:`cross_attn`), which K3 does not take; the tests
    also hold the self-attention kernels' plain versions against it."""
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    k32, v32 = k.float(), v.float()
    outs = []
    for s in range(0, Lq, chunk):
        qb = q[:, s:s + chunk]
        qp = q_pos[:, s:s + chunk]
        n = qb.shape[1]
        qg = qb.reshape(B, n, KV, G, dh).float()
        scores = torch.einsum("bqkgd,blkd->bkgql", qg, k32) * dh ** -0.5
        kp = k_pos[:, None, None, None, :]
        qq = qp[:, None, None, :, None]
        mask = kp >= 0
        if causal:
            mask = mask & (kp <= qq)
        if window > 0:
            mask = mask & (qq - kp < window)
        mask = mask & (qq >= 0)
        probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        out = torch.einsum("bkgql,blkd->bqkgd", probs, v32)
        outs.append(out.reshape(B, n, H, dh).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
class _CacheNode:
    """A cache node's device leaves (``LEAVES``), each stacked over the
    layers of its stage on a leading axis; :meth:`layer` gives one layer's
    views. ``ring`` is host metadata here, not a device leaf as in JAX."""

    LEAVES: ClassVar[tuple[str, ...]] = ()

    def layer(self, r: int):
        return dataclasses.replace(self, **{f: getattr(self, f)[r] for f in self.LEAVES})

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in self.LEAVES)


@dataclasses.dataclass
class KVCache(_CacheNode):
    """Dense slot cache. Per layer: k, v (B, S, KV, dh) and slot_pos (B, S)
    int32, the absolute position held by each slot (-1 = empty); S is
    max_len, or the window for a ring cache."""

    LEAVES: ClassVar[tuple[str, ...]] = ("k", "v", "slot_pos")
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    ring: bool


@dataclasses.dataclass
class XAttnCache(_CacheNode):
    """Cross-attention cache: per layer the image K, V (B, vision_tokens,
    KV, dh) that prefill computed, read by every decode step and never
    written by one. It is a dense slot cache under either serving layout
    (a fixed size a slot, no pages). ``q_pos`` (B,) zeros and ``slot_pos``
    (B, vision_tokens) arange, int32, are K6's query and key positions:
    every image slot is live for every row, a parked one too (the JAX
    ``cross_attn_decode``'s ``qpos = 0``). They are not leaves: made once
    by :func:`init_xattn_cache` for the node's batch, shared by its layer
    views, and left alone by the slot splices."""

    LEAVES: ClassVar[tuple[str, ...]] = ("k", "v")
    k: torch.Tensor
    v: torch.Tensor
    q_pos: torch.Tensor
    slot_pos: torch.Tensor


def init_xattn_cache(B: int, S: int, kv: int, dh: int, dtype, device,
                     layers: int | None = None) -> XAttnCache:
    lead = () if layers is None else (layers,)
    return XAttnCache(k=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
                      v=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
                      q_pos=torch.zeros((B,), dtype=torch.int32, device=device),
                      slot_pos=torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1))


def init_kv_cache(B: int, S: int, kv: int, dh: int, dtype, ring: bool,
                  device, layers: int | None = None) -> KVCache:
    lead = () if layers is None else (layers,)
    return KVCache(
        k=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
        v=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
        slot_pos=torch.full(lead + (B, S), -1, dtype=torch.int32, device=device),
        ring=bool(ring),
    )


def cache_insert(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Write Ln new entries (B, Ln, KV, dh) at their absolute positions
    (B, Ln), in place: slot = position (ring: modulo S); a position < 0,
    or past S in a non-ring cache, is dropped (JAX's ``mode="drop"``).

    With Ln == 1 (decode) each row writes one slot, so the update is a
    gather-select-scatter with no host sync: a dropped row writes back the
    value it read. With Ln > 1 (prefill) the valid entries are compacted;
    in a ring only each row's last S positions are kept, which is the
    last-write-wins result of writing the (distinct, increasing) positions
    in order."""
    B, S = cache.slot_pos.shape
    slots = positions % S if cache.ring else positions
    valid = positions >= 0
    if not cache.ring:
        valid = valid & (positions < S)
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)
    positions = positions.to(cache.slot_pos.dtype)
    if positions.shape[1] == 1:
        b = torch.arange(B, device=positions.device)[:, None]
        idx = torch.where(valid, slots, 0).long()
        keep = valid[..., None, None]
        cache.k[b, idx] = torch.where(keep, k_new, cache.k[b, idx])
        cache.v[b, idx] = torch.where(keep, v_new, cache.v[b, idx])
        cache.slot_pos[b, idx] = torch.where(valid, positions, cache.slot_pos[b, idx])
        return cache
    if cache.ring:
        last = torch.where(valid, positions, -1).amax(dim=1, keepdim=True)
        valid = valid & (positions > last - S)
    bi, li = valid.nonzero(as_tuple=True)
    si = slots[bi, li].long()
    cache.k[bi, si] = k_new[bi, li]
    cache.v[bi, si] = v_new[bi, li]
    cache.slot_pos[bi, si] = positions[bi, li]
    return cache


@dataclasses.dataclass
class RowWrite:
    """Where M new rows land in a flat ``(N, ...)`` view, without a host
    sync: ``dst[target[m]] = rows[source[m]]``. A row that must not land
    is redirected onto the first valid row's address with that row's
    value (a duplicate write of equal bytes); with no valid row at all,
    onto ``dst[base]`` with its own value (``any_valid`` False). The valid
    rows' addresses are distinct (pages are owned by one slot, or shared
    only below the slot's write front). One plan serves every tensor of a
    node; a stacked node's plan has a leading layer axis, and
    :meth:`layer` gives one layer's plan. A sharded node's plan is made per
    shard (each redirect stays in its shard) and carries ``table``, the
    node's block table with the shard offsets applied (ids into the
    shard-folded pool, (..., B, nb)), which the kernel route of the
    sharded decode wrappers reads: made here once a step for every
    layer."""

    target: torch.Tensor     # (..., M) long
    source: torch.Tensor     # (..., M) long
    any_valid: torch.Tensor  # (..., M) bool, one value per plan
    table: torch.Tensor | None = None

    @classmethod
    def of(cls, idx, valid, base=0) -> "RowWrite":
        """``idx``, ``valid`` (..., M): one plan per leading index;
        ``base`` (broadcast against (..., 1)): where a plan with no valid
        row writes its own value back."""
        idx = idx.long()
        # gather, not idx[first]: a 0-dim CUDA index is read to the host
        first = valid.to(torch.int32).argmax(-1, keepdim=True)
        any_valid = valid.any(-1, keepdim=True)
        fallback = torch.where(any_valid, idx.gather(-1, first), base)
        source = torch.where(valid, torch.arange(idx.shape[-1], device=idx.device), first)
        return cls(torch.where(valid, idx, fallback), source, any_valid.expand_as(valid))

    def layer(self, r: int) -> "RowWrite":
        return RowWrite(self.target[r], self.source[r], self.any_valid[r],
                        None if self.table is None else self.table[r])

    def apply(self, dst, rows) -> None:
        """Write ``rows`` (M, ...) into ``dst`` (N, ...), in place."""
        rows = rows.reshape(-1, *dst.shape[1:]).to(dst.dtype).index_select(0, self.source)
        keep = self.any_valid.reshape(-1, *[1] * (rows.dim() - 1))
        dst.index_put_((self.target,), torch.where(keep, rows,
                                                   dst.index_select(0, self.target)))


@dataclasses.dataclass
class PagedKVCache(_CacheNode):
    """Paged decode cache: one page pool per layer plus per-slot block
    tables, so cache residency tracks the tokens admitted instead of a
    dense ``(B, max_len, ...)`` worst case. Per layer: k_pages, v_pages
    (n_pages, page_size, KV, dh); page_pos (n_pages, page_size) int32
    absolute position per page row (-1 = empty); block_table (B, nb) int32
    physical page of logical block j (-1 = unmapped). Logical layout per
    sequence is :class:`KVCache`'s: absolute positions, a ring of logical
    size nb * page_size for sliding-window layers.

    ``sharded`` (host metadata, like ``ring``; every paged layout has it):
    the pool is split into dp per-replica shards -- per layer k_pages /
    v_pages (dp, n_pages/dp, page_size, KV, w), page_pos (dp, n_pages/dp,
    page_size), block_table (dp, B/dp, nb) with page ids local to their
    shard; shard s owns slots [s B/dp, (s+1) B/dp)."""

    LEAVES: ClassVar[tuple[str, ...]] = ("k_pages", "v_pages", "page_pos", "block_table")
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_pos: torch.Tensor
    block_table: torch.Tensor
    ring: bool
    sharded: bool = False


@dataclasses.dataclass
class QuantPagedKVCache(_CacheNode):
    """Paged decode cache with int8 or nibble-packed int4 pages (n_pages,
    page_size, KV, dh | dh/2) and f32 absmax scales k_scale / v_scale
    (n_pages, page_size, KV, ngr), one per ``dh // ngr``-wide group of a
    row. The format comes from the shapes: int4 iff the pages' last dim
    is dh / 2."""

    LEAVES: ClassVar[tuple[str, ...]] = ("k_pages", "v_pages", "k_scale", "v_scale",
                                         "page_pos", "block_table")
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page_pos: torch.Tensor
    block_table: torch.Tensor
    ring: bool
    sharded: bool = False


@dataclasses.dataclass
class SVDPagedKVCache(_CacheNode):
    """Paged decode cache storing K/V as rank-r coefficients (n_pages,
    page_size, KV, r) in per-layer, per-kv-head orthonormal bases k_basis /
    v_basis (KV, dh, r): decode projects q through the k basis, runs K7 on
    the coefficients with the original head dim's softmax scale, and maps
    the output back through the v basis."""

    LEAVES: ClassVar[tuple[str, ...]] = ("k_pages", "v_pages", "k_basis", "v_basis",
                                         "page_pos", "block_table")
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_basis: torch.Tensor
    v_basis: torch.Tensor
    page_pos: torch.Tensor
    block_table: torch.Tensor
    ring: bool
    sharded: bool = False


# every paged cache layout the serving engine pools and allocates
PAGED_CACHE_TYPES = (PagedKVCache, QuantPagedKVCache, SVDPagedKVCache)


def _paged_common(B, logical, page_size, n_pages, device, lead):
    if logical % page_size:
        raise ValueError(f"logical cache size {logical} is not a multiple of "
                         f"page_size {page_size}")
    return dict(
        page_pos=torch.full(lead + (n_pages, page_size), -1, dtype=torch.int32,
                            device=device),
        block_table=torch.full(lead + (B, logical // page_size), -1,
                               dtype=torch.int32, device=device))


def init_paged_kv_cache(B: int, logical: int, page_size: int, n_pages: int,
                        kv: int, dh: int, dtype, ring: bool, device,
                        layers: int | None = None) -> PagedKVCache:
    """``logical`` (per-sequence logical size: the dense S rounded up to a
    page multiple) must divide into whole pages."""
    lead = () if layers is None else (layers,)
    shape = lead + (n_pages, page_size, kv, dh)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        ring=bool(ring), **_paged_common(B, logical, page_size, n_pages, device, lead))


def init_quant_paged_kv_cache(B: int, logical: int, page_size: int, n_pages: int,
                              kv: int, dh: int, bits: int, ngr: int, ring: bool,
                              device, layers: int | None = None) -> QuantPagedKVCache:
    if bits not in (8, 4):
        raise ValueError(f"quantised pools hold int8 or int4, got {bits} bits")
    lead = () if layers is None else (layers,)
    shape = lead + (n_pages, page_size, kv, dh if bits == 8 else dh // 2)
    sshape = lead + (n_pages, page_size, kv, ngr)
    return QuantPagedKVCache(
        k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
        v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        ring=bool(ring), **_paged_common(B, logical, page_size, n_pages, device, lead))


def init_svd_paged_kv_cache(B: int, logical: int, page_size: int, n_pages: int,
                            kv: int, dh: int, r: int, dtype, ring: bool, device,
                            layers: int | None = None) -> SVDPagedKVCache:
    """The bases start as the identity prefix (exact at r == dh);
    ``serve/cache.install_svd_bases`` replaces them per layer."""
    if not 1 <= r <= dh:
        raise ValueError(f"svd rank {r} must lie in [1, {dh}]")
    lead = () if layers is None else (layers,)
    shape = lead + (n_pages, page_size, kv, r)
    eye = torch.eye(dh, r, dtype=torch.float32, device=device)
    return SVDPagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        k_basis=eye.expand(lead + (kv, dh, r)).clone(),
        v_basis=eye.expand(lead + (kv, dh, r)).clone(),
        ring=bool(ring), **_paged_common(B, logical, page_size, n_pages, device, lead))


def paged_addresses(positions, block_table, ring: bool, page_size: int, nb: int):
    """(page, offset) of absolute ``positions`` (N, L) through
    ``block_table`` (N, nb). An invalid position (< 0, or past the logical
    size of a non-ring table) or an unmapped block gives page -1. Ring
    tables wrap at the logical size nb * page_size, like the dense ring's
    ``positions % S``."""
    logical = nb * page_size
    safe = positions.clamp_min(0)
    idx = safe % logical if ring else safe
    valid = positions >= 0
    if not ring:
        valid = valid & (positions < logical)
    blk = (idx // page_size).clamp_max(nb - 1).long()
    page = torch.gather(block_table, 1, blk)
    page = torch.where(valid & (page >= 0), page, -1)
    return page, idx % page_size


def paged_cache_sharded(cache) -> bool:
    """True for a paged node split into per-replica shards (``sharded``),
    stacked or one layer's view."""
    return isinstance(cache, PAGED_CACHE_TYPES) and cache.sharded


def _shard_fold(a, dp: int):
    """(B, ...) -> (dp, B/dp, ...): slot-major contiguous chunks, so shard
    ``s`` owns slots [s B/dp, (s+1) B/dp) -- the engine's slot -> shard
    map."""
    return a.reshape(dp, a.shape[0] // dp, *a.shape[1:])


def paged_write(cache, positions) -> RowWrite:
    """Where the rows at ``positions`` (B, L) land in the cache's flat
    (n_pages * page_size, ...) pool view: through the block table, with
    invalid positions and unmapped blocks dropped. A stacked node (tables
    (layers, B, nb)) gets one plan per layer, each through its own
    layer's table, computed together: ``decode_step`` builds it once per
    step and hands layer ``r`` its :meth:`RowWrite.layer`. A sharded
    node's rows split into their shards' slot chunks, each planned through
    its own shard's table into that shard's page range of the
    shard-folded view (no write crosses a shard), and the plan carries
    the offset table the sharded decode wrappers read."""
    ps = cache.k_pages.shape[-3]
    bt = cache.block_table
    L = positions.shape[-1]
    if not cache.sharded:
        lead, nb = bt.shape[:-2], bt.shape[-1]
        pos = positions.expand(*lead, *positions.shape).reshape(-1, L)
        page, off = paged_addresses(pos, bt.reshape(-1, nb), cache.ring, ps, nb)
        page, off = page.reshape(*lead, -1), off.reshape(*lead, -1)
        return RowWrite.of(page.clamp_min(0).long() * ps + off.long(), page >= 0)
    lead, (dp, bs, nb) = bt.shape[:-3], bt.shape[-3:]
    npl = cache.k_pages.shape[-4]
    pos = _shard_fold(positions, dp).expand(*lead, dp, bs, L).reshape(-1, L)
    page, off = paged_addresses(pos, bt.reshape(-1, nb), cache.ring, ps, nb)
    page, off = page.reshape(*lead, dp, bs * L), off.reshape(*lead, dp, bs * L)
    base = (torch.arange(dp, device=bt.device) * (npl * ps))[:, None]
    plan = RowWrite.of(page.clamp_min(0).long() * ps + off.long() + base, page >= 0, base)
    source = plan.source + torch.arange(dp, device=bt.device)[:, None] * (bs * L)
    return RowWrite(plan.target.flatten(-2), source.flatten(-2),
                    plan.any_valid.flatten(-2), shard_offset_table(bt, npl))


def _rows(t, trailing: int):
    """A pool tensor as a flat (rows, *trailing dims) view: every page row
    of every shard, in page order."""
    return t.view(-1, *t.shape[t.dim() - trailing:])


def paged_insert(cache, k_new, v_new, positions, write: RowWrite | None = None):
    """Insert L decode rows (B, L, KV, w) at ``positions`` (B, L) through
    the block table, in place -- L = 1 is the decode step, L > 1 the
    speculative-verify block. Invalid positions and unmapped blocks are
    dropped. Works on any pool whose pages match ``k_new``'s trailing dims
    (fp pools, and the svd pool's rank-r pools), sharded or not: a
    sharded node's rows land through their own shard's table.
    ``write``: the step's :func:`paged_write`, when the caller has it."""
    write = paged_write(cache, positions) if write is None else write
    write.apply(_rows(cache.k_pages, 2), k_new)
    write.apply(_rows(cache.v_pages, 2), v_new)
    write.apply(_rows(cache.page_pos, 0), positions)
    return cache


def quant_cache_bits(cache: QuantPagedKVCache, dh: int) -> int:
    return quant_bits(cache.k_pages.shape[-1], dh)


def paged_insert_quant(cache: QuantPagedKVCache, k_new, v_new, positions,
                       dh: int, write: RowWrite | None = None) -> QuantPagedKVCache:
    """Quantise-on-write: L decode rows (B, L, KV, dh) become int pages and
    scales at their block-table addresses, in place (sharded or not, as
    :func:`paged_insert`)."""
    bits, ngr = quant_cache_bits(cache, dh), cache.k_scale.shape[-1]
    kq, ks = quantize_kv(k_new, bits, ngr)
    vq, vs = quantize_kv(v_new, bits, ngr)
    write = paged_write(cache, positions) if write is None else write
    for dst, src in ((cache.k_pages, kq), (cache.v_pages, vq),
                     (cache.k_scale, ks), (cache.v_scale, vs)):
        write.apply(_rows(dst, 2), src)
    write.apply(_rows(cache.page_pos, 0), positions)
    return cache


# The JAX package's names for the sharded route (``jax.vmap`` of the single
# pool's insert over the shard axis); here one in-place insert serves both
# layouts, each shard's rows through its own table.
sharded_paged_insert = paged_insert
sharded_paged_insert_quant = paged_insert_quant


def svd_project_kv(x, basis):
    """(B, L, KV, dh) through (KV, dh, r) -> (B, L, KV, r) coefficients, f32."""
    return torch.einsum("blkd,kdr->blkr", x.float(), basis.float())


# ---------------------------------------------------------------------------
# block-level entry points
# ---------------------------------------------------------------------------
def attn_train(params, x, positions, cfg, ctx: SiteCtx, key=None, *, window: int):
    """Self-attention over a full sequence (training / prefill math).

    Differentiable: ``ops.flash_attention`` runs K3 forward and, under
    autograd, K4/K5 backward from the saved (q, k, v, o, lse). The kernels
    mask by iota, i.e. they assume contiguous ``arange`` positions (true
    for the training batch and prefill; ``positions`` feeds RoPE). Rows
    marked with a position < 0 are zeroed, as the JAX kernel branch does.
    Inside a context-parallel block of the mesh executor
    (``runtime.sharding.ring_context``) x is this rank's zigzag shard of
    the sequence, ``positions`` its global positions, and the ring
    (``kernels/ring_attention.py``) runs K3-K5 over every live chunk pair.
    ``key``: the block's key, from which the ``attn.qkv`` site draws.
    Under tensor parallelism (``runtime.sharding.model_group``) with the
    heads split, x enters whole on every model rank (gathered over the
    sequence under ``seq_shard``), Q/K/V are column-parallel, K3-K5 run
    at this rank's head counts, and ``out @ wo`` is row-parallel, summed
    over the model group (or reduce-scattered over the sequence).
    Returns (out @ wo, (k_roped, v)) -- the pair the prefill cache stores.
    """
    mg = model_group()
    split = mg is not None and mg.heads
    x = tp_enter(x, mg, split)
    q, k, v = _project_qkv(params, x, ctx, cfg, key)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ring = ring_context()
    if ring is not None:
        out = ring_attention(q, k, v, ring=ring, causal=True, window=window)
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        out = torch.where(positions[..., None, None] >= 0, out, 0.0)
    out = out.reshape(*x.shape[:-1], -1)
    return tp_exit(out @ params["wo"].to(x.dtype), mg, split), (k, v)




def attn_decode(params, x, positions, cache, cfg, *, window: int,
                write: RowWrite | None = None):
    """Decode attention: x (B, L, d), positions (B, L) absolute (-1 =
    parked slot). L = 1 is the decode step; L > 1 the speculative-verify
    block (the drafted rows insert and score in one call, each masked by
    its own position). Inserts this step's K/V into the cache in place,
    then attends: K6 over a dense :class:`KVCache`, K7 over a
    :class:`PagedKVCache` or the coefficients of an
    :class:`SVDPagedKVCache`, K8 over a :class:`QuantPagedKVCache` -- a
    sharded pool's through the sharded wrappers, one launch for the whole
    batch. ``write``: the step's :func:`paged_write` for a paged cache."""
    q, k, v = _project_qkv(params, x, exact_ctx(), cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if paged_cache_sharded(cache):
        # the step's offset table, when the caller planned the step
        table = None if write is None else write.table
        paged_fn = functools.partial(ops.flash_sharded_paged_decode, table=table)
        quant_fn = functools.partial(ops.flash_sharded_paged_decode_quant, table=table)
    else:
        paged_fn, quant_fn = ops.flash_paged_decode, ops.flash_paged_decode_quant
    if isinstance(cache, QuantPagedKVCache):
        paged_insert_quant(cache, k, v, positions, cfg.head_dim, write)
        out = quant_fn(q, cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale,
                       positions, cache.block_table, cache.page_pos, causal=True,
                       window=window)
    elif isinstance(cache, SVDPagedKVCache):
        # scores in the rank-r space equal scores in head space with K
        # reconstructed through the same orthonormal basis, so K7 runs on
        # the coefficients; only the softmax scale stays the head dim's
        B, L, H, dh = q.shape
        kv, r = cache.k_pages.shape[-2], cache.k_pages.shape[-1]
        paged_insert(cache, svd_project_kv(k, cache.k_basis).to(x.dtype),
                     svd_project_kv(v, cache.v_basis).to(x.dtype), positions, write)
        qc = torch.einsum("blkgd,kdr->blkgr", q.reshape(B, L, kv, H // kv, dh).float(),
                          cache.k_basis.float())
        out = paged_fn(qc.reshape(B, L, H, r).to(q.dtype), cache.k_pages, cache.v_pages,
                       positions, cache.block_table, cache.page_pos, causal=True,
                       window=window, scale=dh ** -0.5)
        out = torch.einsum("blkgr,kdr->blkgd", out.reshape(B, L, kv, H // kv, r).float(),
                           cache.v_basis.float())
        out = out.reshape(B, L, H, dh).to(q.dtype)
    elif isinstance(cache, PagedKVCache):
        paged_insert(cache, k, v, positions, write)
        out = paged_fn(q, cache.k_pages, cache.v_pages, positions, cache.block_table,
                       cache.page_pos, causal=True, window=window)
    else:
        cache_insert(cache, k, v, positions)
        q_pos = positions.reshape(-1) if positions.shape[1] == 1 else positions
        out = ops.flash_decode(q, cache.k, cache.v, q_pos, cache.slot_pos,
                               causal=True, window=window)
    out = out.reshape(*x.shape[:-1], -1)
    return out @ params["wo"].to(x.dtype), cache


def cross_attn(params, x, image_embeds, cfg, ctx: SiteCtx, key=None, *, chunk: int,
               flash_sdp: bool = True):
    """Gated cross-attention (no RoPE, non-causal) for training and
    prefill: x (B, Lq, d) queries over ``image_embeds`` (B, Lk, d). The
    attention is :func:`sdpa`, recomputed in backward when ``flash_sdp``
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``): only q, k,
    v are kept, not the (Lq, Lk) probabilities. Returns
    (tanh(gate_attn) * out @ wo, (k, v)) -- the pair the prefill cache
    stores.

    Under tensor parallelism with the heads split, x enters as
    :func:`attn_train`'s does (gathered over the sequence under
    ``seq_shard``); ``image_embeds`` are whole on every model rank, never
    split over the sequence: ``attn.cross_kv`` compresses the same rows
    from the same key on every rank and K2 takes this rank's K/V columns
    (or, K/V heads the axis cannot split, its q heads' group of them).
    ``sdpa`` runs at this rank's heads and ``out @ wo`` is row-parallel.
    The gate multiplies the summed output (:func:`_gate`)."""
    mg = model_group()
    split = mg is not None and mg.heads
    x = tp_enter(x, mg, split)
    if split:
        image_embeds = copy_to_model(image_embeds, mg)
    q, k, v = _project_qkv(params, x, ctx, cfg, key, kv_src=image_embeds)
    B, Lq = x.shape[:2]
    Lk = image_embeds.shape[1]
    q_pos = torch.arange(Lq, dtype=torch.int32, device=x.device).expand(B, Lq)
    k_pos = torch.arange(Lk, dtype=torch.int32, device=x.device).expand(B, Lk)
    sdp = functools.partial(sdpa, q_pos=q_pos, k_pos=k_pos, causal=False, window=0,
                            chunk=chunk)
    if flash_sdp and torch.is_grad_enabled():
        out = checkpoint(sdp, q, k, v, use_reentrant=False)
    else:
        out = sdp(q, k, v)
    out = out.reshape(*x.shape[:-1], -1) @ params["wo"].to(x.dtype)
    return _gate(params["gate_attn"], out, mg, split), (k, v)


def _gate(gate, out, mg, split: bool):
    """``tanh(gate) * out`` on the residual stream: the row-parallel
    output leaves the model group first (:func:`tp_exit`), so the gate
    multiplies the sum, and its gradient is whole on every rank; a gate
    on the partial sums would get a part of it on each. Under
    ``seq_shard`` the sum is this rank's chunk of the sequence, and the
    gate's gradient is summed over the group (:func:`seq_param`)."""
    out = tp_exit(out, mg, split)
    return torch.tanh(seq_param(gate, mg).to(out.dtype)) * out


def cross_attn_decode(params, x, cache: XAttnCache, cfg):
    """Decode-time cross-attention: x (B, 1, d) over the cached image K/V
    through K6 non-causal (every slot live, ``q_pos`` 0). Reads the cache
    and writes nothing to it."""
    dh = cfg.head_dim
    h = params["wq"].shape[1] // dh
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(*x.shape[:-1], h, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    out = ops.flash_decode(q, cache.k, cache.v, cache.q_pos, cache.slot_pos, causal=False,
                           window=0)
    out = out.reshape(*x.shape[:-1], -1) @ params["wo"].to(x.dtype)
    return torch.tanh(params["gate_attn"].to(x.dtype)) * out
