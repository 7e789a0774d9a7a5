"""Slot-addressed decode-cache helpers (``repro/serve/cache.py``).

The engine owns ONE batched cache tree (``models.init_caches`` with B =
max_slots): a list per stage of stacked cache nodes whose tensors carry
the layer stack at axis 0. Dense nodes hold the batch slot at axis 1:
:class:`KVCache` -- ``k``/``v`` (layers, B, S, KV, dh), ``slot_pos``
(layers, B, S) -- and the recurrent :class:`SSMCache` -- ``state``
(layers, B, H, P, N), ``conv_state`` (layers, B, W-1, conv_dim). Paged
nodes hold page pools (layers, n_pages, page_size, KV, w), ``page_pos``
(layers, n_pages, page_size) and block tables (layers, B, nb), one row
per slot shared by every layer of the stack. Every node lists its device
tensors in ``tensors()``; the splices, copies and byte counts below walk
those.

Admission = prefill the request alone (batch 1, a dense cache), then
splice its cache into the slot. The JAX package returns new trees and
donates the old buffers on the TPU; the port writes the engine's cache in
place and never copies a whole cache. Dense: slice assignment of the
slot, every tensor of the node; a recurrent state node splices whole and
is never pad-masked (its arch prefills at the prompt's own length).
Paged: :func:`write_slot_paged` installs the slot's block-table row
(the only time a table changes: a request reserves its pages up front),
resets ``page_pos`` on the newly owned pages (they may carry a previous
owner's positions) and scatters the prompt's rows through the row --
quantised by the decode path's own quantiser for int8 / int4 pools,
projected into the layer's bases for svd pools. Eviction needs no reset:
a freed slot's decode position is parked at -1, which masks every key and
drops the write, and no live block table maps a freed page.

On a data mesh (an engine with ``mesh=``), :func:`shard_slots` splits
every paged node into per-replica shards: the pool and table tensors take
a shard axis after the layer axis, as views of the same storage. A
splice into a sharded node routes the global slot to (shard, local slot)
and splices that shard's sub-pool with the single-pool path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.flash_decode import quantize_kv
from repro_torch.models.attention import (PAGED_CACHE_TYPES, KVCache, PagedKVCache,
                                          QuantPagedKVCache, SVDPagedKVCache,
                                          paged_addresses, paged_cache_sharded,
                                          quant_cache_bits)
from repro_torch.runtime.sharding import dp_degree


def kv_cache_nodes(caches):
    """Every self-attention KV node (dense or paged) of a cache tree, in
    stage order."""
    for stage in caches:
        for node in stage:
            if isinstance(node, (KVCache,) + PAGED_CACHE_TYPES):
                yield node


def cache_nodes(caches):
    """Every node of a cache tree (KV, paged or recurrent state), in stage
    order."""
    for stage in caches:
        yield from stage


def map_tensors(node, fn):
    """Replace each of ``node``'s device tensors ``t`` by ``fn(t)``, in
    place. Returns ``node``."""
    for name in node.LEAVES:
        setattr(node, name, fn(getattr(node, name)))
    return node


def write_slot(full, one, slot: int):
    """Splice a batch-1 dense cache tree ``one`` into batch slot ``slot``
    of the dense tree ``full`` (every tensor of every node), in place;
    ``one`` may lie on another device (a Prefix handed off in host form).
    Returns ``full``."""
    for fn, on in zip(cache_nodes(full), cache_nodes(one)):
        for a, b in zip(fn.tensors(), on.tensors()):
            a[:, slot] = b[:, 0].to(device=a.device, dtype=a.dtype)
    return full


def read_slot(full, slot: int):
    """Copy batch slot ``slot`` of a dense tree out as a batch-1 tree (tests)."""
    return [[map_tensors(dataclasses.replace(node), lambda t: t[:, slot:slot + 1].clone())
             for node in stage] for stage in full]


def mask_pad_rows(caches, prompt_len: int):
    """Invalidate, in place, the K/V rows at positions >= ``prompt_len`` of
    a batch-1 prefill cache (the rows a length-bucketed prompt padded in):
    their ``slot_pos`` becomes -1, which every decode path treats as
    empty. Returns ``caches``."""
    for node in kv_cache_nodes(caches):
        node.slot_pos.masked_fill_(node.slot_pos >= prompt_len, -1)
    return caches


def park_positions(pos, active):
    """Decode positions with inactive slots parked at -1 (the decode
    kernels mask every key of a parked row; the cache inserts drop its
    write)."""
    return torch.where(active, pos, -1)


# ---------------------------------------------------------------------------
# paged splices
# ---------------------------------------------------------------------------
def _splice_targets(fc, oc: KVCache, row: np.ndarray, slot: int, prompt_len: int,
                    start: int):
    """Install ``row`` as ``slot``'s block table in every layer, reset
    ``page_pos`` of the row's fresh pages, and return the scatter targets
    of the prompt rows that land: (layer, page, offset) index tensors and
    the (layer, row) index of each in the prefill cache.

    ``start`` is the copy-on-write boundary in tokens (0 unshared): the
    row's first ``start // ps`` pages were adopted from a live prefix owner,
    so their ``page_pos`` is kept and the prompt rows below ``start`` are
    not scattered (they would land on the owner's pages). The partly
    shared page, if ``start`` is not page-aligned, is a fresh page whose
    leading rows arrive through :func:`cow_split_pages`."""
    nlayers, _, ps = fc.k_pages.shape[:3]
    nb = fc.block_table.shape[2]
    dev = fc.k_pages.device
    row_t = torch.as_tensor(np.asarray(row, np.int32), device=dev)
    fc.block_table[:, slot] = row_t
    fresh = [int(p) for j, p in enumerate(row) if p >= 0 and j >= start // ps]
    if fresh:
        fc.page_pos[:, torch.as_tensor(fresh, device=dev)] = -1
    spos = oc.slot_pos[:, 0].to(dev)
    spos = torch.where((spos >= start) & (spos < prompt_len), spos, -1)
    page, off = paged_addresses(spos, row_t.expand(nlayers, nb), fc.ring, ps, nb)
    # admission may read back to the host: keep only the rows that land
    li, si = (page >= 0).nonzero(as_tuple=True)
    return (li, page[li, si].long(), off[li, si].long()), (li, si), spos


def _splice_paged(fc, oc: KVCache, row, slot: int, prompt_len: int, start: int):
    """Scatter the batch-1 prefill cache ``oc`` into the pages of ``row``:
    fp pools as they are, int8 / int4 pools through :func:`quantize_kv`
    (the decode path's quantiser), svd pools projected into each layer's
    bases. ``fc`` may be a view (one shard of a sharded node): the rows
    are written through it."""
    target, src_at, spos = _splice_targets(fc, oc, row, slot, prompt_len, start)
    k, v = oc.k[:, 0].to(fc.k_pages.device), oc.v[:, 0].to(fc.k_pages.device)
    if isinstance(fc, QuantPagedKVCache):
        bits, ngr = quant_cache_bits(fc, k.shape[-1]), fc.k_scale.shape[-1]
        kq, ks = quantize_kv(k, bits, ngr)
        vq, vs = quantize_kv(v, bits, ngr)
        pairs = ((fc.k_pages, kq), (fc.v_pages, vq), (fc.k_scale, ks), (fc.v_scale, vs))
    elif isinstance(fc, SVDPagedKVCache):
        kc = torch.einsum("lskd,lkdr->lskr", k.float(), fc.k_basis.float())
        vc = torch.einsum("lskd,lkdr->lskr", v.float(), fc.v_basis.float())
        pairs = ((fc.k_pages, kc), (fc.v_pages, vc))
    else:
        pairs = ((fc.k_pages, k), (fc.v_pages, v))
    for dst, src in pairs + ((fc.page_pos, spos),):
        dst.index_put_(target, src[src_at].to(dst.dtype))


def _pool_fields(node) -> tuple[str, ...]:
    """The node's tensors that carry the page-pool / block-table layout,
    and so the shard axis of a sharded node; svd bases are per layer and
    shared by every shard."""
    if isinstance(node, QuantPagedKVCache):
        return ("k_pages", "v_pages", "k_scale", "v_scale", "page_pos", "block_table")
    return ("k_pages", "v_pages", "page_pos", "block_table")


# a stacked node or one layer's view alike (``sharded`` is host metadata)
paged_node_sharded = paged_cache_sharded


def _take_shard(node, shard: int):
    """Shard ``shard``'s sub-pool of a sharded stacked node as an unsharded
    stacked node ((layers, n_pages/dp, ...) pools, (layers, B/dp, nb)
    table): views, so a splice into it writes the shard in place."""
    return dataclasses.replace(node, sharded=False, **{
        f: getattr(node, f)[:, shard] for f in _pool_fields(node)})


def _put_shard(node, sub, shard: int) -> None:
    """Write a spliced sub-pool back into shard ``shard``: a copy only for
    a leaf that is not already that shard's view (a :func:`_take_shard`
    sub-pool was written in place)."""
    for f in _pool_fields(node):
        dst, src = getattr(node, f)[:, shard], getattr(sub, f)
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def _splice_node(fn, on, row, slot: int, prompt_len: int, start: int) -> None:
    """One paged node's splice. A sharded node routes the global slot to
    (shard, local slot) by the contiguous-chunk map, slot // (B/dp), and
    splices the shard's sub-pool; ``row`` then holds shard-local page ids
    (the engine keeps one allocator per pool and shard)."""
    if paged_node_sharded(fn):
        shard, local = divmod(slot, fn.block_table.shape[2])
        sub = _take_shard(fn, shard)
        _splice_paged(sub, on, row, local, prompt_len, start)
        _put_shard(fn, sub, shard)
    else:
        _splice_paged(fn, on, row, slot, prompt_len, start)


def write_slot_paged(full, one, rows, slot: int, prompt_len: int, starts=None):
    """Splice a batch-1 prefill cache tree ``one`` into ``slot`` of the
    engine cache ``full``, in place. ``rows`` mirrors the tree: a (nb,)
    int32 block-table row (numpy) per paged node, None elsewhere.
    ``starts`` (optional) mirrors it too: the copy-on-write share boundary
    in tokens per paged node (None = 0, an unshared admission). Dense
    nodes take the ordinary slot splice with the pad rows masked (a KV
    node's; a recurrent state node splices whole). Returns ``full``."""
    for si, (fstage, ostage) in enumerate(zip(full, one)):
        for bi, (fn, on) in enumerate(zip(fstage, ostage)):
            if isinstance(fn, PAGED_CACHE_TYPES):
                start = 0 if starts is None else (starts[si][bi] or 0)
                _splice_node(fn, on, rows[si][bi], slot, prompt_len, start)
            else:
                write_slot([[fn]], mask_pad_rows([[on]], prompt_len), slot)
    return full


def cow_split_pages(full, srcs, dsts, lo: int, hi: int):
    """Copy-on-write split after a prefix-shared splice: for every paged
    node, copy the rows of the owner's page ``srcs[si][bi]`` whose
    positions lie in ``[lo, hi)`` into the adopter's fresh page
    ``dsts[si][bi]``, keeping their ``page_pos``, in place; -1 (or None)
    in either disables the copy for a node. The engine runs it once per
    admission, after :func:`write_slot_paged` and before any decode
    write, so the adopter's stream equals an unshared run's. Prefix
    sharing is single-replica (the engine refuses it on sharded pools),
    so a sharded node cannot reach here."""
    for si, stage in enumerate(full):
        for bi, node in enumerate(stage):
            if not isinstance(node, PAGED_CACHE_TYPES):
                continue
            if paged_node_sharded(node):
                raise NotImplementedError(
                    "copy-on-write prefix sharing is single-replica only; "
                    "sharded paged pools cannot reach cow_split_pages")
            src, dst = srcs[si][bi], dsts[si][bi]
            if src is None or dst is None or src < 0 or dst < 0:
                continue
            pp = node.page_pos[:, src]
            live = (pp >= lo) & (pp < hi)
            for f in _pool_fields(node)[:-2]:      # the rows, not page_pos / table
                t = getattr(node, f)
                t[:, dst] = torch.where(live[..., None, None], t[:, src], t[:, dst])
            node.page_pos[:, dst] = torch.where(live, pp, node.page_pos[:, dst])
    return full


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
def kv_token_bytes(node) -> int:
    """K+V bytes per cached token across the node's layer stack; for a
    compressed pool the true stored footprint (int pages plus their f32
    scales, or rank-r coefficient rows), which is what makes admission
    capacity grow with the compression ratio at a fixed byte budget.
    Indexed from the ends, so sharded pools count the same."""
    if isinstance(node, QuantPagedKVCache):
        layers, kv, dhq = node.k_pages.shape[0], node.k_pages.shape[-2], node.k_pages.shape[-1]
        ngr = node.k_scale.shape[-1]
        return 2 * layers * kv * (dhq * node.k_pages.element_size()
                                  + ngr * node.k_scale.element_size())
    if isinstance(node, (SVDPagedKVCache, PagedKVCache)):
        layers, kv, w = node.k_pages.shape[0], node.k_pages.shape[-2], node.k_pages.shape[-1]
        return 2 * layers * kv * w * node.k_pages.element_size()
    layers, _, _, kv, dh = node.k.shape
    return 2 * layers * kv * dh * node.k.element_size()


def pool_geometry(node) -> tuple[int, int]:
    """(physical pages, page_size) of a stacked paged node, sharded or
    not (every shard's pages counted)."""
    if paged_node_sharded(node):
        return node.k_pages.shape[1] * node.k_pages.shape[2], node.k_pages.shape[3]
    return node.k_pages.shape[1], node.k_pages.shape[2]


def cache_bytes(caches) -> int:
    """Total decode-cache footprint in bytes (every device leaf of every
    node, recurrent state included)."""
    return sum(t.numel() * t.element_size()
               for node in cache_nodes(caches) for t in node.tensors())


def slot_bytes(caches, max_slots: int) -> int:
    """Per-slot share of the cache footprint."""
    return cache_bytes(caches) // max(1, max_slots)


# ---------------------------------------------------------------------------
# svd bases
# ---------------------------------------------------------------------------
def _top_eig_basis(w_heads, r: int):
    """Top-r orthonormal column basis of each head's projection range:
    ``w_heads`` (layers, d, KV, dh) -> (layers, KV, dh, r) f32, the top-r
    eigenvectors of W^T W (calibration-free, KQ-SVD idiom). Eigenvectors
    are defined up to sign, so the stored coefficients may differ in sign
    from the JAX package's; the projector B B^T and the attention output
    do not."""
    w = w_heads.float()
    gram = torch.einsum("ldkh,ldkg->lkhg", w, w)
    _, vecs = torch.linalg.eigh(gram)          # ascending eigenvalues
    return vecs[..., -r:].contiguous()


@torch.no_grad()
def install_svd_bases(caches, model, cfg):
    """Replace every svd pool's identity-prefix bases, in place, with the
    top-r eigenbases of the owning stage's K/V projection weights. The
    engine calls it once at build time. Returns ``caches``."""
    for si, ((unit, rep), stage) in enumerate(zip(cfg.stages, caches)):
        for bi, node in enumerate(stage):
            if not isinstance(node, SVDPagedKVCache):
                continue
            r, dh = node.k_pages.shape[-1], cfg.head_dim
            attn = model.stages[si][bi].attn
            d = attn.wk.shape[-2]
            kv = attn.wk.shape[-1] // dh
            node.k_basis = _top_eig_basis(attn.wk.reshape(rep, d, kv, dh), r)
            node.v_basis = _top_eig_basis(attn.wv.reshape(rep, d, kv, dh), r)
    return caches


# ---------------------------------------------------------------------------
# per-replica shards on a data mesh
# ---------------------------------------------------------------------------
def _shard_paged(node, dp: int):
    """``node`` with every pool / table tensor as a view of shape (layers,
    dp, n/dp, ...): shard s owns slots [s B/dp, (s+1) B/dp) and pages [s
    n/dp, (s+1) n/dp). The table's ids are shard-local from here on; the
    engine's fresh table maps nothing (-1), so no id has to move."""
    n_pages = node.k_pages.shape[1]
    B = node.block_table.shape[1]
    if B % dp:
        raise ValueError(
            f"serving a paged cache on a data-parallel mesh needs "
            f"max_slots divisible by the DP degree {dp} (each replica "
            f"shard owns max_slots/{dp} contiguous slots); got "
            f"max_slots={B}")
    if n_pages % dp:
        raise ValueError(
            f"paged pools shard per replica: the pool's {n_pages} "
            f"pages must divide by the DP degree {dp} so every "
            f"replica gets an equal page budget — raise pool_tokens "
            f"(or pick page_size/max_slots) so pages % {dp} == 0")
    split = {f: getattr(node, f).view(getattr(node, f).shape[0], dp, -1,
                                      *getattr(node, f).shape[2:])
             for f in _pool_fields(node)}
    return dataclasses.replace(node, sharded=True, **split)


def shard_slots(caches, mesh):
    """Lay the engine cache out for ``mesh``'s data axes, in place (the
    JAX ``shard_slots``, one process and one device here).

    Paged nodes are split into per-replica shards (:func:`_shard_paged`:
    the pools (layers, dp, n_pages/dp, ps, KV, w), the table (layers, dp,
    B/dp, nb) with shard-local ids), so each replica's slots read and
    write only its own pages. Dense nodes keep their layout; their slot
    axis must divide by the degree, as the JAX placement requires. SVD
    bases are per layer and shared by every shard. Returns ``caches``."""
    dp = dp_degree(mesh)
    for stage in caches:
        for i, node in enumerate(stage):
            if isinstance(node, PAGED_CACHE_TYPES):
                stage[i] = _shard_paged(node, dp)
                continue
            for t in node.tensors():
                if t.dim() > 1 and t.shape[1] % dp:
                    raise ValueError(
                        f"serving on a data-parallel mesh needs max_slots divisible "
                        f"by the DP degree {dp}; got a cache slot axis of "
                        f"{t.shape[1]} (shape {tuple(t.shape)})")
    return caches
