"""Slot-addressed decode-cache helpers (``repro/serve/cache.py``).

The engine owns ONE batched cache tree (``models.init_caches`` with B =
max_slots): a list per stage of stacked cache nodes whose tensors carry
the layer stack at axis 0. Dense nodes (:class:`KVCache`) hold the batch
slot at axis 1 -- ``k``/``v`` (layers, B, S, KV, dh), ``slot_pos``
(layers, B, S). Paged nodes hold page pools (layers, n_pages, page_size,
KV, w), ``page_pos`` (layers, n_pages, page_size) and block tables
(layers, B, nb), one row per slot shared by every layer of the stack.

Admission = prefill the request alone (batch 1, a dense cache), then
splice its cache into the slot. The JAX package returns new trees and
donates the old buffers on the TPU; the port writes the engine's cache in
place and never copies a whole cache. Dense: slice assignment of the
slot. Paged: :func:`write_slot_paged` installs the slot's block-table row
(the only time a table changes: a request reserves its pages up front),
resets ``page_pos`` on the newly owned pages (they may carry a previous
owner's positions) and scatters the prompt's rows through the row --
quantised by the decode path's own quantiser for int8 / int4 pools,
projected into the layer's bases for svd pools. Eviction needs no reset:
a freed slot's decode position is parked at -1, which masks every key and
drops the write, and no live block table maps a freed page.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_decode import quantize_kv
from repro_torch.models.attention import (PAGED_CACHE_TYPES, KVCache, PagedKVCache,
                                          QuantPagedKVCache, SVDPagedKVCache,
                                          paged_addresses, quant_cache_bits)


def kv_cache_nodes(caches):
    """Every self-attention KV node (dense or paged) of a cache tree, in
    stage order."""
    for stage in caches:
        for node in stage:
            if isinstance(node, (KVCache,) + PAGED_CACHE_TYPES):
                yield node


def write_slot(full, one, slot: int):
    """Splice a batch-1 dense cache tree ``one`` into batch slot ``slot``
    of the dense tree ``full``, in place; ``one`` may lie on another device
    (a Prefix handed off in host form). Returns ``full``."""
    for fn, on in zip(kv_cache_nodes(full), kv_cache_nodes(one)):
        for a, b in zip(fn.tensors(), on.tensors()):
            a[:, slot] = b[:, 0].to(device=a.device, dtype=a.dtype)
    return full


def read_slot(full, slot: int):
    """Copy batch slot ``slot`` of a dense tree out as a batch-1 tree (tests)."""
    return [[KVCache(*(t[:, slot:slot + 1].clone() for t in node.tensors()),
                     ring=node.ring) for node in stage] for stage in full]


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
    of the prompt rows: (positions (layers, S), flat row index into the
    (layers * n_pages * ps, ...) pool view, validity).

    ``start`` is the copy-on-write boundary in tokens (0 unshared): the
    row's first ``start // ps`` pages were adopted from a live prefix owner,
    so their ``page_pos`` is kept and the prompt rows below ``start`` are
    not scattered (they would land on the owner's pages). The partly
    shared page, if ``start`` is not page-aligned, is a fresh page whose
    leading rows arrive through :func:`cow_split_pages`."""
    nlayers, n_pages, ps = fc.k_pages.shape[:3]
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
    lidx = torch.arange(nlayers, device=dev)[:, None]
    flat = (lidx * n_pages + page.clamp_min(0).long()) * ps + off.long()
    return spos, flat, page >= 0


def _splice_paged(fc, oc: KVCache, row, slot: int, prompt_len: int, start: int):
    """Scatter the batch-1 prefill cache ``oc`` into the pages of ``row``:
    fp pools as they are, int8 / int4 pools through :func:`quantize_kv`
    (the decode path's quantiser), svd pools projected into each layer's
    bases."""
    spos, flat, valid = _splice_targets(fc, oc, row, slot, prompt_len, start)
    # admission may read back to the host: keep only the rows that land
    keep = valid.reshape(-1).nonzero().squeeze(1)
    target = flat.reshape(-1)[keep]
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
        view = dst.view(-1, *dst.shape[3:])
        view.index_put_((target,), src.reshape(-1, *view.shape[1:])[keep].to(dst.dtype))


def write_slot_paged(full, one, rows, slot: int, prompt_len: int, starts=None):
    """Splice a batch-1 prefill cache tree ``one`` into ``slot`` of the
    engine cache ``full``, in place. ``rows`` mirrors the tree: a (nb,)
    int32 block-table row (numpy) per paged node, None elsewhere.
    ``starts`` (optional) mirrors it too: the copy-on-write share boundary
    in tokens per paged node (None = 0, an unshared admission). Dense
    nodes take the ordinary slot splice with the pad rows masked. Returns
    ``full``."""
    for si, (fstage, ostage) in enumerate(zip(full, one)):
        for bi, (fn, on) in enumerate(zip(fstage, ostage)):
            if isinstance(fn, PAGED_CACHE_TYPES):
                start = 0 if starts is None else (starts[si][bi] or 0)
                _splice_paged(fn, on, rows[si][bi], slot, prompt_len, start)
            else:
                write_slot([[fn]], mask_pad_rows([[on]], prompt_len), slot)
    return full


def _copy_fields(node) -> tuple[str, ...]:
    """The pool leaves a copy-on-write split copies besides page_pos."""
    if isinstance(node, QuantPagedKVCache):
        return ("k_pages", "v_pages", "k_scale", "v_scale")
    return ("k_pages", "v_pages")


def cow_split_pages(full, srcs, dsts, lo: int, hi: int):
    """Copy-on-write split after a prefix-shared splice: for every paged
    node, copy the rows of the owner's page ``srcs[si][bi]`` whose
    positions lie in ``[lo, hi)`` into the adopter's fresh page
    ``dsts[si][bi]``, keeping their ``page_pos``, in place; -1 (or None)
    in either disables the copy for a node. The engine runs it once per
    admission, after :func:`write_slot_paged` and before any decode
    write, so the adopter's stream equals an unshared run's."""
    for si, stage in enumerate(full):
        for bi, node in enumerate(stage):
            if not isinstance(node, PAGED_CACHE_TYPES):
                continue
            src, dst = srcs[si][bi], dsts[si][bi]
            if src is None or dst is None or src < 0 or dst < 0:
                continue
            pp = node.page_pos[:, src]
            live = (pp >= lo) & (pp < hi)
            for f in _copy_fields(node):
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
    capacity grow with the compression ratio at a fixed byte budget."""
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
    """(physical pages, page_size) of a stacked paged node."""
    return node.k_pages.shape[1], node.k_pages.shape[2]


def cache_bytes(caches) -> int:
    """Total decode-cache footprint in bytes (every device leaf)."""
    return sum(t.numel() * t.element_size()
               for node in kv_cache_nodes(caches) for t in node.tensors())


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
