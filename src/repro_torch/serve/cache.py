"""Slot-addressed decode-cache helpers, dense layout
(``repro/serve/cache.py``).

The engine owns ONE batched cache tree (``models.init_caches`` with B =
max_slots): a list per stage of stacked :class:`KVCache` nodes whose
tensors carry the layer stack at axis 0 and the batch slot at axis 1 --
``k``/``v`` (layers, B, S, KV, dh), ``slot_pos`` (layers, B, S).

Admission = prefill the request alone (batch 1), then splice its cache
into the slot. The JAX package returns new trees and donates the old
buffers on the TPU; the port writes the slot of the engine's cache in
place (slice assignment) and never copies the whole cache. Eviction needs
no reset: a freed slot's decode position is parked at -1, which masks
every key in K6 and makes ``cache_insert`` drop the write, and the next
admission overwrites the whole slot.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import KVCache


def kv_cache_nodes(caches):
    """Every self-attention KV node of a cache tree, in stage order."""
    for stage in caches:
        for node in stage:
            if isinstance(node, KVCache):
                yield node


def write_slot(full, one, slot: int):
    """Splice a batch-1 cache tree ``one`` into batch slot ``slot`` of
    ``full``, in place. Returns ``full``."""
    for fn, on in zip(kv_cache_nodes(full), kv_cache_nodes(one)):
        for a, b in zip(fn.tensors(), on.tensors()):
            a[:, slot] = b[:, 0].to(a.dtype)
    return full


def read_slot(full, slot: int):
    """Copy batch slot ``slot`` out as a batch-1 cache tree (tests)."""
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
    """Decode positions with inactive slots parked at -1 (K6 masks every
    key of a parked row; ``cache_insert`` drops its write)."""
    return torch.where(active, pos, -1)


def kv_token_bytes(node: KVCache) -> int:
    """K+V bytes per cached token across the node's layer stack."""
    layers, _, _, kv, dh = node.k.shape
    return 2 * layers * kv * dh * node.k.element_size()


def cache_bytes(caches) -> int:
    """Total decode-cache footprint in bytes (k, v and slot_pos)."""
    return sum(t.numel() * t.element_size()
               for node in kv_cache_nodes(caches) for t in node.tensors())


def slot_bytes(caches, max_slots: int) -> int:
    """Per-slot share of the cache footprint."""
    return cache_bytes(caches) // max(1, max_slots)
