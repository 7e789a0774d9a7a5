"""Residual blocks of the dense slice (``repro/models/blocks.py``): the
self-attention kinds ``attn`` and ``swa`` with a SwiGLU FFN, trained and
served on the residual structure without rematerialisation.

A block's parameters are stacked over the layers of its stage (leading
axis ``rep``, as the JAX package stacks them for ``lax.scan``);
:meth:`Block.layer` hands one layer's views to the functions below, which
mirror their JAX counterparts on a per-layer dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import ffn, ffn_sites, init_ffn, init_rms_norm, rms_norm

SERVED_KINDS = ("attn", "swa")
LATER_SLICE_KINDS = ("block kinds moe, latt, rec, ssm and xattn arrive with "
                     "the port's later slices; this slice runs attn/swa")
LATER_SLICE_STRUCTURE = ("block_structure='reversible' arrives with the port's "
                         "reversible-training slice; this slice trains the "
                         "residual structure")
LATER_SLICE_REMAT = ("remat='full' and remat='pamm' arrive with the port's "
                     "rematerialisation slice; this slice trains with remat='none'")


def _window_for(kind: str, cfg) -> int:
    if kind == "swa":
        return cfg.sliding_window
    if kind == "latt":
        return cfg.local_window
    return 0


def _require_served(kind: str) -> None:
    if kind not in SERVED_KINDS:
        raise NotImplementedError(f"{kind!r}: {LATER_SLICE_KINDS}")


def resolve_block_structure(cfg, rcfg) -> str:
    """Config-time check of block kinds, block structure and remat: this
    slice trains the residual structure of attn/swa blocks with no
    rematerialisation; anything else raises, naming the later slice."""
    for unit, _ in cfg.stages:
        for kind in unit:
            _require_served(kind)
    if getattr(rcfg, "block_structure", "residual") != "residual":
        raise NotImplementedError(LATER_SLICE_STRUCTURE)
    if getattr(rcfg, "remat", "none") != "none":
        raise NotImplementedError(LATER_SLICE_REMAT)
    return "residual"


def init_block(kind: str, cfg, gen: torch.Generator, dtype) -> dict:
    """One layer's parameters (a plain dict with the JAX names)."""
    _require_served(kind)
    return {
        "norm1": init_rms_norm(cfg.d_model, dtype, gen.device),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_rms_norm(cfg.d_model, dtype, gen.device),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _params_module(tree: dict, trainable: bool) -> nn.Module:
    """nn.Module whose attributes follow a (nested) dict of tensors."""
    mod = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            mod.add_module(name, _params_module(val, trainable))
        else:
            mod.register_parameter(name, nn.Parameter(val, requires_grad=trainable))
    return mod


def _views(mod: nn.Module, r: int) -> dict:
    out = {name: p[r] for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        out[name] = _views(child, r)
    return out


class Block(nn.Module):
    """A stage's blocks of one kind, parameters stacked over ``rep``
    layers: ``norm1`` (rep, d), ``attn.wq`` (rep, d, H*dh), ... -- the
    names and leading axis of the JAX tree (``model.py:95-114``).
    ``trainable``: whether the parameters require grad."""

    def __init__(self, kind: str, stacked: dict, trainable: bool = True):
        super().__init__()
        _require_served(kind)
        self.kind = kind
        self.rep = stacked["norm1"].shape[0]
        mod = _params_module(stacked, trainable)
        for name, child in mod.named_children():
            self.add_module(name, child)
        for name, p in mod.named_parameters(recurse=False):
            self.register_parameter(name, p)

    @classmethod
    def from_layers(cls, kind: str, layers: list[dict]) -> "Block":
        return cls(kind, _stack(layers))

    def layer(self, r: int) -> dict:
        """Layer ``r``'s parameters as views (no copy)."""
        return _views(self, r)

    def layers(self) -> list[dict]:
        """Every layer's parameters as views, from one ``unbind`` per
        stacked tensor. Under autograd its backward stacks the layers'
        gradients once; indexing layer by layer would add a zero tensor
        the size of the whole stack per layer."""
        return _unbound(self, self.rep)


def _unbound(mod: nn.Module, rep: int) -> list[dict]:
    out = [{} for _ in range(rep)]
    for name, p in mod.named_parameters(recurse=False):
        for r, view in enumerate(p.unbind(0)):
            out[r][name] = view
    for name, child in mod.named_children():
        for r, sub in enumerate(_unbound(child, rep)):
            out[r][name] = sub
    return out


def _stack(layers: list[dict]) -> dict:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------
def block_train(kind, cfg, rcfg, ctx, params, x, positions, key, aux, *,
                cache=None, cache_positions=None):
    """Returns (x, aux). ``ctx`` is this block's SiteCtx and ``key`` its
    key (None when no site draws, as in serving); ``aux`` is the auxiliary
    loss carried through (0 for attn/swa). ``cache``: this layer's KVCache
    to fill in place with the prompt's (roped) K/V (prefill);
    ``cache_positions`` marks bucketing pad rows -1 so they are dropped,
    not written (a pad row would evict a real tail token from a ring
    cache)."""
    _require_served(kind)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    out, (k_roped, v) = attn_lib.attn_train(
        params["attn"], h, positions, cfg, ctx, key, window=_window_for(kind, cfg))
    x = x + out
    if cache is not None:
        attn_lib.cache_insert(
            cache, k_roped, v,
            positions if cache_positions is None else cache_positions)
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + ffn_sites(params["ffn"], h2, ctx, key), aux


def block_decode(kind, cfg, rcfg, params, x, positions, cache, write=None):
    """One decode step (or verify block). x: (B, L, d). Returns (x, cache)
    -- the cache is updated in place; ``write`` is the step's
    ``attention.paged_write`` of a paged cache."""
    _require_served(kind)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    out, cache = attn_lib.attn_decode(params["attn"], h, positions, cache, cfg,
                                      window=_window_for(kind, cfg), write=write)
    x = x + out
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + ffn(params["ffn"], h2), cache


def init_block_cache(kind, cfg, B: int, max_len: int, dtype, device, *,
                     layers: int | None = None, layout: str = "dense",
                     page_size: int = 0, pool_pages: int | None = None,
                     cache_format=None):
    """Zero-initialized decode cache (optionally stacked over ``layers``).

    ``layout="dense"``: a slot cache; a sliding-window kind gets a ring of
    min(max_len, window) slots. ``layout="paged"``: a page pool of
    ``pool_pages`` pages of ``page_size`` tokens (default: the dense worst
    case, B x blocks per slot) plus block tables; a ring's logical size is
    the dense ring size rounded up to whole pages.

    ``cache_format`` (a compressed :class:`core.plan.CacheFormat`) swaps
    the pool for its int8 / int4 / svd variant. ``pool_pages`` is a byte
    budget expressed in dense pages, so a compressed pool gets
    proportionally more pages at the same budget, capped at the dense
    worst case (``repro/models/blocks.py:512-567``)."""
    _require_served(kind)
    win = _window_for(kind, cfg)
    size = min(max_len, win) if win else max_len
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    compressed = cache_format is not None and cache_format.is_compressed
    if compressed and layout != "paged":
        raise ValueError(
            f"cache.kv={cache_format} requires cache_layout='paged' -- "
            "the dense slab has no compressed storage path")
    if layout == "dense":
        return attn_lib.init_kv_cache(B, size, kv, dh, dtype, bool(win), device,
                                      layers=layers)
    if layout != "paged":
        raise ValueError(f"cache_layout must be dense|paged, got {layout!r}")
    if page_size < 1:
        raise ValueError(f"paged cache needs page_size >= 1, got {page_size}")
    logical = -(-size // page_size) * page_size
    worst = B * (logical // page_size)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if compressed and pool_pages is not None:
        # the same byte budget buys 1/ratio-sized tokens -> ratio x pages
        base_tb = itemsize * 2 * kv * dh
        pool_pages = int(pool_pages * base_tb // max(1, cache_format.token_bytes(
            kv, dh, itemsize)))
    n_pages = max(1, worst if pool_pages is None else min(pool_pages, worst))
    common = dict(ring=bool(win), device=device, layers=layers)
    if compressed and cache_format.kind in ("int8", "int4"):
        return attn_lib.init_quant_paged_kv_cache(
            B, logical, page_size, n_pages, kv, dh,
            8 if cache_format.kind == "int8" else 4, cache_format.n_groups(dh), **common)
    if compressed and cache_format.kind == "svd":
        return attn_lib.init_svd_paged_kv_cache(
            B, logical, page_size, n_pages, kv, dh, cache_format.svd_rank(dh), dtype,
            **common)
    return attn_lib.init_paged_kv_cache(B, logical, page_size, n_pages, kv, dh, dtype,
                                        **common)
