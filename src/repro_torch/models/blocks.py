"""Blocks of the served kinds (``repro/models/blocks.py``): the
self-attention kinds ``attn``, ``swa`` and ``latt`` (local attention over
``cfg.local_window``) with a SwiGLU FFN, ``moe`` (self-attention with a
mixture-of-experts FFN, ``models/moe.py``), ``rec`` (an RG-LRU sublayer,
``models/rglru.py``, then a SwiGLU FFN), ``ssm`` (a single Mamba-2
sublayer, ``models/ssm.py``) and ``xattn`` (gated cross-attention over
the image embeddings, then a gated SwiGLU FFN), on the residual structure
(with or without rematerialisation) or, all but ``ssm`` and ``xattn``, as
reversible two-stream blocks.

A block's parameters are stacked over the layers of its stage (leading
axis ``rep``, as the JAX package stacks them for ``lax.scan``);
:meth:`Block.layer` hands one layer's views to the functions below, which
mirror their JAX counterparts on a per-layer dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.linear import STATS_LEN, SiteMode
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import ffn, ffn_sites, init_ffn, init_rms_norm, rms_norm
from repro_torch.runtime.collectives import seq_param
from repro_torch.runtime.sharding import model_group

BLOCK_KINDS = ("attn", "swa", "latt", "moe", "rec", "ssm", "xattn")
BLOCK_STRUCTURES = ("residual", "reversible", "reversible_ref")
REMAT_MODES = ("none", "full", "pamm")
# Kinds with the two-sublayer mixer/FFN split the F/G decomposition needs
# (the JAX package's list; ssm is single-sublayer and xattn threads the
# image embeddings and a gate through its FFN: neither is ever reversible)
REVERSIBLE_KINDS = ("attn", "swa", "latt", "moe", "rec")
# Kinds a context-parallel (ring attention) mesh can shard over the
# sequence (the JAX package's list): attention kinds run the ring, moe's
# mixer is attention too; rec / ssm scan over L and xattn reads
# full-sequence cross-modal extras
CONTEXT_PARALLEL_KINDS = ("attn", "swa", "latt", "moe")


def _window_for(kind: str, cfg) -> int:
    if kind == "swa":
        return cfg.sliding_window
    if kind == "latt":
        return cfg.local_window
    return 0


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the port runs {BLOCK_KINDS}")


def resolve_block_structure(cfg, rcfg, *, cp: int = 1) -> str:
    """Validate ``rcfg.block_structure`` against the architecture, remat
    and the mesh executor's context-parallel degree ``cp`` (the JAX
    package's checks and texts), then that every kind is known.

    ``reversible_ref`` is the same two-stream math under plain autograd
    (every stream saved): the parity and memory baseline of the
    memory-saving path, not a setting for real runs."""
    structure = getattr(rcfg, "block_structure", "residual") or "residual"
    if structure not in BLOCK_STRUCTURES:
        raise ValueError(
            f"RunConfig.block_structure={structure!r}: must be one of "
            f"{BLOCK_STRUCTURES}")
    if cp > 1:
        bad = sorted({k for unit, _ in cfg.stages for k in unit
                      if k not in CONTEXT_PARALLEL_KINDS})
        if bad:
            raise ValueError(
                f"context parallelism (cp={cp}) supports block kinds "
                f"{CONTEXT_PARALLEL_KINDS}; stage kind(s) {bad} are "
                f"sequence-recurrent or consume full-sequence extras and "
                f"cannot shard over the sequence axis. Drop --mesh-context "
                f"for this architecture.")
        if structure != "residual":
            raise ValueError(
                f"block_structure={structure!r} x context parallelism "
                f"(cp={cp}) is invalid: the reversible stage's custom_vjp "
                f"re-runs F (which now contains the ring's ppermute "
                f"collectives) during stream reconstruction, and the ring's "
                f"own custom_vjp cannot nest inside that replay without "
                f"re-synchronizing every shard per stage. Use "
                f"block_structure='residual' with --mesh-context, or "
                f"cp=1 with reversible blocks.")
    remat = getattr(rcfg, "remat", "none")
    if remat not in REMAT_MODES:
        raise ValueError(f"RunConfig.remat={remat!r}: must be one of {REMAT_MODES}")
    kinds = sorted({k for unit, _ in cfg.stages for k in unit})
    if structure != "residual":
        bad = [k for k in kinds if k not in REVERSIBLE_KINDS]
        if bad:
            raise ValueError(
                f"block_structure={structure!r} supports kinds "
                f"{REVERSIBLE_KINDS}; stage kind(s) {bad} have no two-sublayer "
                f"F/G split (ssm is single-sublayer, xattn consumes cross-modal "
                f"extras). Use block_structure='residual' for this architecture.")
        if remat != "none":
            raise ValueError(
                f"remat={remat!r} x block_structure={structure!r} is "
                f"invalid: the reversible backward already reconstructs the "
                f"residual stream from the stage outputs, and a checkpoint "
                f"around the stage would re-save the very (y1, y2) carries it "
                f"erases, then recompute F/G a second time on top. Use "
                f"remat='none' with reversible blocks; remat='full'|'pamm' "
                f"belongs to block_structure='residual'.")
    for kind in kinds:
        _check_kind(kind)
    return structure


def init_block(kind: str, cfg, gen: torch.Generator, dtype, *, e_pad: int = 0) -> dict:
    """One layer's parameters (a plain dict with the JAX names); ``e_pad``
    pads a moe block's expert axis with dead experts."""
    _check_kind(kind)
    if kind == "ssm":
        return {"norm1": init_rms_norm(cfg.d_model, dtype, gen.device),
                "ssm": ssm_lib.init_ssm(gen, cfg, dtype)}
    if kind == "rec":
        return {"norm1": init_rms_norm(cfg.d_model, dtype, gen.device),
                "rec": rglru_lib.init_rglru(gen, cfg, dtype),
                "norm2": init_rms_norm(cfg.d_model, dtype, gen.device),
                "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype)}
    if kind == "xattn":
        # both gates start at zero: the block is the identity at init
        return {"norm1": init_rms_norm(cfg.d_model, dtype, gen.device),
                "attn": attn_lib.init_attention(gen, cfg, dtype, cross=True),
                "norm2": init_rms_norm(cfg.d_model, dtype, gen.device),
                "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype),
                "gate_ffn": torch.zeros((), dtype=dtype, device=gen.device)}
    return {
        "norm1": init_rms_norm(cfg.d_model, dtype, gen.device),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_rms_norm(cfg.d_model, dtype, gen.device),
        "ffn": (moe_lib.init_moe(gen, cfg, dtype, e_pad=e_pad) if kind == "moe"
                else init_ffn(gen, cfg.d_model, cfg.d_ff, dtype)),
    }


def _ffn_train(kind, cfg, rcfg, ctx, params, h, key):
    """The block's FFN sublayer through its sites: (out, aux), aux None
    for the dense FFN."""
    if kind == "moe":
        return moe_lib.moe_ffn(params["ffn"], h, cfg,
                               gather_dispatch=rcfg.moe_gather_dispatch,
                               token_blocks=rcfg.moe_token_blocks, ctx=ctx, key=key)
    return ffn_sites(params["ffn"], h, ctx, key), None


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
        _check_kind(kind)
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
# reversible two-stream blocks
# ---------------------------------------------------------------------------
def block_f(kind, cfg, rcfg, ctx, params, x, positions, key):
    """First reversible sublayer (token mixer): norm1 -> attention or the
    recurrence. Returns the pre-residual output; the caller forms
    y1 = x1 + F(x2). Under tensor parallelism the sublayers run their
    model-axis paths (a stage's backward replays them, collectives
    included, in the same order on every rank), and under ``seq_shard``
    the norm reads this rank's chunk of the stream (:func:`seq_param`)."""
    h = rms_norm(x, seq_param(params["norm1"], model_group()), cfg.norm_eps)
    if kind == "rec":
        return rglru_lib.rglru_train(params["rec"], h, cfg, ctx, key)
    out, _ = attn_lib.attn_train(params["attn"], h, positions, cfg, ctx, key,
                                 window=_window_for(kind, cfg))
    return out


def block_g(kind, cfg, rcfg, ctx, params, y1, key):
    """Second reversible sublayer: norm2 -> (Mo)FFN through its sites.
    Returns ``(G(y1), aux)``, aux the MoE balance loss (None for the dense
    FFN); the caller forms y2 = x2 + G(y1) and sums aux."""
    return _ffn_train(kind, cfg, rcfg, ctx, params,
                      rms_norm(y1, seq_param(params["norm2"], model_group()), cfg.norm_eps),
                      key)


def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a + b) and its exact rounding error e."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def _dd_add(hi, lo, b):
    """Compensated stream add: (hi, lo) + b -> renormalised (hi, lo).

    The streams ride as double-word pairs because the plain inverse
    (x + f) - f loses the forward add's rounding error, about an ulp a
    layer, compounding through the reconstruction. With the error in
    ``lo`` the backward rebuilds the forward's f32 streams bit for bit; a
    bf16 pair holds 16 bits, and its drift grows through the layers below.
    Sublayers read only ``hi``; under autograd TwoSum's error channel
    has an exactly zero Jacobian. Eager ops only: a compiler that fuses
    or reassociates these adds destroys the compensation."""
    s, e = _two_sum(hi, b)
    return _two_sum(s, lo + e)


def _nest(names, tensors) -> dict:
    """Dotted parameter names and their tensors -> a nested dict."""
    out: dict = {}
    for name, t in zip(names, tensors):
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


class _Stage:
    """What a reversible stage runs besides its tensors: the unit's
    kinds, each block's parameter names and its span of the flat
    parameter list, the layers' keys (stage ``fold_in(si)``, layer
    ``split(rep)``, block ``fold_in(bi)`` -- the residual path's chain)
    and the positions. (The JAX stage pins each stream's sharding
    between layers; on one card there is nothing to pin.)"""

    def __init__(self, cfg, rcfg, unit, si, resolved, blocks, positions, key, paths):
        self.cfg, self.rcfg, self.unit, self.si = cfg, rcfg, unit, si
        self.resolved, self.positions, self.paths = resolved, positions, paths
        self.rep = blocks[0].rep
        self.keys = key.fold_in(si).split(self.rep)
        self.names, self.spans, start = [], [], 0
        for block in blocks:
            names = [n for n, _ in block.named_parameters()]
            self.names.append(names)
            self.spans.append((start, start + len(names)))
            start += len(names)

    def layer(self, leaves) -> list[dict]:
        """One layer's flat leaves -> per-block parameter dicts."""
        return [_nest(names, leaves[a:b]) for names, (a, b) in zip(self.names, self.spans)]

    def run_layer(self, params, r, x1h, x1l, x2h, x2l, aux, tele, mode):
        """y1 = x1 + F(x2), y2 = x2 + G(y1) for each block of layer r; the
        blocks' aux losses added to ``aux``."""
        cfg, rcfg = self.cfg, self.rcfg
        for bi, kind in enumerate(self.unit):
            ctx = self.resolved.ctx(self.si, kind, tele, mode)
            bkey = self.keys[r].fold_in(bi)
            f = block_f(kind, cfg, rcfg, ctx, params[bi], x2h, self.positions, bkey)
            x1h, x1l = _dd_add(x1h, x1l, f)
            g, a = block_g(kind, cfg, rcfg, ctx, params[bi], x1h, bkey)
            x2h, x2l = _dd_add(x2h, x2l, g)
            if a is not None:
                aux = aux + a
        return x1h, x1l, x2h, x2l, aux


class _ReversibleStage(torch.autograd.Function):
    """One stage of reversible layers whose backward saves no activation:
    the forward keeps only the output streams (and the parameters, its
    inputs); the backward walks the layers top-down, rebuilds each
    layer's input streams from its outputs and takes the sublayers'
    vector-Jacobian products on the way.

    The forward runs without autograd, so a site would neither compress
    nor report; its :class:`SiteMode` makes each compress for the
    telemetry, which leaves as a non-differentiable (sites, STATS_LEN)
    output. The backward's recompute compresses again from the same key
    (the same state) and reports nothing: K1 runs twice a site a layer,
    K3 twice a layer, as in the JAX package's custom_vjp. The stage's
    summed MoE aux loss is an output too; its cotangent reaches each
    moe block's G with the stream's (``g_vjp((dy2, daux))`` in JAX)."""

    @staticmethod
    def forward(ctx, stage, x1h, x1l, x2h, x2l, *flat):
        tele = {p: torch.zeros(STATS_LEN, dtype=torch.float32, device=x1h.device)
                for p in stage.paths}
        mode = SiteMode(stats_without_grad=True)
        per_layer = list(zip(*(t.unbind(0) for t in flat)))
        aux = torch.zeros((), dtype=torch.float32, device=x1h.device)
        for r in range(stage.rep):
            x1h, x1l, x2h, x2l, aux = stage.run_layer(stage.layer(per_layer[r]), r,
                                                      x1h, x1l, x2h, x2l, aux, tele, mode)
        ctx.stage = stage
        ctx.save_for_backward(x1h, x1l, x2h, x2l, *flat)
        stats = torch.stack([tele[p] for p in stage.paths]) if stage.paths else \
            torch.zeros((0, STATS_LEN), device=x1h.device)
        ctx.mark_non_differentiable(stats)
        return x1h, x1l, x2h, x2l, aux, stats

    @staticmethod
    def backward(ctx, dy1, _dy1l, dy2, _dy2l, daux, _dstats):
        stage = ctx.stage
        cfg, rcfg = stage.cfg, stage.rcfg
        y1h, y1l, y2h, y2l, *flat = ctx.saved_tensors
        dflat = [torch.zeros_like(t) for t in flat]
        # TwoSum's error channel carries no gradient: the lo outputs'
        # cotangents are dropped, and a lo input's equals its hi one's
        mode = SiteMode()
        with mode:
            for r in reversed(range(stage.rep)):
                leaves = [t[r].detach().requires_grad_() for t in flat]
                params = stage.layer(leaves)
                for bi in reversed(range(len(stage.unit))):
                    kind, bkey = stage.unit[bi], stage.keys[r].fold_in(bi)
                    a, b = stage.spans[bi]
                    sctx = stage.resolved.ctx(stage.si, kind, None, mode)
                    # one call is both the reconstruction and the vjp's
                    # primal: eager ops on the same input give the
                    # forward's output bit for bit
                    with torch.enable_grad():
                        y1 = y1h.detach().requires_grad_()
                        g, g_aux = block_g(kind, cfg, rcfg, sctx, params[bi], y1, bkey)
                    x2h, x2l = _dd_add(y2h, y2l, -g.detach())
                    outs, cots = [g], [dy2]
                    if g_aux is not None:     # the moe block's balance loss
                        outs.append(g_aux)
                        cots.append(daux)
                    dy1_g, *dpg = torch.autograd.grad(outs, [y1, *leaves[a:b]], cots,
                                                      allow_unused=True)
                    dy1 = dy1 + dy1_g
                    with torch.enable_grad():
                        x2 = x2h.detach().requires_grad_()
                        f = block_f(kind, cfg, rcfg, sctx, params[bi], x2, stage.positions,
                                    bkey)
                    x1h, x1l = _dd_add(y1h, y1l, -f.detach())
                    dx2_f, *dpf = torch.autograd.grad(f, [x2, *leaves[a:b]], dy1,
                                                      allow_unused=True)
                    dy2 = dy2 + dx2_f
                    for i, (pg, pf) in enumerate(zip(dpg, dpf), start=a):
                        for part in (pg, pf):
                            if part is not None:
                                dflat[i][r] += part
                    y1h, y1l, y2h, y2l = x1h, x1l, x2h, x2l
        return (None, dy1, dy1, dy2, dy2, *dflat)


def reversible_stage(cfg, rcfg, unit, si, resolved, blocks, streams, tele, positions,
                     key, *, save_memory: bool = True):
    """Run one (unit x rep) stage of the two-stream reversible stack
    (``repro/models/blocks.py:reversible_stage``). ``streams``: (x1h,
    x1l, x2h, x2l), compensated pairs (:func:`_dd_add`); ``tele``: the
    run's telemetry dict, updated in place; ``key``: the step's key.
    Returns (streams, aux): the output streams and the stage's summed MoE
    aux loss (f32, 0 without moe blocks).

    ``save_memory=True`` is one :class:`_ReversibleStage` (the output
    streams saved, every layer rebuilt in backward); ``False``
    (``reversible_ref``) the same layers under plain autograd."""
    stage = _Stage(cfg, rcfg, unit, si, resolved, blocks, positions, key, sorted(tele))
    flat = [p for block in blocks for _, p in block.named_parameters()]
    if save_memory:
        *streams, aux, stats = _ReversibleStage.apply(stage, *streams, *flat)
        for path, row in zip(stage.paths, stats):
            tele[path] = tele[path] + row
        return tuple(streams), aux
    per_layer = list(zip(*(t.unbind(0) for t in flat)))
    aux = torch.zeros((), dtype=torch.float32, device=streams[0].device)
    for r in range(stage.rep):
        *streams, aux = stage.run_layer(stage.layer(per_layer[r]), r, *streams, aux, tele,
                                        None)
    return tuple(streams), aux


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------
def block_train(kind, cfg, rcfg, ctx, params, x, positions, key, aux, *,
                extras=None, cache=None, cache_positions=None):
    """Returns (x, aux). ``ctx`` is this block's SiteCtx and ``key`` its
    key (None when no site draws, as in serving); ``aux`` is the auxiliary
    loss carried through (the moe kind adds its balance loss). ``extras``:
    the model's cross-modal inputs (``image_embeds`` (B, vision_tokens, d)
    for an xattn block). ``cache``: this layer's cache to fill in place
    (prefill): a KVCache with the prompt's (roped) K/V, an XAttnCache with
    the image K/V, an SSMCache or RGLRUCache with the state the prompt
    leaves; ``cache_positions`` marks bucketing pad rows -1 so they are
    dropped, not written (a pad row would evict a real tail token from a
    ring cache). Pad rows are query rows of an xattn block: its image K/V
    do not depend on them. Under tensor parallelism
    (``runtime.sharding.model_group``) every kind runs its model-axis
    path; under ``seq_shard`` the norms and an xattn block's ``gate_ffn``
    read this rank's chunk of the sequence, so their gradients are summed
    over the model group (:func:`seq_param`; ``gate_attn``'s in
    ``attention.cross_attn``)."""
    mg = model_group()
    if mg is not None:
        params = {**params, **{n: seq_param(params[n], mg)
                               for n in ("norm1", "norm2", "gate_ffn") if n in params}}
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind == "xattn":
        out, (k_img, v_img) = attn_lib.cross_attn(
            params["attn"], h, extras["image_embeds"], cfg, ctx, key,
            chunk=rcfg.attn_chunk, flash_sdp=rcfg.flash_sdp)
        if cache is not None:
            cache.k.copy_(k_img)
            cache.v.copy_(v_img)
        x = x + out
        out2 = ffn_sites(params["ffn"], rms_norm(x, params["norm2"], cfg.norm_eps), ctx, key)
        return x + torch.tanh(params["gate_ffn"].to(x.dtype)) * out2, aux
    if kind in ("ssm", "rec"):
        train = ssm_lib.ssm_train if kind == "ssm" else rglru_lib.rglru_train
        if cache is None:
            out = train(params[kind], h, cfg, ctx, key)
        else:
            out, filled = train(params[kind], h, cfg, ctx, key, return_cache=True)
            for dst, src in zip(cache.tensors(), filled.tensors()):
                dst.copy_(src)
    else:
        out, (k_roped, v) = attn_lib.attn_train(
            params["attn"], h, positions, cfg, ctx, key, window=_window_for(kind, cfg))
        if cache is not None:
            attn_lib.cache_insert(
                cache, k_roped, v,
                positions if cache_positions is None else cache_positions)
    x = x + out
    if kind == "ssm":
        return x, aux
    out2, a = _ffn_train(kind, cfg, rcfg, ctx, params,
                         rms_norm(x, params["norm2"], cfg.norm_eps), key)
    return x + out2, aux if a is None else aux + a


def block_decode(kind, cfg, rcfg, params, x, positions, cache, write=None):
    """One decode step (or verify block). x: (B, L, d). Returns (x, cache)
    -- the cache is updated in place; ``write`` is the step's
    ``attention.paged_write`` of a paged cache."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind == "ssm":
        out, cache = ssm_lib.ssm_decode(params["ssm"], h, cache, cfg)
        return x + out, cache
    if kind == "xattn":
        x = x + attn_lib.cross_attn_decode(params["attn"], h, cache, cfg)
        out2 = ffn(params["ffn"], rms_norm(x, params["norm2"], cfg.norm_eps))
        return x + torch.tanh(params["gate_ffn"].to(x.dtype)) * out2, cache
    if kind == "rec":
        out, cache = rglru_lib.rglru_decode(params["rec"], h, cache, cfg)
    else:
        out, cache = attn_lib.attn_decode(params["attn"], h, positions, cache, cfg,
                                          window=_window_for(kind, cfg), write=write)
    x = x + out
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    if kind == "moe":
        out2, _ = moe_lib.moe_ffn(params["ffn"], h2, cfg,
                                  gather_dispatch=rcfg.moe_gather_dispatch,
                                  token_blocks=rcfg.moe_token_blocks, with_aux=False)
        return x + out2, cache
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
    worst case (``repro/models/blocks.py:512-567``). An ssm or rec block's
    recurrent state, and an xattn block's image K/V, are dense slot caches
    under either layout: they have no pages."""
    if kind == "xattn":
        return attn_lib.init_xattn_cache(B, cfg.vision_tokens, cfg.n_kv_heads,
                                         cfg.head_dim, dtype, device, layers=layers)
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, B, dtype, device, layers=layers)
    if kind == "rec":
        return rglru_lib.init_rglru_cache(cfg, B, dtype, device, layers=layers)
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
