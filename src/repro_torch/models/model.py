"""Model assembly (``repro/models/model.py``):
embedding -> staged block stack -> final norm -> head.

  init_model(cfg, rcfg, seed=0, device="cuda")          -> Model
  forward(cfg, rcfg, plan, model, batch, key)           -> (hidden, aux)
  loss_fn(cfg, rcfg, plan, model, batch, key)           -> (loss, metrics)
  init_caches(cfg, rcfg, B, max_len, device, layout=...) -> caches
  prefill(cfg, rcfg, model, batch, max_len, plan=None)  -> (logits, caches)
  decode_step(cfg, rcfg, model, tokens, pos, caches)    -> (logits, caches)

``plan`` is anything ``core.plan.as_resolved`` accepts; ``key`` is a
:class:`repro_torch.core.keys.Key` (the step's key). A stage with ``rep``
layers keeps its parameters stacked (the JAX tree's leading ``layers``
axis) and runs as a Python loop over them, where the JAX package runs
``lax.scan``; the keys follow the JAX chain (stage ``fold_in``, layer
``split``, block ``fold_in``). Caches mirror the JAX tree: one list per
stage, one stacked cache node per block of the stage's unit (a
:class:`KVCache` or page pool for attention, an :class:`XAttnCache` for
cross-attention, an :class:`SSMCache` or :class:`RGLRUCache` for an ssm
or rec block). ``batch`` holds ``tokens`` (B, L), ``labels``, optional
``mask``, optional ``positions`` (B, L) (a context shard's global
positions under the mesh executor; ``arange`` otherwise) and, for a
vision arch, ``image_embeds`` (B, vision_tokens, d),
which every xattn block reads (cast to the compute dtype). An embed-input
arch (``cfg.embed_inputs``, musicgen) has no ``embed`` table: its batch
holds ``embeds`` (B, L, d) in place of ``tokens``, and ``decode_step``
takes (B, L, d) embeddings. With ``cfg.n_codebooks`` the head is (d,
vocab x n_codebooks), the labels (B, L, n_codebooks), and the logits hold
every codebook's vocab side by side.
Serving (prefill, decode) runs under ``torch.no_grad``.

Tensor parallelism (``runtime.sharding.tensor_parallel``, entered by the
mesh executor around its forward and backward): ``init_model(...,
mesh=)`` keeps this rank's slice of every leaf the model axis splits
(``runtime.sharding.model_cut``); the embedding is vocabulary-parallel
(rows outside this rank's range give zeros, summed over the model group);
the blocks run their column- and row-parallel products; the loss is the
vocabulary-parallel chunked cross-entropy over the local head columns.
A multi-codebook head holds this rank's share of every codebook, each
codebook's loss vocabulary-parallel over its block of the local columns.
Under ``rcfg.seq_shard`` the residual stream between blocks holds this
rank's chunk of the sequence (Megatron sequence parallelism), and so do
the two reversible streams.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import plan as plan_lib
from repro_torch.core.keys import Key
from repro_torch.core.linear import SiteMode
from repro_torch.core.plan import exact_ctx
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (chunked_cross_entropy, embed_init,
                                       init_rms_norm, rms_norm)
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.collectives import seq_param, tp_exit

__all__ = ["Model", "init_model", "forward", "loss_fn", "init_caches",
           "prefill", "decode_step", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain path")
    return device


def _dtype(rcfg):
    return getattr(torch, rcfg.compute_dtype), getattr(torch, rcfg.param_dtype)


def _padded_vocab(cfg, rcfg) -> int:
    """Vocab dim of embed/head (padded to ``pad_vocab_multiple``)."""
    m = rcfg.pad_vocab_multiple
    if not m or cfg.n_codebooks:
        return cfg.vocab_size
    return ((cfg.vocab_size + m - 1) // m) * m


class Model(nn.Module):
    """Parameters of a decoder with the JAX tree's names and layouts:
    ``embed`` (V, d), ``stages[si][bi]`` (:class:`blocks.Block`, stacked
    over the stage's layers), ``final_norm`` (d,), ``head`` (d, V).
    ``embed`` None (an embed-input arch) registers no embedding, as the
    JAX tree has no ``embed`` leaf then. ``trainable``: whether embed /
    final_norm / head require grad (the blocks carry their own flag)."""

    def __init__(self, embed, stages: list[list[blk.Block]], final_norm, head,
                 trainable: bool = True):
        super().__init__()
        p = lambda t: nn.Parameter(t, requires_grad=trainable)
        self.register_parameter("embed", None if embed is None else p(embed))
        self.stages = nn.ModuleList(nn.ModuleList(unit) for unit in stages)
        self.final_norm = p(final_norm)
        self.head = p(head)

    @property
    def device(self) -> torch.device:
        return self.head.device


def shard_module_(mod: nn.Module, mesh, cfg) -> nn.Module:
    """Replace each parameter of ``mod`` (full leaves, named as in the JAX
    tree) by this rank's slice of it along the model axis, copied, so the
    whole leaf is freed (:func:`runtime.sharding.shard_params`)."""
    for name, p in list(mod.named_parameters()):
        owner = mod.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        part = sh.shard_params({name: p.detach()}, mesh, cfg.head_dim, cfg)[name]
        if part.shape != p.shape:
            owner.register_parameter(leaf, nn.Parameter(part.clone(),
                                                        requires_grad=p.requires_grad))
    return mod


def init_model(cfg, rcfg, seed: int = 0, device="cuda", mesh=None) -> Model:
    """Random-initialised parameters, requiring grad, drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)``. With a ``mesh``
    whose model degree is above 1, each leaf is drawn whole (the same
    draws as one process) and only this rank's slice of it is kept,
    block by block, so the whole tree is never on the device at once."""
    device = resolve_device(device)
    _, pdt = _dtype(rcfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    v_pad = _padded_vocab(cfg, rcfg)
    e_pad = sh.padded_experts(cfg, rcfg)
    tp = 1 if mesh is None else sh.tp_degree(mesh)
    local = ((lambda name, t: sh.shard_params({name: t}, mesh, cfg.head_dim, cfg)[name].clone())
             if tp > 1 else (lambda name, t: t))
    embed = (None if cfg.embed_inputs
             else local("embed", embed_init(gen, v_pad, cfg.d_model, pdt)))
    stages = []
    for unit, rep in cfg.stages:
        stage = []
        for kind in unit:
            block = blk.Block.from_layers(
                kind, [blk.init_block(kind, cfg, gen, pdt, e_pad=e_pad) for _ in range(rep)])
            stage.append(shard_module_(block, mesh, cfg) if tp > 1 else block)
        stages.append(stage)
    final_norm = init_rms_norm(cfg.d_model, pdt, device)
    head = local("head", (torch.randn((cfg.d_model, v_pad * max(1, cfg.n_codebooks)),
                                      generator=gen, device=device)
                          * cfg.d_model ** -0.5).to(pdt))
    return Model(embed, stages, final_norm, head)


def init_caches(cfg, rcfg, B: int, max_len: int, device, *,
                layout: str | None = None, page_size: int | None = None,
                pool_pages: int | None = None, cache_plan=None):
    """Decode caches for the whole stack (B = batch slots).

    ``layout`` / ``page_size`` default from ``rcfg.cache_layout`` /
    ``rcfg.kv_page_size``: ``dense`` keeps slot-contiguous (layers, B, S,
    KV, dh) slabs, ``paged`` builds per-layer page pools plus block tables
    (``attention.PagedKVCache``). ``pool_pages`` caps each pool (None = the
    dense worst case). ``cache_plan`` (a resolved plan, default parsed
    from ``rcfg.cache_compress``) maps each stage's attention caches to a
    :class:`core.plan.CacheFormat`: int8 / int4 pools quantise on write,
    svd pools store rank-r coefficients."""
    cdt, _ = _dtype(rcfg)
    layout = layout or rcfg.cache_layout
    page_size = page_size or rcfg.kv_page_size
    if cache_plan is None:
        cache_plan = plan_lib.cache_plan_from_spec(rcfg.cache_compress or "").resolve(cfg)
    return [[blk.init_block_cache(kind, cfg, B, max_len, cdt, device, layers=rep,
                                  layout=layout, page_size=page_size,
                                  pool_pages=pool_pages,
                                  cache_format=cache_plan.cache_format(si, kind))
             for kind in unit]
            for si, (unit, rep) in enumerate(cfg.stages)]


def _embed(cfg, model: Model, inputs, cdt):
    """The block stack's input: an embed-input arch's embeddings (B, L, d)
    cast to the compute dtype, else the table rows of tokens (B, L).
    Under tensor parallelism with the vocabulary split, a rank's table
    holds rows [index * V/tp, (index + 1) * V/tp): tokens outside it give
    zeros and the ranks' rows are summed (under ``seq_shard``, this rank's
    chunk of the sequence of the sum; an embed-input arch's embeddings,
    whole on every rank, give this rank's chunk)."""
    mg = sh.model_group()
    if cfg.embed_inputs:
        return tp_exit(inputs.to(cdt), mg, False)
    if mg is None or not mg.vocab:
        return tp_exit(model.embed[inputs].to(cdt), mg, False)
    rows = model.embed.shape[0]
    local = inputs - mg.index * rows
    inside = (local >= 0) & (local < rows)
    x = model.embed[torch.where(inside, local, 0)] * inside[..., None].to(model.embed.dtype)
    return tp_exit(x.to(cdt), mg, True)


def _inputs(cfg, batch: dict):
    return batch["embeds" if cfg.embed_inputs else "tokens"]


def _extras(cfg, batch: dict, cdt) -> dict:
    """The cross-modal inputs of the blocks: ``image_embeds`` in the
    compute dtype for a vision arch."""
    if not cfg.vision_tokens:
        return {}
    return {"image_embeds": batch["image_embeds"].to(cdt)}


def _positions(B: int, L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=torch.int32, device=device).expand(B, L)


def _require_residual_serving(cfg, rcfg, fn_name: str):
    if blk.resolve_block_structure(cfg, rcfg) != "residual":
        raise NotImplementedError(
            f"{fn_name} does not implement the reversible two-stream stack: "
            f"block_structure='reversible' is a train-time activation-memory "
            f"optimization, and a reversibly-trained model computes a "
            f"different function than the residual stack. Score through "
            f"forward()/loss_fn, or serve with a residual-trained model.")


# ---------------------------------------------------------------------------
# staged forward (training / scoring)
# ---------------------------------------------------------------------------
def _layer(cfg, rcfg, resolved, unit, si, params, extras, x, aux, positions, key, tele,
           mode):
    """One step of a stage's layer loop: every block of the unit."""
    for bi, kind in enumerate(unit):
        ctx = resolved.ctx(si, kind, tele, mode)
        x, aux = blk.block_train(kind, cfg, rcfg, ctx, params[bi], x, positions,
                                 key.fold_in(bi), aux, extras=extras)
    return x, aux


def forward(cfg, rcfg, plan, model: Model, batch: dict, key: Key, *,
            telemetry: dict | None = None):
    """Returns (hidden (B, L, d), aux_loss); under tensor parallelism with
    ``seq_shard``, this rank's (B, L/tp, d) chunk of the hidden states.

    ``telemetry``: pass a dict to receive the per-site stats vectors (site
    path -> STATS_LEN tensor) summed over all layers.

    ``rcfg.remat``: ``full`` recomputes each layer in backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of the layer
    body), compressing again from the same key; ``pamm`` recomputes it
    too but keeps the compressed states across the boundary
    (:class:`core.linear.SiteMode`), so K1 runs once. ``block_structure``
    ``reversible`` / ``reversible_ref`` runs the two-stream stack
    (:func:`blocks.reversible_stage`)."""
    resolved = plan_lib.as_resolved(plan, cfg, rcfg)
    structure = blk.resolve_block_structure(cfg, rcfg)
    mg = sh.model_group()
    if mg is not None:
        sh.validate_tensor_parallel(cfg, rcfg, mg.tp)
    cdt, _ = _dtype(rcfg)
    inputs = _inputs(cfg, batch)
    x = _embed(cfg, model, inputs, cdt)
    extras = _extras(cfg, batch, cdt)
    # under seq_shard x holds this rank's chunk of the sequence; RoPE and
    # the attention masks read the whole sequence's positions
    B, L = inputs.shape[:2]
    # a context shard of the mesh executor sees a zigzag slice of the
    # sequence: its global positions arrive in the batch and drive RoPE and
    # the ring's masks across the shard seams
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, L, x.device)
    else:
        positions = positions.to(device=x.device, dtype=torch.int32)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tele = resolved.zero_telemetry(x.device)
    if structure != "residual":
        # both streams start at the embedding; the merge averages them
        zero = torch.zeros_like(x)
        streams = (x, zero, x, zero)
        for si, (unit, _) in enumerate(cfg.stages):
            streams, stage_aux = blk.reversible_stage(
                cfg, rcfg, unit, si, resolved, list(model.stages[si]), streams, tele,
                positions, key, save_memory=structure == "reversible")
            aux = aux + stage_aux
        x1h, x1l, x2h, x2l = streams
        x = 0.5 * ((x1h + x1l) + (x2h + x2l))
    else:
        for si, ((unit, rep), stage) in enumerate(zip(cfg.stages, model.stages)):
            keys = key.fold_in(si).split(rep)
            layers = [block.layers() for block in stage]
            for r in range(rep):
                params = [layer[r] for layer in layers]
                step = functools.partial(_layer, cfg, rcfg, resolved, unit, si, params,
                                         extras)
                if rcfg.remat == "none":
                    x, aux = step(x, aux, positions, keys[r], tele, None)
                    continue
                mode = SiteMode(keep_states=rcfg.remat == "pamm")
                # the layer draws no global RNG: its samplers own their generators
                x, aux = checkpoint(step, x, aux, positions, keys[r], tele, mode,
                                    use_reentrant=False, preserve_rng_state=False,
                                    context_fn=mode.checkpoint_contexts)
    if telemetry is not None:
        telemetry.update(tele)
    return rms_norm(x, seq_param(model.final_norm, mg), cfg.norm_eps), aux


def loss_fn(cfg, rcfg, plan, model: Model, batch: dict, key: Key):
    """Mean token NLL (+ the MoE aux term) and its metrics
    ``{"nll", "aux", "sites"}`` -- the port of the JAX ``loss_fn``.

    With ``cfg.n_codebooks`` the NLL is the mean over codebooks of one
    chunked cross-entropy each, over the head's column slice of that
    codebook (a view: the gradient lands in the one ``head``) and its
    labels; a ``lm_head`` site compresses each from the key
    ``fold_in(0x1EAD).fold_in(c)`` and its stats are summed. Under tensor
    parallelism a rank's head holds its 1/tp of each codebook's columns
    (``runtime.sharding.head_parts``), so codebook c's view is the c-th
    local block and each cross-entropy runs vocabulary-parallel (every
    rank compresses the same h from the same key)."""
    resolved = plan_lib.as_resolved(plan, cfg, rcfg)
    tele: dict = {}
    h, aux = forward(cfg, rcfg, resolved, model, batch, key, telemetry=tele)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape[:2], dtype=torch.float32, device=h.device)
    head_site = resolved.head_site()
    if head_site is not None and head_site.is_exact:
        head_site = None
    head_key = key.fold_in(0x1EAD)
    if cfg.n_codebooks:
        v = model.head.shape[1] // cfg.n_codebooks      # a rank's share of each codebook
        losses = [chunked_cross_entropy(h, model.head[:, c * v:(c + 1) * v], labels[..., c],
                                        mask, rcfg.loss_chunk, site=head_site,
                                        key=head_key.fold_in(c))
                  for c in range(cfg.n_codebooks)]
    else:
        losses = [chunked_cross_entropy(h, model.head, labels, mask, rcfg.loss_chunk,
                                        valid_vocab=cfg.vocab_size, site=head_site,
                                        key=head_key)]
    if head_site is not None:
        losses, stats = zip(*losses)
        tele[head_site.path] = tele.get(head_site.path, 0) + sum(stats)
    nll = sum(losses) / len(losses)
    moe_coef = 0.01 if cfg.n_experts else 0.0
    loss = nll + moe_coef * aux / max(1, cfg.n_layers)
    return loss, {"nll": nll, "aux": aux, "sites": tele}


@torch.no_grad()
def prefill(cfg, rcfg, model: Model, batch: dict, max_len: int, plan=None,
            prompt_len=None):
    """Run the prompt and build caches sized ``max_len``.
    Returns (logits (B, 1, V) f32, caches).

    ``plan``: optional plan routed through the same per-site resolution as
    training. Forward outputs are exact for every policy, and without
    autograd no site compresses, so a plan changes no logits.

    ``prompt_len``: optional (B,) true prompt lengths of right-padded
    (length-bucketed) prompts: their pad rows are never written to the
    cache, and the logits row is taken at ``prompt_len - 1``.
    """
    _require_residual_serving(cfg, rcfg, "prefill")
    resolved = None if plan is None else plan_lib.as_resolved(plan, cfg, rcfg)
    cdt, _ = _dtype(rcfg)
    x = _embed(cfg, model, _inputs(cfg, batch), cdt)
    extras = _extras(cfg, batch, cdt)
    B, L, _ = x.shape
    positions = _positions(B, L, x.device)
    cpos = None
    if prompt_len is not None:
        plen = torch.as_tensor(prompt_len, device=x.device)
        cpos = torch.where(positions < plen[:, None], positions, -1)
    # the prompt's cache is a dense slab whatever the engine's layout: the
    # engine splices it into its own pool (serve/cache.py)
    caches = [[blk.init_block_cache(kind, cfg, B, max_len, cdt, x.device, layers=rep)
               for kind in unit] for unit, rep in cfg.stages]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    key = Key(0)
    for si, ((unit, rep), stage, stage_caches) in enumerate(
            zip(cfg.stages, model.stages, caches)):
        for r in range(rep):
            for kind, block, cache in zip(unit, stage, stage_caches):
                ctx = exact_ctx() if resolved is None else resolved.ctx(si, kind, None)
                x, aux = blk.block_train(kind, cfg, rcfg, ctx, block.layer(r), x,
                                         positions, key, aux, extras=extras,
                                         cache=cache.layer(r), cache_positions=cpos)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if prompt_len is not None:
        x = x[torch.arange(B, device=x.device), plen - 1][:, None]
    else:
        x = x[:, -1:]
    logits = (x @ model.head.to(cdt)).float()
    return logits, caches


@torch.no_grad()
def decode_step(cfg, rcfg, model: Model, tokens, pos, caches):
    """One decode step for the whole batch: tokens (B, L) (an embed-input
    arch's embeddings (B, L, d)), pos (B, L) absolute positions (-1 =
    parked slot). L = 1 is the decode step; L > 1 a speculative-verify
    block, whose rows are scored in one call, each masked by its own
    position (paged caches). The caches are updated in
    place. Returns (logits (B, L, V*) f32, caches). An xattn block decodes
    from the image K/V its cache holds since prefill, so the step takes no
    image input (the JAX ``decode_step``'s ``extras`` goes unread there
    too)."""
    _require_residual_serving(cfg, rcfg, "decode_step")
    cdt, _ = _dtype(rcfg)
    x = _embed(cfg, model, tokens, cdt)
    for (unit, rep), stage, stage_caches in zip(cfg.stages, model.stages, caches):
        # a paged node's write addresses, for all its layers at once
        writes = [attn_lib.paged_write(c, pos) if isinstance(c, attn_lib.PAGED_CACHE_TYPES)
                  else None for c in stage_caches]
        for r in range(rep):
            for kind, block, cache, write in zip(unit, stage, stage_caches, writes):
                x, _ = blk.block_decode(kind, cfg, rcfg, block.layer(r), x, pos,
                                        cache.layer(r),
                                        None if write is None else write.layer(r))
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ model.head.to(cdt)).float()
    return logits, caches
