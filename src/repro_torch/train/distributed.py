"""Mesh executor (``repro/train/distributed.py``): data x context, or
data x model, training over the ranks of a
:class:`~repro_torch.launch.mesh.Mesh`.

The JAX package runs one ``shard_map`` program per device, its data axis
manual and its model axis left to GSPMD; the port runs one process per
(data, model, context) coordinate, and each rank

  * takes its slice of the global batch (data axis) and, under context
    parallelism, its zigzag slice of the sequence (chunks ``(c,
    2cp-1-c)``) with the global positions that RoPE and the ring's masks
    read (``kernels/ring_attention.py``);
  * runs ``loss_and_grad`` on it -- the same K1-K5 paths as the
    single-process step, attention through the ring when the context
    degree is above 1; under a model degree above 1 it holds its slice of
    the parameters (``runtime.sharding.model_cut``) and runs the column-
    and row-parallel products over the model group
    (``runtime.sharding.tensor_parallel``), K3-K5 at its head counts;
  * averages loss, NLL and the MoE aux term over the data x context ranks
    and sums the per-site telemetry (``moe.expert``'s over the model
    ranks too when they split the experts: each compressed its share);
  * all-reduces the gradients (mean), or runs the int8 error-feedback
    all-reduce (``runtime/grad_compress.py``) with its own residues;
  * clips by the global norm (the squares of model-split leaves summed
    over the model group), takes the warmup-cosine rate and runs AdamW
    under ZeRO-1: it updates only its data shard's slice of each moment
    and of its (model-axis) parameter slice (``runtime.sharding.zero1_dim``),
    then the data ranks gather the parameter slices
    (``collectives.gather_shards_``).

PAMM sampling: ``blocks=auto`` resolves to dp x cp; each rank compresses
its rows as one block of ``block_share = dp x cp`` (``_localize_policy``)
from :func:`shard_site_key`, the key of its block in the blocked
single-process compress, so the executor draws what ``blocks=dp*cp``
draws in one process, and every shard draws its own stream. The model
coordinate never enters the key or the block count: the model ranks of
one data shard compress the same (whole) input from the same key, so K1
yields the same state on each, and K2 takes each rank's columns of dZ.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch.core.keys import Key
from repro_torch.core.plan import resolve_for_run
from repro_torch.core.policies import PammPolicy
from repro_torch.kernels.ring_attention import zigzag_permutation, zigzag_shard_positions
from repro_torch.models import init_model
from repro_torch.models.blocks import resolve_block_structure
from repro_torch.models.model import _padded_vocab
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.collectives import all_reduce_, gather_shards_
from repro_torch.runtime.grad_compress import init_error_buffers, tree_compressed_psum
from repro_torch.train.train_step import (GRAD_COMPRESS_SCHEMES, TrainState,
                                          batch_to_device, finish_metrics, loss_and_grad)

__all__ = ["make_shard_map_train_step", "make_shard_map_grads", "ShardMapGrads",
           "init_distributed_state", "shard_site_key",
           "zero1_of", "local_batch", "gathered_moments", "gathered_error_buffers"]


def shard_site_key(key: Key, site_id: int, *, dp: int, shard: int) -> Key:
    """Site key of data x context shard ``shard`` of ``dp``: block
    ``shard``'s key in the blocked single-process derivation,
    ``key.fold_in(site_id).split(dp)[shard]`` (``core/pamm.py``'s
    ``pamm_compress_blocked``)."""
    return key.fold_in(site_id).split(dp)[shard]


def _localize_policy(policy, dp: int):
    """Per-shard view of a mesh-resolved policy: a PAMM policy blocked over
    the shard count compresses its shard's rows in ``n_blocks // dp``
    local blocks (1 for ``blocks=auto``) with ``block_share=dp``, so the
    shard's generator count is its share of the global blocked run."""
    if isinstance(policy, PammPolicy) and policy.n_blocks > 1:
        return dataclasses.replace(policy, n_blocks=max(1, policy.n_blocks // dp),
                                   block_share=dp)
    return policy


def zero1_of(rcfg, mesh, params: dict):
    """``(layout, data index, dp)`` of ZeRO-1 for AdamW on a mesh with data
    degree above 1 (``rcfg.zero1``), else None (moments whole on every
    rank; Adafactor's factored moments are never split, as in the JAX
    ``opt_state_shardings``)."""
    dp = sh.dp_degree(mesh)
    if dp <= 1 or rcfg.optimizer != "adamw" or not rcfg.zero1:
        return None
    return sh.zero1_layout(params, dp), mesh.coord("data"), dp


def init_distributed_state(cfg, rcfg, mesh, *, device="cuda", model=None) -> TrainState:
    """This rank's TrainState: the parameters (``model``, already this
    rank's slices under a model degree above 1 -- ``bridge.shard_jax_params``
    -- or initialised from ``rcfg.seed``: the same draws on every rank, of
    which each keeps its model-axis slices), its ZeRO-1 slices of the
    optimizer moments and, under ``grad_compress="int8_ef"``, its zeroed
    error-feedback residues."""
    if model is None:
        model = init_model(cfg, rcfg, seed=rcfg.seed, device=device, mesh=mesh)
    params = dict(model.named_parameters())
    opt_init, _ = make_optimizer(rcfg.optimizer)
    zero1 = zero1_of(rcfg, mesh, params)
    opt = opt_init(params, zero1=zero1) if zero1 else opt_init(params)
    ef = init_error_buffers(params) if rcfg.grad_compress == "int8_ef" else None
    return TrainState(params=model, opt=opt, ef=ef)


def local_batch(batch: dict, mesh, device, *, grad_accum: int = 1) -> dict:
    """This rank's part of a GLOBAL batch (numpy or tensors, leading axis
    the global batch): its data slice, and under context parallelism the
    zigzag-permuted sequence's slice (every leaf whose second axis is the
    sequence; token-wise losses are permutation invariant) plus
    ``positions``. The model axis takes nothing: a rank's ``embeds`` and
    ``image_embeds`` are its data shard's, whole (``models/model._embed``
    takes a ``seq_shard`` chunk of the first; xattn blocks read the second
    whole). Raises the JAX texts on an indivisible batch or sequence."""
    leaf = next(iter(batch.values()))
    B, L = leaf.shape[0], leaf.shape[1]
    sh.validate_batch_divisible(B, mesh, grad_accum=grad_accum, where="shard_map train step")
    sh.validate_seq_divisible(L, mesh, where="shard_map train step")
    dp, cp = sh.dp_degree(mesh), sh.cp_degree(mesh)
    b_loc, l_loc = B // dp, L // cp
    b0, c = mesh.coord("data") * b_loc, mesh.coord("context")
    keep = zigzag_permutation(L, cp)[c * l_loc:(c + 1) * l_loc] if cp > 1 else None
    out = {}
    for k, v in batch.items():
        v = v[b0:b0 + b_loc]
        if keep is not None and v.ndim >= 2 and v.shape[1] == L:
            v = v[:, keep]
        out[k] = v
    if cp > 1:
        out["positions"] = zigzag_shard_positions(c, L, cp).expand(b_loc, l_loc)
    return batch_to_device(out, device)


class ShardMapGrads(NamedTuple):
    """The gradient half of a mesh step, for this rank.

    ``rank_grads(model, batch, step) -> (loss, metrics, grads)``: the loss
    and gradients of this rank's part of the GLOBAL ``batch``, not yet
    reduced. ``sync_grads(grads, ef) -> (grads, ef)``: their mean over the
    data x context ranks, or the int8 error-feedback all-reduce with the
    residues ``ef`` (both in place)."""

    rank_grads: Callable
    sync_grads: Callable


def make_shard_map_grads(cfg, rcfg, *, mesh, sampler=None) -> ShardMapGrads:
    """This rank's :class:`ShardMapGrads` over ``mesh``: the plan resolved
    for the mesh (``blocks=auto`` = dp x cp), each PAMM site localised to
    its shard with :func:`shard_site_key`."""
    if mesh is None:
        raise ValueError("the shard_map executor needs a mesh; use "
                         "make_train_step for single-process runs")
    gc = getattr(rcfg, "grad_compress", "none")
    if gc not in GRAD_COMPRESS_SCHEMES:
        raise ValueError(f"unknown grad_compress {gc!r}; have {GRAD_COMPRESS_SCHEMES}")
    dp, cp = sh.dp_degree(mesh), sh.cp_degree(mesh)
    n_shards = dp * cp
    bk = getattr(rcfg, "moe_token_blocks", 1)
    if bk > 1 and (bk % dp or cp > 1):
        # a rank dispatches its data shard's tokens in bk / dp blocks: the
        # global batch's bk contiguous blocks, split by rank
        raise ValueError(
            f"moe_token_blocks={bk} on a mesh of data {dp} x context {cp}: each "
            f"data rank dispatches its share of the {bk} token blocks, so the "
            f"blocks must divide by the data degree and the context degree "
            f"must be 1 (a context rank's tokens are a zigzag slice of each "
            f"sequence, not whole blocks)")
    # the JAX executor's config-time gate, with the cp decision table
    resolve_block_structure(cfg, rcfg, cp=cp)
    resolved_global = resolve_for_run(cfg, rcfg, mesh)
    if n_shards > 1:
        odd = sorted({s.policy.n_blocks for s in resolved_global.compressed_sites
                      if isinstance(s.policy, PammPolicy) and s.policy.n_blocks != n_shards})
        if odd:
            warnings.warn(
                f"PAMM blocks={odd} != shard count {n_shards} (dp {dp} x "
                f"cp {cp}): the shard_map executor localizes blocks per "
                f"shard with a different key chain than the jit executor's "
                f"global blocked compress — training is valid but NOT "
                f"sampling-compatible between executors. Use blocks=auto "
                f"(= dp x cp) for bit parity.",
                stacklevel=3,
            )
    resolved = resolved_global.map_policies(lambda p: _localize_policy(p, n_shards))
    if n_shards > 1:
        # the model coordinate stays out: model ranks draw the same rows
        shard = mesh.coord("data") * cp + mesh.coord("context")
        resolved = resolved.with_site_key_fn(
            functools.partial(shard_site_key, dp=n_shards, shard=shard))
    sh.validate_tensor_parallel(cfg, rcfg, sh.tp_degree(mesh))
    mg = sh.make_model_group(mesh, cfg, rcfg, _padded_vocab(cfg, rcfg))
    sync, comm = mesh.sync_group, mesh.comm

    def rank_grads(model, batch: dict, step_idx: int):
        b = local_batch(batch, mesh, model.device, grad_accum=rcfg.grad_accum)
        L = b["labels"].shape[1]
        if mg is not None and mg.seq_shard and L % mg.tp:
            raise ValueError(f"seq_shard: sequence length {L} is not divisible by the "
                             f"model degree {mg.tp}")
        key = Key(rcfg.seed, sampler=sampler).fold_in(int(step_idx))
        with sh.context_parallel(mesh), sh.data_parallel(mesh), sh.tensor_parallel(mg):
            return loss_and_grad(cfg, rcfg, resolved, model, b, key)

    def sync_grads(grads: dict, ef):
        if gc == "int8_ef":
            return tree_compressed_psum(grads, ef, sync, n_shards, comm)
        all_reduce_(list(grads.values()), sync, n_shards, comm, mean=True)
        return grads, ef

    return ShardMapGrads(rank_grads, sync_grads)


def make_shard_map_train_step(cfg, rcfg, *, total_steps: int = 10000, mesh,
                              sampler=None, grads_hook=None):
    """This rank's ``step(state, batch, step) -> (state, metrics)`` over
    ``mesh``; ``batch`` is the GLOBAL batch (every rank is handed the same
    one and takes its part). Parameters, moments and residues are updated
    in place; the metrics are the same on every rank. ``grads_hook``, if
    given, sees the gradients after the all-reduce and before clipping
    (a dict keyed like the parameters; it must not change them)."""
    rank_grads, sync_grads = make_shard_map_grads(cfg, rcfg, mesh=mesh, sampler=sampler)
    dp, n_shards = sh.dp_degree(mesh), sh.dp_degree(mesh) * sh.cp_degree(mesh)
    _, opt_update = make_optimizer(rcfg.optimizer)
    sync, comm = mesh.sync_group, mesh.comm
    v_pad, e_pad = _padded_vocab(cfg, rcfg), sh.padded_experts(cfg, rcfg)
    mg = sh.make_model_group(mesh, cfg, rcfg, v_pad)

    def step(state: TrainState, batch: dict, step_idx: int):
        model = state.params
        params = dict(model.named_parameters())
        loss, metrics, grads = rank_grads(model, batch, step_idx)
        grads, new_ef = sync_grads(grads, state.ef)
        if grads_hook is not None:
            grads_hook(grads)
        # metrics over the shards, not shard 0's: mean loss / nll / aux,
        # summed telemetry (stored bytes, kept / total rows, beta sums)
        scalars = torch.stack([loss.float(), metrics["nll"].float(),
                               metrics["aux"].float()])
        all_reduce_([scalars], sync, n_shards, comm, mean=True)
        all_reduce_(list(metrics["sites"].values()), sync, n_shards, comm, mean=False)
        if mg is not None and mg.experts:
            # each model rank compressed its share of the experts
            all_reduce_([v for p, v in metrics["sites"].items() if p.endswith(".moe.expert")],
                        mg.group, mg.tp, comm, mean=False)
        loss, metrics["nll"], metrics["aux"] = scalars.unbind(0)
        split = None if mg is None else (sh.model_layout(params, cfg, v_pad, e_pad), mg)
        grads, gnorm = clip_by_global_norm(grads, rcfg.grad_clip, model_split=split)
        lr = warmup_cosine(int(step_idx), total_steps, rcfg.lr, rcfg.warmup_frac)
        zero1 = zero1_of(rcfg, mesh, params)
        kw = {"zero1": zero1} if zero1 else {}
        _, opt = opt_update(grads, state.opt, params, lr, weight_decay=rcfg.weight_decay,
                            pamm_lr_scale=rcfg.pamm_lr_scale, **kw)
        if zero1:
            with torch.no_grad():
                gather_shards_(params, zero1[0], zero1[1], dp, mesh.group("data"), comm)
        return (TrainState(params=model, opt=opt, ef=new_ef),
                finish_metrics(loss, metrics, gnorm, lr))

    return step


def gathered_moments(state: TrainState, mesh, rcfg) -> tuple[dict, dict]:
    """The whole AdamW moments ``(m, v)`` from the data ranks' ZeRO-1
    slices (a collective: every rank of the mesh calls it)."""
    params = dict(state.params.named_parameters())
    zero1 = zero1_of(rcfg, mesh, params)
    if zero1 is None:
        return state.opt.m, state.opt.v
    layout, index, dp = zero1
    out = []
    for moments in (state.opt.m, state.opt.v):
        full = {}
        for n, t in moments.items():
            if layout[n] is None:
                full[n] = t
                continue
            full[n] = torch.zeros(params[n].shape, dtype=t.dtype, device=t.device)
            sh.shard_slice(full[n], layout[n], index, dp).copy_(t)
        gather_shards_(full, layout, index, dp, mesh.group("data"), mesh.comm)
        out.append(full)
    return out[0], out[1]


def gathered_error_buffers(state: TrainState, mesh) -> dict | None:
    """Every rank's error-feedback residues, stacked (n_shards, *shape) in
    shard order (the JAX ``TrainState.ef`` layout); a collective."""
    if state.ef is None:
        return None
    n = sh.dp_degree(mesh) * sh.cp_degree(mesh)
    return {name: mesh.comm.all_gather(e.reshape(-1), mesh.sync_group, n).view(n, *e.shape)
            for name, e in state.ef.items()}
