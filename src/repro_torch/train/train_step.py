"""Train-step factory (``repro/train/train_step.py``, jit executor only):
loss -> grads -> clip -> schedule -> optimizer.

``make_train_step(cfg, rcfg)`` returns ``train_step(state, batch, step)``.
The step's key is ``Key(rcfg.seed).fold_in(step)`` -- the path of the JAX
``fold_in(seed_key, step)`` -- and every compression site folds its
``site_id`` into its block's key, so each site draws its own stream
(:mod:`repro_torch.core.keys`; ``sampler`` replaces the default draws).
The plan is resolved once, here. Per-site telemetry (stored bytes / kept
fraction / beta) lands in the returned metrics under ``site/<path>/...``.

On a CUDA model the compressed QKV projections run K1 (compress, forward)
and K2 (apply, backward), and attention runs K3 forward and K4/K5
backward. ``rcfg.remat`` (``full`` / ``pamm``) and ``rcfg.block_structure``
(``reversible`` / ``reversible_ref``) act inside ``models.forward``: the
recompute runs K3 again, and K1 too except under ``pamm``; each
microbatch of ``grad_accum`` is its own forward and backward, so they
compose. Checkpoints go through :mod:`repro_torch.checkpoint` (with
``bridge.train_state_tree``). This is the single-process executor; the mesh
executor (data x context ranks, ZeRO-1, the int8 error-feedback
all-reduce) is :mod:`repro_torch.train.distributed`, which shares
:func:`loss_and_grad` with it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.keys import Key
from repro_torch.core.plan import resolve_for_run
from repro_torch.core.stats import site_telemetry_metrics
from repro_torch.models import init_model, loss_fn
from repro_torch.models.blocks import resolve_block_structure
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import clip_by_global_norm

GRAD_COMPRESS_SCHEMES = ("none", "int8_ef")


class TrainState(NamedTuple):
    params: Any   # the Model (its parameters are updated in place)
    opt: Any      # OptState (under the mesh executor: this data shard's ZeRO-1 slices)
    # this rank's error-feedback residues (name -> f32 tensor shaped like
    # the parameter) under the mesh executor's int8_ef all-reduce, else None
    ef: Any = None


def init_train_state(cfg, rcfg, *, device="cuda", seed: int | None = None) -> TrainState:
    """Random parameters from ``seed`` (default ``rcfg.seed``) on
    ``device`` and a fresh optimizer state."""
    model = init_model(cfg, rcfg, seed=rcfg.seed if seed is None else seed,
                       device=device)
    opt_init, _ = make_optimizer(rcfg.optimizer)
    return TrainState(params=model, opt=opt_init(dict(model.named_parameters())))


def batch_to_device(batch: dict, device) -> dict:
    """numpy / tensor batch leaves -> tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        out[k] = t.to(device, non_blocking=True)
    return out


def loss_and_grad(cfg, rcfg, resolved, model, batch: dict, key: Key):
    """Value and grad of the plan-resolved loss, with microbatch
    accumulation (``rcfg.grad_accum``; microbatch i draws from
    ``key.split(accum)[i]``). Returns ``(loss, metrics, grads)`` with grads
    a dict keyed like ``model.named_parameters()``."""
    names, params = zip(*model.named_parameters())
    accum = max(1, rcfg.grad_accum)
    if accum == 1:
        loss, metrics = loss_fn(cfg, rcfg, resolved, model, batch, key)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), _detach(metrics), dict(zip(names, grads))
    # gradients averaged in f32 (each microbatch compressed on its own)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    loss_acc, m_acc = None, None
    for i, mkey in enumerate(key.split(accum)):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss_i, metrics_i = loss_fn(cfg, rcfg, resolved, model, mb, mkey)
        for acc, g in zip(g_acc, torch.autograd.grad(loss_i, params)):
            acc.add_(g.float() / accum)
        loss_i, metrics_i = loss_i.detach() / accum, _scale(_detach(metrics_i), accum)
        loss_acc = loss_i if loss_acc is None else loss_acc + loss_i
        m_acc = metrics_i if m_acc is None else _add(m_acc, metrics_i)
    grads = {n: g.to(p.dtype) for n, g, p in zip(names, g_acc, params)}
    return loss_acc, m_acc, grads


def _detach(metrics: dict) -> dict:
    return {"nll": metrics["nll"].detach(), "aux": metrics["aux"].detach(),
            "sites": {p: v.detach() for p, v in metrics["sites"].items()}}


def _scale(metrics: dict, accum: int) -> dict:
    return {"nll": metrics["nll"] / accum, "aux": metrics["aux"] / accum,
            "sites": {p: v / accum for p, v in metrics["sites"].items()}}


def _add(a: dict, b: dict) -> dict:
    return {"nll": a["nll"] + b["nll"], "aux": a["aux"] + b["aux"],
            "sites": {p: a["sites"][p] + b["sites"][p] for p in a["sites"]}}


def finish_metrics(loss, metrics: dict, gnorm, lr: float) -> dict:
    """The metric dict of a step: 0-d tensors (read them with ``float``)."""
    out = {"loss": loss.float(), "nll": metrics["nll"].float(), "grad_norm": gnorm,
           "lr": torch.tensor(lr, dtype=torch.float32)}
    out.update(site_telemetry_metrics(metrics.get("sites", {})))
    return out


def make_train_step(cfg, rcfg, *, total_steps: int = 10000, sampler=None, mesh=None):
    """``train_step(state, batch, step) -> (state, metrics)``; the model's
    parameters and the optimizer moments are updated in place. ``mesh``
    only steers plan resolution (``blocks=auto`` = its data x context
    degree), as in the JAX package."""
    gc = getattr(rcfg, "grad_compress", "none")
    if gc != "none":
        # one process computes one gradient: there is no per-shard gradient
        # to quantise, and proceeding would train uncompressed
        raise ValueError(
            f"RunConfig.grad_compress={gc!r} is only honored by the "
            f"shard_map executor (train.distributed.make_shard_map_train_step, "
            f"--executor shard_map); the jit executor would silently train "
            f"uncompressed. Set grad_compress='none' or switch executor.")
    if mesh is not None:
        from repro_torch.runtime.sharding import cp_degree

        if cp_degree(mesh) > 1:
            raise ValueError(
                f"mesh has a context axis of degree {cp_degree(mesh)}, "
                f"but the jit executor cannot run ring context-parallel "
                f"attention; use the shard_map executor "
                f"(--executor shard_map / make_shard_map_train_step).")
    resolve_block_structure(cfg, rcfg)
    resolved = resolve_for_run(cfg, rcfg, mesh)
    _, opt_update = make_optimizer(rcfg.optimizer)

    def train_step(state: TrainState, batch: dict, step: int):
        model = state.params
        key = Key(rcfg.seed, sampler=sampler).fold_in(int(step))
        batch = batch_to_device(batch, model.device)
        loss, metrics, grads = loss_and_grad(cfg, rcfg, resolved, model, batch, key)
        grads, gnorm = clip_by_global_norm(grads, rcfg.grad_clip)
        lr = warmup_cosine(int(step), total_steps, rcfg.lr, rcfg.warmup_frac)
        _, opt = opt_update(grads, state.opt, dict(model.named_parameters()), lr,
                            weight_decay=rcfg.weight_decay,
                            pamm_lr_scale=rcfg.pamm_lr_scale)
        return (TrainState(params=model, opt=opt, ef=state.ef),
                finish_metrics(loss, metrics, gnorm, lr))

    return train_step
