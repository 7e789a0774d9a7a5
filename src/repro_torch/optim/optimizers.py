"""Optimizers written out as the JAX package writes them
(``repro/optim/optimizers.py``), not ``torch.optim``.

* AdamW with decoupled weight decay, global-norm clipping and per-path
  learning-rate scales: the paper (App. D) trains the PAMM-wrapped weights
  (W_Q / W_K / W_V) at alpha * lr. Only the Adam step is scaled; the decay
  stays at the plain lr (``optimizers.py:86-89``), which parameter groups
  of ``torch.optim.AdamW`` would not give.
* Adafactor (factored second moments), state ~= params.

Parameters, gradients and moments are dicts keyed by the model's parameter
names (``model.named_parameters()``). Unlike the pure JAX functions, the
updates work in place -- the parameters, and the moments of the returned
state -- which keeps one copy of each 1.8B-element tree on the card.

ZeRO-1 (``zero1=(layout, index, dp)``, the mesh executor's): the AdamW
moments of a parameter whose ``layout`` names a dimension hold only data
shard ``index``'s 1/dp slice of it along that dimension
(``runtime.sharding.zero1_dim``, the JAX ``zero1_specs`` rule), and the
update writes only that slice of the parameter; the executor then gathers
the slices (``runtime.collectives.gather_shards_``). A ``None`` entry keeps
the whole moment on every shard. The arithmetic is the unsharded one,
element for element.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.runtime.sharding import shard_slice

PAMM_WEIGHT_KEYS = ("wq", "wk", "wv")


class OptState(NamedTuple):
    step: int
    m: dict         # first moment (AdamW) or row stats (Adafactor)
    v: dict         # second moment / col stats


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def clip_by_global_norm(tree: dict, max_norm: float, *, model_split=None):
    """Scale the gradients in place to global norm <= max_norm; returns
    (tree, norm before clipping). ``model_split``: ``(layout, mg)`` under
    tensor parallelism, ``layout`` a leaf's ``runtime.sharding.Cut`` or
    None (``model_layout``) -- the squares of what the model axis splits
    (each rank holds a slice) are summed over the model group ``mg``, the
    whole leaves and a cut's whole parts (the same on every rank) counted
    once."""
    if model_split is None:
        gn = global_norm(tree)
    else:
        from repro_torch.runtime.collectives import reduce_from_model

        layout, mg = model_split
        zero = torch.zeros((), device=next(iter(tree.values())).device)
        split_sq, whole_sq = zero, zero
        for n, x in tree.items():
            sq = torch.sum(torch.square(x.float()))
            cut = layout.get(n)
            if cut is None:
                whole_sq = whole_sq + sq
                continue
            parts = sum((torch.sum(torch.square(x[i].float())) for i in cut.whole_index(mg.tp)),
                        zero)
            split_sq, whole_sq = split_sq + sq - parts, whole_sq + parts
        gn = torch.sqrt(reduce_from_model(split_sq, mg) + whole_sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree.values():
        g.copy_((g.float() * scale).to(g.dtype))
    return tree, gn


def _path_lr_scale(name: str, pamm_scale: float) -> float:
    return pamm_scale if set(name.split(".")) & set(PAMM_WEIGHT_KEYS) else 1.0


def _local(name: str, t: torch.Tensor, zero1) -> torch.Tensor:
    if zero1 is None:
        return t
    layout, index, dp = zero1
    return shard_slice(t, layout[name], index, dp)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params: dict, *, moment_dtype=torch.float32, zero1=None) -> OptState:
    """Zeroed moments; under ``zero1`` only this data shard's slices."""
    zeros = lambda n, p: torch.zeros(_local(n, p, zero1).shape, dtype=moment_dtype,
                                     device=p.device)
    return OptState(step=0, m={n: zeros(n, p) for n, p in params.items()},
                    v={n: zeros(n, p) for n, p in params.items()})


@torch.no_grad()
def adamw_update(grads: dict, state: OptState, params: dict, lr: float, *,
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, pamm_lr_scale=1.0,
                 zero1=None):
    step = state.step + 1
    # bias corrections in f32, as the JAX code computes them
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for name, p in params.items():
        p = _local(name, p, zero1)
        g32 = _local(name, grads[name], zero1).float()
        m, v = state.m[name], state.v[name]
        s = _path_lr_scale(name, pamm_lr_scale)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        # ``s`` (paper App. D) scales only the Adam step of PAMM-wrapped
        # weights; decoupled decay stays at the plain lr
        p.copy_((p32 - lr * s * delta - lr * weight_decay * p32).to(p.dtype))
    return params, OptState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) -- factored v, no first moment
# ---------------------------------------------------------------------------
def adafactor_init(params: dict) -> OptState:
    def rows(p):
        shape = p.shape[:-1] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return OptState(step=0, m={n: rows(p) for n, p in params.items()},
                    v={n: cols(p) for n, p in params.items()})


@torch.no_grad()
def adafactor_update(grads: dict, state: OptState, params: dict, lr: float, *,
                     decay=0.8, eps=1e-30, clip_thresh=1.0, weight_decay=0.0,
                     pamm_lr_scale=1.0):
    step = state.step + 1
    beta = float(np.float32(1.0) - np.float32(step) ** np.float32(-decay))
    for name, p in params.items():
        g32 = grads[name].float()
        r, c = state.m[name], state.v[name]
        s = _path_lr_scale(name, pamm_lr_scale)
        sq = g32 * g32 + eps
        if p.dim() >= 2:
            r.copy_(beta * r + (1 - beta) * sq.mean(-1))
            c.copy_(beta * c + (1 - beta) * sq.mean(-2))
            rmean = r.mean(-1, keepdim=True)
            vhat = (r / rmean.clamp_min(eps))[..., None] * c[..., None, :]
        else:
            r.copy_(beta * r + (1 - beta) * sq)
            vhat = r
        u = g32 / torch.sqrt(vhat + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms_u / clip_thresh, min=1.0)
        p32 = p.float()
        p.copy_((p32 - lr * s * u - lr * weight_decay * p32).to(p.dtype))
    return params, OptState(step=step, m=state.m, v=state.v)


def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
