"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
``repro/models/rglru.py``).

Recurrence:  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
with a_t = exp(-c · softplus(Λ) · r_t), r_t = σ(W_a x_t), i_t = σ(W_i x_t),
c = 8, in f32. The block is Griffin's recurrent temporal-mixing layer: a
gated linear unit whose main branch is conv(1d, width 4) -> RG-LRU,
multiplied by a GeLU side branch, then projected back to d_model.

Training and prefill run the linear recurrence ``h_t = a_t h_{t-1} + b_t``
as a log-depth doubling scan over L (:class:`LinearScan`; the JAX package
runs ``lax.associative_scan``, which is no Pallas kernel). A chunked
quadratic form as in the SSD does not fit here: its (B, chunks, T, T, W)
weights at W 4096 would take gigabytes. The scan's backward is the
reverse scan ``g_t = dh_t + a_{t+1} g_{t+1}``, ``db = g``,
``da_t = g_t h_{t-1}``, so training saves a and h (one f32 (B, L, W)
tensor each) instead of every doubling step. Decode is the one-step
update, written into the slot cache in place.

The recurrent branch's input projection ``w_x`` is the ``rglru.in``
compression site (``ctx.apply``: K1 and K2 under a PAMM rule, exact by
default); decode uses a plain product. The gate products ``w_a`` and
``w_i`` run in f32, as in the JAX package.

Under tensor parallelism (``runtime.sharding.model_group`` with ``lru``)
a model rank runs its lru_width/tp columns of the recurrence. The input
enters whole (``tp_enter``); ``w_y`` and the ``rglru.in`` site ``w_x``
are column-parallel (K1 on the whole rows, K2 at the rank's columns),
and so is the conv. The gates read the whole width: the rank's conv
output is all-gathered once a layer in the compute dtype (its f32
gradient reduce-scattered back, ``runtime.collectives.gather_width``),
and ``w_a`` / ``w_i`` hold the rank's output columns, so each rank
computes both gates of its columns exactly. ``lambda`` is whole on every
rank: a rank reads its columns, and their gradient is summed over the
model group. The scan is elementwise over the width and needs no
collective; ``out`` is row-parallel (``tp_exit``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _CacheNode
from repro_torch.models.layers import causal_depthwise_conv, dense_init
from repro_torch.runtime.collectives import copy_to_model, gather_width, tp_enter, tp_exit
from repro_torch.runtime.sharding import model_group

_C = 8.0
_FLOOR = 1e-12


@dataclasses.dataclass
class RGLRUCache(_CacheNode):
    """A slot's recurrent state. Per layer: h (B, W) f32, the RG-LRU state;
    conv_state (B, conv_width-1, W) in the compute dtype, the last
    conv_width-1 conv inputs. Both hold the batch slot at axis 1 when
    stacked over the layers, like a dense KV node."""

    LEAVES: ClassVar[tuple[str, ...]] = ("h", "conv_state")
    h: torch.Tensor
    conv_state: torch.Tensor


def init_rglru(gen: torch.Generator, cfg, dtype) -> dict:
    """One layer's parameters: the projections and conv in ``dtype``,
    ``lambda`` in f32, drawn so that a ∈ (0.9, 0.999) at r = 1 (Griffin
    app. A)."""
    d, w = cfg.d_model, cfg.lru_width
    dev = gen.device
    u = torch.rand((w,), generator=gen, device=dev) * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))
    return {
        "w_y": dense_init(gen, d, w, dtype),        # GeLU side branch
        "w_x": dense_init(gen, d, w, dtype),        # recurrent branch input
        "conv_w": (torch.randn((cfg.conv_width, w), generator=gen, device=dev)
                   * 0.2).to(dtype),
        "w_a": dense_init(gen, w, w, dtype),        # recurrence gate
        "w_i": dense_init(gen, w, w, dtype),        # input gate
        "lambda": lam.float(),
        "out": dense_init(gen, w, d, dtype),
    }


def _sqrt_floor(t):
    """sqrt(max(t, 1e-12)), the maximum's gradient split at a tie as
    ``jnp.maximum``'s is (``torch.maximum`` splits it; ``clamp_min`` would
    pass it whole)."""
    return torch.sqrt(torch.maximum(t, t.new_tensor(_FLOOR)))


def _gates(params, xb, mg=None):
    """(a, b) of the recurrence, f32: the decay a and the gated input
    b = sqrt(1 - a²) · i · x. Under tensor parallelism (``mg``) ``xb``
    holds this rank's columns, the gates read them all (gathered) and
    a, b are the rank's columns."""
    if mg is None:
        x32 = x_own = xb.float()
        lam = params["lambda"]
    else:
        w = xb.shape[-1]
        x32 = gather_width(xb, mg)
        x_own = x32[..., mg.index * w:(mg.index + 1) * w]
        lam = copy_to_model(params["lambda"], mg)[mg.index * w:(mg.index + 1) * w]
    r = torch.sigmoid(x32 @ params["w_a"].float())
    i = torch.sigmoid(x32 @ params["w_i"].float())
    a = torch.exp(-_C * F.softplus(lam.float()) * r)      # log a <= 0
    return a, _sqrt_floor(1.0 - a * a) * (i * x_own)


def _doubling_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1 in ceil(log2 L)
    steps: after the step at offset s, b_t holds the recurrence over the
    last 2s positions up to t and a_t their product."""
    L = a.shape[1]
    off = 1
    while off < L:
        nb = b.clone()
        nb[:, off:].addcmul_(a[:, off:], b[:, :-off])
        b = nb
        if 2 * off < L:
            na = a.clone()
            na[:, off:].mul_(a[:, :-off])
            a = na
        off *= 2
    return b


class LinearScan(torch.autograd.Function):
    """h = scan(a, b) over axis 1 of (B, L, W) f32 tensors; the backward
    is the reverse scan, from the saved a and h."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        # g_t = dh_t + a_{t+1} g_{t+1}: the forward scan over reversed time
        # with the coefficients shifted by one (the first one never read)
        a_next = torch.cat([torch.zeros_like(a[:, :1]), a.flip(1)[:, :-1]], dim=1)
        g = _doubling_scan(a_next, dh.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g


def rglru_train(params, x, cfg, ctx, key, *, return_cache: bool = False):
    """x: (B, L, d_model) -> (B, L, d_model): full-sequence training or
    prefill. ``return_cache``: also return the :class:`RGLRUCache` the
    sequence leaves (its last state and last conv_width-1 conv inputs)."""
    mg = model_group()
    split = mg is not None and mg.lru
    x = tp_enter(x, mg, split)
    y_side = F.gelu(x @ params["w_y"].to(x.dtype), approximate="tanh")
    xb = ctx.apply("rglru.in", x, params["w_x"], None, key)
    xb, conv_state = causal_depthwise_conv(xb, params["conv_w"])
    a, b = _gates(params, xb, mg if split else None)
    h = LinearScan.apply(a, b)
    out = tp_exit((h.to(x.dtype) * y_side) @ params["out"].to(x.dtype), mg, split)
    if return_cache:
        return out, RGLRUCache(h=h[:, -1], conv_state=conv_state)
    return out


def init_rglru_cache(cfg, B: int, dtype, device, layers: int | None = None) -> RGLRUCache:
    """Zero state (optionally stacked over ``layers``)."""
    lead = () if layers is None else (layers,)
    w = cfg.lru_width
    return RGLRUCache(
        h=torch.zeros(lead + (B, w), dtype=torch.float32, device=device),
        conv_state=torch.zeros(lead + (B, cfg.conv_width - 1, w), dtype=dtype,
                               device=device),
    )


def rglru_decode(params, x, cache: RGLRUCache, cfg):
    """One token for every slot: x (B, 1, d_model). Every slot's state
    advances (a parked one too: the next admission overwrites it).
    Updates ``cache`` in place; returns (out, cache)."""
    y_side = F.gelu(x @ params["w_y"].to(x.dtype), approximate="tanh")
    xb = x @ params["w_x"].to(x.dtype)
    xb, conv_state = causal_depthwise_conv(xb, params["conv_w"], cache.conv_state)
    a, b = _gates(params, xb)
    h = a[:, 0] * cache.h + b[:, 0]
    out = (h[:, None].to(x.dtype) * y_side) @ params["out"].to(x.dtype)
    cache.h.copy_(h)
    cache.conv_state.copy_(conv_state)
    return out, cache
