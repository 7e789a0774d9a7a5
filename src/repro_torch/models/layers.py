"""Shared building blocks of the dense slice (``repro/models/layers.py``).

Parameters keep the JAX layouts: a projection ``w`` is ``(n_in, n_out)``
applied as ``x @ w``; RMSNorm scales are zero-centred (applied as
``1 + scale``). Initializers draw from an explicit ``torch.Generator`` on
the target device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.runtime import sharding as sh
from repro_torch.runtime.collectives import (model_max_, reduce_from_model, tp_enter,
                                              tp_exit)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, n_in: int, n_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
    w = torch.randn((n_in, n_out), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, L, H, dh); positions: (B, L) integer."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs                  # (B, L, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def ffn(params, x):
    h = F.silu(x @ params["w_gate"].to(x.dtype)) * (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


def ffn_sites(params, x, ctx, key=None, *, shared: bool = False):
    """SwiGLU FFN with gate/up/down as compression sites; with every role
    exact it equals :func:`ffn`. Gate and up read the same x, so when both
    resolve to the same policy ONE compressed state backs both weight
    gradients (telemetry lands on ffn.gate).

    Under tensor parallelism with the FFN width split (``ModelGroup.ffn``;
    a MoE block's shared experts, ``shared``, by ``ModelGroup.shared``),
    gate and up are column-parallel (x whole on every model rank, this
    rank's columns; a compressed site draws the same state on every rank
    from the same key, and K2 takes the local columns of dZ) and down is
    row-parallel (its partial sums summed over the model group; a
    compressed ``ffn.down`` runs its policy's split route over the group,
    ``core/linear.py``)."""
    mg = sh.model_group()
    split = mg is not None and (mg.shared if shared else mg.ffn)
    x = tp_enter(x, mg, split)
    gate_site = ctx.site("ffn.gate")
    up_site = ctx.site("ffn.up")
    if (gate_site is not None and up_site is not None
            and up_site.shared_with == gate_site.path):
        g, u = ctx.apply_shared("ffn.gate", x, [params["w_gate"], params["w_up"]],
                                [None, None], key)
    else:
        g = ctx.apply("ffn.gate", x, params["w_gate"], None, key)
        u = ctx.apply("ffn.up", x, params["w_up"], None, key)
    down = ctx.apply("ffn.down", F.silu(g) * u, params["w_down"], None, key,
                     split=mg if split else None)
    return tp_exit(down, mg, split)


# ---------------------------------------------------------------------------
# causal depthwise conv (width W), used by the ssm block
# ---------------------------------------------------------------------------
def causal_depthwise_conv(x, w, state=None):
    """x: (B, L, C); w: (W, C). Returns (y, new_state).

    ``state`` is the last W-1 inputs of the previous segment (B, W-1, C);
    None means zero history (training from position 0). The new state is
    the last W-1 rows of ``concat(state, x)``, so a segment shorter than
    W-1 keeps part of the old state."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)            # (B, W-1+L, C)
    L = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + L] * w[i].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y, new_state


def init_depthwise_conv(gen: torch.Generator, width: int, channels: int, dtype) -> torch.Tensor:
    w = torch.randn((width, channels), generator=gen, device=gen.device)
    return (w / math.sqrt(width)).to(dtype)


# ---------------------------------------------------------------------------
# chunked softmax cross-entropy
# ---------------------------------------------------------------------------
def chunked_cross_entropy(h, w_head, labels, mask, chunk: int,
                          valid_vocab: int | None = None, site=None, key=None):
    """Mean token NLL without materializing (B, L, V) at once.

    h: (B, L, d) final hidden states; w_head: (d, V), or a view of one
    codebook's columns of a multi-codebook head; labels: (B, L) int;
    mask: (B, L) {0,1} float. Loops over sequence chunks (padded to a
    whole chunk, as the JAX scan does); inside a chunk the logits are
    (B, chunk, V) f32, and vocab columns past ``valid_vocab`` get -1e30.

    ``site``/``key``: the plan's ``lm_head`` site. When given and not
    exact, each chunk's hidden states are compressed for the head's weight
    gradient with key ``key.fold_in(chunk)``, and the call returns
    ``(loss, stats)`` with the site telemetry summed over chunks.

    Under tensor parallelism with the vocabulary split (``w_head`` this
    rank's columns [index * V/tp, (index + 1) * V/tp)), the cross-entropy
    is vocabulary-parallel: h is whole on every model rank (gathered over
    the sequence under ``seq_shard``), each chunk's row max is the max
    over the ranks, and the sum of exp and the target's logit are summed
    over them, so every rank gets the one loss and its gradient reaches
    the local columns only. A compressed head compresses the same h with
    the same key on every rank.
    """
    mg = sh.model_group()
    vp = mg is not None and mg.vocab
    h = tp_enter(h, mg, vp)
    B, L, d = h.shape
    chunk = min(chunk, L)
    n_chunks = (L + chunk - 1) // chunk
    pad = n_chunks * chunk - L
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    v_total = w_head.shape[1]
    v0 = mg.index * v_total if vp else 0
    compressed = site is not None and not site.is_exact
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    stats = torch.zeros((5,), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        hb = h[:, c * chunk:(c + 1) * chunk]
        lb = labels[:, c * chunk:(c + 1) * chunk]
        mb = mask[:, c * chunk:(c + 1) * chunk].float()
        if compressed:
            z, st = site.apply(hb, w_head, None, key.fold_in(c))
            logits = z.float()
            if st is not None:
                stats = stats + st
        else:
            logits = (hb @ w_head.to(hb.dtype)).float()
        if valid_vocab is not None and valid_vocab < v0 + v_total:
            col = torch.arange(v0, v0 + v_total, device=h.device)
            logits = logits.masked_fill(col >= valid_vocab, -1e30)
        if vp:
            logz, gold = _vocab_parallel_terms(logits, lb.long() - v0, mg)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
        tot = tot + ((logz - gold) * mb).sum()
        cnt = cnt + mb.sum()
    loss = tot / cnt.clamp_min(1.0)
    if site is not None:
        return loss, stats
    return loss


def _vocab_parallel_terms(logits, local_labels, mg):
    """(logsumexp over the whole vocabulary, the target's logit) of
    ``logits`` (B, c, V/tp) f32, this rank's columns: the row max is the
    max over the model ranks (a constant of the gradient), the sum of exp
    and the target logit (0 on the ranks whose columns do not hold it)
    are summed over them with an identity backward, so each rank's
    gradient lands on its own columns."""
    with torch.no_grad():
        m = model_max_(logits.max(dim=-1).values.contiguous(), mg)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    inside = (local_labels >= 0) & (local_labels < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local_labels, 0)[..., None])[..., 0]
    gold = torch.where(inside, gold, 0.0)
    both = reduce_from_model(torch.stack([sumexp, gold]), mg)
    return m + torch.log(both[0]), both[1]
