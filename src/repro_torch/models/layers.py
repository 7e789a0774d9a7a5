"""Shared building blocks, serving subset (``repro/models/layers.py``).

Parameters keep the JAX layouts: a projection ``w`` is ``(n_in, n_out)``
applied as ``x @ w``; RMSNorm scales are zero-centred (applied as
``1 + scale``). Initializers draw from an explicit ``torch.Generator`` on
the target device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def ffn_sites(params, x, ctx, key=None):
    """SwiGLU FFN with gate/up/down as projection sites; with every role
    exact (the only case in this slice) it equals :func:`ffn`."""
    g = ctx.apply("ffn.gate", x, params["w_gate"], None, key)
    u = ctx.apply("ffn.up", x, params["w_up"], None, key)
    return ctx.apply("ffn.down", F.silu(g) * u, params["w_down"], None, key)
