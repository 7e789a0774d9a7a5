"""Token sampling for the serving engine: greedy / temperature / top-k
(``repro/serve/sampling.py``).

All sampling state is vectorised over batch slots, so one call serves a
continuously-batched mix of requests with different settings. The random
draw of a row is a pure function of (request seed, index of the token
within the request, token id) -- never of the slot or the engine's step
-- so a request samples identically alone or packed with others.

JAX draws with threefry, which PyTorch cannot reproduce; the port uses a
stateless counter-based integer hash instead (:func:`uniform_bits`), on
the device, with no host loop per row. The two packages therefore draw
different tokens from the same seed; what both guarantee is the contract
above. Greedy rows take the argmax and draw nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


class SamplingParams(NamedTuple):
    """Per-request sampling configuration: temperature <= 0 is greedy;
    top_k <= 0 keeps the whole vocabulary as support."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def _mix32(x):
    """A 32-bit avalanche finalizer on int64 tensors holding values in
    [0, 2**32). The multipliers stay below 2**31, so no product overflows
    int64 before the mask."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def uniform_bits(seeds, token_idx, V: int):
    """(B, V) uniforms in (0, 1), a pure function of (seed[b],
    token_idx[b], v)."""
    s = _mix32(seeds.long() & _M32)
    t = _mix32((s ^ (token_idx.long() & _M32)) * 0x27D4EB2F & _M32)
    v = torch.arange(V, dtype=torch.int64, device=seeds.device)
    h = _mix32((t[:, None] + v[None, :] * 0x165667B1) & _M32)
    return ((h >> 8).double() + 0.5) * 2.0 ** -24


def sample_tokens(logits, seeds, token_idx, temperature, top_k, *,
                  any_sampling: bool = True):
    """logits (B, V) f32; seeds, token_idx, top_k (B,) int; temperature (B,)
    f32. Returns (B,) int64 token ids.

    Rows with temperature <= 0 are greedy. Rows with top_k > 0 restrict
    the support to exactly the k highest logits: ranks come from a stable
    descending sort, so when logits tie at the k-th value the lower token
    index wins and exactly k tokens survive. ``any_sampling=False`` (the
    caller knows every row is greedy) skips the sort and the draw.
    """
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampling:
        return greedy
    B, V = logits.shape
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    order = torch.sort(scaled, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(V, device=logits.device).expand(B, V))
    support = (top_k[:, None] <= 0) | (ranks < torch.clamp(top_k, 1, V)[:, None])
    masked = torch.where(support, scaled, NEG_INF)
    u = uniform_bits(seeds, token_idx, V)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked.double() + gumbel, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
