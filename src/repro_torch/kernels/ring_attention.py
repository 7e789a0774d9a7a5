"""Ring context-parallel attention around K3 / K4 / K5
(``repro/kernels/ring_attention.py``).

The sequence axis shards over the ``cp`` ranks of the mesh's context
axis. Zigzag (fold-in-half) sharding splits the global sequence into
``2 * cp`` chunks of ``C = L / (2 * cp)``; rank ``i`` owns chunks ``(i,
2cp-1-i)``, an equal mix of early and late positions, so every rank does
the same causal work. Each rank keeps its q shard; its k / v shard
rotates around the ring (:func:`~repro_torch.runtime.collectives.ring_shift`),
and every ring step splits into the four (q-chunk, kv-chunk) pairs, each
run through K3 with its global offsets ``(q_off, k_off)`` and merged into
the rank's output with the NEG_INF-safe online-softmax merge. A pair whose
whole score block the causal mask or the window kills is not launched
(:func:`ring_pair_live`). With no window that leaves ``2cp + 1`` pairs per
rank and pass.

Offsets need no transport: after ``s`` rotations rank ``i`` holds the kv
of rank ``(i - s) % cp``, and its chunks' offsets follow from that index.
(The JAX package ships them through ``ppermute`` only because
``axis_index`` does not lower under partial-auto ``shard_map``.)

The backward is one co-rotation: ``(k, v, dk, dv)`` rotate together for
exactly ``cp`` steps, a full circle, so the dk / dv accumulators arrive at
the rank that owns those keys; dq accumulates in place. Each pair's
gradients come from K4 / K5 given the *merged* ``(o, lse)``: with the
global lse, ``p = exp(s - lse)`` is the exact slice of the full-sequence
probability row, so the pair gradients sum to the full-sequence gradient.
The autograd Function saves the shard's ``(q, k, v, o, lse)`` only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.runtime.collectives import ring_shift

__all__ = ["ring_attention", "ring_pair_live", "zigzag_permutation",
           "zigzag_inverse_permutation", "zigzag_shard_positions", "live_pairs"]


# ---------------------------------------------------------------------------
# zigzag layout
# ---------------------------------------------------------------------------
def zigzag_permutation(L: int, cp: int) -> np.ndarray:
    """Index permutation putting the zigzag layout into contiguous shards:
    ``x[perm]`` reorders a length-``L`` sequence so that its ``i``-th
    contiguous slice of ``L // cp`` tokens holds global chunks ``(i,
    2*cp - 1 - i)``."""
    if L % (2 * cp):
        raise ValueError(f"L={L} not divisible by 2*cp={2 * cp}")
    C = L // (2 * cp)
    order = []
    for i in range(cp):
        order.extend([i, 2 * cp - 1 - i])
    return np.concatenate([np.arange(c * C, (c + 1) * C) for c in order])


def zigzag_inverse_permutation(L: int, cp: int) -> np.ndarray:
    """Inverse of :func:`zigzag_permutation` (restores global order)."""
    perm = zigzag_permutation(L, cp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(L)
    return inv


def zigzag_shard_positions(shard: int, L: int, cp: int, device="cpu") -> torch.Tensor:
    """Global positions (length ``L // cp``, int32) owned by ``shard``:
    RoPE's positions and the ring's mask offsets."""
    C = L // (2 * cp)
    ar = torch.arange(C, dtype=torch.int32, device=device)
    return torch.cat([shard * C + ar, (2 * cp - 1 - shard) * C + ar])


def _chunk_offsets(shard: int, C: int, cp: int) -> tuple[int, int]:
    return shard * C, (2 * cp - 1 - shard) * C


# ---------------------------------------------------------------------------
# pair-level liveness
# ---------------------------------------------------------------------------
def ring_pair_live(q_off: int, k_off: int, C: int, *, causal: bool, window: int) -> bool:
    """False iff the whole (q-chunk, kv-chunk) score block is masked: q
    rows span ``[q_off, q_off + C)`` and keys ``[k_off, k_off + C)``."""
    live = True
    if causal:
        live = live and k_off <= q_off + (C - 1)
    if window > 0:
        live = live and k_off + (C - 1) > q_off - window
    return live


def live_pairs(index: int, cp: int, C: int, *, causal: bool = True, window: int = 0) -> int:
    """How many chunk pairs rank ``index`` launches in one ring pass."""
    offs = _chunk_offsets(index, C, cp)
    n = 0
    for s in range(cp):
        ko = _chunk_offsets((index - s) % cp, C, cp)
        n += sum(ring_pair_live(qo, k, C, causal=causal, window=window)
                 for qo in offs for k in ko)
    return n


# ---------------------------------------------------------------------------
# partial merge (online softmax across kv shards)
# ---------------------------------------------------------------------------
def _merge(o_a, lse_a, o_b, lse_b):
    """Merge two attention partials over disjoint key sets. o: (B, C, H,
    dh) f32, lse: (B, H, C) f32. NEG_INF-safe: when both sides are dead
    the weights are 1/2 each over zero outputs (no NaN); one dead side gets
    weight exp(NEG_INF - m) == 0 exactly."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    tot = wa + wb
    lse = m + torch.log(tot)
    ca = (wa / tot).transpose(1, 2)[..., None]
    cb = (wb / tot).transpose(1, 2)[..., None]
    return o_a * ca + o_b * cb, lse


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------
def _pairs(ring, step: int, C: int, causal: bool, window: int):
    """The live (aq, ak, q_off, k_off) of ring step ``step``: q chunk aq of
    this rank against kv chunk ak of rank (index - step) % cp."""
    q_offs = _chunk_offsets(ring.index, C, ring.cp)
    k_offs = _chunk_offsets((ring.index - step) % ring.cp, C, ring.cp)
    for aq, qo in enumerate(q_offs):
        for ak, ko in enumerate(k_offs):
            if ring_pair_live(qo, ko, C, causal=causal, window=window):
                yield aq, ak, qo, ko


def _fwd_ring(q, k, v, ring, causal: bool, window: int):
    """Ring forward on this rank's shard q (B, 2C, H, dh), k / v (B, 2C,
    KV, dh): o in q's dtype and lse (B, H, 2C) f32."""
    B, Lc, H, dh = q.shape
    C = Lc // 2
    o32 = torch.zeros((B, Lc, H, dh), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Lc), NEG_INF, dtype=torch.float32, device=q.device)
    for s in range(ring.cp):
        for aq, ak, qo, ko in _pairs(ring, s, C, causal, window):
            qs, ks = slice(aq * C, (aq + 1) * C), slice(ak * C, (ak + 1) * C)
            po, plse = ops.flash_attention_fwd(q[:, qs], k[:, ks], v[:, ks], causal=causal,
                                               window=window, offs=(qo, ko))
            mo, mlse = _merge(o32[:, qs], lse[:, :, qs], po.float(), plse)
            o32[:, qs] = mo
            lse[:, :, qs] = mlse
        if s != ring.cp - 1:
            k, v = ring_shift([k, v], ring)
    # rows dead across every kv shard emit exact zeros, not 0/0 artifacts
    dead = (lse <= NEG_INF / 2).transpose(1, 2)[..., None]
    # contiguous: the kernels take (heads, dh) rows laid out densely, and
    # where() would follow the transposed mask's strides
    return torch.where(dead, 0.0, o32).to(q.dtype).contiguous(), lse


def _bwd_ring(q, k, v, o, lse, do, ring, causal: bool, window: int):
    B, Lc, H, dh = q.shape
    KV = k.shape[2]
    C = Lc // 2
    # zero dO on globally dead rows so their partials vanish
    dead = (lse <= NEG_INF / 2).transpose(1, 2)[..., None]
    do = torch.where(dead, 0.0, do.float()).to(q.dtype).contiguous()
    lse_c = [lse[:, :, :C].contiguous(), lse[:, :, C:].contiguous()]
    dq = torch.zeros((B, Lc, H, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Lc, KV, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s in range(ring.cp):
        for aq, ak, qo, ko in _pairs(ring, s, C, causal, window):
            qs, ks = slice(aq * C, (aq + 1) * C), slice(ak * C, (ak + 1) * C)
            pdq, pdk, pdv = ops.flash_attention_bwd(
                q[:, qs], k[:, ks], v[:, ks], o[:, qs], lse_c[aq], do[:, qs],
                causal=causal, window=window, offs=(qo, ko))
            dq[:, qs] += pdq.float()
            dk[:, ks] += pdk.float()
            dv[:, ks] += pdv.float()
        # rotate after every step (cp rotations = a full circle), carrying
        # the accumulators with their kv: they end at the owning rank
        k, v, dk, dv = ring_shift([k, v, dk, dv], ring)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """The ring with FlashAttention-2's residuals: saves this shard's
    ``(q, k, v, o, lse)``, O(L / cp) per rank."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool, window: int):
        o, lse = _fwd_ring(q, k, v, ring, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring, ctx.causal, ctx.window = ring, causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_ring(q, k, v, o, lse, do.contiguous(), ctx.ring,
                               ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, *, ring, causal: bool = True, window: int = 0):
    """Context-parallel attention over a zigzag-sharded sequence, for the
    rank ``ring`` (:class:`~repro_torch.runtime.sharding.RingGroup`). q:
    (B, Lc, H, dh) and k / v: (B, Lc, KV, dh) are this rank's two chunks
    (Lc = L / cp), at the global positions of
    :func:`zigzag_shard_positions` (which RoPE has already applied; the
    masks take them from the rank). Differentiable: the backward runs the
    co-rotation, every rank of the ring together."""
    if q.shape[1] % 2:
        raise ValueError(f"zigzag shard length {q.shape[1]} must be even")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Ring.apply(q, k, v, ring, causal, window)
    return _fwd_ring(q, k, v, ring, causal, window)[0]
