"""GQA attention of the dense slice (``repro/models/attention.py``).

Covers the self-attention variants of the dense slice: grouped-query
attention with any H/KV ratio (MQA included), RoPE, optional per-head
qk-norm (qwen3) and QKV bias (qwen2), and sliding-window attention with a
ring-buffer KV cache (h2o-danube).

Training and prefill attention go through K3 (forward) and, under
autograd, K4/K5 (backward); decode attention goes through K6 -- all by way
of :mod:`repro_torch.kernels.ops`: the plain PyTorch versions for CPU
tensors, the hand-written CUDA kernels for CUDA tensors. :func:`sdpa`
stays as the plain reference the tests compare against. The Q/K/V
projections run through the ``attn.qkv`` site of the run's plan: one
compressed state per layer backs all three weight gradients (Fig. 2).

The KV cache is updated in place (``cache_insert``): the JAX package
returns a new cache and donates the old buffers on the TPU, which the
port gets for free by writing into the slab.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.plan import SiteCtx, exact_ctx
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30
LATER_SLICE_PAGED = ("paged, quantised and svd KV caches arrive with the "
                     "port's paged-serving slice (kernels K7, K8)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    kv, d, dh, h = cfg.n_kv_heads, cfg.d_model, cfg.head_dim, cfg.n_heads
    params = {
        "wq": dense_init(gen, d, h * dh, dtype),
        "wk": dense_init(gen, d, kv * dh, dtype),
        "wv": dense_init(gen, d, kv * dh, dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        params["bq"], params["bk"], params["bv"] = zeros(h * dh), zeros(kv * dh), zeros(kv * dh)
    if cfg.qk_norm:
        params["q_norm"], params["k_norm"] = zeros(dh), zeros(dh)
    return params


def _project_qkv(params, x, ctx: SiteCtx, cfg, key=None):
    """Q, K, V of self-attention from one shared projection site."""
    dh = cfg.head_dim
    h = params["wq"].shape[1] // dh
    kv = params["wk"].shape[1] // dh
    biases = [params.get("bq"), params.get("bk"), params.get("bv")]
    q, k, v = ctx.apply_shared(
        "attn.qkv", x, [params["wq"], params["wk"], params["wv"]], biases, key)
    q = q.reshape(*x.shape[:-1], h, dh)
    k = k.reshape(*x.shape[:-1], kv, dh)
    v = v.reshape(*x.shape[:-1], kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# plain reference (tests only)
# ---------------------------------------------------------------------------
def sdpa(q, k, v, q_pos, k_pos, *, causal: bool, window: int, chunk: int):
    """q: (B,Lq,H,dh); k,v: (B,Lk,KV,dh); *_pos: (B, L*) (-1 = invalid).
    Position-masked attention over query chunks; returns (B, Lq, H, dh)."""
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    k32, v32 = k.float(), v.float()
    outs = []
    for s in range(0, Lq, chunk):
        qb = q[:, s:s + chunk]
        qp = q_pos[:, s:s + chunk]
        n = qb.shape[1]
        qg = qb.reshape(B, n, KV, G, dh).float()
        scores = torch.einsum("bqkgd,blkd->bkgql", qg, k32) * dh ** -0.5
        kp = k_pos[:, None, None, None, :]
        qq = qp[:, None, None, :, None]
        mask = kp >= 0
        if causal:
            mask = mask & (kp <= qq)
        if window > 0:
            mask = mask & (qq - kp < window)
        mask = mask & (qq >= 0)
        probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        out = torch.einsum("bkgql,blkd->bqkgd", probs, v32)
        outs.append(out.reshape(B, n, H, dh).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Dense slot cache. Per layer: k, v (B, S, KV, dh) and slot_pos (B, S)
    int32, the absolute position held by each slot (-1 = empty); S is
    max_len, or the window for a ring cache. A stage's cache stacks its
    layers on a leading axis (:meth:`layer` gives one layer's views).
    ``ring`` is host metadata here, not a device leaf as in JAX."""

    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    ring: bool

    def layer(self, r: int) -> "KVCache":
        return KVCache(self.k[r], self.v[r], self.slot_pos[r], self.ring)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.k, self.v, self.slot_pos)


def init_kv_cache(B: int, S: int, kv: int, dh: int, dtype, ring: bool,
                  device, layers: int | None = None) -> KVCache:
    lead = () if layers is None else (layers,)
    return KVCache(
        k=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
        v=torch.zeros(lead + (B, S, kv, dh), dtype=dtype, device=device),
        slot_pos=torch.full(lead + (B, S), -1, dtype=torch.int32, device=device),
        ring=bool(ring),
    )


def cache_insert(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Write Ln new entries (B, Ln, KV, dh) at their absolute positions
    (B, Ln), in place: slot = position (ring: modulo S); a position < 0,
    or past S in a non-ring cache, is dropped (JAX's ``mode="drop"``).

    With Ln == 1 (decode) each row writes one slot, so the update is a
    gather-select-scatter with no host sync: a dropped row writes back the
    value it read. With Ln > 1 (prefill) the valid entries are compacted;
    in a ring only each row's last S positions are kept, which is the
    last-write-wins result of writing the (distinct, increasing) positions
    in order."""
    B, S = cache.slot_pos.shape
    slots = positions % S if cache.ring else positions
    valid = positions >= 0
    if not cache.ring:
        valid = valid & (positions < S)
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)
    positions = positions.to(cache.slot_pos.dtype)
    if positions.shape[1] == 1:
        b = torch.arange(B, device=positions.device)[:, None]
        idx = torch.where(valid, slots, 0).long()
        keep = valid[..., None, None]
        cache.k[b, idx] = torch.where(keep, k_new, cache.k[b, idx])
        cache.v[b, idx] = torch.where(keep, v_new, cache.v[b, idx])
        cache.slot_pos[b, idx] = torch.where(valid, positions, cache.slot_pos[b, idx])
        return cache
    if cache.ring:
        last = torch.where(valid, positions, -1).amax(dim=1, keepdim=True)
        valid = valid & (positions > last - S)
    bi, li = valid.nonzero(as_tuple=True)
    si = slots[bi, li].long()
    cache.k[bi, si] = k_new[bi, li]
    cache.v[bi, si] = v_new[bi, li]
    cache.slot_pos[bi, si] = positions[bi, li]
    return cache


# ---------------------------------------------------------------------------
# block-level entry points
# ---------------------------------------------------------------------------
def attn_train(params, x, positions, cfg, ctx: SiteCtx, key=None, *, window: int):
    """Self-attention over a full sequence (training / prefill math).

    Differentiable: ``ops.flash_attention`` runs K3 forward and, under
    autograd, K4/K5 backward from the saved (q, k, v, o, lse). The kernels
    mask by iota, i.e. they assume contiguous ``arange`` positions (true
    for the training batch and prefill; ``positions`` feeds RoPE). Rows
    marked with a position < 0 are zeroed, as the JAX kernel branch does.
    ``key``: the block's key, from which the ``attn.qkv`` site draws.
    Returns (out @ wo, (k_roped, v)) -- the pair the prefill cache stores.
    """
    q, k, v = _project_qkv(params, x, ctx, cfg, key)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out = torch.where(positions[..., None, None] >= 0, out, 0.0)
    out = out.reshape(*x.shape[:-1], -1)
    return out @ params["wo"].to(x.dtype), (k, v)


def attn_decode(params, x, positions, cache, cfg, *, window: int):
    """Decode attention through K6: x (B, 1, d), positions (B, 1) absolute
    (-1 = parked slot). Inserts this step's K/V into the dense slot cache
    in place, then attends over the slab."""
    if not isinstance(cache, KVCache):
        raise NotImplementedError(LATER_SLICE_PAGED)
    q, k, v = _project_qkv(params, x, exact_ctx(), cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = cache_insert(cache, k, v, positions)
    q_pos = positions.reshape(-1) if positions.shape[1] == 1 else positions
    out = ops.flash_decode(q, cache.k, cache.v, q_pos, cache.slot_pos,
                           causal=True, window=window)
    out = out.reshape(*x.shape[:-1], -1)
    return out @ params["wo"].to(x.dtype), cache
