"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch, the
port of ``repro/models/moe.py``.

Tokens are sorted by expert id and placed in a dense ``(E, capacity, d)``
buffer, as in the JAX package:

  1. router logits (f32) -> softmax -> top-k, the weights renormalised;
  2. the T k (token, expert) pairs sorted by expert id (stable);
  3. rank within an expert = sorted position - the expert's first one;
  4. rows past the capacity are dropped (capacity_factor 1.25);
  5. the experts' SwiGLU as batched products (``torch.bmm``, where the
     JAX package has ``einsum('ecd,edf->ecf')``); under a plan the gate and
     up products run through the ``moe.expert`` site (one PAMM state per
     expert, :meth:`core.linear.CompressedSite.apply_batched`);
  6. each token's k expert outputs gathered back, weighted and summed.

A load-balance auxiliary loss (Switch §2.2) is returned alongside.

Every shape is static, as under ``jit``: no ``nonzero``, ``unique`` or
boolean indexing, nothing read back to the host. Which pairs are dropped
depends on the order of the k slots and of the sort, so the port keeps
JAX's: top-k ties go to the lower expert id (a stable descending sort),
the pair sort is stable, and the router product stays in full f32 (a TF32
near tie would route a token elsewhere). The JAX scatters
(``.at[dest].set(..., mode="drop")`` and the combine's
``.at[src_tok].add``) become writes into a buffer one row longer whose
last row takes the dropped pairs, and gathers through the pair -> slot
map: each token owns exactly k pairs, so its k rows are gathered into
(T, k, d) and summed over k in a fixed order. The dispatch's backward
does the same (:class:`_Dispatch`), and the combine's backward gathers
through the slot -> pair map (:class:`_Combine`), so no float is ever
added by an atomic and two runs give the same bits.

``token_blocks > 1`` is the JAX package's per-data-shard dispatch: the
(T, d) tokens split into that many contiguous blocks (when T divides by
it; otherwise one block, silently, as in JAX), each routed and dropped on
its own at its own capacity, the aux loss the blocks' mean. The JAX
package ``vmap``s the blocks onto the data axis; the port runs them in
order on its one device, each through the same gather-combine. The blocked
path trains exact: no ``moe.expert`` state (and so no batched K1 / K2),
the shared experts exact too, with the JAX warning naming the hot sites.

Under tensor parallelism whose model axis splits the E' experts
(``ModelGroup.experts``; the JAX ``experts -> model`` rule), a rank holds
experts [index E'/tp, (index + 1) E'/tp): every model rank holds the whole
tokens (``tp_enter``: the input's gradient is summed over the group) and
the whole f32 router, routes them and builds the one dispatch plan over
the global E', but its buffer holds only its experts' slots. It runs
their SwiGLU (the ``moe.expert`` site's batched K1 / K2 over them, each
expert drawing what one process draws), combines only the pairs routed
to them (the others add zero rows), and the output is summed over the
group (``tp_exit``), blocked dispatch alike. The router's gradient is
then the sum of the ranks' shares of the combine's gate-weight gradient
(``copy_to_model`` on the router), while the balance loss's is whole on
every rank: its backward is scaled by 1 / tp (:func:`aux_grad_share`) so
the sum counts it once. The shared experts are the column- and
row-parallel FFN of their own width (``ModelGroup.shared``). Where tp
does not divide E', every rank holds every expert and nothing is summed.
"""
from __future__ import annotations

import contextlib
import math
import warnings

import torch
import torch.nn.functional as F

from repro_torch.core.plan import exact_ctx
from repro_torch.models.layers import dense_init, ffn_sites, init_ffn
from repro_torch.runtime.collectives import copy_to_model, tp_enter, tp_exit
from repro_torch.runtime.sharding import data_shards, model_group

__all__ = ["moe_capacity", "init_moe", "moe_ffn", "route", "dispatch_plan"]

def moe_capacity(n_tokens: int, cfg) -> int:
    tk = n_tokens * cfg.n_experts_per_tok
    cap = math.ceil(tk / cfg.n_experts * cfg.capacity_factor)
    return max(4, min(cap, tk))


def init_moe(gen: torch.Generator, cfg, dtype, *, e_pad: int = 0) -> dict:
    """Router (d, E) f32 whatever ``dtype``; experts stacked (E', d, f) /
    (E', f, d) with E' = max(E, e_pad): the padding experts are zero and
    never routed to, so the function is the same (``repro/models/moe.py``)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ep = max(e, e_pad)

    def experts(n_in, n_out):
        w = torch.randn((e, n_in, n_out), generator=gen, device=gen.device) / math.sqrt(n_in)
        return F.pad(w, (0, 0, 0, 0, 0, ep - e)).to(dtype)

    params = {
        "router": dense_init(gen, d, e, torch.float32, scale=0.02),
        "w_gate": experts(d, f),
        "w_up": experts(d, f),
        "w_down": experts(f, d),
    }
    if cfg.n_shared_experts:
        params["shared"] = init_ffn(gen, d, cfg.moe_d_ff * cfg.n_shared_experts, dtype)
    return params


@contextlib.contextmanager
def _full_f32():
    """Matrix products in full f32 inside (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    if not prev:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(router, x2d, k: int):
    """(probs (T, E) f32, gate_w (T, k), gate_i (T, k) int64): the softmax
    of the f32 router logits and its k largest entries, renormalised; ties
    go to the lower expert id, first (``jax.lax.top_k``)."""
    with _full_f32():
        logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = vals[:, :k], idx[:, :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_i


def dispatch_plan(gate_i, cap: int, ep: int):
    """Where each (token, expert) pair goes: (perm, dest, pair_slot,
    slot_pair).

    ``perm`` sorts the flat pairs (token-major) by expert id, stably;
    ``dest`` (sorted order) is each pair's slot ``expert * cap + rank`` in
    the (ep cap) buffer, or ``ep * cap`` when its rank reaches the
    capacity (dropped); ``pair_slot`` (T, k) is ``dest`` in pair order;
    ``slot_pair`` (ep cap,) the flat pair each slot holds, -1 if none."""
    t, k = gate_i.shape
    flat_e = gate_i.reshape(-1)
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    experts = torch.arange(ep, device=gate_i.device)
    starts = torch.searchsorted(sorted_e, experts)           # each expert's first slot
    rank = torch.arange(t * k, device=gate_i.device) - starts[sorted_e]
    dest = torch.where(rank < cap, sorted_e * cap + rank, ep * cap)
    pair_slot = torch.empty_like(dest).scatter_(0, perm, dest)  # a permutation: no collision
    slot_pair = torch.full((ep * cap + 1,), -1, dtype=dest.dtype, device=dest.device)
    slot_pair[dest] = perm                       # only the drop row ep cap collides
    return perm, dest, pair_slot.view(t, k), slot_pair[:-1]


def _gather_pairs(rows, pair_slot):
    """(T, k, d): the row of each pair's slot, a zero row for a dropped
    pair (``pair_slot`` ep cap). Gathers within ``rows``, no copy of it."""
    n = rows.shape[0]
    got = rows[pair_slot.clamp_max(n - 1)]
    return torch.where((pair_slot < n)[..., None], got, got.new_zeros(()))


class _Dispatch(torch.autograd.Function):
    """The (ep cap, d) expert buffer from the tokens x2d (T, d).

    Forward: rows gathered through ``slot_src`` (the token of each slot, -1
    for an empty one; ``gather_dispatch``), or (``scatter`` = (dest,
    src_tok)) the sorted pairs' rows written at ``dest`` into a buffer one
    row longer, whose last row takes the dropped pairs. Backward: each
    token's k slots gathered through ``pair_slot`` (T, k) and summed over
    k in a fixed order -- the JAX scatter-add without atomics."""

    @staticmethod
    def forward(ctx, x2d, slot_src, pair_slot, scatter):
        ctx.save_for_backward(pair_slot)
        if scatter is None:
            rows = x2d[slot_src.clamp_min(0)]
            return torch.where((slot_src >= 0)[:, None], rows, torch.zeros_like(rows))
        dest, src_tok = scatter
        buf = x2d.new_zeros((slot_src.shape[0] + 1, x2d.shape[1]))
        buf[dest] = x2d[src_tok]
        return buf[:-1]

    @staticmethod
    def backward(ctx, g):
        (pair_slot,) = ctx.saved_tensors
        return _gather_pairs(g, pair_slot).sum(1), None, None, None


class _Combine(torch.autograd.Function):
    """out[t] = sum_j (h[pair_slot[t, j]] (f32) * gate_w[t, j]) in h's
    dtype, j in order: each token's k expert outputs gathered, weighted
    and summed (the JAX ``.at[src_tok].add``). Backward: the slots' rows
    gathered from the output gradient through ``slot_pair`` (each slot
    feeds at most one pair) and the gate weights' gradient from the same
    gather as the forward -- no scatter-add, no atomics. The forward keeps
    h, not the (T, k, d) gather."""

    @staticmethod
    def forward(ctx, h, gate_w, pair_slot, slot_pair):
        ctx.save_for_backward(h, gate_w, pair_slot, slot_pair)
        contrib = _gather_pairs(h, pair_slot).float() * gate_w[..., None]
        return contrib.to(h.dtype).sum(1)

    @staticmethod
    def backward(ctx, g):
        h, gate_w, pair_slot, slot_pair = ctx.saved_tensors
        k = pair_slot.shape[1]
        g32 = g.float()
        pair = slot_pair.clamp_min(0)
        dh = g32[pair // k] * gate_w.reshape(-1)[pair][:, None]
        dh = torch.where((slot_pair >= 0)[:, None], dh, torch.zeros_like(dh)).to(h.dtype)
        dgate = None
        if ctx.needs_input_grad[1]:
            dgate = torch.bmm(_gather_pairs(h, pair_slot).float(), g32[:, :, None])[..., 0]
        return dh, dgate, None, None


def aux_grad_share(tp: int) -> float:
    """The share of the balance loss's gradient each of ``tp`` expert-parallel
    ranks keeps (module docstring)."""
    return 1.0 / tp


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def moe_ffn(params, x, cfg, *, gather_dispatch: bool = True, token_blocks: int = 1,
            ctx=None, key=None, with_aux: bool = True):
    """x: (B, L, d) or (T, d). Returns (out, aux_loss); aux is None when
    ``with_aux`` is False (decode, where nothing reads it).

    ``ctx`` / ``key`` (the block's SiteCtx and key) enable the
    ``moe.expert`` site: per-expert compressed states back the gate / up
    weight gradients. ``gather_dispatch`` builds the buffer by gathering
    rows through a slot -> token map instead of scattering the rows; both
    give the same buffer. ``token_blocks`` > 1 dispatches each of that
    many contiguous token blocks on its own, exact (module docstring); on
    a rank of the mesh executor, whose tokens are its data shard's, its
    share of them (``runtime.sharding.data_shards``). Under a model group
    that splits the experts, this rank's share of them (module docstring)."""
    mg = model_group()
    split = mg is not None and mg.experts
    experts = None
    x_in, d = x, x.shape[-1]
    if mg is not None:
        x = tp_enter(x, mg, split)      # the whole tokens on every model rank
    if split:
        e_loc = params["w_gate"].shape[0]
        experts = (mg.index * e_loc, mg.tp * e_loc)
        params = {**params, "router": copy_to_model(params["router"], mg)}
    lead = x.shape[:-1]
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    n_blocks = token_blocks // data_shards()
    blocked = token_blocks > 1 and t % n_blocks == 0
    if blocked:
        if ctx is not None:
            hot = [r for r in ("moe.expert", "ffn.gate", "ffn.up", "ffn.down")
                   if (site := ctx.site(r)) is not None and not site.is_exact]
            if hot:
                warnings.warn(
                    f"compression sites {hot} are not applied on the blocked "
                    f"(moe_token_blocks={token_blocks}) MoE dispatch path; "
                    "they train exact for this run", stacklevel=2)
        blocks = [_moe_tokens(params, xb, cfg, gather_dispatch, with_aux=with_aux,
                              experts=experts)
                  for xb in x2d.split(t // n_blocks)]
        out = torch.cat([o for o, _ in blocks])
        aux = torch.stack([a for _, a in blocks]).mean() if with_aux else None
    else:
        out, aux = _moe_tokens(params, x2d, cfg, gather_dispatch, ctx=ctx, key=key,
                               with_aux=with_aux, experts=experts)
    out = out.reshape(*lead, d)
    if mg is not None:
        out = tp_exit(out, mg, split)
    if split and aux is not None:
        aux = _ScaleGrad.apply(aux, aux_grad_share(mg.tp))
    if cfg.n_shared_experts:
        # the shared experts' FFN through its sites (exact on the blocked
        # path and without a plan), as its own column / row-parallel pair
        sites = ctx is not None and key is not None and not blocked
        out = out + ffn_sites(params["shared"], x_in, ctx if sites else exact_ctx(),
                              key, shared=True)
    return out, aux


def _moe_tokens(params, x2d, cfg, gather_dispatch: bool, *, ctx=None, key=None,
                with_aux: bool = True, experts=None):
    """Dispatch, compute and combine for one flat block of tokens (T, d):
    the routed experts' output (the shared experts are the caller's).
    ``experts``: (first, E') when ``params`` holds experts [first, first +
    E) of E' (a rank's share), else None."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    cap = moe_capacity(t, cfg)
    e_loc = params["w_gate"].shape[0]
    first, ep = experts if experts is not None else (0, e_loc)   # ep: padded count (>= e)
    probs, gate_w, gate_i = route(params["router"], x2d, k)

    aux = None
    if with_aux:  # load balance (Switch): E * sum_e f_e * p_e
        me = probs.mean(0)
        ce = F.one_hot(gate_i, e).float().sum(1).mean(0)
        aux = e * (me * ce).sum()

    perm, dest, pair_slot, slot_pair = dispatch_plan(gate_i, cap, ep)
    if e_loc != ep:
        # this rank's slots [first cap, (first + E) cap); a pair routed
        # elsewhere goes where a dropped one goes
        lo, n = first * cap, e_loc * cap
        pair_slot, dest = (torch.where((s >= lo) & (s < lo + n), s - lo, n)
                           for s in (pair_slot, dest))
        slot_pair = slot_pair[lo:lo + n]
    slot_src = torch.where(slot_pair >= 0, slot_pair // k, -1)   # each slot's token
    buf = _Dispatch.apply(x2d, slot_src, pair_slot,
                          None if gather_dispatch else (dest, perm // k))
    buf = buf.reshape(e_loc, cap, d)

    dt = buf.dtype
    site = ctx.site("moe.expert") if (ctx is not None and key is not None) else None
    if site is not None and not site.is_exact:
        # one compressed state per expert buffer, shared by gate and up; the
        # down projection's input (the post-SwiGLU hidden) stays exact
        (zg, zu), stats = site.apply_batched(buf, [params["w_gate"], params["w_up"]], key,
                                             ctx.mode, experts=experts)
        ctx.record(site, stats)
        h = F.silu(zg) * zu
    else:
        h = F.silu(torch.bmm(buf, params["w_gate"].to(dt))) * torch.bmm(
            buf, params["w_up"].to(dt))
    h = torch.bmm(h, params["w_down"].to(dt)).reshape(e_loc * cap, d)

    # each token's k outputs (a zero row for a dropped pair), weighted, summed
    return _Combine.apply(h, gate_w, pair_slot, slot_pair), aux
