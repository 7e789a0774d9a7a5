"""The port's one kernel dispatch point.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, which launches or raises. There is no
fallback from a CUDA tensor to a plain version: a kernel that does not
build or launch is an error the caller sees.

Besides the single-kernel wrappers this module assembles the full PAMM
operations from K1 / K2 (``repro/kernels/ops.py:36-63``) and joins the
attention forward (K3) and backward (K4, K5) in one autograd Function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import pamm_apply as _pa
from repro_torch.kernels import pamm_compress as _pc

__all__ = ["flash_attention_fwd", "flash_attention_bwd", "flash_attention",
           "flash_decode", "flash_paged_decode", "flash_paged_decode_quant",
           "flash_sharded_paged_decode", "flash_sharded_paged_decode_quant",
           "csim_argmax", "segment_matmul", "pamm_compress",
           "pamm_apply", "csim_argmax_batched", "segment_matmul_batched",
           "pamm_compress_batched", "pamm_apply_batched", "csim_partial",
           "csim_finish", "pamm_compress_split", "FlashAttention"]


def _route(x, name: str):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        offs=None):
    """K3 (prefill attention): (o (B,L,H,dh), lse (B,H,L) f32). ``offs``:
    None or (q_off, k_off), the global positions of the first query and
    key (ring context parallelism)."""
    if _route(q, "flash_attention_fwd"):
        return _fa.flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                            offs=offs)
    return _fa.flash_attention_fwd_ref(q, k, v, causal=causal, window=window, offs=offs)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, offs=None):
    """K4 + K5 (attention backward): (dq, dk, dv) from the saved
    (q, k, v, o, lse) and the output gradient dO; ``offs`` as in the
    forward."""
    if _route(q, "flash_attention_bwd"):
        return _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                            window=window, offs=offs)
    return _fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, offs=offs)


class FlashAttention(torch.autograd.Function):
    """FlashAttention-2 with the JAX package's ``custom_vjp`` residuals:
    the forward (K3) saves (q, k, v, o, lse), O(L) statistics instead of the
    (L, L) probabilities; the backward recomputes them tile by tile (K4,
    K5)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, offs=None):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, offs=offs)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.offs = causal, window, offs
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window,
                                         offs=ctx.offs)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, offs=None):
    """Attention output (B, L, H, dh). Differentiable: under autograd it
    runs K3 forward and K4/K5 backward; otherwise (serving) K3 alone, with
    nothing saved. ``offs`` as in :func:`flash_attention_fwd`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, offs)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, offs=offs)[0]


def flash_decode(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                 window: int = 0):
    """K6 (decode attention) over a dense slot cache: (B, 1, H, dh)."""
    if _route(q, "flash_decode"):
        return _fd.flash_decode_cuda(q, k, v, q_pos, slot_pos, causal=causal,
                                     window=window)
    return _fd.flash_decode_ref(q, k, v, q_pos, slot_pos, causal=causal,
                                window=window)


def flash_paged_decode(q, k_pages, v_pages, q_pos, block_table, page_pos, *,
                       causal: bool = True, window: int = 0,
                       scale: float | None = None):
    """K7 (decode attention through a page pool and block table; Lq >= 1
    rows with per-row positions): (B, Lq, H, dh)."""
    if _route(q, "flash_paged_decode"):
        return _fd.flash_paged_decode_cuda(q, k_pages, v_pages, q_pos, block_table,
                                           page_pos, causal=causal, window=window,
                                           scale=scale)
    return _fd.flash_paged_decode_ref(q, k_pages, v_pages, q_pos, block_table,
                                      page_pos, causal=causal, window=window,
                                      scale=scale)


def flash_paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                             block_table, page_pos, *, causal: bool = True,
                             window: int = 0):
    """K8 (K7 over int8 / int4 pages with f32 scales, dequantised per
    tile): (B, Lq, H, dh)."""
    if _route(q, "flash_paged_decode_quant"):
        return _fd.flash_paged_decode_quant_cuda(
            q, k_pages, v_pages, k_scale, v_scale, q_pos, block_table, page_pos,
            causal=causal, window=window)
    return _fd.flash_paged_decode_quant_ref(
        q, k_pages, v_pages, k_scale, v_scale, q_pos, block_table, page_pos,
        causal=causal, window=window)


def flash_sharded_paged_decode(q, k_pages, v_pages, q_pos, block_table, page_pos, *,
                               causal: bool = True, window: int = 0,
                               scale: float | None = None, table=None):
    """K7 over per-replica shards of one pool (pools (dp, n_pages/dp, ps,
    KV, w), block_table (dp, B/dp, nb) of shard-local ids; q, q_pos
    slot-major): (B, Lq, H, dh). ``table``: the offset ids of the kernel
    route, when the caller made them once a step (the plain version reads
    the shard-local table)."""
    if _route(q, "flash_sharded_paged_decode"):
        return _fd.flash_sharded_paged_decode_cuda(
            q, k_pages, v_pages, q_pos, block_table, page_pos, causal=causal,
            window=window, scale=scale, table=table)
    return _fd.flash_sharded_paged_decode_ref(q, k_pages, v_pages, q_pos, block_table,
                                              page_pos, causal=causal, window=window,
                                              scale=scale)


def flash_sharded_paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, q_pos,
                                     block_table, page_pos, *, causal: bool = True,
                                     window: int = 0, table=None):
    """K8 over per-replica shards of one int8 / int4 pool and its scales,
    as :func:`flash_sharded_paged_decode`: (B, Lq, H, dh)."""
    if _route(q, "flash_sharded_paged_decode_quant"):
        return _fd.flash_sharded_paged_decode_quant_cuda(
            q, k_pages, v_pages, k_scale, v_scale, q_pos, block_table, page_pos,
            causal=causal, window=window, table=table)
    return _fd.flash_sharded_paged_decode_quant_ref(
        q, k_pages, v_pages, k_scale, v_scale, q_pos, block_table, page_pos,
        causal=causal, window=window)


def csim_argmax(x, c):
    """K1: (cs (b,) f32, idx (b,) int32, ||x_i|| (b,) f32)."""
    if _route(x, "csim_argmax"):
        return _pc.csim_argmax_cuda(x, c)
    return _pc.csim_argmax_ref(x, c)


def csim_partial(x, c):
    """K1's split route, pass A: a column slice's dots and squared row
    norms, (b, k + 1) f32."""
    if _route(x, "csim_partial"):
        return _pc.csim_partial_cuda(x, c)
    return _pc.csim_partial_ref(x, c)


def csim_finish(part, idx):
    """K1's split route, pass B: (cs, idx, ||x_i||) (b,) from pass A's
    buffer summed over the slices and the generators' rows ``idx``."""
    if _route(part, "csim_finish"):
        return _pc.csim_finish_cuda(part, idx)
    return _pc.csim_finish_ref(part, idx)


def segment_matmul(f, alpha, gz, k: int):
    """K2: Btilde = onehot(f)^T (alpha * dZ), (k, m) f32."""
    if _route(gz, "segment_matmul"):
        return _pa.segment_matmul_cuda(f, alpha, gz, k)
    return _pa.segment_matmul_ref(f, alpha, gz, k)


def csim_argmax_batched(x, c):
    """Batched K1, the experts in one launch: x (E, b, n), c (E, k, n) ->
    (cs, idx, ||x_i||), each (E, b)."""
    if _route(x, "csim_argmax_batched"):
        return _pc.csim_argmax_batched_cuda(x, c)
    return _pc.csim_argmax_batched_ref(x, c)


def segment_matmul_batched(f, alpha, gz, k: int):
    """Batched K2, the experts in one launch: f, alpha (E, b), dZ (E, b, m)
    -> Btilde (E, k, m) f32."""
    if _route(gz, "segment_matmul_batched"):
        return _pa.segment_matmul_batched_cuda(f, alpha, gz, k)
    return _pa.segment_matmul_batched_ref(f, alpha, gz, k)


def _epilogue(cs, norm_a, norm_c_at, eps: float, dim: int):
    """alpha, beta of a PAMM state from K1's outputs (``kernels/ops.py``'s
    JAX epilogue): ``norm_c_at`` is the norm of each row's generator; zero
    rows (padding) count in neither side of beta. ``dim``: the row axis."""
    alpha = cs * norm_a / norm_c_at.clamp_min(1e-20)
    keep = (cs * cs >= 1.0 - float(eps) * float(eps)) if math.isfinite(eps) \
        else torch.ones_like(cs, dtype=torch.bool)
    nonzero = norm_a > 0
    contributing = keep & nonzero
    alpha = torch.where(contributing, alpha, torch.zeros_like(alpha))
    beta = nonzero.float().sum(dim) / contributing.float().sum(dim).clamp_min(1.0)
    return alpha, beta


def pamm_compress(x, k: int, eps: float, idx):
    """PAMM compress of x (b, n) around the generator rows ``idx`` (k,):
    K1 plus the alpha / eps / beta epilogue (in torch, as the JAX wrapper
    keeps it in jnp). The generators are ``x[idx]`` in x's dtype."""
    from repro_torch.core.pamm import PammState

    if idx.shape != (min(k, x.shape[0]),):
        raise ValueError(f"pamm_compress: idx must hold min(k, b) = "
                         f"{min(k, x.shape[0])} rows, got {tuple(idx.shape)}")
    c = x.index_select(0, idx.to(x.device))
    cs, assign, norm_a = csim_argmax(x, c)
    norm_c = norm_a.index_select(0, idx.to(x.device))
    alpha, beta = _epilogue(cs, norm_a, norm_c.index_select(0, assign.long()), eps, 0)
    return PammState(c, alpha, assign, beta)


def pamm_compress_split(x, k: int, eps: float, idx, reduce_):
    """:func:`pamm_compress` of rows split by columns over the ranks of a
    model group, x (b, n/tp) this rank's slice: pass A on the slice,
    ``reduce_`` (sums a tensor over the group, in place) on its (b, k + 1)
    buffer, pass B on the sums. alpha, assign and beta are the whole rows'
    on every rank; the generators are this rank's slice of them, so
    :func:`pamm_apply` gives this rank's rows of the weight gradient."""
    from repro_torch.core.pamm import PammState

    if idx.shape != (min(k, x.shape[0]),):
        raise ValueError(f"pamm_compress_split: idx must hold min(k, b) = "
                         f"{min(k, x.shape[0])} rows, got {tuple(idx.shape)}")
    idx = idx.to(x.device)
    c = x.index_select(0, idx)
    part = csim_partial(x, c)
    reduce_(part)
    cs, assign, norm_a = csim_finish(part, idx)
    norm_c = norm_a.index_select(0, idx)
    alpha, beta = _epilogue(cs, norm_a, norm_c.index_select(0, assign.long()), eps, 0)
    return PammState(c, alpha, assign, beta)


def pamm_apply(state, gz):
    """PAMM apply: beta * C^T @ K2(f, alpha, dZ), (n, m) f32. The thin
    (n, k) x (k, m) product is a library matmul, as JAX leaves it to XLA."""
    k = state.generators.shape[0]
    btilde = segment_matmul(state.assign, state.alpha, gz.contiguous(), k)
    return state.beta * (state.generators.float().T @ btilde)


def pamm_compress_batched(x, k: int, eps: float, idx):
    """PAMM compress of each expert's x[e] (b, n) around its generator rows
    ``idx[e]`` (E, min(k, b)), in one batched K1 launch: a
    :class:`PammState` whose leaves carry the leading expert axis
    (generators (E, k, n), alpha and assign (E, b), beta (E,)); expert e's
    equals :func:`pamm_compress` of x[e] around idx[e]."""
    from repro_torch.core.pamm import PammState

    E, b, n = x.shape
    if idx.shape != (E, min(k, b)):
        raise ValueError(f"pamm_compress_batched: idx must be (E, min(k, b)) = "
                         f"{(E, min(k, b))}, got {tuple(idx.shape)}")
    idx = idx.to(x.device)
    c = x[torch.arange(E, device=x.device)[:, None], idx]
    cs, assign, norm_a = csim_argmax_batched(x, c)
    norm_c = torch.gather(norm_a, 1, idx)
    alpha, beta = _epilogue(cs, norm_a, torch.gather(norm_c, 1, assign.long()), eps, 1)
    return PammState(c, alpha, assign, beta)


def pamm_apply_batched(state, gz):
    """PAMM apply of a batched state: beta_e C_e^T K2(f_e, alpha_e, dZ_e),
    (E, n, m) f32, the segment sums in one batched K2 launch."""
    k = state.generators.shape[1]
    btilde = segment_matmul_batched(state.assign, state.alpha, gz.contiguous(), k)
    return state.beta[:, None, None] * torch.bmm(
        state.generators.float().transpose(1, 2), btilde)
