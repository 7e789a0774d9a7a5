"""K3: FlashAttention-2 forward for prefill, as a CUDA kernel and its
plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py`` (``_fwd_impl``; public
``flash_attention_fwd``). Both functions take q (B, L, H, dh) and k, v
(B, L, KV, dh) with contiguous ``arange`` positions (training batch and
serving prefill), the causal and sliding-window masks, GQA query head h
reading kv head h // G, and return o (B, L, H, dh) in q's dtype plus the
row statistic lse (B, H, L) f32 that the training slice's backward needs.

The kernel (``csrc/flash_attention_fwd.cu``) says in its header what
bounds it on the H100 and what its design does about that. The plain
version is what the CPU tests hold against the JAX kernel; nothing on the
card's main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NEG_INF = -1e30
DENOM_FLOOR = 1e-30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _iota_mask(L: int, causal: bool, window: int, device) -> torch.Tensor:
    pos = torch.arange(L, device=device)
    mask = torch.ones((L, L), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    return mask


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version of K3: scores in f32, masked with the finite NEG_INF,
    softmax, then o in q's dtype and lse = logsumexp of the masked
    scores (the value the kernel's online softmax reaches)."""
    LAUNCHES["flash_attention_fwd_ref"] += 1
    B, L, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, L, KV, G, dh).float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k.float()) * dh ** -0.5
    s = s.masked_fill(~_iota_mask(L, causal, window, q.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                      # (B, KV, G, L)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,blkd->bqkgd", p, v.float())
    return (o.reshape(B, L, H, dh).to(q.dtype),
            lse.reshape(B, H, L))


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"K3 kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K3 kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"K3 kernel: q (B,L,H,dh), k/v (B,L,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != dh:
        raise ValueError(f"K3 kernel: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2] or dh > 256:
        raise ValueError(f"K3 kernel: H={H} must be a multiple of KV="
                         f"{k.shape[2]} and dh={dh} at most 256")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(f"K3 kernel: {name} must lie on {q.device} with "
                             f"contiguous (heads, dh) rows; strides "
                             f"{x.stride()}")


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch K3 on q's current CUDA stream; returns (o, lse)."""
    _check(q, k, v)
    B, L, H, dh = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    fn = build.library("flash_attention_fwd").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, L, H, k.shape[2], dh,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), o.stride(0), o.stride(1),
             int(causal), int(window), dh ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_attention_fwd", err)
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse
