"""K6: single-query flash decode over a dense slot cache, as a CUDA kernel
and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_decode.py`` (``flash_decode_kernel``
and its oracle ``flash_decode_ref``). Decode caches are slot-addressed,
so the mask comes from per-slot absolute positions ``slot_pos`` (-1 =
empty; a ring buffer for sliding-window layers) against the query's
``q_pos``, never from iota. A parked slot (``q_pos = -1``) masks every
key; its output is finite and discarded by the engine.

The kernel (``csrc/flash_decode.cu``) takes one query row (Lq = 1) and
says in its header what bounds it on the H100. The plain version takes
any Lq >= 1 (the paged speculative-verify path will reuse it) and is what
the CPU tests hold against the JAX kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_ref(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                     window: int = 0, scale: float | None = None):
    """q (B, Lq, H, dh); k, v (B, S, KV, dh); q_pos (B,) or (B, Lq);
    slot_pos (B, S). Materializes (B, Lq, KV, G, S) scores in f32."""
    LAUNCHES["flash_decode_ref"] += 1
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Lq, KV, G, dh).float()
    s = torch.einsum("blkgd,bskd->blkgs", qg, k.float()) * scale
    qp = q_pos.reshape(B, -1)[:, :, None, None, None]
    sp = slot_pos[:, None, None, None, :]
    mask = sp >= 0
    if causal:
        mask = mask & (sp <= qp)
    if window > 0:
        mask = mask & (qp - sp < window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("blkgs,bskd->blkgd", p, v.float())
    return out.reshape(B, Lq, H, dh).to(q.dtype)


def _check(q, k, v, q_pos, slot_pos):
    if q.device.type != "cuda":
        raise ValueError(f"K6 kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K6 kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"K6 kernel is the single-query path: q (B,1,H,dh), "
                         f"got {tuple(q.shape)}")
    B, _, H, dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"K6 kernel: k/v (B,S,KV,dh) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    S, KV = k.shape[1], k.shape[2]
    if H % KV or dh > 256:
        raise ValueError(f"K6 kernel: H={H} must be a multiple of KV={KV} "
                         f"and dh={dh} at most 256")
    if q_pos.shape != (B,) or slot_pos.shape != (B, S):
        raise ValueError(f"K6 kernel: q_pos (B,) and slot_pos (B,S); got "
                         f"{tuple(q_pos.shape)}, {tuple(slot_pos.shape)}")
    if q_pos.dtype != torch.int32 or slot_pos.dtype != torch.int32:
        raise ValueError("K6 kernel: q_pos and slot_pos must be int32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(f"K6 kernel: {name} must lie on {q.device} with "
                             f"contiguous (heads, dh) rows; strides {x.stride()}")
    if (q_pos.device != q.device or slot_pos.device != q.device
            or not q_pos.is_contiguous() or slot_pos.stride(1) != 1):
        raise ValueError("K6 kernel: q_pos/slot_pos must lie on q's device "
                         "with contiguous slots")


def flash_decode_cuda(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                      window: int = 0):
    """Launch K6 on q's current CUDA stream; returns (B, 1, H, dh)."""
    _check(q, k, v, q_pos, slot_pos)
    B, _, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = build.entry("flash_decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             slot_pos.data_ptr(), o.data_ptr(), B, S, H, KV, dh,
             q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             slot_pos.stride(0), o.stride(0), int(causal), int(window),
             dh ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return o
