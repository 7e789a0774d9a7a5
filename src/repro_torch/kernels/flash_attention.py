"""K3, K4, K5: FlashAttention-2 forward and backward, as CUDA kernels and
their plain PyTorch versions.

Counterpart of ``repro/kernels/flash_attention.py`` (``_fwd_impl`` and
``_bwd_impl``). The functions take q (B, L, H, dh) and k, v (B, L, KV, dh)
with contiguous ``arange`` positions (training batch and serving prefill),
the causal and sliding-window masks, GQA query head h reading kv head
h // G, and an optional ``offs = (q_off, k_off)``: the global positions
of the first query and the first key (ring context parallelism hands a
kernel one chunk pair of the sequence). The masks then compare global
positions ``q_off + i`` and ``k_off + j``; ``offs=None`` means (0, 0).
The forward (K3) returns o (B, L, H, dh) in q's dtype plus the row
statistic lse (B, H, L) f32; the backward recomputes the probabilities
from (q, k, v, lse) and returns dq (K4, q-major) and dk, dv (K5, kv-major,
the G query heads of a kv head folded in), each in its input's dtype.
``delta = rowsum(dO * O)`` is a torch op before the backward kernels, as
it is a jnp op outside Pallas in the JAX package.

Rows that see no key. With offsets and a window, a query row of a live
chunk pair can see no key at all (q chunk [2C, 3C), k chunk [C, 2C),
window < C). Every version then averages V over some key set of its own:
the JAX kernel over its padded tile walk (masked and padded keys alike
get NEG_INF), the plain version over the L keys, the CUDA kernels over
the keys of their live tiles (keys past L get -inf). What holds for all
of them, and all the ring merge (``repro/kernels/ring_attention.py:133``)
needs from such a row, is ``lse <= NEG_INF / 2`` and a finite o: the
merge then gives the row's partial weight 0. The tests compare the
versions on rows that see a key and hold the others to those two
properties. The backward takes the merged lse, finite on every row, so
it needs no such rule.

The kernels (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``)
say in their headers what bounds them on the H100 and what their design
does about that. The plain versions are what the CPU tests hold against
the JAX kernels; nothing on the card's main path calls them. The autograd
Function joining forward and backward is ``ops.FlashAttention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NEG_INF = -1e30
DENOM_FLOOR = 1e-30
_DTYPES = (torch.float32, torch.bfloat16)   # each has its own route
MAX_DH = 256                                # the widest head each route instantiates


def _offsets(offs) -> tuple[int, int]:
    """``offs`` as two Python ints (q_off, k_off); None is (0, 0)."""
    if offs is None:
        return 0, 0
    q_off, k_off = offs
    return int(q_off), int(k_off)


def _iota_mask(L: int, causal: bool, window: int, device, offs=None) -> torch.Tensor:
    """(L, L) visibility of key j to query i at global positions
    ``q_off + i`` and ``k_off + j``."""
    q_off, k_off = _offsets(offs)
    pos = torch.arange(L, device=device)
    qp, kp = pos + q_off, pos + k_off
    mask = torch.ones((L, L), dtype=torch.bool, device=device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window > 0:
        mask &= qp[:, None] - kp[None, :] < window
    return mask


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            offs=None):
    """Plain version of K3: scores in f32, masked with the finite NEG_INF,
    softmax, then o in q's dtype and lse = logsumexp of the masked
    scores (the value the kernel's online softmax reaches)."""
    LAUNCHES["flash_attention_fwd_ref"] += 1
    B, L, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, L, KV, G, dh).float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k.float()) * dh ** -0.5
    s = s.masked_fill(~_iota_mask(L, causal, window, q.device, offs), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                      # (B, KV, G, L)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,blkd->bqkgd", p, v.float())
    return (o.reshape(B, L, H, dh).to(q.dtype),
            lse.reshape(B, H, L))


def _check(q, k, v, *, kernel: str = "K3", extra=()):
    """Raise unless q, k, v (and the ``extra`` (name, tensor) pairs shaped
    like q) are what the attention kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{kernel} kernel: q (B,L,H,dh), k/v (B,L,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != dh:
        raise ValueError(f"{kernel} kernel: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2] or dh > MAX_DH:
        raise ValueError(f"{kernel} kernel: H={H} must be a multiple of KV="
                         f"{k.shape[2]} and dh={dh} at most {MAX_DH}")
    for name, x in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if x.shape != (q.shape if name not in ("k", "v") else k.shape):
            raise ValueError(f"{kernel} kernel: {name} {tuple(x.shape)} does not "
                             f"match q {tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{kernel} kernel: {name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device or x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(f"{kernel} kernel: {name} must lie on {q.device} with "
                             f"contiguous (heads, dh) rows; strides "
                             f"{x.stride()}")


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                             offs=None):
    """Launch K3 on q's current CUDA stream; returns (o, lse). The route
    is the dtype's: bf16 runs the tensor-core kernel (``flash_attention_fwd``),
    f32 the scalar one (``flash_attention_fwd_f32``); each is counted
    under its entry's name."""
    _check(q, k, v)
    B, L, H, dh = q.shape
    q_off, k_off = _offsets(offs)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    name = "flash_attention_fwd" if q.dtype == torch.bfloat16 else "flash_attention_fwd_f32"
    err = build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, L, H, k.shape[2], dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), int(causal), int(window),
        q_off, k_off, dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(name, err)
    LAUNCHES[name] += 1
    return o, lse


# ---------------------------------------------------------------------------
# backward: K4 (dq) and K5 (dk, dv)
# ---------------------------------------------------------------------------
def _delta(o, do):
    """rowsum(dO * O) in f32, laid out (B, H, L) like lse."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, offs=None):
    """Plain version of K4 + K5: recomputes p = exp(s - lse) from the
    masked f32 scores as ``_dq_kernel`` / ``_dkv_kernel`` do, then
    ds = p * (dO v^T - delta) * scale; returns (dq, dk, dv)."""
    LAUNCHES["flash_attention_bwd_ref"] += 1
    B, L, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qg = q.reshape(B, L, KV, G, dh).float()
    dog = do.reshape(B, L, KV, G, dh).float()
    k32, v32 = k.float(), v.float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k32) * scale
    s = s.masked_fill(~_iota_mask(L, causal, window, q.device, offs), NEG_INF)
    p = torch.exp(s - lse.reshape(B, KV, G, L, 1))
    dp = torch.einsum("bqkgd,blkd->bkgql", dog, v32)
    delta = _delta(o, do).reshape(B, KV, G, L, 1)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgql,blkd->bqkgd", ds, k32).reshape(B, L, H, dh)
    dk = torch.einsum("bkgql,bqkgd->blkd", ds, qg)
    dv = torch.einsum("bkgql,bqkgd->blkd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_entry(name: str, q) -> str:
    """The route of K4 (``flash_attention_dq``) or K5 (``flash_attention_dkv``)
    for q's dtype: the entry itself for bf16 (tensor cores), its ``_f32``
    twin for f32 (scalar)."""
    return name if q.dtype == torch.bfloat16 else name + "_f32"


def _launch_dq(q, k, v, lse, delta, do, dq, causal: bool, window: int, offs=(0, 0)):
    """Launch K4 into ``dq`` on q's current CUDA stream, on the route of q's
    dtype (counted under its entry's name); the caller has checked the
    operands."""
    B, L, H, dh = q.shape
    name = _bwd_entry("flash_attention_dq", q)
    err = build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, L, H, k.shape[2], dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
        int(causal), int(window), *offs, dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(name, err)
    LAUNCHES[name] += 1


def _launch_dkv(q, k, v, lse, delta, do, dk, dv, causal: bool, window: int,
                offs=(0, 0)):
    """Launch K5 into ``dk``, ``dv`` on q's current CUDA stream, on the route
    of q's dtype (counted under its entry's name); the caller has checked
    the operands."""
    B, L, H, dh = q.shape
    name = _bwd_entry("flash_attention_dkv", q)
    err = build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H, k.shape[2], dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        do.stride(0), do.stride(1), dk.stride(0), dk.stride(1), dv.stride(0), dv.stride(1),
        int(causal), int(window), *offs, dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(name, err)
    LAUNCHES[name] += 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, offs=None):
    """Check the operands once, compute delta as a torch op, then launch K4
    and K5 on q's current CUDA stream; returns (dq, dk, dv). The route is
    the dtype's, as for K3: bf16 runs the tensor-core kernels
    (``flash_attention_dq``, ``flash_attention_dkv``), f32 the scalar ones
    (``flash_attention_dq_f32``, ``flash_attention_dkv_f32``)."""
    _check(q, k, v, kernel="K4/K5", extra=(("o", o), ("do", do)))
    B, L, H, _ = q.shape
    if (lse.shape != (B, H, L) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"K4/K5 kernels: lse must be a contiguous (B, H, L) f32 "
                         f"tensor on {q.device}; got {tuple(lse.shape)} {lse.dtype}")
    delta = _delta(o, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    offs = _offsets(offs)
    _launch_dq(q, k, v, lse, delta, do, dq, causal, window, offs)
    _launch_dkv(q, k, v, lse, delta, do, dk, dv, causal, window, offs)
    return dq, dk, dv
