"""The port's one kernel dispatch point.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, which launches or raises. There is no
fallback from a CUDA tensor to a plain version: a kernel that does not
build or launch is an error the caller sees.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd

__all__ = ["flash_attention_fwd", "flash_attention", "flash_decode"]


def _route(x, name: str):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """K3 (prefill attention): (o (B,L,H,dh), lse (B,H,L) f32)."""
    if _route(q, "flash_attention_fwd"):
        return _fa.flash_attention_fwd_cuda(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_fwd_ref(q, k, v, causal=causal, window=window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """K3 output only (serving drops lse)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]


def flash_decode(q, k, v, q_pos, slot_pos, *, causal: bool = True,
                 window: int = 0):
    """K6 (decode attention) over a dense slot cache: (B, 1, H, dh)."""
    if _route(q, "flash_decode"):
        return _fd.flash_decode_cuda(q, k, v, q_pos, slot_pos, causal=causal,
                                     window=window)
    return _fd.flash_decode_ref(q, k, v, q_pos, slot_pos, causal=causal,
                                window=window)
