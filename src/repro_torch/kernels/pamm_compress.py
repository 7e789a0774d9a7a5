"""K1: the PAMM compress core (csim arg-max), as a CUDA kernel and its
plain PyTorch version.

Counterpart of ``repro/kernels/pamm_compress.py`` (``csim_argmax``) and of
its oracle ``repro/kernels/ref.py:csim_argmax_ref``. Both functions take
x (b, n) and the generators c (k, n), float32 or bfloat16, and return, per
row of x, the signed cosine similarity at argmax_j |csim(x_i, c_j)| (f32),
that index (int32; ties to the lowest j) and ||x_i|| (f32).

The kernel (``csrc/pamm_compress.cu``) says in its header what bounds it
on the H100 and what its design does about that: bf16 runs on the tensor
cores (mma.sync, x streamed by cp.async), f32 on a scalar route; both walk
the generators in chunks with a running best per row. The plain version is what
the CPU tests hold against the JAX kernel; nothing on the card's main path
calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NORM_EPS = 1e-20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def csim_argmax_ref(x, c):
    """Plain version of K1: csim in f32, arg-max of |csim| (first maximum),
    the signed value there, and the row norms of x."""
    LAUNCHES["csim_argmax_ref"] += 1
    x32, c32 = x.float(), c.float()
    norm_a = torch.linalg.vector_norm(x32, dim=1)
    norm_c = torch.linalg.vector_norm(c32, dim=1)
    csim = (x32 @ c32.T) / (norm_a.clamp_min(NORM_EPS)[:, None]
                            * norm_c.clamp_min(NORM_EPS)[None, :])
    idx = torch.argmax(csim.abs(), dim=1)
    cs = torch.gather(csim, 1, idx[:, None])[:, 0]
    return cs, idx.to(torch.int32), norm_a


def _check(x, c):
    if x.device.type != "cuda":
        raise ValueError(f"K1 kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or c.dtype != x.dtype:
        raise ValueError(f"K1 kernel takes float32 or bfloat16 x/c of one dtype, "
                         f"got {x.dtype}/{c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"K1 kernel: x (b, n) and c (k, n); got {tuple(x.shape)}, "
                         f"{tuple(c.shape)}")
    if x.shape[0] < 1 or c.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"K1 kernel: empty x or c: {tuple(x.shape)}, {tuple(c.shape)}")
    if max(x.numel(), c.numel()) >= 2**31 or c.device != x.device:
        raise ValueError("K1 kernel: x and c must lie on one device with < 2^31 elements")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"K1 kernel: x and c must be contiguous; strides "
                         f"{x.stride()}, {c.stride()}")


def csim_argmax_cuda(x, c):
    """Launch K1 on x's current CUDA stream; returns (cs, idx, norm_a)."""
    _check(x, c)
    b, n = x.shape
    out = torch.empty((3, b), dtype=torch.float32, device=x.device)  # cs, idx, norm
    cs, idx, norm = out[0], out[1].view(torch.int32), out[2]
    err = build.entry("csim_argmax")(
        x.data_ptr(), c.data_ptr(), cs.data_ptr(), idx.data_ptr(), norm.data_ptr(),
        b, n, c.shape[0], _DTYPES[x.dtype], build.raw_stream(x))
    build.check_launch("csim_argmax", err)
    LAUNCHES["csim_argmax"] += 1
    return cs, idx, norm
