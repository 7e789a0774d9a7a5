"""K2: the PAMM apply core (a deterministic segment sum), as a CUDA kernel
and its plain PyTorch version.

Counterpart of ``repro/kernels/pamm_apply.py`` (``segment_matmul``) and of
its oracle ``repro/kernels/ref.py:segment_matmul_ref``. Both functions take
f (b,) int32 generator indices in [0, k), alpha (b,) f32 and dZ (b, m)
float32 or bfloat16, and return Btilde = onehot(f)^T (alpha * dZ), (k, m)
f32. Two launches on the same inputs give bitwise identical output.

The kernel (``csrc/pamm_apply.cu``) says in its header what bounds it on
the H100 and how it stays deterministic without atomics. The plain version
is what the CPU tests hold against the JAX kernel; nothing on the card's
main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_matmul_ref(f, alpha, gz, k: int):
    """Plain version of K2: alpha * dZ in f32, summed into row f_i of a
    (k, m) zero matrix (``index_add_``, deterministic on the CPU)."""
    LAUNCHES["segment_matmul_ref"] += 1
    bprime = alpha[:, None].float() * gz.float()
    out = torch.zeros((k, gz.shape[1]), dtype=torch.float32, device=gz.device)
    return out.index_add_(0, f.long(), bprime)


def _check(f, alpha, gz, k):
    if gz.device.type != "cuda":
        raise ValueError(f"K2 kernel needs CUDA tensors, got {gz.device}")
    if gz.dtype not in _DTYPES:
        raise ValueError(f"K2 kernel takes float32 or bfloat16 dZ, got {gz.dtype}")
    if f.dtype != torch.int32 or alpha.dtype != torch.float32:
        raise ValueError(f"K2 kernel: f must be int32 and alpha float32, got "
                         f"{f.dtype}/{alpha.dtype}")
    if gz.dim() != 2 or f.shape != (gz.shape[0],) or alpha.shape != (gz.shape[0],):
        raise ValueError(f"K2 kernel: f (b,), alpha (b,), dZ (b, m); got "
                         f"{tuple(f.shape)}, {tuple(alpha.shape)}, {tuple(gz.shape)}")
    if k < 1 or gz.shape[0] < 1 or gz.shape[1] < 1 or max(gz.numel(), k * gz.shape[1]) >= 2**31:
        raise ValueError(f"K2 kernel: needs k >= 1, non-empty dZ and < 2^31 "
                         f"elements; got k={k}, dZ {tuple(gz.shape)}")
    if f.device != gz.device or alpha.device != gz.device:
        raise ValueError("K2 kernel: f, alpha and dZ must lie on one device")
    if not (f.is_contiguous() and alpha.is_contiguous() and gz.is_contiguous()):
        raise ValueError(f"K2 kernel: f, alpha and dZ must be contiguous; dZ "
                         f"strides {gz.stride()}")


def segment_matmul_cuda(f, alpha, gz, k: int):
    """Launch K2 on dZ's current CUDA stream; returns Btilde (k, m) f32."""
    _check(f, alpha, gz, k)
    b, m = gz.shape
    out = torch.empty((k, m), dtype=torch.float32, device=gz.device)
    err = build.entry("segment_matmul")(
        f.data_ptr(), alpha.data_ptr(), gz.data_ptr(), out.data_ptr(), b, m, k,
        _DTYPES[gz.dtype], torch.cuda.current_stream(gz.device).cuda_stream)
    build.check_launch("segment_matmul", err)
    LAUNCHES["segment_matmul"] += 1
    return out
