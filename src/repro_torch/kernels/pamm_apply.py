"""K2: the PAMM apply core (a deterministic segment sum), as a CUDA kernel
and its plain PyTorch version.

Counterpart of ``repro/kernels/pamm_apply.py`` (``segment_matmul``) and of
its oracle ``repro/kernels/ref.py:segment_matmul_ref``. Both functions take
f (b,) int32 generator indices in [0, k), alpha (b,) f32 and dZ (b, m)
float32 or bfloat16, and return Btilde = onehot(f)^T (alpha * dZ), (k, m)
f32. Two launches on the same inputs give bitwise identical output.

The kernel (``csrc/pamm_apply.cu``) says in its header what bounds it on
the H100 and how it stays deterministic without atomics: it splits the
rows over blocks (:func:`_splits`, a function of b, m and k alone, so the
same inputs give the same bits on any card), sums each split into an f32
partial and merges the partials in split order in a second launch. The
plain version is what the CPU tests hold against the JAX kernel; nothing
on the card's main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_BLOCKS = 264     # blocks the split rule aims at: two an SM of an H100, fixed
SPLIT_MIN_ROWS = 64    # fewest rows a split takes: 16 for each of a block's 4 warps
MAX_SPLITS = 65535     # the grid's y limit


def segment_matmul_ref(f, alpha, gz, k: int):
    """Plain version of K2: alpha * dZ in f32, summed into row f_i of a
    (k, m) zero matrix (``index_add_``, deterministic on the CPU)."""
    LAUNCHES["segment_matmul_ref"] += 1
    bprime = alpha[:, None].float() * gz.float()
    out = torch.zeros((k, gz.shape[1]), dtype=torch.float32, device=gz.device)
    return out.index_add_(0, f.long(), bprime)


def _splits(b: int, m: int, k: int) -> tuple[int, int]:
    """(split count S, rows per split) of K2's rows, from the shapes alone.

    The blocks of one split are its 256-column tiles times its 16-generator
    tiles; the rule gives each split enough rows (at least SPLIT_MIN_ROWS)
    that S times those tiles comes to about SPLIT_BLOCKS blocks. Never read
    from the card (the SM count) or the data: another S sums in another
    order, and the same inputs must give the same bits everywhere. At b 8192
    and k 16: S 33 of 249 rows at m 2048, S 66 of 125 rows at m 1024, 264
    blocks of bf16 columns either way."""
    tiles = -(-m // 256) * -(-k // 16)
    per = max(SPLIT_MIN_ROWS, -(-b * tiles // SPLIT_BLOCKS), -(-b // MAX_SPLITS))
    return -(-b // per), per


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
    if (k < 1 or k > 16 * 65535 or gz.shape[0] < 1 or gz.shape[1] < 1
            or max(gz.numel(), k * gz.shape[1]) >= 2**31):
        raise ValueError(f"K2 kernel: needs 1 <= k <= {16 * 65535}, non-empty dZ and "
                         f"< 2^31 elements; got k={k}, dZ {tuple(gz.shape)}")
    if f.device != gz.device or alpha.device != gz.device:
        raise ValueError("K2 kernel: f, alpha and dZ must lie on one device")
    if not (f.is_contiguous() and alpha.is_contiguous() and gz.is_contiguous()):
        raise ValueError(f"K2 kernel: f, alpha and dZ must be contiguous; dZ "
                         f"strides {gz.stride()}")


def segment_matmul_cuda(f, alpha, gz, k: int):
    """Launch K2 on dZ's current CUDA stream; returns Btilde (k, m) f32.
    The rows are split by :func:`_splits`; the split kernel and the merge
    of the (S, k, m) f32 partials count as one launch. Btilde is the first
    (k, m) slice of one (S + 1, k, m) allocation that also holds the
    partials (S > 1), so a caller that keeps Btilde keeps the partials'
    S k m 4 bytes too (4.125 MiB at the training shapes): copy it to keep
    it. ``ops.pamm_apply`` uses it at once."""
    _check(f, alpha, gz, k)
    b, m = gz.shape
    nsplit, per = _splits(b, m, k)
    # Btilde, then the (S, k, m) partials, in one allocation (none with S 1)
    buf = torch.empty((nsplit + 1 if nsplit > 1 else 1, k, m), dtype=torch.float32,
                      device=gz.device)
    out = buf[0]
    err = build.entry("segment_matmul")(
        f.data_ptr(), alpha.data_ptr(), gz.data_ptr(), out.data_ptr(),
        out.data_ptr() + 4 * k * m, b, m, k, nsplit, per, _DTYPES[gz.dtype],
        build.raw_stream(gz))
    build.check_launch("segment_matmul", err)
    LAUNCHES["segment_matmul"] += 1
    return out
