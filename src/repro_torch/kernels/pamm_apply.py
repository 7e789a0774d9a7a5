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

The batched pair (:func:`segment_matmul_batched_ref`,
:func:`segment_matmul_batched_cuda`) takes E problems at once, f and
alpha (E, b) and dZ (E, b, m), and returns (E, k, m): the MoE site's
experts in one launch (``repro/core/linear.py:250``'s ``vmap``). Its
split rule, :func:`_splits_batched`, counts the experts' blocks together
and depends on the shapes alone. The 2-D pair is the batched one at E 1,
each with its own launch count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_BLOCKS = 264     # blocks the split rule aims at: two an SM of an H100, fixed
SPLIT_MIN_ROWS = 64    # fewest rows a split takes: 16 for each of a block's 4 warps
MAX_SPLITS = 65535     # the grid's y limit


def _plain(f, alpha, gz, k: int):
    """K2 in plain PyTorch over the expert axis: f, alpha (E, b), dZ (E, b,
    m) -> (E, k, m) f32. alpha * dZ in f32, summed into row f_i of each
    expert's (k, m) zero matrix, as one ``index_add_`` into (E k, m) rows
    (deterministic on the CPU)."""
    E, b, m = gz.shape
    bprime = alpha[..., None].float() * gz.float()
    rows = f.long() + k * torch.arange(E, device=gz.device)[:, None]
    out = torch.zeros((E * k, m), dtype=torch.float32, device=gz.device)
    return out.index_add_(0, rows.reshape(-1), bprime.reshape(E * b, m)).view(E, k, m)


def segment_matmul_ref(f, alpha, gz, k: int):
    """Plain version of K2: f, alpha (b,), dZ (b, m) -> (k, m) f32."""
    LAUNCHES["segment_matmul_ref"] += 1
    return _plain(f[None], alpha[None], gz[None], k)[0]


def segment_matmul_batched_ref(f, alpha, gz, k: int):
    """Plain version of the batched K2: :func:`segment_matmul_ref` of each
    expert."""
    LAUNCHES["segment_matmul_batched_ref"] += 1
    return _plain(f, alpha, gz, k)


def _split_rows(b: int, tiles: int) -> tuple[int, int]:
    """(S, rows per split) for ``b`` rows whose every split runs ``tiles``
    blocks: at least SPLIT_MIN_ROWS rows a split, about SPLIT_BLOCKS
    blocks in all."""
    per = max(SPLIT_MIN_ROWS, -(-b * tiles // SPLIT_BLOCKS), -(-b // MAX_SPLITS))
    return -(-b // per), per


def _splits_batched(e: int, b: int, m: int, k: int) -> tuple[int, int]:
    """(split count S, rows per split) of each expert's rows in K2, from the
    shapes alone.

    The blocks of one split are the ``e`` experts' 256-column tiles times
    their 16-generator tiles; the rule gives each split enough rows (at
    least SPLIT_MIN_ROWS) that S times those tiles comes to about
    SPLIT_BLOCKS blocks. Never read from the card (the SM count) or the
    data: another S sums in another order, and the same inputs must give
    the same bits everywhere. At the MoE site's E 40 x b 2048, k 4, m 512:
    S 4 of 621 rows, 320 blocks."""
    return _split_rows(b, e * -(-m // 256) * -(-k // 16))


def _splits(b: int, m: int, k: int) -> tuple[int, int]:
    """(S, rows per split) of the 2-D K2: :func:`_splits_batched` at one
    expert. At b 8192 and k 16: S 33 of 249 rows at m 2048, S 66 of 125
    rows at m 1024, 264 blocks of bf16 columns either way."""
    return _splits_batched(1, b, m, k)


def _check(f, alpha, gz, k):
    if gz.device.type != "cuda":
        raise ValueError(f"K2 kernel needs CUDA tensors, got {gz.device}")
    if gz.dtype not in _DTYPES:
        raise ValueError(f"K2 kernel takes float32 or bfloat16 dZ, got {gz.dtype}")
    if f.dtype != torch.int32 or alpha.dtype != torch.float32:
        raise ValueError(f"K2 kernel: f must be int32 and alpha float32, got "
                         f"{f.dtype}/{alpha.dtype}")
    if gz.dim() != 3 or f.shape != gz.shape[:-1] or alpha.shape != gz.shape[:-1]:
        raise ValueError(f"K2 kernel: f (E, b), alpha (E, b), dZ (E, b, m), E 1 for the "
                         f"2-D entry; got {tuple(f.shape)}, {tuple(alpha.shape)}, "
                         f"{tuple(gz.shape)}")
    E, b, m = gz.shape
    if k < 1 or E * -(-k // 16) > 65535 or min(gz.shape) < 1 or max(b * m, k * m) >= 2**31:
        raise ValueError(f"K2 kernel: needs 1 <= k, E ceil(k / 16) <= 65535, non-empty "
                         f"dZ and < 2^31 elements an expert; got k={k}, dZ "
                         f"{tuple(gz.shape)}")
    if f.device != gz.device or alpha.device != gz.device:
        raise ValueError("K2 kernel: f, alpha and dZ must lie on one device")
    if not (f.is_contiguous() and alpha.is_contiguous() and gz.is_contiguous()):
        raise ValueError(f"K2 kernel: f, alpha and dZ must be contiguous; dZ "
                         f"strides {gz.stride()}")


def _launch(f, alpha, gz, k: int, nsplit: int, per: int):
    """One launch of K2 over f, alpha (E, b) and dZ (E, b, m) on dZ's current
    CUDA stream, each expert's rows in ``nsplit`` splits of ``per`` rows;
    the split kernel and the ordered merge of the (E, S, k, m) f32 partials
    count as one launch. Returns Btilde (E, k, m) f32, the first E k m
    floats of one allocation that also holds the partials (S > 1)."""
    E, b, m = gz.shape
    n_out = E * k * m
    buf = torch.empty(n_out * (nsplit + 1 if nsplit > 1 else 1), dtype=torch.float32,
                      device=gz.device)
    out = buf[:n_out].view(E, k, m)
    err = build.entry("segment_matmul_batched")(
        f.data_ptr(), alpha.data_ptr(), gz.data_ptr(), out.data_ptr(),
        out.data_ptr() + 4 * n_out, E, b, m, k, nsplit, per, _DTYPES[gz.dtype],
        build.raw_stream(gz))
    build.check_launch("segment_matmul_batched", err)
    return out


def segment_matmul_cuda(f, alpha, gz, k: int):
    """Launch K2 on dZ (b, m) (the batched launch at E 1); returns Btilde
    (k, m) f32. The rows are split by :func:`_splits`. Btilde shares its
    allocation with the partials' S k m 4 bytes (4.125 MiB at the training
    shapes), so a caller that keeps it keeps them too: copy it to keep it.
    ``ops.pamm_apply`` uses it at once."""
    f, alpha, gz = f[None], alpha[None], gz[None]
    _check(f, alpha, gz, k)
    out = _launch(f, alpha, gz, k, *_splits(gz.shape[1], gz.shape[2], k))[0]
    LAUNCHES["segment_matmul"] += 1
    return out


def segment_matmul_batched_cuda(f, alpha, gz, k: int):
    """Launch the batched K2 (every expert in one launch); returns Btilde
    (E, k, m) f32. Each expert's rows are split by :func:`_splits_batched`."""
    _check(f, alpha, gz, k)
    out = _launch(f, alpha, gz, k, *_splits_batched(*gz.shape, k))
    LAUNCHES["segment_matmul_batched"] += 1
    return out
