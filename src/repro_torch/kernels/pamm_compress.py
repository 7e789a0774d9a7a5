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

The batched pair (:func:`csim_argmax_batched_ref`,
:func:`csim_argmax_batched_cuda`) takes E problems at once, x (E, b, n)
and c (E, k, n), and returns (E, b) each: the MoE site's experts in one
launch, the counterpart of the JAX package's ``vmap`` over
``pamm_compress`` (``repro/core/linear.py:250``). The 2-D pair is the
batched one at E 1, each with its own launch count.

The split route serves a row-parallel site under tensor parallelism,
whose model ranks each hold a column slice of every row: pass A
(:func:`csim_partial_ref`, :func:`csim_partial_cuda`) writes a slice's
dot products and squared row norms into one (b, k + 1) f32 buffer, the
caller sums it over the model group, and pass B (:func:`csim_finish_ref`,
:func:`csim_finish_cuda`) takes the arg-max from the sums: together, K1
of the whole rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import LAUNCHES

NORM_EPS = 1e-20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _plain(x, c):
    """K1 in plain PyTorch over the expert axis: x (E, b, n), c (E, k, n)
    -> (cs, idx, norm_a), each (E, b). csim in f32 as one batched product,
    arg-max of |csim| (first maximum), the signed value there."""
    x32, c32 = x.float(), c.float()
    norm_a = torch.linalg.vector_norm(x32, dim=2)
    norm_c = torch.linalg.vector_norm(c32, dim=2)
    csim = torch.bmm(x32, c32.transpose(1, 2)) / (
        norm_a.clamp_min(NORM_EPS)[:, :, None] * norm_c.clamp_min(NORM_EPS)[:, None, :])
    idx = torch.argmax(csim.abs(), dim=2)
    cs = torch.gather(csim, 2, idx[..., None])[..., 0]
    return cs, idx.to(torch.int32), norm_a


def csim_argmax_ref(x, c):
    """Plain version of K1: x (b, n), c (k, n) -> (cs, idx, norm_a) (b,)."""
    LAUNCHES["csim_argmax_ref"] += 1
    return tuple(t[0] for t in _plain(x[None], c[None]))


def csim_argmax_batched_ref(x, c):
    """Plain version of the batched K1: :func:`csim_argmax_ref` of each
    expert's x[e] (b, n) against its c[e] (k, n)."""
    LAUNCHES["csim_argmax_batched_ref"] += 1
    return _plain(x, c)


def _check(x, c):
    if x.device.type != "cuda":
        raise ValueError(f"K1 kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or c.dtype != x.dtype:
        raise ValueError(f"K1 kernel takes float32 or bfloat16 x/c of one dtype, "
                         f"got {x.dtype}/{c.dtype}")
    if x.dim() != 3 or c.dim() != 3 or c.shape[2] != x.shape[2] or c.shape[0] != x.shape[0]:
        raise ValueError(f"K1 kernel: x (E, b, n) and c (E, k, n), E 1 for the 2-D "
                         f"entry; got {tuple(x.shape)}, {tuple(c.shape)}")
    if min(x.shape) < 1 or c.shape[1] < 1:
        raise ValueError(f"K1 kernel: empty x or c: {tuple(x.shape)}, {tuple(c.shape)}")
    if (max(x[0].numel(), c[0].numel()) >= 2**31 or x.shape[0] > 65535
            or c.device != x.device):
        raise ValueError("K1 kernel: x and c must lie on one device with < 2^31 elements "
                         "an expert and at most 65535 experts")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"K1 kernel: x and c must be contiguous; strides "
                         f"{x.stride()}, {c.stride()}")


def _launch(x, c):
    """One launch of K1 over x (E, b, n) and c (E, k, n) on x's current CUDA
    stream, the expert the outermost grid axis; (cs, idx, norm_a) (E, b)."""
    _check(x, c)
    E, b, n = x.shape
    out = torch.empty((3, E, b), dtype=torch.float32, device=x.device)  # cs, idx, norm
    cs, idx, norm = out[0], out[1].view(torch.int32), out[2]
    err = build.entry("csim_argmax_batched")(
        x.data_ptr(), c.data_ptr(), cs.data_ptr(), idx.data_ptr(), norm.data_ptr(),
        E, b, n, c.shape[1], _DTYPES[x.dtype], build.raw_stream(x))
    build.check_launch("csim_argmax_batched", err)
    return cs, idx, norm


def csim_argmax_cuda(x, c):
    """Launch K1 on x (b, n) (the batched launch at E 1); returns (cs, idx,
    norm_a)."""
    out = tuple(t[0] for t in _launch(x[None], c[None]))
    LAUNCHES["csim_argmax"] += 1
    return out


def csim_argmax_batched_cuda(x, c):
    """Launch the batched K1 (every expert in one launch); returns (cs, idx,
    norm_a), each (E, b)."""
    out = _launch(x, c)
    LAUNCHES["csim_argmax_batched"] += 1
    return out


def csim_partial_ref(x, c):
    """Plain version of pass A: x (b, n), c (k, n), a column slice of each
    -> (b, k + 1) f32, row i's dots with the k generators then ||x_i||^2."""
    LAUNCHES["csim_partial_ref"] += 1
    x32 = x.float()
    return torch.cat([x32 @ c.float().T, (x32 * x32).sum(1, keepdim=True)], dim=1)


def csim_finish_ref(part, idx):
    """Plain version of pass B: ``part`` (b, k + 1), pass A's buffer summed
    over the column slices, and the generators' rows ``idx`` (k,) of x ->
    (cs, idx, norm_a) (b,), as :func:`csim_argmax_ref` of the whole rows."""
    LAUNCHES["csim_finish_ref"] += 1
    k = part.shape[1] - 1
    norm_a = part[:, k].sqrt()
    norm_c = norm_a[idx.long()]
    inv_c = torch.where(norm_c > 0, 1.0 / norm_c.clamp_min(NORM_EPS), 0.0)
    csim = part[:, :k] * (1.0 / norm_a.clamp_min(NORM_EPS))[:, None] * inv_c[None, :]
    best = torch.argmax(csim.abs(), dim=1)
    cs = torch.gather(csim, 1, best[:, None])[:, 0]
    return cs, best.to(torch.int32), norm_a


def csim_partial_cuda(x, c):
    """Launch pass A on x (b, n), c (k, n); returns the (b, k + 1) buffer."""
    _check(x[None], c[None])
    b, n = x.shape
    k = c.shape[0]
    part = torch.empty((b, k + 1), dtype=torch.float32, device=x.device)
    err = build.entry("csim_partial")(x.data_ptr(), c.data_ptr(), part.data_ptr(), b, n, k,
                                      _DTYPES[x.dtype], build.raw_stream(x))
    build.check_launch("csim_partial", err)
    LAUNCHES["csim_partial"] += 1
    return part


def csim_finish_cuda(part, idx):
    """Launch pass B on the summed (b, k + 1) buffer and the generators'
    rows ``idx`` (k,); returns (cs, idx, norm_a), each (b,)."""
    if part.device.type != "cuda" or part.dtype != torch.float32 or part.dim() != 2:
        raise ValueError(f"K1 pass B needs a (b, k + 1) f32 CUDA buffer, got "
                         f"{part.dtype} {tuple(part.shape)} on {part.device}")
    b, k = part.shape[0], part.shape[1] - 1
    if k < 1 or b < 1 or idx.shape != (k,) or part.numel() >= 2**31:
        raise ValueError(f"K1 pass B: buffer {tuple(part.shape)}, idx {tuple(idx.shape)}")
    part = part.contiguous()
    rows = idx.to(device=part.device, dtype=torch.int32).contiguous()
    out = torch.empty((3, b), dtype=torch.float32, device=part.device)  # cs, idx, norm
    cs, best, norm = out[0], out[1].view(torch.int32), out[2]
    err = build.entry("csim_finish")(part.data_ptr(), rows.data_ptr(), cs.data_ptr(),
                                     best.data_ptr(), norm.data_ptr(), b, k,
                                     build.raw_stream(part))
    build.check_launch("csim_finish", err)
    LAUNCHES["csim_finish"] += 1
    return cs, best, norm
