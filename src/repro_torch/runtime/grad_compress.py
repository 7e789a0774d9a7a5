"""Error-feedback int8 gradient compression for the data x context
all-reduce (``repro/runtime/grad_compress.py``).

Each rank quantises its gradient plus its error-feedback residue to int8
with one f32 scale per tensor, keeps the new residue, and the ranks
average the dequantised values (Seide et al. 2014 / Karimireddy et al.
2019). As in the JAX package, what travels is the f32 dequantised tensor
(no all-reduce sums int8), and :func:`allreduce_wire_bytes` counts the
int8 width the scheme would put on the wire.
"""
from __future__ import annotations

import math

import torch

from repro_torch.runtime.collectives import all_reduce_


def ef_quantize(g: torch.Tensor, err: torch.Tensor):
    """Returns (q int8, scale f32 scalar, new_err). g, err: same shape f32."""
    target = g.float() + err
    scale = torch.clamp(target.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.float() * scale
    return q, scale, new_err


def ef_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group, n: int, comm):
    """All-reduce-mean of ``g`` over the ``n`` ranks of ``group`` with int8
    EF compression: (the mean of the ranks' dequantised values in g's
    dtype, this rank's new residue), written into ``g`` and ``err``."""
    out, new_err = tree_compressed_psum({"g": g}, {"g": err}, group, n, comm)
    return out["g"], new_err["g"]


def tree_compressed_psum(grads: dict, err_tree: dict, group, n: int, comm):
    """:func:`compressed_psum` of every leaf, the dequantised values
    all-reduced together. Returns (mean grads, new residues), dicts keyed
    like ``grads``. In place, leaf by leaf, to keep one copy of each tree
    on the card: ``grads`` receive the mean (an f32 leaf holds its
    dequantised values on the way; any other dtype gets an f32 buffer, so
    the sum is f32 as in the JAX package); ``err_tree`` the new residues."""
    deq = {}
    for name, g in grads.items():
        q, scale, new_err = ef_quantize(g, err_tree[name])
        err_tree[name].copy_(new_err)
        d = ef_dequantize(q, scale)
        deq[name] = g.copy_(d) if g.dtype == torch.float32 else d
        del q, new_err, d
    all_reduce_(list(deq.values()), group, n, comm, mean=True)
    for name, g in grads.items():
        if deq[name] is not g:
            g.copy_(deq[name])
    return grads, err_tree


def init_error_buffers(params: dict) -> dict:
    """Zeroed f32 residues shaped like ``params`` (this rank's row)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


_WIRE_WIDTH = {"bf16": 2, "f32": 4, "int8_ef": 1}


def allreduce_wire_bytes(params, dp: int, scheme: str = "bf16") -> int:
    """Bytes each rank moves per step for the gradient all-reduce: a ring
    all-reduce moves ``2 * (dp-1)/dp * payload``; ``int8_ef`` pays one int8
    per element plus one f32 scale per tensor. ``params``: tensors or
    shapes (a dict, list or anything with ``.shape`` leaves)."""
    if scheme not in _WIRE_WIDTH:
        raise ValueError(f"scheme must be one of {sorted(_WIRE_WIDTH)}, got {scheme!r}")
    leaves = list(params.values()) if isinstance(params, dict) else list(params)
    payload = sum(math.prod(getattr(leaf, "shape", leaf)) for leaf in leaves) \
        * _WIRE_WIDTH[scheme]
    if scheme == "int8_ef":
        payload += 4 * len(leaves)  # one f32 scale per tensor
    if dp <= 1:
        return 0
    return int(2 * (dp - 1) / dp * payload)
