"""The mesh's axes and their degrees, the config-time divisibility checks,
the ring dispatch context and the ZeRO-1 rule
(``repro/runtime/sharding.py:100, 194-345``), for a
:class:`repro_torch.launch.mesh.Mesh`.

The error texts are the JAX package's. Its GSPMD-only parts
(``logical_to_pspec``, ``maybe_constrain``, ``shard_map_ctx``,
``scan_compat``) have no counterpart: each rank runs eagerly on its own
slice. What the JAX ``zero1_specs`` reads from the parameters' logical
specs -- which dimensions the tensor-parallel ``model`` axis already takes
-- the port keeps as :data:`MODEL_AXIS_DIMS`, so its ZeRO-1 layout is the
JAX one and a later checkpoint slice reads the same moment slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

CONTEXT_AXIS = "context"

# Per parameter leaf, the dimensions (counted from the end) whose logical
# axis the JAX rules put on the ``model`` axis (heads, ffn, experts,
# vocab: ``repro/runtime/sharding.py:DEFAULT_RULES``), keyed by the leaf's
# name and its number of dimensions; stacked block leaves carry the
# leading ``layers`` axis. A dimension listed here is not free for ZeRO-1.
MODEL_AXIS_DIMS = {
    ("wq", 3): (-1,), ("wk", 3): (-1,), ("wv", 3): (-1,), ("wo", 3): (-2,),
    ("bq", 2): (-1,), ("bk", 2): (-1,), ("bv", 2): (-1,),
    ("w_gate", 3): (-1,), ("w_up", 3): (-1,), ("w_down", 3): (-2,),
    ("w_gate", 4): (-3,), ("w_up", 4): (-3,), ("w_down", 4): (-3,),   # moe: experts
    ("w_x", 3): (-1,), ("w_y", 3): (-1,), ("conv_w", 3): (-1,), ("out", 3): (-2,),
    ("w_a", 3): (-2,), ("w_i", 3): (-2,),
    ("in_proj", 3): (-1,), ("out_proj", 3): (-2,), ("out_norm", 2): (-1,),
    ("embed", 2): (-2,), ("head", 2): (-1,),
}


def data_axis_names(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes (``('data',)``, or ``()``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_degree(mesh) -> int:
    """Number of data-parallel shards."""
    deg = 1
    for a in data_axis_names(mesh):
        deg *= mesh.axis_size(a)
    return deg


def context_axis_names(mesh) -> tuple[str, ...]:
    """The mesh's context-parallel (sequence / ring) axes: ``('context',)``
    when present, else ``()``."""
    return tuple(a for a in (CONTEXT_AXIS,) if a in mesh.axis_names)


def cp_degree(mesh) -> int:
    """Number of context-parallel (sequence) shards."""
    deg = 1
    for a in context_axis_names(mesh):
        deg *= mesh.axis_size(a)
    return deg


def sync_axis_names(mesh) -> tuple[str, ...]:
    """Axes gradients / loss / metrics reduce over: data x context. Every
    (data, context) coordinate computes the loss of a distinct (batch
    slice, sequence slice) block, so the reduction set is their product."""
    return data_axis_names(mesh) + context_axis_names(mesh)


def validate_seq_divisible(seq_len: int, mesh, *, bq: int | None = None,
                           where: str = "train step"):
    """Raise a clear config-time error when the sequence length cannot
    zigzag-shard over the context axis (``seq_len % (2 * cp)``)."""
    cp = cp_degree(mesh)
    if cp <= 1:
        return
    fold = 2 * cp
    if seq_len % fold:
        lo = (seq_len // fold) * fold
        hi = lo + fold
        hint = ""
        if bq:
            step = fold * bq
            zlo = (seq_len // step) * step
            hint = (f" (for zero kernel padding, a multiple of cp*2*bq = "
                    f"{step}, e.g. {zlo or step} or {zlo + step})")
        raise ValueError(
            f"{where}: seq_len {seq_len} is not divisible by 2*cp = {fold} "
            f"(context axis {context_axis_names(mesh)} of degree {cp}; "
            f"zigzag sharding folds the sequence into {fold} chunks). "
            f"Nearest valid lengths: {lo or fold} or {hi}{hint}."
        )


def validate_batch_divisible(global_batch: int, mesh, *, grad_accum: int = 1,
                             where: str = "train step"):
    """Raise a clear error when the global batch cannot shard over the data
    axes."""
    dp = dp_degree(mesh)
    axes = data_axis_names(mesh)
    if dp > 1 and global_batch % dp:
        raise ValueError(
            f"{where}: global batch {global_batch} is not divisible by the "
            f"data-parallel degree {dp} (mesh axes {axes} of shape "
            f"{tuple(mesh.shape)}). Pick a global batch that is a "
            f"multiple of {dp}, or reshape the mesh."
        )
    accum = max(1, grad_accum)
    local = global_batch // max(1, dp)
    if accum > 1 and local % accum:
        raise ValueError(
            f"{where}: per-shard batch {local} (global {global_batch} / "
            f"dp {dp}) is not divisible by grad_accum={accum}."
        )


# ---------------------------------------------------------------------------
# the ring dispatch context
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RingGroup:
    """This rank's place in the context ring: the subgroup, its degree
    ``cp``, this rank's index along the axis, and the transport."""

    group: Any
    cp: int
    index: int
    comm: Any


_RING: list[RingGroup] = []


def ring_context() -> RingGroup | None:
    """The ring of the enclosing :func:`context_parallel` block when its
    degree is above 1, else None -- the dispatch point for ring attention
    (``models/attention.attn_train``). The JAX package finds it from the
    shard_map trace; here the mesh executor enters the block around its
    forward and backward (a rematerialised layer recomputes inside it,
    on the autograd thread of a CUDA backward too, so it is process-wide)."""
    return _RING[-1] if _RING else None


@contextlib.contextmanager
def context_parallel(mesh):
    """Run the enclosed forward / backward as this rank's shard of the
    mesh's context axis (a no-op when its degree is 1)."""
    cp = cp_degree(mesh)
    if cp <= 1:
        yield None
        return
    ring = RingGroup(mesh.group(CONTEXT_AXIS), cp, mesh.coord(CONTEXT_AXIS), mesh.comm)
    _RING.append(ring)
    try:
        yield ring
    finally:
        _RING.pop()


_DATA_SHARDS: list[int] = []


def data_shards() -> int:
    """The data degree of the enclosing :func:`data_parallel` block (1
    outside one): a rank there holds 1/data_shards() of the global batch's
    tokens, so MoE's blocked dispatch cuts them into ``moe_token_blocks /
    data_shards()`` blocks, and the ranks' blocks together are the global
    batch's ``moe_token_blocks`` (``models/moe.moe_ffn``)."""
    return _DATA_SHARDS[-1] if _DATA_SHARDS else 1


@contextlib.contextmanager
def data_parallel(mesh):
    """Run the enclosed forward / backward as this rank's data shard of
    ``mesh`` (process-wide, as :func:`context_parallel`)."""
    _DATA_SHARDS.append(dp_degree(mesh))
    try:
        yield
    finally:
        _DATA_SHARDS.pop()


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------
def _leaf_key(name: str, ndim: int):
    return (name.rsplit(".", 1)[-1], ndim)


def zero1_dim(name: str, shape, dp: int) -> int | None:
    """The dimension of parameter ``name`` (shape ``shape``) that its
    optimizer moments split over ``dp`` data shards: the first dimension
    the model axis does not take whose size ``dp`` divides and is at least
    ``dp`` (``zero1_specs``' rule); None keeps the moments whole on every
    rank."""
    if dp <= 1:
        return None
    ndim = len(shape)
    taken = {d % ndim for d in MODEL_AXIS_DIMS.get(_leaf_key(name, ndim), ())}
    for i, dim in enumerate(shape):
        if i not in taken and dim % dp == 0 and dim >= dp:
            return i
    return None


def shard_slice(t, dim: int | None, index: int, dp: int):
    """The view of data shard ``index``'s 1/dp slice of ``t`` along ``dim``
    (``t`` itself for ``dim`` None)."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t.narrow(dim, index * n, n)


def zero1_layout(params: dict, dp: int) -> dict:
    """``{name: dim or None}`` for a dict of parameters (or shapes)."""
    return {n: zero1_dim(n, tuple(p.shape), dp) for n, p in params.items()}
