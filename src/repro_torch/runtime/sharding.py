"""The mesh's axes and their degrees, the config-time divisibility checks,
the ring dispatch context, the tensor-parallel layout and dispatch context
and the ZeRO-1 rule (``repro/runtime/sharding.py:26-60, 100, 194-345``),
for a :class:`repro_torch.launch.mesh.Mesh`.

The error texts are the JAX package's. Its GSPMD-only parts
(``logical_to_pspec``, ``maybe_constrain``, ``shard_map_ctx``,
``scan_compat``) have no counterpart: each rank runs eagerly on its own
slice. What ``logical_to_pspec`` makes of the parameters' logical specs --
which dimension of each leaf the tensor-parallel ``model`` axis takes --
the port keeps as :data:`MODEL_AXIS_DIMS`: :func:`model_dim` reads it for
a rank's slice of a leaf (:func:`shard_params`), and ZeRO-1 keeps off
those dimensions, so the port's layouts are the JAX ones.
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


MODEL_AXIS = "model"
# Leaves the model axis splits by whole heads: their dimension must divide
# into tp x head_dim (the q heads for wq / bq / wo, the K/V heads for the
# others), or the leaf stays whole on every rank.
Q_HEAD_LEAVES = ("wq", "bq", "wo")
KV_HEAD_LEAVES = ("wk", "wv", "bk", "bv")


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
# tensor parallelism: the layout of the model axis
# ---------------------------------------------------------------------------
def _leaf_key(name: str, ndim: int):
    return (name.rsplit(".", 1)[-1], ndim)


def tp_degree(mesh) -> int:
    """Number of tensor-parallel (model axis) shards."""
    return mesh.axis_size(MODEL_AXIS)


def model_dim(name: str, shape, tp: int, head_dim: int = 1) -> int | None:
    """The dimension of parameter ``name`` (full shape ``shape``) that the
    model axis of degree ``tp`` splits, or None (whole on every rank): the
    dimension :data:`MODEL_AXIS_DIMS` names when ``tp`` divides it -- in
    whole heads of ``head_dim`` for the head leaves -- as the JAX
    ``state_shardings`` drops an uneven dimension to replication
    (``repro/runtime/sharding.py:sanitize_shardings``)."""
    if tp <= 1:
        return None
    ndim = len(shape)
    dims = MODEL_AXIS_DIMS.get(_leaf_key(name, ndim), ())
    if not dims:
        return None
    dim = dims[0] % ndim
    leaf = name.rsplit(".", 1)[-1]
    unit = head_dim if leaf in Q_HEAD_LEAVES + KV_HEAD_LEAVES else 1
    return dim if shape[dim] % (tp * unit) == 0 else None


def shard_params(flat: dict, mesh, head_dim: int = 1) -> dict:
    """This rank's slice of each full leaf of ``flat`` along its
    :func:`model_dim` (views; a whole leaf is itself)."""
    tp, index = tp_degree(mesh), mesh.coord(MODEL_AXIS)
    return {n: shard_slice(t, model_dim(n, tuple(t.shape), tp, head_dim), index, tp)
            for n, t in flat.items()}


def padded_experts(cfg, rcfg) -> int:
    """E': the expert count padded up to ``rcfg.pad_experts_multiple``
    with dead experts (``repro/models/model.py:89-90``); 0 without experts."""
    em = getattr(rcfg, "pad_experts_multiple", 0)
    e = cfg.n_experts
    return (-(-e // em) * em if em else e) if e else 0


def _full_size(name: str, ndim: int, cfg, v_pad: int, n_experts: int) -> int | None:
    """The whole size of the dimension the model axis would split of leaf
    ``name`` (``ndim`` dimensions), None for other leaves: a MoE expert
    leaf's (layers, E', ., .) splits its E' experts, the shared experts'
    FFN its ``moe_d_ff * n_shared_experts`` columns (``core/plan.py``'s
    ``_role_n_in``), a dense FFN its ``d_ff``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in Q_HEAD_LEAVES:
        return cfg.n_heads * cfg.head_dim
    if leaf in KV_HEAD_LEAVES:
        return cfg.n_kv_heads * cfg.head_dim
    if leaf in ("w_gate", "w_up", "w_down"):
        if ndim == 4:
            return n_experts or cfg.n_experts
        if ".shared." in f".{name}":
            return cfg.moe_d_ff * cfg.n_shared_experts
        return cfg.d_ff
    if leaf in ("embed", "head"):
        return v_pad * (max(1, cfg.n_codebooks) if leaf == "head" else 1)
    return None


def local_model_dim(name: str, local_shape, cfg, v_pad: int,
                    n_experts: int = 0) -> int | None:
    """:func:`model_dim` of a leaf read from one rank's slice of it: the
    dimension :data:`MODEL_AXIS_DIMS` names when it is shorter than the
    whole (``cfg``; ``v_pad`` the padded vocabulary, ``n_experts`` the
    padded expert count E' of :func:`padded_experts`, 0 for
    ``cfg.n_experts``)."""
    ndim = len(local_shape)
    dims = MODEL_AXIS_DIMS.get(_leaf_key(name, ndim), ())
    full = _full_size(name, ndim, cfg, v_pad, n_experts)
    if not dims or full is None:
        return None
    dim = dims[0] % ndim
    return dim if local_shape[dim] != full else None


def unshard_params(shards: list, cfg, v_pad: int, n_experts: int = 0) -> dict:
    """Inverse of :func:`shard_params`: the model ranks' slices (one dict
    each, in model-axis order; tensors or numpy arrays) -> the whole
    leaves (``n_experts`` as in :func:`local_model_dim`)."""
    import numpy as np
    import torch

    out = {}
    for n, t in shards[0].items():
        dim = local_model_dim(n, tuple(t.shape), cfg, v_pad, n_experts)
        if dim is None:
            out[n] = t
        elif isinstance(t, torch.Tensor):
            out[n] = torch.cat([s[n] for s in shards], dim=dim)
        else:
            out[n] = np.concatenate([s[n] for s in shards], axis=dim)
    return out


# The refusals of tensor parallelism, each naming the slice that lifts it.
TP_KINDS = ("attn", "swa", "moe")
LATER_SLICE_TP_KINDS = (
    "tensor parallelism (model degree {tp}) runs the block kinds {ok}; {bad} "
    "arrive with later slices: ssm and rec / latt with their inner widths over the "
    "model axis, xattn with cross-attention heads over it. Use --data-model D 1 for "
    "this architecture")
LATER_SLICE_TP_REVERSIBLE = (
    "block_structure={structure!r} under tensor parallelism (model degree {tp}) "
    "arrives with a later slice: the reversible stage's backward replays its "
    "sublayers, and the replay does not carry the model axis's collectives yet. "
    "Use block_structure='residual' with a model degree above 1")
LATER_SLICE_TP_EMBED_INPUTS = (
    "an embed-input architecture (musicgen's four-codebook frontend) under tensor "
    "parallelism (model degree {tp}) arrives with a later slice: its head holds "
    "every codebook's vocabulary side by side. Use --data-model D 1")
LATER_SLICE_TP_CONTEXT = (
    "a model (tensor-parallel) degree above 1 together with a context degree above 1 "
    "arrives with a later slice (the ring inside tensor-parallel attention); use "
    "--data-model D M with --mesh-context 1, or --data-model D 1 with --mesh-context C")
LATER_SLICE_TP_OPTIMIZER = (
    "optimizer={opt!r} under tensor parallelism (model degree {tp}) arrives with a "
    "later slice: its factored moments average over dimensions the model axis "
    "splits. Use optimizer='adamw'")
LATER_SLICE_TP_GRAD_COMPRESS = (
    "grad_compress={gc!r} under tensor parallelism (model degree {tp}) arrives with "
    "a later slice: its one int8 scale a tensor is the max over the whole leaf, "
    "which the model ranks each hold a slice of. Use grad_compress='none'")


def validate_tensor_parallel(cfg, rcfg, tp: int) -> None:
    """Config-time refusals of a model degree ``tp`` above 1 (the texts
    above). The dense kinds and ``moe`` (experts over the model axis) run;
    a compressed row-parallel site (``ffn.down``) compresses its split
    input through K1's split route (``core/pamm.py``)."""
    if tp <= 1:
        return
    kinds = sorted({k for unit, _ in cfg.stages for k in unit})
    bad = [k for k in kinds if k not in TP_KINDS]
    if bad:
        raise NotImplementedError(LATER_SLICE_TP_KINDS.format(tp=tp, ok=TP_KINDS, bad=bad))
    structure = getattr(rcfg, "block_structure", "residual") or "residual"
    if structure != "residual":
        raise NotImplementedError(LATER_SLICE_TP_REVERSIBLE.format(structure=structure,
                                                                   tp=tp))
    if cfg.embed_inputs or cfg.n_codebooks:
        raise NotImplementedError(LATER_SLICE_TP_EMBED_INPUTS.format(tp=tp))
    if rcfg.optimizer != "adamw":
        raise NotImplementedError(LATER_SLICE_TP_OPTIMIZER.format(opt=rcfg.optimizer, tp=tp))
    gc = getattr(rcfg, "grad_compress", "none")
    if gc != "none":
        raise NotImplementedError(LATER_SLICE_TP_GRAD_COMPRESS.format(gc=gc, tp=tp))
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if H % tp == 0 and KV % tp and (H // KV) % (H // tp):
        raise NotImplementedError(
            f"tensor parallelism (model degree {tp}) with {H} q heads over {KV} K/V "
            f"heads: the K/V heads stay whole on every rank, and a rank's {H // tp} "
            f"q heads must then fall in one K/V head's group of {H // KV}")


# ---------------------------------------------------------------------------
# the tensor-parallel dispatch context
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the model axis: the subgroup, its degree
    ``tp``, this rank's index along it and the transport; ``seq_shard``:
    the residual stream is split over the sequence between blocks
    (Megatron sequence parallelism); and which sublayers the model axis
    splits (a dimension it cannot divide stays whole: :func:`model_dim`):
    the q heads (``heads``; wq / bq columns, wo rows), the K/V heads
    (``kv``; else every rank holds them all and takes its q heads' group),
    the FFN width (``ffn``), the (padded) vocabulary (``vocab``), a MoE
    block's E' experts (``experts``: rank ``index`` holds experts
    [index E'/tp, (index + 1) E'/tp)) and its shared experts' FFN width
    (``shared``, ``moe_d_ff * n_shared_experts``)."""

    group: Any
    tp: int
    index: int
    comm: Any
    seq_shard: bool = False
    heads: bool = False
    kv: bool = False
    ffn: bool = False
    vocab: bool = False
    experts: bool = False
    shared: bool = False


_MODEL: list[ModelGroup] = []


def model_group() -> ModelGroup | None:
    """The model axis of the enclosing :func:`tensor_parallel` block when its
    degree is above 1, else None: the dispatch point of the column- and
    row-parallel products (``models/layers.py``, ``models/attention.py``,
    ``models/model.py``). Process-wide, as :func:`ring_context`: a
    rematerialised layer recomputes inside it in backward."""
    return _MODEL[-1] if _MODEL else None


def make_model_group(mesh, cfg, rcfg, v_pad: int) -> ModelGroup | None:
    """The :class:`ModelGroup` of ``mesh`` for ``cfg`` (``v_pad``: the padded
    vocabulary), or None for a model degree of 1."""
    tp = tp_degree(mesh)
    if tp <= 1:
        return None
    d, dh = cfg.d_model, cfg.head_dim
    # a stacked block leaf (layers, d, width), an expert leaf (layers, E',
    # d, f), the head (d, V)
    split = lambda leaf, *shape: model_dim(leaf, shape, tp, dh) is not None
    heads = split("wq", 1, d, cfg.n_heads * dh)
    ep = padded_experts(cfg, rcfg)
    return ModelGroup(mesh.group(MODEL_AXIS), tp, mesh.coord(MODEL_AXIS), mesh.comm,
                      seq_shard=bool(getattr(rcfg, "seq_shard", False)), heads=heads,
                      kv=heads and split("wk", 1, d, cfg.n_kv_heads * dh),
                      ffn=split("w_gate", 1, d, cfg.d_ff), vocab=split("head", d, v_pad),
                      experts=bool(ep) and split("w_gate", 1, ep, d, cfg.moe_d_ff),
                      shared=bool(cfg.n_shared_experts) and split(
                          "w_gate", 1, d, cfg.moe_d_ff * cfg.n_shared_experts))


@contextlib.contextmanager
def tensor_parallel(group: ModelGroup | None):
    """Run the enclosed forward / backward as this rank's shard of the
    model axis (a no-op for None)."""
    if group is None:
        yield None
        return
    _MODEL.append(group)
    try:
        yield group
    finally:
        _MODEL.pop()


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

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
    """The view of shard ``index``'s 1/dp slice of ``t`` (a tensor or a
    numpy array) along ``dim`` (``t`` itself for ``dim`` None)."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def zero1_layout(params: dict, dp: int) -> dict:
    """``{name: dim or None}`` for a dict of parameters (or shapes)."""
    return {n: zero1_dim(n, tuple(p.shape), dp) for n, p in params.items()}
