"""The mesh's axes and their degrees, the config-time divisibility checks,
the ring dispatch context, the tensor-parallel layout and dispatch context
and the ZeRO-1 rule (``repro/runtime/sharding.py:26-60, 100, 194-345``),
for a :class:`repro_torch.launch.mesh.Mesh`.

The error texts are the JAX package's. Its GSPMD-only parts
(``logical_to_pspec``, ``maybe_constrain``, ``shard_map_ctx``,
``scan_compat``) have no counterpart: each rank runs eagerly on its own
slice. What ``logical_to_pspec`` makes of the parameters' logical specs --
which dimension of each leaf the tensor-parallel ``model`` axis takes --
the port keeps as :data:`MODEL_AXIS_DIMS`: :func:`model_cut` reads it for
a rank's slice of a leaf (:func:`shard_params`), and ZeRO-1 keeps off
those dimensions, so the port's layouts are the JAX ones, with four
departures by design:

  * attention's K/V leaves are split in whole heads only (all K/V heads
    whole on every rank when the degree exceeds them);
  * Mamba-2's packed leaves are cut by heads, not in one contiguous
    slice. ``in_proj``'s columns are ``[z | x | B | C | dt]`` and
    ``conv_w``'s ``[x | B | C]``: model rank r holds the z, x and dt
    columns of its nh/tp heads and the B and C columns whole (one group;
    with ngroups > 1, its groups' columns), a :class:`Cut` of several
    parts. JAX's contiguous ``("embed", "ffn")`` cut would hand rank 0
    all of z and part of x, from which no rank can run its heads;
  * the RG-LRU gates ``w_a`` / ``w_i`` (lru_width x lru_width) are cut
    by columns (a rank's output width), not by JAX's rows
    ``("ffn", None)``: a rank all-gathers its conv output once a layer
    and computes both gates of its columns exactly, where the row cut
    would reduce-scatter both gates' f32 partial products;
  * a multi-codebook head (musicgen's (d, n_codebooks x V)) is cut by
    codebooks: rank r holds columns [c V + r V/tp, c V + (r + 1) V/tp) of
    each codebook c, n_codebooks split parts (:func:`head_parts`), not
    JAX's contiguous ``("embed", "vocab")`` cut. Each codebook's loss
    then runs through the one vocabulary-parallel cross-entropy
    (``models/model.loss_fn``); the contiguous cut would hand a rank whole
    codebooks at tp 2 and part of one at tp 8, two loss routes.

Leaves whole on every rank whose gradient is partial on each (Mamba-2's
B / C columns, ``a_log``, ``d_skip``, ``dt_bias``, RG-LRU's ``lambda``,
attention's whole K/V heads and q_norm / k_norm; under ``seq_shard`` the
norms and an xattn block's gates, which read this rank's chunk of the
sequence) have that gradient summed over the model group in backward,
where they are read; the global norm counts their squares once
(:func:`model_layout`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

CONTEXT_AXIS = "context"

# Per parameter leaf, the dimensions (counted from the end) whose logical
# axis the JAX rules put on the ``model`` axis (heads, ffn, experts,
# vocab: ``repro/runtime/sharding.py:DEFAULT_RULES``), keyed by the leaf's
# name (an ssm or rec block's leaves by ``ssm.<leaf>`` / ``rec.<leaf>``:
# both kinds have a ``conv_w``) and its number of dimensions; stacked
# block leaves carry the leading ``layers`` axis. A dimension listed here
# is not free for ZeRO-1. ``rec.w_a`` / ``rec.w_i`` take their columns
# (module docstring), where JAX takes their rows.
MODEL_AXIS_DIMS = {
    ("wq", 3): (-1,), ("wk", 3): (-1,), ("wv", 3): (-1,), ("wo", 3): (-2,),
    ("bq", 2): (-1,), ("bk", 2): (-1,), ("bv", 2): (-1,),
    ("w_gate", 3): (-1,), ("w_up", 3): (-1,), ("w_down", 3): (-2,),
    ("w_gate", 4): (-3,), ("w_up", 4): (-3,), ("w_down", 4): (-3,),   # moe: experts
    ("rec.w_x", 3): (-1,), ("rec.w_y", 3): (-1,), ("rec.conv_w", 3): (-1,),
    ("rec.out", 3): (-2,), ("rec.w_a", 3): (-1,), ("rec.w_i", 3): (-1,),
    ("ssm.in_proj", 3): (-1,), ("ssm.conv_w", 3): (-1,), ("ssm.out_norm", 2): (-1,),
    ("ssm.out_proj", 3): (-2,),
    ("embed", 2): (-2,), ("head", 2): (-1,),
}
# Mamba-2's leaves packed by parts (module docstring): their cut needs the
# config (:func:`ssm_parts`)
SSM_PACKED = ("ssm.in_proj", "ssm.conv_w")


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
    parts = name.split(".")
    leaf = ".".join(parts[-2:]) if len(parts) > 1 and parts[-2] in ("ssm", "rec") \
        else parts[-1]
    return (leaf, ndim)


def _narrow(t, dim: int, start: int, n: int):
    return t[(slice(None),) * dim + (slice(start, start + n),)]


def _cat(pieces: list, dim: int):
    import torch

    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(pieces, dim=dim)
    import numpy as np

    return np.concatenate(pieces, axis=dim)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How the model axis cuts dimension ``dim`` of a leaf: the
    dimension's ``parts`` in order, each ``(size, split)``. Of a split
    part each rank holds its 1/tp slice (rank r the r-th), of a whole
    part all of it; a rank's slice is its pieces of the parts, in order.
    One split part is the plain contiguous cut."""

    dim: int
    parts: tuple

    @property
    def contiguous(self) -> bool:
        return len(self.parts) == 1 and self.parts[0][1]

    def local_size(self, tp: int) -> int:
        return sum(size // tp if split else size for size, split in self.parts)

    def take(self, t, index: int, tp: int):
        """Rank ``index``'s slice of the whole leaf ``t`` (a tensor or a
        numpy array): a view for the contiguous cut, a copy otherwise."""
        if self.contiguous:
            return shard_slice(t, self.dim, index, tp)
        pieces, off = [], 0
        for size, split in self.parts:
            pieces.append(_narrow(t, self.dim, off + index * size // tp, size // tp)
                          if split else _narrow(t, self.dim, off, size))
            off += size
        return _cat(pieces, self.dim)

    def join(self, pieces: list):
        """The whole leaf from the model ranks' slices, in model order (a
        whole part from the first rank's: every rank holds the same)."""
        tp = len(pieces)
        out, off = [], 0
        for size, split in self.parts:
            n = size // tp if split else size
            out += ([_narrow(p, self.dim, off, n) for p in pieces] if split
                    else [_narrow(pieces[0], self.dim, off, n)])
            off += n
        return _cat(out, self.dim)

    def whole_index(self, tp: int) -> list:
        """Index tuples of the whole parts in a rank's slice."""
        out, off = [], 0
        for size, split in self.parts:
            n = size // tp if split else size
            if not split:
                out.append((slice(None),) * self.dim + (slice(off, off + n),))
            off += n
        return out


def tp_degree(mesh) -> int:
    """Number of tensor-parallel (model axis) shards."""
    return mesh.axis_size(MODEL_AXIS)


def ssm_splits(cfg, tp: int) -> bool:
    """Whether the model axis of degree ``tp`` splits the ssm blocks: by
    whole heads, the B / C groups whole (one group) or split with them
    (``tp`` dividing ngroups); otherwise every ssm leaf stays whole."""
    ng = cfg.ssm_ngroups
    return tp > 1 and cfg.ssm_nheads % tp == 0 and (ng == 1 or ng % tp == 0)


def ssm_parts(leaf: str, cfg) -> tuple:
    """The parts of a packed Mamba-2 leaf's last dimension (``ssm.in_proj``
    ``[z | x | B | C | dt]``, ``ssm.conv_w`` ``[x | B | C]``): B and C are
    whole for one group, split (by groups) for several."""
    din, ng, st = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
    bc = ((ng * st, ng > 1),) * 2
    if leaf == "ssm.in_proj":
        return ((din, True), (din, True)) + bc + ((cfg.ssm_nheads, True),)
    return ((din, True),) + bc


def head_parts(cfg, v_pad: int) -> tuple:
    """The parts of the head's columns: one split part of ``v_pad`` a
    codebook (one for a single-codebook head), so that a rank holds its
    1/tp of each codebook's vocabulary."""
    return ((v_pad, True),) * max(1, cfg.n_codebooks)


def model_cut(name: str, shape, tp: int, head_dim: int = 1, cfg=None) -> Cut | None:
    """How the model axis of degree ``tp`` cuts parameter ``name`` (full
    shape ``shape``), or None (whole on every rank): the dimension
    :data:`MODEL_AXIS_DIMS` names when ``tp`` divides it -- in whole
    heads of ``head_dim`` for the head leaves -- as the JAX
    ``state_shardings`` drops an uneven dimension to replication
    (``repro/runtime/sharding.py:sanitize_shardings``); an ssm leaf (which
    needs ``cfg``) by :func:`ssm_splits` and, packed, in :func:`ssm_parts`;
    the head by codebooks (:func:`head_parts`, when ``tp`` divides a
    codebook's vocabulary; without ``cfg`` the head is one codebook)."""
    if tp <= 1:
        return None
    ndim = len(shape)
    key = _leaf_key(name, ndim)
    dims = MODEL_AXIS_DIMS.get(key, ())
    if not dims:
        return None
    dim = dims[0] % ndim
    leaf = key[0]
    if leaf.startswith("ssm."):
        if cfg is None:
            raise ValueError(f"the model axis's cut of the ssm leaf {leaf!r} depends on the "
                             f"config (its heads, groups and state): pass cfg=")
        if not ssm_splits(cfg, tp):
            return None
        return Cut(dim, ssm_parts(leaf, cfg) if leaf in SSM_PACKED else ((shape[dim], True),))
    if leaf == "head" and cfg is not None and cfg.n_codebooks:
        v = shape[dim] // cfg.n_codebooks
        return Cut(dim, head_parts(cfg, v)) if v % tp == 0 else None
    unit = head_dim if leaf in Q_HEAD_LEAVES + KV_HEAD_LEAVES else 1
    return Cut(dim, ((shape[dim], True),)) if shape[dim] % (tp * unit) == 0 else None


def shard_params(flat: dict, mesh, head_dim: int = 1, cfg=None) -> dict:
    """This rank's slice of each full leaf of ``flat`` along its
    :func:`model_cut` (views for a contiguous cut; a whole leaf is
    itself); ``cfg`` is needed for ssm leaves."""
    tp, index = tp_degree(mesh), mesh.coord(MODEL_AXIS)
    out = {}
    for n, t in flat.items():
        cut = model_cut(n, tuple(t.shape), tp, head_dim, cfg)
        out[n] = t if cut is None else cut.take(t, index, tp)
    return out


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
    ``_role_n_in``), a dense FFN its ``d_ff``, an ssm block its packed
    ``in_proj`` / ``conv_w`` columns or its inner width, a rec block its
    RG-LRU width."""
    leaf = _leaf_key(name, ndim)[0]
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
    if leaf in SSM_PACKED:
        return sum(size for size, _ in ssm_parts(leaf, cfg))
    if leaf in ("ssm.out_norm", "ssm.out_proj"):
        return cfg.ssm_d_inner
    if leaf.startswith("rec."):
        return cfg.lru_width
    if leaf in ("embed", "head"):
        return v_pad * (max(1, cfg.n_codebooks) if leaf == "head" else 1)
    return None


def local_model_cut(name: str, local_shape, cfg, v_pad: int,
                    n_experts: int = 0) -> Cut | None:
    """:func:`model_cut` of a leaf read from one rank's slice of it: the
    cut of the dimension :data:`MODEL_AXIS_DIMS` names when it is shorter
    than the whole (``cfg``; ``v_pad`` the padded vocabulary,
    ``n_experts`` the padded expert count E' of :func:`padded_experts`, 0
    for ``cfg.n_experts``)."""
    ndim = len(local_shape)
    key = _leaf_key(name, ndim)
    dims = MODEL_AXIS_DIMS.get(key, ())
    full = _full_size(name, ndim, cfg, v_pad, n_experts)
    if not dims or full is None:
        return None
    dim = dims[0] % ndim
    if local_shape[dim] == full:
        return None
    if key[0] in SSM_PACKED:
        return Cut(dim, ssm_parts(key[0], cfg))
    return Cut(dim, head_parts(cfg, v_pad) if key[0] == "head" else ((full, True),))


def model_layout(local: dict, cfg, v_pad: int, n_experts: int = 0) -> dict:
    """``{name: Cut or None}`` of a rank's leaves (tensors or shapes)."""
    return {n: local_model_cut(n, tuple(t.shape), cfg, v_pad, n_experts)
            for n, t in local.items()}


def unshard_params(shards: list, cfg, v_pad: int, n_experts: int = 0) -> dict:
    """Inverse of :func:`shard_params`: the model ranks' slices (one dict
    each, in model-axis order; tensors or numpy arrays) -> the whole
    leaves (``n_experts`` as in :func:`local_model_cut`)."""
    out = {}
    for n, t in shards[0].items():
        cut = local_model_cut(n, tuple(t.shape), cfg, v_pad, n_experts)
        out[n] = t if cut is None else cut.join([s[n] for s in shards])
    return out


# The refusals of tensor parallelism, each naming the slice that lifts it.
TP_KINDS = ("attn", "swa", "latt", "moe", "ssm", "rec", "xattn")
LATER_SLICE_TP_KINDS = (
    "tensor parallelism (model degree {tp}) has a model-axis layout for the block "
    "kinds {ok}; {bad} has none: a new kind runs under the model axis from the slice "
    "that gives it one. Use --data-model D 1 for this architecture")
NEXT_SLICE = ("the next tensor-parallel slice, which brings adafactor, int8_ef and a "
              "context degree under the model axis")
LATER_SLICE_TP_CONTEXT = (
    "a model (tensor-parallel) degree above 1 together with a context degree above 1 "
    f"arrives with {NEXT_SLICE} (the ring inside tensor-parallel attention); use "
    "--data-model D M with --mesh-context 1, or --data-model D 1 with --mesh-context C")
LATER_SLICE_TP_OPTIMIZER = (
    "optimizer={opt!r} under tensor parallelism (model degree {tp}) arrives with "
    f"{NEXT_SLICE}: its factored moments average over dimensions the model axis "
    "splits. Use optimizer='adamw'")
LATER_SLICE_TP_GRAD_COMPRESS = (
    "grad_compress={gc!r} under tensor parallelism (model degree {tp}) arrives with "
    f"{NEXT_SLICE}: its one int8 scale a tensor is the max over the whole leaf, "
    "which the model ranks each hold a slice of. Use grad_compress='none'")


def validate_tensor_parallel(cfg, rcfg, tp: int) -> None:
    """Config-time refusals of a model degree ``tp`` above 1 (the texts
    above). Every block kind runs: the dense kinds, ``moe`` (experts over
    the model axis), ``ssm`` (Mamba-2 heads over it), ``rec`` / ``latt``
    (the RG-LRU width; latt's K/V head whole) and ``xattn`` (the
    cross-attention heads; the image rows whole on every rank), on the
    residual or the reversible structure; a compressed row-parallel site
    (``ffn.down``) compresses its split input through K1's split route
    (``core/pamm.py``); an embed-input, multi-codebook arch (musicgen)
    holds its share of every codebook (:func:`head_parts`)."""
    if tp <= 1:
        return
    kinds = sorted({k for unit, _ in cfg.stages for k in unit})
    bad = [k for k in kinds if k not in TP_KINDS]
    if bad:
        raise NotImplementedError(LATER_SLICE_TP_KINDS.format(tp=tp, ok=TP_KINDS, bad=bad))
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
    splits (a dimension it cannot divide stays whole: :func:`model_cut`):
    the q heads (``heads``; wq / bq columns, wo rows), the K/V heads
    (``kv``; else every rank holds them all and takes its q heads' group),
    the FFN width (``ffn``), the (padded) vocabulary (``vocab``; each
    codebook's of a multi-codebook head, :func:`head_parts`), a MoE
    block's E' experts (``experts``: rank ``index`` holds experts
    [index E'/tp, (index + 1) E'/tp)), its shared experts' FFN width
    (``shared``, ``moe_d_ff * n_shared_experts``), an ssm block's heads
    (``ssm``: :func:`ssm_splits`) and a rec block's RG-LRU width
    (``lru``)."""

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
    ssm: bool = False
    lru: bool = False


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
    split = lambda leaf, *shape: model_cut(leaf, shape, tp, dh) is not None
    heads = bool(cfg.n_heads) and split("wq", 1, d, cfg.n_heads * dh)
    ep = padded_experts(cfg, rcfg)
    return ModelGroup(mesh.group(MODEL_AXIS), tp, mesh.coord(MODEL_AXIS), mesh.comm,
                      seq_shard=bool(getattr(rcfg, "seq_shard", False)), heads=heads,
                      kv=heads and split("wk", 1, d, cfg.n_kv_heads * dh),
                      ffn=split("w_gate", 1, d, cfg.d_ff), vocab=split("head", d, v_pad),
                      experts=bool(ep) and split("w_gate", 1, ep, d, cfg.moe_d_ff),
                      shared=bool(cfg.n_shared_experts) and split(
                          "w_gate", 1, d, cfg.moe_d_ff * cfg.n_shared_experts),
                      ssm=bool(cfg.ssm_state) and ssm_splits(cfg, tp),
                      lru=bool(cfg.lru_width) and split("rec.w_x", 1, d, cfg.lru_width))


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
