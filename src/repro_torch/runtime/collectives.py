"""Collectives of the mesh executor over a ``torch.distributed`` group:
the mean all-reduce over the sync group, the all-gather of ZeRO-1 slices,
the ring's send-to-next / receive-from-previous, and the four autograd
mappings of tensor parallelism over the model group (Megatron's ``f`` /
``g`` and their sequence-parallel forms): :func:`copy_to_model`,
:func:`reduce_from_model`, :func:`gather_seq` and :func:`scatter_seq`;
and three more the ssm and rec blocks need: :func:`model_sum` (a sum
over the group both ways), :func:`copy_cols_to_model` (a leaf whose given
columns are whole on every rank) and :func:`gather_width` (the RG-LRU's
width all-gather, reduce-scattered back).

The ranks of one card talk over gloo (NCCL refuses two ranks on one
device). gloo takes CUDA tensors for all_reduce and all_gather and stages
them through host memory itself; a send or recv of a CUDA tensor ends the
process ("writev: Bad address"; ``tools/gloo_probe.py`` found both on an
H100, see ``PERF.md``), so the ring's send / recv go through pinned host
buffers here: copied out, sent, received, copied back. That staging is
this module's transport, not a fallback. :class:`Transport` counts, per
operation, the bytes that cross between the card and the host -- gloo's
own copies for all_reduce / all_gather, this module's for send_recv --
and the mesh executor prints them. Tensors travel packed: one flat buffer
per dtype, cut into buckets of at most ``BUCKET_BYTES``, so a
1.8B-parameter gradient needs buffers of a bucket's size, not of its own.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.runtime.sharding import shard_slice

BUCKET_BYTES = 1 << 28               # 256 MiB a bucket


class Transport:
    """Moves this rank's tensors between ranks. ``host_bytes[op]``: bytes
    of CUDA tensors copied between the card and host memory (each copy
    out and each copy back counted); ``calls[op]``: collective calls
    issued."""

    def __init__(self):
        self.host_bytes: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self._pinned: dict = {}

    def reset(self) -> None:
        self.host_bytes.clear()
        self.calls.clear()

    def stats(self) -> dict:
        return {"host_bytes": dict(self.host_bytes), "calls": dict(self.calls)}

    def _host(self, numel: int, dtype, slot: int) -> torch.Tensor:
        """A pinned host buffer of at least ``numel`` elements (reused)."""
        key = (dtype, slot)
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, pin_memory=torch.cuda.is_available())
            self._pinned[key] = buf
        return buf[:numel]

    def _count(self, op: str, t: torch.Tensor, copies: int) -> None:
        if t.device.type == "cuda":
            self.host_bytes[op] += copies * t.numel() * t.element_size()

    # ------------------------------------------------------------------
    def all_reduce_(self, flat: torch.Tensor, group, op: str = "all_reduce",
                    reduce=dist.ReduceOp.SUM) -> None:
        """Sum (or ``reduce``) ``flat`` (1-D, contiguous) over ``group`` in
        place (gloo copies a CUDA tensor out to host and the result back);
        ``op`` names the counters it lands in."""
        self.calls[op] += 1
        self._count(op, flat, 2)
        dist.all_reduce(flat, op=reduce, group=group)

    def all_gather(self, flat: torch.Tensor, group, n: int,
                   op: str = "all_gather") -> torch.Tensor:
        """The ``n`` ranks' ``flat`` (1-D, equal sizes), stacked (n, numel)
        (gloo copies a CUDA tensor out and the ``n`` parts back)."""
        self.calls[op] += 1
        self._count(op, flat, 1 + n)
        out = torch.empty((n, flat.numel()), dtype=flat.dtype, device=flat.device)
        dist.all_gather(list(out.unbind(0)), flat, group=group)
        return out

    def reduce_scatter(self, parts: torch.Tensor, group,
                       op: str = "reduce_scatter") -> torch.Tensor:
        """``parts`` (n, numel), contiguous: the sum over the ``n`` ranks of
        ``group`` of row ``i``, on group rank ``i`` (gloo copies the n rows
        of a CUDA tensor out and this rank's sum back)."""
        self.calls[op] += 1
        self._count(op, parts, 1)
        self._count(op, parts[0], 1)
        out = torch.empty(parts.shape[1:], dtype=parts.dtype, device=parts.device)
        _reduce_scatter(out, parts.reshape(-1), group=group)
        return out

    def shift(self, flat: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
        """Send ``flat`` (1-D uint8) to group rank ``dst`` and receive the
        same number of bytes from group rank ``src``: both posted before
        either is waited on, so a ring of ranks cannot deadlock. A CUDA
        tensor goes out and comes back through pinned host buffers."""
        self.calls["send_recv"] += 1
        dst_g = dist.get_global_rank(group, dst)
        src_g = dist.get_global_rank(group, src)
        if flat.device.type != "cuda":
            send, recv = flat, torch.empty_like(flat)
        else:
            send = self._host(flat.numel(), flat.dtype, slot=1)
            send.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
            recv = self._host(flat.numel(), flat.dtype, slot=2)
            self._count("send_recv", flat, 2)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst_g, group),
                                       dist.P2POp(dist.irecv, recv, src_g, group)])
        for r in reqs:
            r.wait()
        if flat.device.type != "cuda":
            return recv
        # a blocking copy: the buffer is free again when it returns
        return torch.empty_like(flat).copy_(recv)


# torch 2.13 renames reduce_scatter_tensor (same arguments)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ---------------------------------------------------------------------------
# tensor parallelism: the autograd mappings over the model group
# ---------------------------------------------------------------------------
def _model_all_reduce(t: torch.Tensor, mg) -> torch.Tensor:
    """The sum of ``t`` over the model group, in a new tensor."""
    flat = t.contiguous().reshape(-1).clone()
    mg.comm.all_reduce_(flat, mg.group, op="model_all_reduce")
    return flat.view(t.shape)


# the counter a compressed row-parallel site's sums land in: K1's split
# route's (b, k + 1) buffers and CompAct's sketches
ROW_SITE_OP = "row_site_all_reduce"


def model_sum_(t: torch.Tensor, mg, op: str = ROW_SITE_OP) -> torch.Tensor:
    """``t`` (contiguous) replaced in place by its sum over the model
    group; ``op`` names the transport's counters."""
    mg.comm.all_reduce_(t.view(-1), mg.group, op=op)
    return t


def model_max_(t: torch.Tensor, mg) -> torch.Tensor:
    """``t`` (contiguous) replaced in place by its elementwise max over the
    model group."""
    mg.comm.all_reduce_(t.view(-1), mg.group, op="model_all_reduce",
                        reduce=dist.ReduceOp.MAX)
    return t


def _model_parts(t: torch.Tensor, mg, op: str = "model_all_gather") -> list:
    """Every model rank's ``t`` (same shape on each), in model-axis order;
    ``op`` names the transport's counters."""
    got = mg.comm.all_gather(t.contiguous().reshape(-1), mg.group, mg.tp, op=op)
    return list(got.view(mg.tp, *t.shape).unbind(0))


def _seq_gather(t: torch.Tensor, mg, dim: int = 1,
                op: str = "model_all_gather") -> torch.Tensor:
    """(B, L/tp, ...) on each rank -> (B, L, ...), the ranks' parts in
    model-axis order along ``dim`` (the sequence; the last dimension for
    :func:`gather_width`)."""
    return torch.cat(_model_parts(t, mg, op), dim=dim)


def _seq_chunks(t: torch.Tensor, tp: int, dim: int = 1) -> torch.Tensor:
    """(B, L, ...) -> (tp, B, L/tp, ...) contiguous: chunk i of ``dim``
    first."""
    if t.shape[dim] % tp:
        raise ValueError(f"size {t.shape[dim]} of dimension {dim} (the sequence under "
                         f"seq_shard) does not split over the model axis of degree {tp}")
    return torch.stack(t.chunk(tp, dim=dim)).contiguous()


def _seq_reduce_scatter(t: torch.Tensor, mg, dim: int = 1,
                        op: str = "model_reduce_scatter") -> torch.Tensor:
    """(B, L, ...) partial sums -> this rank's (B, L/tp, ...) chunk of
    ``dim`` of the sum over the model group."""
    parts = _seq_chunks(t, mg.tp, dim)
    return mg.comm.reduce_scatter(parts.reshape(mg.tp, -1), mg.group,
                                  op=op).view(parts.shape[1:])


def _seq_own(t: torch.Tensor, mg) -> torch.Tensor:
    """(B, L, ...) -> this rank's (B, L/tp, ...) chunk (a copy)."""
    return _seq_chunks(t, mg.tp)[mg.index]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model group
    (the input of a column-parallel product, whose ranks each see part of
    its gradient)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (a row-parallel product's partial
    outputs); identity backward."""

    @staticmethod
    def forward(ctx, x, mg):
        return _model_all_reduce(x, mg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather over the sequence forward. Backward: reduce-scatter when
    the ranks' gradients are partial (a sharded sublayer follows),
    else this rank's chunk of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, mg, partial):
        ctx.mg, ctx.partial = mg, partial
        return _seq_gather(x, mg)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _seq_reduce_scatter(g, ctx.mg), None, None
        return _seq_own(g, ctx.mg), None, None


class _ScatterSeq(torch.autograd.Function):
    """Forward: reduce-scatter over the sequence when the ranks hold
    partial sums (a row-parallel product), else this rank's chunk of the
    (identical) tensor. Backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mg, partial):
        ctx.mg = mg
        return _seq_reduce_scatter(x, mg) if partial else _seq_own(x, mg)

    @staticmethod
    def backward(ctx, g):
        return _seq_gather(g, ctx.mg), None, None


class _CopyColsToModel(torch.autograd.Function):
    """Identity forward; backward sums columns [start, stop) of the
    gradient's last dimension over the model group (a leaf of which only
    those columns are whole on every rank, each rank's part of their
    gradient from its own heads)."""

    @staticmethod
    def forward(ctx, w, mg, start, stop):
        ctx.mg, ctx.cols = mg, (start, stop)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.cols
        g = g.clone()
        g[..., start:stop] = _model_all_reduce(g[..., start:stop], ctx.mg)
        return g, None, None, None


class _GatherWidth(torch.autograd.Function):
    """All-gather over the last dimension forward, in the input's dtype,
    the result cast to ``dtype``; backward reduce-scatters the gradient in
    ``dtype`` (each rank's part of it is partial), this rank's columns
    cast back."""

    @staticmethod
    def forward(ctx, x, mg, dtype):
        ctx.mg, ctx.dtype = mg, x.dtype
        return _seq_gather(x, mg, dim=-1, op="width_all_gather").to(dtype)

    @staticmethod
    def backward(ctx, g):
        mine = _seq_reduce_scatter(g, ctx.mg, dim=-1, op="width_reduce_scatter")
        return mine.to(ctx.dtype), None, None


def copy_to_model(x: torch.Tensor, mg) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce backward."""
    return _CopyToModel.apply(x, mg)


def copy_cols_to_model(w: torch.Tensor, mg, start: int, stop: int) -> torch.Tensor:
    """:func:`copy_to_model` for columns [start, stop) of ``w``'s last
    dimension only: identity forward; backward sums those columns'
    gradient over the model group and keeps the others' as they are."""
    return _CopyColsToModel.apply(w, mg, start, stop)


def model_sum(x: torch.Tensor, mg) -> torch.Tensor:
    """The sum of ``x`` over the model group, whose gradient is summed
    over it too (every rank's output reads the sum): all-reduce forward
    and backward, Megatron's ``g`` after its ``f``."""
    return reduce_from_model(copy_to_model(x, mg), mg)


def gather_width(x: torch.Tensor, mg, dtype=torch.float32) -> torch.Tensor:
    """The ranks' (..., w/tp) column slices -> the whole (..., w) in
    ``dtype``: all-gathered in ``x``'s dtype, the gradient reduce-scattered
    in ``dtype`` (the transport's ``width_all_gather`` /
    ``width_reduce_scatter`` counters)."""
    return _GatherWidth.apply(x, mg, dtype)


def reduce_from_model(x: torch.Tensor, mg) -> torch.Tensor:
    """Megatron's ``g``: all-reduce forward, identity backward."""
    return _ReduceFromModel.apply(x, mg)


def gather_seq(x: torch.Tensor, mg, partial: bool = True) -> torch.Tensor:
    """Sequence parallelism's ``f``: all-gather forward, reduce-scatter
    backward (``partial=False``: the chunk of the gradient backward)."""
    return _GatherSeq.apply(x, mg, partial)


def scatter_seq(x: torch.Tensor, mg, partial: bool = True) -> torch.Tensor:
    """Sequence parallelism's ``g``: reduce-scatter forward (``partial=False``:
    this rank's chunk), all-gather backward."""
    return _ScatterSeq.apply(x, mg, partial)


def tp_enter(x: torch.Tensor, mg, sharded: bool) -> torch.Tensor:
    """The input of a sublayer under tensor parallelism (``mg`` None: x
    itself): whole and replicated on every model rank. A sublayer the
    model axis splits (``sharded``) sees part of its gradient on each
    rank, which backward sums; under ``seq_shard`` the residual stream's
    chunks are gathered first."""
    if mg is None:
        return x
    if mg.seq_shard:
        return gather_seq(x, mg, partial=sharded)
    return copy_to_model(x, mg) if sharded else x


def tp_exit(y: torch.Tensor, mg, sharded: bool) -> torch.Tensor:
    """A sublayer's output back onto the residual stream: a split
    sublayer's partial sums summed over the model group (``sharded``), and
    under ``seq_shard`` this rank's chunk of the sequence."""
    if mg is None:
        return y
    if mg.seq_shard:
        return scatter_seq(y, mg, partial=sharded)
    return reduce_from_model(y, mg) if sharded else y


def seq_param(p: torch.Tensor, mg) -> torch.Tensor:
    """A whole parameter applied to the residual stream's chunk of the
    sequence under ``seq_shard`` (the norms): each model rank sees part
    of its gradient, which backward sums (:func:`copy_to_model`)."""
    return copy_to_model(p, mg) if mg is not None and mg.seq_shard else p


def gather_model_(tensors: dict, layout: dict, mg) -> dict:
    """The whole leaves from the model ranks' slices: each tensor whose
    ``layout`` holds a :class:`runtime.sharding.Cut`
    (``runtime.sharding.model_layout``) is all-gathered over the model
    group and joined by it (a collective: every model rank calls it with
    the same names, in the same order); the others are returned as they
    are."""
    out = {}
    for n, t in tensors.items():
        cut = layout.get(n)
        if cut is None or mg is None:
            out[n] = t
            continue
        out[n] = cut.join(_model_parts(t, mg))
    return out


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
def _buckets(tensors: list[torch.Tensor]):
    """Consecutive runs (lists of indices) of same-dtype tensors of at most
    BUCKET_BYTES (a larger tensor is a run of its own)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        if run and (t.dtype != tensors[run[0]].dtype or size + nb > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(i)
        size += nb
    if run:
        yield run


def all_reduce_(tensors: list[torch.Tensor], group, n: int, comm: Transport, *,
                mean: bool) -> None:
    """Sum (``jax.lax.psum``) or mean (``pmean``: the sum, then divided by
    n) of each tensor over the ``n`` ranks of ``group``, in place."""
    if n <= 1:
        return
    for run in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        comm.all_reduce_(flat, group)
        if mean:
            flat.div_(n)
        off = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def gather_shards_(tensors: dict, layout: dict, index: int, dp: int, group,
                   comm: Transport) -> None:
    """ZeRO-1's gather over the ``dp`` data shards of ``group``: this shard
    has written its slice (``runtime.sharding.shard_slice``) of every
    tensor whose ``layout`` names a dimension; fill the other shards'
    slices from theirs, in place, so every shard holds the whole tensors."""
    names = [n for n in tensors if layout.get(n) is not None]
    if dp <= 1 or not names:
        return
    own = [shard_slice(tensors[n], layout[n], index, dp) for n in names]
    for run in _buckets(own):
        got = comm.all_gather(torch.cat([own[i].reshape(-1) for i in run]), group, dp)
        for r in range(dp):
            if r == index:
                continue
            off = 0
            for i in run:
                n, part = names[i], own[i]
                dst = shard_slice(tensors[n], layout[n], r, dp)
                dst.copy_(got[r, off:off + part.numel()].view(part.shape))
                off += part.numel()


def pack_bytes(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes end to end, one uint8 tensor."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def unpack_bytes(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inverse of :func:`pack_bytes`: tensors shaped and typed like ``like``."""
    out, off = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        out.append(flat[off:off + nb].view(t.dtype).view(t.shape))
        off += nb
    return out


def ring_shift(tensors: list[torch.Tensor], ring) -> list[torch.Tensor]:
    """The ring's rotation: send ``tensors`` to the next member (index + 1)
    and return the previous member's, so after ``s`` calls member ``i``
    holds what member ``(i - s) % cp`` started with."""
    flat = pack_bytes(tensors)
    got = ring.comm.shift(flat, ring.group, (ring.index + 1) % ring.cp,
                          (ring.index - 1) % ring.cp)
    return unpack_bytes(got, tensors)
