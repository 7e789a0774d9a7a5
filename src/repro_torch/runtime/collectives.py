"""Collectives of the mesh executor over a ``torch.distributed`` group:
the mean all-reduce over the sync group, the all-gather of ZeRO-1 slices
and the ring's send-to-next / receive-from-previous.

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
    def all_reduce_(self, flat: torch.Tensor, group) -> None:
        """Sum ``flat`` (1-D, contiguous) over ``group`` in place (gloo
        copies a CUDA tensor out to host and the sum back)."""
        self.calls["all_reduce"] += 1
        self._count("all_reduce", flat, 2)
        dist.all_reduce(flat, group=group)

    def all_gather(self, flat: torch.Tensor, group, n: int) -> torch.Tensor:
        """The ``n`` ranks' ``flat`` (1-D, equal sizes), stacked (n, numel)
        (gloo copies a CUDA tensor out and the ``n`` parts back)."""
        self.calls["all_gather"] += 1
        self._count("all_gather", flat, 1 + n)
        out = torch.empty((n, flat.numel()), dtype=flat.dtype, device=flat.device)
        dist.all_gather(list(out.unbind(0)), flat, group=group)
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
