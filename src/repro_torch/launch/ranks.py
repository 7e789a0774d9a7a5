"""Local ranks: ``world`` processes on this host, each one rank of a gloo
process group, each running one function and handing back what it
returns.

The JAX package runs one process over N devices; the port runs one
process per mesh coordinate, and this module starts them. Processes are
``spawn``-ed (the parent's threads make ``fork`` unsafe), so the function
and its arguments travel pickled: the function must live in a module the
child can import. Each child runs one intra-op thread, joins the group at
``tcp://127.0.0.1:<free port>`` (gloo: several ranks may share one card,
which NCCL refuses) with ``timeout`` seconds for every collective, calls
``fn(rank, world, *args)`` and puts the result, pickled, on a queue.

Nothing is swallowed: a rank that raises (a collective that outlives
``timeout`` raises in its rank) sends its traceback, and the parent stops
every rank and raises it; a rank that dies, or a group that is not done
by its deadline, stops every rank and raises too.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, timeout: float, inbox, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        fn, args = pickle.loads(inbox.get(timeout=timeout))
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # plain pickle: a tensor travels as its bytes, not as a shared-memory
    # handle that dies with this process
    results.put((rank, True, pickle.dumps(out)))


class Ranks:
    """Started ranks; :meth:`results` waits for them."""

    def __init__(self, world: int, fn, args, timeout: float, deadline: float | None):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.deadline = timeout if deadline is None else deadline
        self._queue, self._inbox = ctx.Queue(), ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, port, timeout, self._inbox, self._queue))
                       for r in range(world)]
        self._start = time.monotonic()
        for p in self._procs:
            p.start()
        # the work goes through a queue, not the processes' arguments: a
        # start() whose pickled arguments outgrow the pipe would wait for
        # that child to import them, and the ranks would start one by one
        payload = pickle.dumps((fn, args))
        for _ in range(world):
            self._inbox.put(payload)

    def _stop(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)

    def _more_failures(self, grace: float = 2.0) -> list:
        """The other ranks' failures that arrive within ``grace`` seconds of
        the first: a rank that raises closes its connections, so its peers
        fail too, and the first report need not be the cause."""
        found, end = [], time.monotonic() + grace
        while time.monotonic() < end:
            try:
                rank, ok, val = self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                if all(p.exitcode is not None for p in self._procs):
                    break
                continue
            if not ok:
                found.append((rank, val))
        return found

    def results(self) -> list:
        """Every rank's return value, in rank order; raises RuntimeError
        (with the tracebacks of the ranks that failed) if one fails, dies or
        outlives the deadline, after stopping all of them."""
        out: dict = {}
        try:
            while len(out) < self.world:
                left = self._start + self.deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"ranks {sorted(set(range(self.world)) - set(out))} "
                                       f"of {self.world} not done within {self.deadline:.0f} s")
                try:
                    rank, ok, val = self._queue.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead and self._queue.empty():
                        raise RuntimeError(f"rank {dead[0]} of {self.world} exited with "
                                           f"code {self._procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError("\n".join(
                        f"rank {r} of {self.world} failed:\n{tb}"
                        for r, tb in [(rank, val)] + self._more_failures()))
                out[rank] = pickle.loads(val)
        finally:
            if len(out) < self.world:
                self._stop()
        for p in self._procs:
            p.join(30)
        self._stop()
        return [out[r] for r in range(self.world)]


def spawn_ranks(world: int, fn, *args, timeout: float = 600.0,
                deadline: float | None = None) -> Ranks:
    """Start ``world`` ranks running ``fn(rank, world, *args)``; returns at
    once (the caller may work while they run). ``timeout``: seconds for
    each collective; ``deadline``: seconds for the whole run (``timeout``
    when None; ``math.inf`` for a training run of any length, which a hung
    collective still ends after ``timeout``)."""
    return Ranks(world, fn, args, timeout, deadline)


def run_ranks(world: int, fn, *args, timeout: float = 600.0,
              deadline: float | None = None) -> list:
    """:func:`spawn_ranks`, then wait: every rank's return value."""
    return spawn_ranks(world, fn, *args, timeout=timeout, deadline=deadline).results()
