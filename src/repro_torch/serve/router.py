"""Request router over N decode replicas (``repro/serve/router.py``).

The stage API (engine.prefill -> Prefix -> engine.insert) makes a
ServeEngine's decode loop independent of where its prompts were
prefilled. The Router builds the serving front on that split:

  * N decode replicas, each a full :class:`ServeEngine` with its own
    slots and (paged) page pools -- capacity scales by adding replicas at
    a FIXED per-replica pool budget instead of growing one pool. All of
    them, and the prefill engine, share one ``Model``: one copy of the
    weights on the card.
  * Optionally one dedicated prefill engine. When set, prompts run there
    and the resulting :class:`Prefix` crosses the engine boundary in
    host form -- ``Prefix.to_host()`` is the transfer format; the
    receiving replica moves it back onto its device at insert.
  * Page-aware admission: strict FIFO over the router queue; the head
    request goes to the admissible replica with the lowest load factor
    (``ServeEngine.pool_load`` -- tightest-pool reserved fraction), ties
    to the lowest replica index, so placement is deterministic and
    token streams are reproducible run to run.

Placement never splits a request: a sequence's KV lives entirely on its
replica, so decode needs no cross-replica communication.

``submit(req, replica=i)`` pins a request. A pin that can NEVER fit
(the request needs more pages than the replica's pool holds) is rejected
at submit time, naming the replica, its pool deficit, and the least
loaded replica that could take the request instead. Transient fullness
is not an error -- the request just waits in FIFO order.

One process steps the replicas one after another, each synchronising
with the host once per decode block; ``stats()["decode_tok_s"]`` keeps
the JAX package's definition (summed tokens over the largest replica
decode wall), which assumes the replicas' walls overlap.
"""
from __future__ import annotations

import collections

from repro_torch.serve.engine import Prefix, Request, RequestOutput, ServeEngine


class Router:
    """Front N decode replicas (+ optional dedicated prefill engine)."""

    def __init__(self, replicas: list[ServeEngine], *,
                 prefill_engine: ServeEngine | None = None):
        if not replicas:
            raise ValueError("Router needs at least one decode replica")
        ml = {e.max_len for e in replicas}
        if len(ml) != 1:
            raise ValueError(f"replicas disagree on max_len: {sorted(ml)}")
        if prefill_engine is not None and prefill_engine.max_len not in ml:
            raise ValueError(
                f"prefill engine max_len={prefill_engine.max_len} != "
                f"replica max_len={ml.pop()}")
        self.replicas = replicas
        self.prefill_engine = prefill_engine
        # (request, pinned replica index or None), strict FIFO
        self.queue: collections.deque[tuple[Request, int | None]] = collections.deque()
        self.placement: dict[int, int] = {}   # uid -> replica index
        self.peak_active = 0                  # aggregate across replicas

    # ------------------------------------------------------------------
    def _fits_capacity(self, eng: ServeEngine, req: Request) -> str | None:
        """None if the request can ever fit on ``eng``; else the tightest
        pool's 'label [fmt]: deficit' description."""
        total = len(req.tokens) + req.max_new_tokens
        worst = None
        for alloc, label, fmt in zip(eng.allocators, eng.pool_labels, eng.pool_formats):
            try:
                need = alloc.blocks_for(total)
            except ValueError as e:
                # exceeds the slot table outright -- can never fit
                return f"pool {label} [{fmt}]: {e}"
            short = need - alloc.spec.n_pages
            if short > 0 and (worst is None or short > worst[0]):
                worst = (short, f"pool {label} [{fmt}] is {short} pages "
                                f"short ({alloc.spec.n_pages} total, {need} needed)")
        return None if worst is None else worst[1]

    def _least_loaded(self, exclude: int | None = None) -> int | None:
        """Index of the least-loaded replica, or None when ``exclude``
        leaves no candidates (single-replica router)."""
        loads = [(eng.pool_load(), i)
                 for i, eng in enumerate(self.replicas) if i != exclude]
        return min(loads)[1] if loads else None

    def submit(self, req: Request, *, replica: int | None = None) -> None:
        """Queue a request; ``replica`` pins it to one decode replica.

        Raises immediately when the request can never be served: by any
        replica (unpinned), or by the pinned replica -- naming the pin's
        pool deficit and the least-loaded alternative."""
        if replica is not None:
            if not 0 <= replica < len(self.replicas):
                raise ValueError(
                    f"request {req.uid}: replica={replica} out of range "
                    f"(router has {len(self.replicas)} replicas)")
            eng = self.replicas[replica]
            deficit = self._fits_capacity(eng, req)
            if deficit is None:
                eng._validate_request(req)
            else:
                alt = self._least_loaded(exclude=replica)
                if alt is None:
                    alt_note = "no other replica exists"
                else:
                    alt_fit = self._fits_capacity(self.replicas[alt], req)
                    alt_note = (
                        f"replica {alt} (least loaded, load factor "
                        f"{self.replicas[alt].pool_load():.2f}) could serve it"
                        if alt_fit is None
                        else "no other replica fits it either")
                raise ValueError(
                    f"request {req.uid} pinned to replica {replica} will "
                    f"never fit: {deficit}; {alt_note} — drop the pin or "
                    "raise pool_tokens")
        else:
            err = None
            for eng in self.replicas:
                try:
                    eng._validate_request(req)
                except ValueError as e:
                    err = e
                    continue
                if self._fits_capacity(eng, req) is None:
                    break
            else:
                if err is not None:
                    raise err
                raise ValueError(
                    f"request {req.uid}: no replica's pools can ever hold "
                    f"{len(req.tokens) + req.max_new_tokens} tokens — "
                    "raise pool_tokens or add replicas")
        self.queue.append((req, replica))

    # ------------------------------------------------------------------
    def _prefill(self, req: Request, target: ServeEngine) -> Prefix:
        pf = self.prefill_engine
        if pf is not None and pf is not target:
            # disaggregated hop: prefill elsewhere, hand off in host form
            return pf.prefill(pf.model, req).to_host()
        return target.prefill(target.model, req)

    def _admissions(self) -> list[RequestOutput]:
        """Strict-FIFO head placement: stop at the first head that no
        candidate replica can place right now."""
        finished: list[RequestOutput] = []
        while self.queue:
            req, pin = self.queue[0]
            cands = [pin] if pin is not None else range(len(self.replicas))
            best = None   # (load, replica, slot)
            for i in cands:
                slot = self.replicas[i].try_place(req)
                if slot is None:
                    continue
                key = (self.replicas[i].pool_load(), i)
                if best is None or key < best[:2]:
                    best = (*key, slot)
            if best is None:
                break
            self.queue.popleft()
            _, rep, slot = best
            eng = self.replicas[rep]
            self.placement[req.uid] = rep
            done = eng.admit_prefix(self._prefill(req, eng), slot)
            if done is not None:
                finished.append(done)
        return finished

    def step(self) -> list[RequestOutput]:
        """One router step: place what fits, then advance every replica
        one decode block, one replica after another."""
        finished = self._admissions()
        # peak reads here: slots are armed by the admissions above and
        # released inside the replica steps below, so sampling after the
        # steps would miss requests that finish within one decode block
        self.peak_active = max(self.peak_active,
                               sum(int(eng.active.sum()) for eng in self.replicas))
        for eng in self.replicas:
            finished.extend(eng.step())
        return finished

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(e.has_work for e in self.replicas)

    def run(self, requests) -> dict[int, RequestOutput]:
        for r in requests:
            self.submit(r)
        done: dict[int, RequestOutput] = {}
        while self.has_work:
            for out in self.step():
                done[out.uid] = out
        return done

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate + per-replica stats. Aggregate rates sum tokens and
        take the max of wall times (the JAX package's definition: it
        counts the replicas' walls as overlapping, though this process
        steps them one after another)."""
        per = [eng.stats() for eng in self.replicas]
        if self.prefill_engine is not None:
            pf = self.prefill_engine.stats()
            pf_tokens, pf_time = pf["prefill_tokens"], pf["prefill_s"]
        else:
            pf_tokens = sum(s["prefill_tokens"] for s in per)
            pf_time = sum(s["prefill_s"] for s in per)
        dec_tokens = sum(s["decode_tokens"] for s in per)
        dec_time = max((s["decode_s"] for s in per), default=0.0)
        return {
            "replicas": len(self.replicas),
            "dedicated_prefill": self.prefill_engine is not None,
            "peak_active_aggregate": self.peak_active,
            "prefill_tokens": pf_tokens,
            "prefill_s": pf_time,
            "prefill_tok_s": pf_tokens / pf_time if pf_time else 0.0,
            "decode_tokens": dec_tokens,
            "decode_s": dec_time,
            "decode_tok_s": dec_tokens / dec_time if dec_time else 0.0,
            "insert_count": sum(s["insert_count"] for s in per),
            "insert_s": sum(s["insert_s"] for s in per),
            "peak_kv_reserved_bytes": sum(s["peak_kv_reserved_bytes"] for s in per),
            "per_replica": per,
        }
