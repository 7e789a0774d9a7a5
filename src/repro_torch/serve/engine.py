"""Continuous-batching serving engine, dense cache layout
(``repro/serve/engine.py``).

Three explicit stages, as in the JAX engine --

  prefill(model, request)              -> Prefix
  insert(prefix, decode_state, slot)   -> DecodeState
  generate(model, decode_state)        -> (DecodeState, GenerateOutput)

-- with the ``submit``/``step``/``run`` continuous-batching loop as a thin
orchestrator on top. A request is prefilled alone (batch 1, prompt padded
to a power-of-two bucket; attention through K3), its cache spliced into a
free slot of the engine's dense cache, and then decoded with every other
active slot, ``decode_block`` tokens per ``generate`` call (attention
through K6). Where the JAX engine runs the block as one jitted
``lax.scan``, the port runs a Python loop over the steps that keeps the
token, position, activity, budget and sample-index vectors on the device
and synchronises with the host once per block, not once per token.

Per-sequence math is row-independent, so a request's tokens do not depend
on which other requests share the batch. On the card this holds for a
fixed slot count: the matrix products see the same shapes either way.

Later slices: paged pools, prefix sharing, speculative verify, mesh
sharding and the multi-replica router raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import stats as stats_lib
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.blocks import LATER_SLICE_KINDS, SERVED_KINDS
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.sampling import SamplingParams, sample_tokens

PAD_TOKEN = -1
LATER_SLICE_SERVING = ("{what} arrives with the port's paged-serving slice "
                       "(kernels K7, K8); this slice serves the dense layout")
LATER_SLICE_MULTI = ("{what} arrives with the port's multi-GPU slice; this "
                     "slice serves one engine on one device")


def _percentile(sorted_samples, p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list (index
    ``ceil(p * n) - 1``)."""
    n = len(sorted_samples)
    if n == 0:
        return 0.0
    rank = max(1, math.ceil(p * n))
    return sorted_samples[min(n - 1, rank - 1)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Request:
    """One generation request. ``eos_id`` < 0 disables the eos stop."""

    uid: int
    tokens: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: int = -1


@dataclasses.dataclass
class RequestOutput:
    uid: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str          # "eos" | "length"
    prefill_s: float
    decode_s: float             # wall time of the decode blocks it was active in

    @property
    def decode_tok_s(self) -> float:
        """Decode-loop rate (the first token comes from prefill)."""
        n = len(self.tokens) - 1
        return n / self.decode_s if self.decode_s > 0 and n > 0 else 0.0


@dataclasses.dataclass
class Prefix:
    """The transferable product of prefill: the batch-1 cache tree, the
    first sampled token and the request. Single-use: ``insert`` marks it
    consumed. :meth:`to_host` moves the cache tensors to the CPU."""

    uid: int
    request: Request
    prompt_len: int
    first_token: int
    caches: Any
    prefill_s: float
    consumed: bool = False
    inserted_slot: int | None = None

    def to_host(self) -> "Prefix":
        for node in cache_lib.kv_cache_nodes(self.caches):
            node.k, node.v, node.slot_pos = (t.cpu() for t in node.tensors())
        return self


@dataclasses.dataclass
class DecodeState:
    """Per-slot decode state: the batched cache tree plus the host-side
    slot vectors. ``insert`` writes one slot; ``generate`` advances every
    active slot one decode block."""

    caches: Any
    slot_uid: np.ndarray      # (B,) int64 request uid; -1 = free
    tok: np.ndarray           # (B,) int32 last sampled token
    pos: np.ndarray           # (B,) int32 next decode position; -1 parked
    remaining: np.ndarray     # (B,) int32 generation budget left
    gen_idx: np.ndarray       # (B,) int32 per-request sample index
    active: np.ndarray        # (B,) bool
    seeds: np.ndarray         # (B,) int32 sampling
    temps: np.ndarray         # (B,) float32
    topks: np.ndarray         # (B,) int32
    eos_ids: np.ndarray       # (B,) int32; -1 = no eos stop

    @classmethod
    def init(cls, caches, B: int) -> "DecodeState":
        return cls(
            caches=caches,
            slot_uid=np.full((B,), -1, np.int64),
            tok=np.zeros((B,), np.int32),
            pos=np.full((B,), -1, np.int32),
            remaining=np.zeros((B,), np.int32),
            gen_idx=np.zeros((B,), np.int32),
            active=np.zeros((B,), bool),
            seeds=np.zeros((B,), np.int32),
            temps=np.zeros((B,), np.float32),
            topks=np.zeros((B,), np.int32),
            eos_ids=np.full((B,), -1, np.int32),
        )

    def slot_state(self, slot: int) -> str:
        uid = int(self.slot_uid[slot])
        if uid >= 0:
            return (f"active (serving request uid={uid}, pos={int(self.pos[slot])}, "
                    f"{int(self.remaining[slot])} tokens remaining)")
        return "free (released; position parked at -1)"


@dataclasses.dataclass
class GenerateOutput:
    """Raw product of one decode block, host-side."""

    emitted: np.ndarray       # (steps, B) int32; PAD_TOKEN where inactive
    was_active: np.ndarray    # (steps, B) bool
    steps: int
    seconds: float


def _state_prop(name: str):
    return property(lambda self: getattr(self.decode_state, name),
                    lambda self, v: setattr(self.decode_state, name, v))


class ServeEngine:
    """Continuous-batching engine over a dense slot cache. See the module
    docstring for the design."""

    def __init__(self, cfg, rcfg, model, *, max_slots: int, max_len: int,
                 decode_block: int = 8, plan=None, mesh=None,
                 cache_layout: str | None = None, pool_tokens: int | None = None,
                 cache_compress: str | None = None,
                 prefix_share: bool = False, speculative_k: int = 0):
        if cfg.embed_inputs or cfg.n_codebooks:
            raise NotImplementedError(
                "serving needs a token frontend; embed-input / multi-codebook "
                "archs (musicgen) are train/score only")
        kinds = {k for unit, _ in cfg.stages for k in unit}
        if not kinds <= set(SERVED_KINDS):
            raise NotImplementedError(f"{cfg.name}: {LATER_SLICE_KINDS}")
        layout = cache_layout or rcfg.cache_layout
        compress = rcfg.cache_compress if cache_compress is None else cache_compress
        for cond, what in ((layout != "dense", f"cache_layout={layout!r}"),
                           (pool_tokens is not None, "pool_tokens"),
                           (bool(compress), "cache_compress"),
                           (prefix_share, "prefix_share"),
                           (speculative_k, "speculative_k")):
            if cond:
                raise NotImplementedError(LATER_SLICE_SERVING.format(what=what))
        if mesh is not None:
            raise NotImplementedError(LATER_SLICE_MULTI.format(what="mesh sharding"))
        # a plan routes prefill through site dispatch; outputs stay exact
        self.plan = plan if plan is not None else (rcfg.compression or None)
        self.cfg, self.rcfg, self.model = cfg, rcfg, model
        self.device = model.device
        self.max_slots, self.max_len = max_slots, max_len
        self.decode_block = decode_block
        self.decode_state = DecodeState.init(
            init_caches(cfg, rcfg, max_slots, max_len, self.device), max_slots)
        self._kv_capacity_bytes = sum(
            node.k.shape[1] * node.k.shape[2] * cache_lib.kv_token_bytes(node)
            for node in cache_lib.kv_cache_nodes(self.caches))
        self.bucket_lens: set[int] = set()

        self.queue: collections.deque[Request] = collections.deque()
        self._outputs: dict[int, list[int]] = {}
        self._decode_acc: dict[int, float] = {}
        self._prefill_s: dict[int, float] = {}
        self._requests: dict[int, Request] = {}
        self.reset_stats()

    caches = _state_prop("caches")
    slot_uid = _state_prop("slot_uid")
    tok = _state_prop("tok")
    pos = _state_prop("pos")
    remaining = _state_prop("remaining")
    gen_idx = _state_prop("gen_idx")
    active = _state_prop("active")
    seeds = _state_prop("seeds")
    temps = _state_prop("temps")
    topks = _state_prop("topks")
    eos_ids = _state_prop("eos_ids")

    # ------------------------------------------------------------------
    # stage API: prefill -> Prefix -> insert -> DecodeState -> generate
    # ------------------------------------------------------------------
    def prefill(self, model, request: Request) -> Prefix:
        """Run the prompt alone (batch 1) and package the result as a
        :class:`Prefix`; the first token is sampled from the prefill
        logits."""
        lp = len(request.tokens)
        lb = self._bucket_len(lp)
        toks = np.zeros((1, lb), np.int64)
        toks[0, :lp] = np.asarray(request.tokens, np.int64)
        t0 = time.perf_counter()
        logits, pcaches = prefill(self.cfg, self.rcfg, model,
                                  {"tokens": torch.as_tensor(toks, device=self.device)},
                                  self.max_len, plan=self.plan, prompt_len=[lp])
        self.bucket_lens.add(lb)
        logits1 = logits[:, -1, : self.cfg.vocab_size]
        sp = request.sampling
        as_dev = lambda x, dt: torch.tensor([x], dtype=dt, device=self.device)
        tok0 = sample_tokens(logits1, as_dev(sp.seed, torch.int64),
                             as_dev(0, torch.int64), as_dev(sp.temperature, torch.float32),
                             as_dev(sp.top_k, torch.int64),
                             any_sampling=sp.temperature > 0)
        self.nonfinite_logits += int((~torch.isfinite(logits1)).any())
        tok0 = int(tok0[0])
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.prefill_tokens += lp
        self.prefill_time += dt
        self.prefill_count += 1
        return Prefix(uid=request.uid, request=request, prompt_len=lp,
                      first_token=tok0, caches=pcaches, prefill_s=dt)

    def insert(self, prefix: Prefix, decode_state: DecodeState,
               slot: int) -> DecodeState:
        """Splice a Prefix into decode slot ``slot`` (in place) and arm the
        slot's sampling/stop vectors. Raises on a consumed Prefix or an
        occupied slot."""
        if prefix.consumed:
            raise ValueError(
                f"stale Prefix (uid={prefix.uid}): already inserted into slot "
                f"{prefix.inserted_slot}, which is now "
                f"{decode_state.slot_state(prefix.inserted_slot)}. A Prefix is "
                "single-use -- re-run prefill to admit the request again")
        if decode_state.active[slot] or decode_state.slot_uid[slot] >= 0:
            raise ValueError(
                f"cannot insert Prefix (uid={prefix.uid}) into slot {slot}: slot "
                f"is {decode_state.slot_state(slot)}")
        req = prefix.request
        lp = prefix.prompt_len
        t0 = time.perf_counter()
        cache_lib.write_slot(decode_state.caches,
                             cache_lib.mask_pad_rows(prefix.caches, lp), slot)
        _sync(self.device)
        self.insert_count += 1
        self.insert_time += time.perf_counter() - t0

        decode_state.slot_uid[slot] = req.uid
        decode_state.tok[slot] = prefix.first_token
        decode_state.pos[slot] = lp
        decode_state.remaining[slot] = req.max_new_tokens - 1
        decode_state.gen_idx[slot] = 1
        decode_state.seeds[slot] = req.sampling.seed
        decode_state.temps[slot] = req.sampling.temperature
        decode_state.topks[slot] = req.sampling.top_k
        decode_state.eos_ids[slot] = req.eos_id
        eos_hit = req.eos_id >= 0 and prefix.first_token == req.eos_id
        decode_state.active[slot] = (decode_state.remaining[slot] > 0 and not eos_hit
                                     and decode_state.pos[slot] < self.max_len - 1)
        prefix.consumed = True
        prefix.inserted_slot = slot
        return decode_state

    def generate(self, model, decode_state: DecodeState, *,
                 steps: int | None = None) -> tuple[DecodeState, GenerateOutput]:
        """One decode block over every active slot: ``steps`` tokens
        (default ``decode_block``, capped at the longest remaining
        generation). The slot vectors stay on the device for the block;
        the host reads them back once at its end."""
        ds = decode_state
        B = ds.active.shape[0]
        if not ds.active.any():
            return ds, GenerateOutput(emitted=np.full((0, B), PAD_TOKEN, np.int32),
                                      was_active=np.zeros((0, B), bool),
                                      steps=0, seconds=0.0)
        steps = min(steps or self.decode_block, int(ds.remaining[ds.active].max()))
        steps = max(1, steps)
        dev = self.device
        on = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)
        tok = on(ds.tok, torch.int64)
        pos = on(ds.pos, torch.int32)
        active = on(ds.active, torch.bool)
        remaining = on(ds.remaining, torch.int32)
        gen_idx = on(ds.gen_idx, torch.int64)
        seeds, topks = on(ds.seeds, torch.int64), on(ds.topks, torch.int64)
        temps, eos_ids = on(ds.temps, torch.float32), on(ds.eos_ids, torch.int64)
        any_sampling = bool((ds.temps[ds.active] > 0).any())
        vocab, limit = self.cfg.vocab_size, self.max_len - 1

        t0 = time.perf_counter()
        emitted, was_active = [], []
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(steps):
            safe_pos = cache_lib.park_positions(pos, active)[:, None]
            logits, _ = decode_step(self.cfg, self.rcfg, model, tok[:, None],
                                    safe_pos, ds.caches)
            logits1 = logits[:, 0, :vocab]
            nonfinite += ((~torch.isfinite(logits1)).any(dim=-1) & active).sum()
            nxt = sample_tokens(logits1, seeds, gen_idx, temps, topks,
                                any_sampling=any_sampling)
            emitted.append(torch.where(active, nxt, PAD_TOKEN))
            was_active.append(active)
            stepped = active.to(torch.int32)
            tok = torch.where(active, nxt, tok)
            pos = pos + stepped
            remaining = remaining - stepped
            gen_idx = gen_idx + stepped
            active = active & (remaining > 0) & (nxt != eos_ids) & (pos < limit)
        # one device -> host transfer for the whole block
        packed = torch.cat([torch.stack(emitted).reshape(-1),
                            torch.stack(was_active).reshape(-1).long(),
                            tok, pos.long(), remaining.long(), gen_idx,
                            active.long(), nonfinite[None]]).cpu().numpy()
        dt = time.perf_counter() - t0
        n = steps * B
        emitted_h = packed[:n].reshape(steps, B).astype(np.int32)
        was_h = packed[n:2 * n].reshape(steps, B).astype(bool)
        rest = packed[2 * n:]
        ds.tok = rest[0:B].astype(np.int32)
        ds.pos = rest[B:2 * B].astype(np.int32)
        ds.remaining = rest[2 * B:3 * B].astype(np.int32)
        ds.gen_idx = rest[3 * B:4 * B].astype(np.int32)
        ds.active = rest[4 * B:5 * B].astype(bool)
        self.nonfinite_logits += int(rest[5 * B])

        n_steps_run = int(was_h.any(axis=1).sum())
        self.decode_tokens += int(was_h.sum())
        self.decode_time += dt
        self.decode_steps += steps
        if n_steps_run:
            self.latency_samples.extend([dt / n_steps_run] * n_steps_run)
        return ds, GenerateOutput(emitted=emitted_h, was_active=was_h,
                                  steps=steps, seconds=dt)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _validate_request(self, req: Request) -> None:
        lp = len(req.tokens)
        if lp < 1 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: empty prompt or generation")
        if lp + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt_len={lp} + max_new_tokens="
                f"{req.max_new_tokens} exceeds max_len={self.max_len}")

    def submit(self, req: Request) -> None:
        self._validate_request(req)
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def _free_slots(self) -> list[int]:
        return [int(i) for i in np.nonzero(~self.active)[0]]

    def _bucket_len(self, lp: int) -> int:
        """The next power of two (>= 16) at or above ``lp``, capped at
        max_len: a handful of prefill shapes instead of one per length.
        Every served kind (attn/swa) couples rows only through causal
        attention, so pad rows cannot perturb the real rows' state."""
        b = 16
        while b < lp:
            b <<= 1
        return min(b, self.max_len)

    def _admit(self, req: Request, slot: int) -> Optional[RequestOutput]:
        prefix = self.prefill(self.model, req)
        self.decode_state = self.insert(prefix, self.decode_state, slot)
        self._requests[req.uid] = req
        self._outputs[req.uid] = [prefix.first_token]
        self._prefill_s[req.uid] = prefix.prefill_s
        self._decode_acc[req.uid] = 0.0
        if not self.active[slot]:
            return self._finish(slot)
        return None

    def _finish(self, slot: int) -> RequestOutput:
        uid = int(self.slot_uid[slot])
        req = self._requests.pop(uid)
        toks = self._outputs.pop(uid)
        reason = ("eos" if req.eos_id >= 0 and toks and toks[-1] == req.eos_id
                  else "length")
        out = RequestOutput(uid=uid, prompt_len=len(req.tokens), tokens=toks,
                            finish_reason=reason,
                            prefill_s=self._prefill_s.pop(uid),
                            decode_s=self._decode_acc.pop(uid))
        self.slot_uid[slot] = -1
        self.active[slot] = False
        self.pos[slot] = -1
        # a stale temperature on a free slot would keep the sampling path on
        self.temps[slot] = 0.0
        self.topks[slot] = 0
        self.seeds[slot] = 0
        self.eos_ids[slot] = -1
        return out

    def step(self, *, decode_steps: int | None = None) -> list[RequestOutput]:
        """Admit what fits (strict FIFO), then run one decode block.
        Returns the requests that finished during this step."""
        finished: list[RequestOutput] = []
        while self.queue:
            free = self._free_slots()
            if not free:
                break
            done = self._admit(self.queue.popleft(), free[0])
            if done is not None:
                finished.append(done)

        self.peak_active = max(self.peak_active, int(self.active.sum()))
        reserved, used = self._cache_usage()
        self.peak_reserved_bytes = max(self.peak_reserved_bytes, reserved)
        self.peak_used_bytes = max(self.peak_used_bytes, used)
        if not self.active.any():
            return finished

        prev_active = self.active.copy()
        self.decode_state, out = self.generate(self.model, self.decode_state,
                                               steps=decode_steps)
        _, used = self._cache_usage()
        self.peak_used_bytes = max(self.peak_used_bytes, used)

        for b in range(self.max_slots):
            uid = int(self.slot_uid[b])
            if uid < 0:
                continue
            if out.was_active[:, b].any():
                self._decode_acc[uid] += out.seconds
            for t in range(out.steps):
                if out.was_active[t, b]:
                    self._outputs[uid].append(int(out.emitted[t, b]))
            if prev_active[b] and not self.active[b]:
                finished.append(self._finish(b))
        return finished

    def run(self, requests: Sequence[Request]) -> dict[int, RequestOutput]:
        """Submit everything, drive steps until drained."""
        for r in requests:
            self.submit(r)
        done: dict[int, RequestOutput] = {}
        while self.has_work:
            for out in self.step():
                done[out.uid] = out
        return done

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the aggregate counters; slot state is kept."""
        self.prefill_tokens = 0
        self.prefill_time = 0.0
        self.prefill_count = 0
        self.insert_count = 0
        self.insert_time = 0.0
        self.decode_tokens = 0
        self.decode_time = 0.0
        self.decode_steps = 0
        self.nonfinite_logits = 0
        # seconds per decode step; bounded so a long-lived engine does not
        # grow host memory one float per generated token
        self.latency_samples: collections.deque[float] = collections.deque(maxlen=65536)
        self.peak_active = 0
        self.peak_reserved_bytes = 0
        self.peak_used_bytes = 0

    def _cache_usage(self) -> tuple[int, int]:
        """(reserved_bytes, used_bytes): every occupied slot reserves its
        whole slab; ``used`` counts the tokens written."""
        occupied = np.nonzero(self.slot_uid >= 0)[0]
        reserved = used = 0
        for node in cache_lib.kv_cache_nodes(self.caches):
            S = node.k.shape[2]
            tb = cache_lib.kv_token_bytes(node)
            reserved += len(occupied) * S * tb
            used += tb * sum(min(max(int(self.pos[s]), 0), S) for s in occupied)
        return reserved, used

    def stats(self) -> dict:
        lat = sorted(self.latency_samples)
        reserved, used = self._cache_usage()
        out = {
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_time,
            "prefill_count": self.prefill_count,
            "prefill_tok_s": (self.prefill_tokens / self.prefill_time
                              if self.prefill_time else 0.0),
            "insert_count": self.insert_count,
            "insert_s": self.insert_time,
            "insert_ms_avg": (1e3 * self.insert_time / self.insert_count
                              if self.insert_count else 0.0),
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_time,
            "decode_steps": self.decode_steps,
            "decode_tok_s": (self.decode_tokens / self.decode_time
                             if self.decode_time else 0.0),
            "p50_token_latency_ms": _percentile(lat, 0.50) * 1e3,
            "p95_token_latency_ms": _percentile(lat, 0.95) * 1e3,
            "nonfinite_logits": self.nonfinite_logits,
            "cache_slot_bytes": cache_lib.slot_bytes(self.caches, self.max_slots),
            "prefill_buckets": len(self.bucket_lens),
            "replica_shards": 1,
            "peak_active": self.peak_active,
            "peak_kv_reserved_bytes": self.peak_reserved_bytes,
            "peak_kv_used_bytes": self.peak_used_bytes,
        }
        out.update(stats_lib.serving_cache_metrics(
            reserved_bytes=reserved, used_bytes=used,
            capacity_bytes=self._kv_capacity_bytes))
        return out
