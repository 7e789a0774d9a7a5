"""Continuous-batching serving engine (``repro/serve/engine.py``).

Three explicit stages, as in the JAX engine --

  prefill(model, request)              -> Prefix
  insert(prefix, decode_state, slot)   -> DecodeState
  generate(model, decode_state)        -> (DecodeState, GenerateOutput)

-- with the ``submit``/``step``/``run`` continuous-batching loop as a thin
orchestrator on top. A request is prefilled alone (batch 1, prompt padded
to a power-of-two bucket unless the arch's prefill couples rows beyond
causal attention; attention through K3), its cache spliced into a
free slot of the engine's dense cache, and then decoded with every other
active slot, ``decode_block`` tokens per ``generate`` call (attention
through K6). Where the JAX engine runs the block as one jitted
``lax.scan``, the port runs a Python loop over the steps that keeps the
token, position, activity, budget and sample-index vectors on the device
and synchronises with the host once per block, not once per token.

For attn / swa / latt / xattn / rec / ssm blocks per-sequence math is
row-independent, so a request's tokens do not depend on which other
requests share the batch. On the card this holds for a fixed slot count: the
matrix products see the same shapes either way. A moe block couples the
rows of a step through its expert capacity, as in the JAX engine: every
slot, a parked one too, takes part in each decode step with the token it
carries. An ssm or rec block's recurrent state (``models/ssm.SSMCache``,
``models/rglru.RGLRUCache``) advances in every slot each step, a parked
one too; an admission overwrites it whole. Prompts of a moe, ssm or rec
arch are prefilled at their own lengths (bucketing off,
``stats()["buckets_enabled"]`` False), since pad rows would take capacity
or enter the state. ``prefill_buckets`` follows the JAX engine: None
decides by the kinds (with a one-time warning per coupled arch), False
turns bucketing off for any arch without the warning, True cannot turn it
on for a coupled kind.

Cache layouts (``cache_layout=dense|paged``): ``dense`` reserves a
``(layers, B, max_len, KV, dh)`` slab, so a short request pays for
``max_len``; ``paged`` backs the attention caches with page pools and
per-slot block tables (serve/paging.py; decode attention through K7, or
K8 for int8 / int4 pools). Admission reserves ``ceil((prompt + max_new) /
page_size)`` pages in every pool up front -- an admitted request never
waits for a page mid-stream, and a slot's block-table row is written to
the card once, at ``insert`` -- so the predicate becomes *a free slot AND
enough free pages in every pool*; eviction returns the pages to the host
free list with no device work. ``cache_compress`` stores the pools as
int8 / int4 / svd at proportionally more pages for the same
``pool_tokens`` byte budget. An ssm or rec block's recurrent state has no
pages: it stays a dense slot cache under either layout, and an arch of
ssm blocks alone has no pool, so admission is the free-slot check and
``prefix_share`` finds nothing to adopt. A swa or latt block's window
makes its pool a ring (a slot's pages are overwritten in place as its
stream passes the window), which ``prefix_share`` refuses, as the JAX
engine does. ``prefix_share`` adopts the full-page prefix of a live or
retired request with the same prompt head (copy-on-write: only the
divergent page is copied). ``speculative_k`` drafts k tokens per slot on
the host and verifies them in one ``decode_step`` over (B, k+1) rows
(K7/K8 with Lq = k+1), emitting the leading run that matches greedy
decoding.

A vision arch's request carries its ``image_embeds`` (vision_tokens,
d): prefill computes each xattn block's image K/V from them into an
:class:`~repro_torch.models.attention.XAttnCache`, a dense slot cache
under either layout that decode reads (K6 non-causal) and never writes.
Its prompts are bucketed like attn's (pad rows are query rows only);
``prefix_share`` is refused, since the prefix index compares prompt
tokens alone.

Several engines on one card, each with its own slots and pools, sit
behind ``serve.router.Router``; a Prefix crosses between them in host
form (:meth:`Prefix.to_host`, then :meth:`ServeEngine.admit_prefix`).

``mesh`` (a data mesh inside this process, ``launch.mesh.make_local_mesh``)
runs the JAX engine's data-parallel layout in one process on the
engine's device: the paged layout splits every pool into ``n_replicas``
= dp per-replica shards with shard-local page ids (``serve/cache.
shard_slots``). Replica r owns the slot chunk [r B/dp, (r+1) B/dp) and
a 1/dp share of every pool's pages, with one allocator per pool and
replica; a request is placed on the replica with the most headroom left
after it in its tightest pool (ties to the lowest replica), in that
replica's lowest free slot; decode reads each slot's pages through its
own shard's table (K7 / K8 through the sharded wrappers, one launch a
layer for the whole batch). A dense engine under a mesh serves as without
one (``n_replicas`` 1), its slot count still divisible by the degree.
``prefix_share`` is single-replica, as in the JAX engine. Still refused:
a mesh of ranks (a later multi-GPU serving slice), and ``speculative_k``
on any kind but attn (as in the JAX engine).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import stats as stats_lib
from repro_torch.core.plan import cache_plan_from_spec
from repro_torch.launch.mesh import is_local_mesh
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.attention import PAGED_CACHE_TYPES, SVDPagedKVCache
from repro_torch.runtime.sharding import dp_degree
from repro_torch.serve import cache as cache_lib
from repro_torch.serve import paging
from repro_torch.serve.sampling import SamplingParams, sample_tokens

PAD_TOKEN = -1
_BUCKET_WARNED: set[str] = set()
LATER_SLICE_RANKS = ("serving on a mesh of ranks (process groups, one card a "
                     "replica) arrives with a later multi-GPU serving slice; this "
                     "engine runs a data mesh inside one process "
                     "(launch.mesh.make_local_mesh)")


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
    """One generation request. ``eos_id`` < 0 disables the eos stop;
    ``image_embeds`` (vision_tokens, d) is a vision arch's image input."""

    uid: int
    tokens: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: int = -1
    image_embeds: Optional[np.ndarray] = None


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
        for node in cache_lib.cache_nodes(self.caches):
            cache_lib.map_tensors(node, lambda t: t.cpu())
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
class _PrefixEntry:
    """One request in the copy-on-write prefix index. ``rows`` holds its
    block-table row per pool (numpy, in pool order): the pages later
    requests adopt. A live entry's pages are held by its slot; a retired
    one keeps only its prompt pages, through an extra ``("prefix", uid)``
    allocator reference, and records its token ``stream`` (prompt +
    generation) as a draft donor for speculative decode."""

    uid: int
    tokens: tuple
    rows: list
    stream: list | None = None
    retired: bool = False


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
    """Continuous-batching engine over a dense slot cache or paged pools.
    See the module docstring for the design."""

    def __init__(self, cfg, rcfg, model, *, max_slots: int, max_len: int,
                 decode_block: int = 8, plan=None, mesh=None,
                 cache_layout: str | None = None, page_size: int | None = None,
                 pool_tokens: int | None = None, cache_compress: str | None = None,
                 prefill_buckets: bool | None = None, prefix_share: bool = False,
                 speculative_k: int = 0, prefix_cache: int = 8):
        if cfg.embed_inputs:
            raise NotImplementedError(
                "serving needs a token frontend; embed-input archs "
                "(musicgen) are train/score only")
        if cfg.n_codebooks:
            raise NotImplementedError("multi-codebook decode is not served")
        kinds = {k for unit, _ in cfg.stages for k in unit}
        if mesh is not None and (not is_local_mesh(mesh) or mesh.size != dp_degree(mesh)):
            raise NotImplementedError(LATER_SLICE_RANKS)
        self.cache_layout = cache_layout or rcfg.cache_layout
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(f"cache_layout must be dense|paged, got {self.cache_layout!r}")
        self.page_size = page_size or rcfg.kv_page_size
        spec = rcfg.cache_compress if cache_compress is None else cache_compress
        self.cache_plan = cache_plan_from_spec(spec or "").resolve(cfg)
        if self.cache_plan.compressed_cache_sites and self.cache_layout != "paged":
            raise ValueError(
                f"cache_compress={spec!r} compresses the paged page pools; the dense "
                "layout has no compressed storage path -- pass cache_layout='paged' "
                "or drop cache_compress")
        if pool_tokens is not None and self.cache_layout != "paged":
            raise ValueError(
                "pool_tokens budgets the paged layout's page pools; the dense layout "
                "always reserves max_slots * max_len slabs -- pass "
                "cache_layout='paged' or drop pool_tokens")
        # a plan routes prefill through site dispatch; outputs stay exact
        self.plan = plan if plan is not None else (rcfg.compression or None)
        self.cfg, self.rcfg, self.model = cfg, rcfg, model
        self.device = model.device
        self.max_slots, self.max_len = max_slots, max_len
        self.decode_block = decode_block
        # pool_tokens: the byte budget of each pool in tokens (None = the
        # dense worst case, max_slots * max_len rounded up to pages)
        pool_pages = None if pool_tokens is None else -(-pool_tokens // self.page_size)
        caches = init_caches(cfg, rcfg, max_slots, max_len, self.device,
                             layout=self.cache_layout, page_size=self.page_size,
                             pool_pages=pool_pages, cache_plan=self.cache_plan)
        if any(isinstance(n, SVDPagedKVCache) for n in cache_lib.kv_cache_nodes(caches)):
            # calibration-free bases from the K/V projection spectra
            cache_lib.install_svd_bases(caches, model, cfg)
        self.n_replicas = 1
        if mesh is not None:
            # data-parallel decode in this process: paged pools split into
            # per-replica shards with shard-local page ids, dense slot caches
            # as they are (their slot count divisible by the degree)
            cache_lib.shard_slots(caches, mesh)
            if self.cache_layout == "paged":
                self.n_replicas = dp_degree(mesh)
        self.decode_state = DecodeState.init(caches, max_slots)

        # one host-side allocator per page pool and replica shard, in
        # cache-tree order (the order _alloc_rows walks), flattened replica
        # by replica into ``allocators``; the dense layout has none and
        # admission is the free-slot check
        pool_specs: list[tuple] = []        # (spec, label, format) per pool
        dense_itemsize = torch.empty((), dtype=getattr(torch, rcfg.compute_dtype)).element_size()
        comp_bytes = dense_bytes = 0
        for si, ((unit, _), stage) in enumerate(zip(cfg.stages, caches)):
            for kind, node in zip(unit, stage):
                if not isinstance(node, PAGED_CACHE_TYPES):
                    continue
                tb = cache_lib.kv_token_bytes(node)
                comp_bytes += tb
                dense_bytes += (2 * node.k_pages.shape[0] * node.k_pages.shape[-2]
                                * cfg.head_dim * dense_itemsize)
                fmt = self.cache_plan.cache_format(si, kind)
                pool_specs.append((paging.spec_from_cache(node, tb), f"stage{si}.{kind}",
                                   str(fmt) if fmt else rcfg.compute_dtype))
        self.replica_allocators: list[list[paging.PageAllocator]] = [
            [paging.PageAllocator(spec) for spec, _, _ in pool_specs]
            for _ in range(self.n_replicas if pool_specs else 1)]
        self.allocators = [a for pools in self.replica_allocators for a in pools]
        self.pool_labels: list[str] = []
        self.pool_formats: list[str] = []
        for rep in range(len(self.replica_allocators)):
            for _, label, fmt in pool_specs:
                self.pool_labels.append(f"replica{rep}/{label}" if self.n_replicas > 1
                                        else label)
                self.pool_formats.append(fmt)
        # bytes per token against uncompressed pools (1.0 dense or fp paged):
        # the admission multiplier at a fixed byte budget
        self.kv_compression_x = dense_bytes / comp_bytes if comp_bytes else 1.0
        self._kv_capacity_bytes = 0
        for node in cache_lib.kv_cache_nodes(caches):
            tb = cache_lib.kv_token_bytes(node)
            if isinstance(node, PAGED_CACHE_TYPES):
                pages, ps = cache_lib.pool_geometry(node)
                self._kv_capacity_bytes += pages * ps * tb
            else:
                self._kv_capacity_bytes += node.k.shape[1] * node.k.shape[2] * tb

        # prompt-length bucketing: off for archs whose prefill couples
        # rows / positions beyond causal attention (recurrent state, MoE
        # expert capacity): pad tokens there would change the spliced
        # state, not just dead cache rows. prefill_buckets=None decides by
        # the kinds, False turns bucketing off for any arch (and, being
        # asked for, without the warning), True cannot turn it on for a
        # coupled kind
        coupled = sorted(kinds & {"rec", "ssm", "moe"})
        bucketable = not coupled
        self.prefill_buckets = (bucketable if prefill_buckets is None
                                else bool(prefill_buckets) and bucketable)
        if coupled and prefill_buckets is not False:
            arch = getattr(cfg, "name", "+".join(coupled))
            if arch not in _BUCKET_WARNED:
                _BUCKET_WARNED.add(arch)
                warnings.warn(
                    f"prefill buckets auto-disabled for arch {arch!r}: "
                    f"its {'/'.join(coupled)} blocks carry sequence-"
                    "coupled prefill state, so pad tokens would perturb "
                    "the spliced caches — every distinct prompt length "
                    "compiles its own prefill (engine stats() reports "
                    "buckets_enabled=False)", stacklevel=2)
        self.bucket_lens: set[int] = set()

        # --- copy-on-write prefix sharing + self-speculative decode ---
        self.prefix_share = bool(prefix_share)
        self.speculative_k = int(speculative_k)
        self.prefix_cache = int(prefix_cache)
        if self.speculative_k < 0 or self.prefix_cache < 0:
            raise ValueError("speculative_k and prefix_cache must be >= 0")
        if self.prefix_share:
            if self.cache_layout != "paged":
                raise ValueError(
                    "prefix_share adopts page-pool pages between requests; the dense "
                    "layout has no pages -- pass cache_layout='paged'")
            if self.n_replicas != 1:
                raise ValueError(
                    "prefix_share is single-replica: sharded pools keep "
                    "shard-local page ids, so adopting another slot's "
                    "pages could alias across shards — run one engine "
                    "per replica behind serve/router.py instead")
            if cfg.vision_tokens:
                raise ValueError(
                    "prefix_share identifies a prefix by its prompt "
                    "tokens alone; vision archs carry per-request image "
                    "state the index cannot compare")
            if any(a.spec.ring for a in self.allocators):
                raise ValueError(
                    "prefix_share needs append-only pools; ring (sliding-window) "
                    "pools overwrite their pages in place, so an adopted prefix "
                    "page would be clobbered by the owner's later tokens")
        if self.speculative_k:
            if self.cache_layout != "paged":
                raise ValueError(
                    "speculative_k verifies k+1 draft rows in one call through the "
                    "paged decode kernels -- pass cache_layout='paged'")
            bad = sorted(kinds - {"attn"})
            if bad:
                raise ValueError(
                    f"speculative_k needs every block to accept multi-row decode "
                    f"queries; {'/'.join(bad)} blocks are sequential/windowed and "
                    "verify row-by-row only")
        # prefix index: live entries by uid; retired ones in an LRU whose
        # prompt pages stay adoptable through ("prefix", uid) references
        # until page pressure or the prefix_cache cap evicts them.
        # _prefix_bykey maps (n_full_pages, hash(prompt prefix)) -> uid.
        self._prefix_live: dict[int, _PrefixEntry] = {}
        self._retired: collections.OrderedDict[int, _PrefixEntry] = collections.OrderedDict()
        self._prefix_bykey: dict[tuple[int, int], int] = {}
        self._draft_donor: dict[int, list[int]] = {}
        self._donor_ok: dict[int, int] = {}

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
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if self.cfg.vision_tokens:
            batch["image_embeds"] = torch.as_tensor(
                np.asarray(request.image_embeds, np.float32), device=self.device)[None]
        logits, pcaches = prefill(self.cfg, self.rcfg, model, batch, self.max_len,
                                  plan=self.plan, prompt_len=[lp])
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
        """Splice a Prefix into decode slot ``slot`` (in place): reserve the
        request's pages in every pool (paged layout), install the caches,
        and arm the slot's sampling/stop vectors. Raises on a consumed
        Prefix or an occupied slot."""
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
        if self.allocators:
            share = self._match_prefix(req.tokens)
            rows, starts, srcs, dsts, flat_rows = self._alloc_rows(req, slot, share)
            cache_lib.write_slot_paged(decode_state.caches, prefix.caches, rows, slot,
                                       lp, starts)
            m = 0 if share is None else share[1]
            lo = (m // self.page_size) * self.page_size
            if lo < m:
                # the divergent page is fresh but its leading rows are still
                # shared content: copy them from the owner's page before any
                # decode write lands on this slot
                cache_lib.cow_split_pages(decode_state.caches, srcs, dsts, lo, m)
            if self.prefix_share:
                if self.speculative_k and share is not None and m == lp and share[0].stream:
                    # full-prompt hit on a retired request: its recorded
                    # continuation drafts this request's greedy stream
                    self._draft_donor[req.uid] = list(share[0].stream)
                    self._donor_ok[req.uid] = 0
                self._register_prefix(req, flat_rows)
        else:
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
        the host reads them back once at its end. With ``speculative_k``
        and no sampling row active, one speculative verify instead."""
        ds = decode_state
        B = ds.active.shape[0]
        if not ds.active.any():
            return ds, GenerateOutput(emitted=np.full((0, B), PAD_TOKEN, np.int32),
                                      was_active=np.zeros((0, B), bool),
                                      steps=0, seconds=0.0)
        if self.speculative_k and not np.any(ds.temps[ds.active] > 0):
            # verify is greedy-only (draft == argmax is the acceptance rule);
            # a sampling row drops the whole block to the sequential loop
            return self._generate_spec(model, ds)
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
    # speculative verify
    # ------------------------------------------------------------------
    def _ngram_draft(self, hist: list, n: int) -> list:
        """n cheap draft tokens from the request's own history: the longest
        n-gram suffix match (3, 2, 1) over a bounded recent window, with
        repeat-last as the floor. Host work only."""
        out: list[int] = []
        h = [int(x) for x in hist[-256:]]
        for _ in range(n):
            nxt = None
            for g in (3, 2, 1):
                if len(h) <= g:
                    continue
                pat = h[-g:]
                for i in range(len(h) - g - 1, -1, -1):
                    if h[i:i + g] == pat:
                        nxt = h[i + g]
                        break
                if nxt is not None:
                    break
            if nxt is None:
                nxt = h[-1]
            out.append(nxt)
            h.append(nxt)
        return out

    def _draft_tokens(self, uid: int, hist: list, k: int) -> list:
        """k draft tokens for a request. A donor stream (a retired request
        that shared the full prompt) drafts first: under greedy sampling
        the new request reproduces it until they really diverge.
        ``_donor_ok`` remembers how much of the history was already checked
        against the donor, so each call checks only the new tokens."""
        d: list[int] = []
        donor = self._draft_donor.get(uid)
        if donor is not None:
            ok = self._donor_ok.get(uid, 0)
            L = len(hist)
            while ok < L and ok < len(donor) and int(donor[ok]) == int(hist[ok]):
                ok += 1
            if ok < L:            # diverged from the donor: it is spent
                self._draft_donor.pop(uid, None)
                self._donor_ok.pop(uid, None)
            else:
                self._donor_ok[uid] = ok
                d = [int(x) for x in donor[L:L + k]]
        if len(d) < k:
            d.extend(self._ngram_draft(list(hist) + d, k - len(d)))
        return d[:k]

    def _generate_spec(self, model, decode_state: DecodeState
                       ) -> tuple[DecodeState, GenerateOutput]:
        """Speculative decode block: draft k tokens per active slot on the
        host, verify them in ONE ``decode_step`` over (B, k+1) rows (the
        last token plus the drafts, at consecutive positions; K7/K8 with
        Lq = k+1), then emit the leading run of drafts that match the
        greedy continuation plus the model's own next token, with the
        sequential loop's stop rules. Row t's logits see exactly what a
        sequential decode would have seen if drafts 1..t are right; rows
        written for rejected drafts sit at positions the slot has not
        reached, which causal masking keeps inert until they are
        rewritten."""
        ds = decode_state
        k = self.speculative_k
        B = self.max_slots
        t0 = time.perf_counter()
        drafts = np.zeros((B, k), np.int32)
        for b in range(B):
            if not ds.active[b]:
                continue
            uid = int(ds.slot_uid[b])
            req = self._requests.get(uid)
            if req is not None and uid in self._outputs:
                hist = [int(x) for x in req.tokens] + [int(x) for x in self._outputs[uid]]
            else:
                # stage-API use without the orchestrator's bookkeeping
                hist = [int(ds.tok[b])]
            drafts[b] = np.asarray(self._draft_tokens(uid, hist, k), np.int32)
        positions = np.where(ds.active[:, None],
                             ds.pos[:, None] + np.arange(k + 1, dtype=np.int32)[None], -1)
        toks = np.concatenate([ds.tok[:, None], drafts], axis=1)
        logits, _ = decode_step(self.cfg, self.rcfg, model,
                                torch.as_tensor(toks, device=self.device).long(),
                                torch.as_tensor(positions.astype(np.int32), device=self.device),
                                ds.caches)
        logits = logits[..., : self.cfg.vocab_size]
        act = torch.as_tensor(ds.active, device=self.device)
        bad = ((~torch.isfinite(logits)).any(dim=-1).any(dim=-1) & act).sum()
        packed = torch.cat([logits.argmax(dim=-1).reshape(-1), bad[None]]).cpu().numpy()
        greedy = packed[:-1].reshape(B, k + 1)
        self.nonfinite_logits += int(packed[-1])
        emitted = np.full((k + 1, B), PAD_TOKEN, np.int32)
        was_active = np.zeros((k + 1, B), bool)
        n_act = int(ds.active.sum())
        self.spec_verify_calls += 1
        self.spec_tokens_drafted += k * n_act
        for b in range(B):
            if not ds.active[b]:
                continue
            a = 0
            while a < k and drafts[b, a] == greedy[b, a]:
                a += 1
            self.spec_tokens_accepted += a
            tok, pos = int(ds.tok[b]), int(ds.pos[b])
            rem, gi, eos = int(ds.remaining[b]), int(ds.gen_idx[b]), int(ds.eos_ids[b])
            alive = True
            for t in range(a + 1):
                nxt = int(greedy[b, t])
                emitted[t, b] = nxt
                was_active[t, b] = True
                tok, pos, rem, gi = nxt, pos + 1, rem - 1, gi + 1
                if not (rem > 0 and nxt != eos and pos < self.max_len - 1):
                    alive = False
                    break
            ds.tok[b], ds.pos[b], ds.remaining[b], ds.gen_idx[b] = tok, pos, rem, gi
            ds.active[b] = alive
        dt = time.perf_counter() - t0
        n_steps_run = int(was_active.any(axis=1).sum())
        self.decode_tokens += int(was_active.sum())
        self.decode_time += dt
        self.decode_steps += 1
        if n_steps_run:
            self.latency_samples.extend([dt / n_steps_run] * n_steps_run)
        return ds, GenerateOutput(emitted=emitted, was_active=was_active,
                                  steps=k + 1, seconds=dt)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _validate_request(self, req: Request) -> None:
        """Raise if the request can never be served by this engine: bad
        sizes, or a pool it cannot fit in."""
        lp = len(req.tokens)
        if lp < 1 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: empty prompt or generation")
        if lp + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt_len={lp} + max_new_tokens="
                f"{req.max_new_tokens} exceeds max_len={self.max_len}")
        if self.cfg.vision_tokens and req.image_embeds is None:
            raise ValueError(f"request {req.uid}: arch needs image_embeds")
        for alloc, label, fmt in zip(self.allocators, self.pool_labels,
                                     self.pool_formats):
            total = lp + req.max_new_tokens
            need = alloc.blocks_for(total)
            if need > alloc.spec.n_pages:
                cap_tok = alloc.spec.n_pages * alloc.spec.page_size
                raise ValueError(
                    f"request {req.uid}: needs {need} pages ({total} tokens) but "
                    f"pool {label} [{fmt}] has {alloc.spec.n_pages} pages "
                    f"({cap_tok} tokens) total -- {total - cap_tok} tokens over "
                    f"capacity; raise pool_tokens or shrink prompt_len + "
                    f"max_new_tokens")

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
        max_len: a handful of prefill shapes instead of one per length
        (attn / swa couple rows only through causal attention, so pad rows
        cannot perturb the real rows' state). ``lp`` itself when bucketing
        is off (a moe or ssm arch: pad rows would take expert capacity or
        enter the recurrent state; or ``prefill_buckets=False``)."""
        if not self.prefill_buckets:
            return lp
        b = 16
        while b < lp:
            b <<= 1
        return min(b, self.max_len)

    # ------------------------------------------------------------------
    # copy-on-write prefix index
    # ------------------------------------------------------------------
    def _match_prefix(self, tokens) -> tuple[_PrefixEntry, int] | None:
        """Longest live or retired prefix match of a prompt: ``(entry, m)``
        with ``m`` the matched token count. Probes from the longest
        full-page prefix down; the token comparison guards against hash
        collisions, and the match extends at most into the first divergent
        page (the one copy-on-write split an admission makes)."""
        if not self.prefix_share:
            return None
        t = tuple(int(x) for x in tokens)
        ps = self.page_size
        for j in range(len(t) // ps, 0, -1):
            key = (j, hash(t[: j * ps]))
            uid = self._prefix_bykey.get(key)
            if uid is None:
                continue
            entry = self._prefix_live.get(uid) or self._retired.get(uid)
            if entry is None:
                del self._prefix_bykey[key]   # evicted owner, stale key
                continue
            if entry.tokens[: j * ps] != t[: j * ps]:
                continue                       # hash collision
            m = j * ps
            lim = min(len(entry.tokens), len(t), (j + 1) * ps)
            while m < lim and entry.tokens[m] == t[m]:
                m += 1
            if entry.retired:
                self._retired.move_to_end(uid)  # LRU touch
            return entry, m
        return None

    def _register_prefix(self, req: Request, flat_rows: list) -> None:
        """Index a just-admitted request as a live prefix owner."""
        t = tuple(int(x) for x in req.tokens)
        self._prefix_live[req.uid] = _PrefixEntry(uid=req.uid, tokens=t, rows=flat_rows)
        for j in range(1, len(t) // self.page_size + 1):
            self._prefix_bykey[(j, hash(t[: j * self.page_size]))] = req.uid

    def _unindex_prefix(self, entry: _PrefixEntry) -> None:
        for j in range(1, len(entry.tokens) // self.page_size + 1):
            key = (j, hash(entry.tokens[: j * self.page_size]))
            if self._prefix_bykey.get(key) == entry.uid:
                del self._prefix_bykey[key]

    def _drop_retired(self, uid: int) -> None:
        """Evict a retired prefix entry: drop its ("prefix", uid) page
        references (the pages free once no adopter maps them)."""
        entry = self._retired.pop(uid)
        for alloc in self.allocators:
            alloc.release(("prefix", uid))
        self._unindex_prefix(entry)

    def _evict_one_retired(self) -> bool:
        """Free the least recently matched retired prefix (page pressure);
        False when nothing is left to evict."""
        if not self._retired:
            return False
        self._drop_retired(next(iter(self._retired)))
        return True

    def _retire_prefix(self, uid: int, generated: list) -> None:
        """Move a finishing request's entry from live to retired: retain
        its prompt pages under a ("prefix", uid) reference (before the
        slot releases them) and record its token stream as a draft donor.
        The oldest retirees fall off the LRU cap."""
        entry = self._prefix_live.pop(uid, None)
        if entry is None:
            return
        if self.prefix_cache == 0:
            self._unindex_prefix(entry)
            return
        n_prompt_pages = -(-len(entry.tokens) // self.page_size)
        for alloc, row in zip(self.replica_allocators[0], entry.rows):
            alloc.retain(("prefix", uid), row[:n_prompt_pages])
        entry.stream = list(entry.tokens) + [int(x) for x in generated]
        entry.retired = True
        self._retired[uid] = entry
        while len(self._retired) > self.prefix_cache:
            self._drop_retired(next(iter(self._retired)))

    # ------------------------------------------------------------------
    # page-aware admission
    # ------------------------------------------------------------------
    def _slot_replica(self, slot: int) -> int:
        """The replica shard owning ``slot`` (the contiguous-chunk map; 0
        with one replica)."""
        return slot // (self.max_slots // self.n_replicas)

    def try_place(self, req: Request) -> int | None:
        """The slot the request should be admitted to, or None if nothing
        fits now. Among the replicas with a free slot and room in every
        pool, the one with the most free pages left after the request in
        its tightest pool (ties to the lowest replica), then its lowest
        free slot; with one replica, the lowest free slot if every pool
        has room. Under page pressure, retired prefixes (a cache, not a
        reservation) give their pages back one LRU entry at a time until
        the request fits or none is left."""
        free = self._free_slots()
        if not free:
            return None
        if not self.allocators:
            return free[0]
        total = len(req.tokens) + req.max_new_tokens
        while True:
            # rematch every round: an eviction below may drop the entry
            # just matched
            match = self._match_prefix(req.tokens)
            s = 0 if match is None else match[1] // self.page_size
            best: tuple[int, int] | None = None
            for rep, pools in enumerate(self.replica_allocators):
                rep_free = [x for x in free if self._slot_replica(x) == rep]
                need = [a.blocks_for(total) - s for a in pools]
                if not rep_free or not all(a.can_allocate(n) for a, n in zip(pools, need)):
                    continue
                headroom = min(a.free_pages - n for a, n in zip(pools, need))
                if best is None or headroom > best[0]:
                    best = (headroom, rep_free[0])
            if best is not None:
                return best[1]
            if not self._evict_one_retired():
                return None

    def pool_load(self) -> float:
        """Load factor in [0, 1]: the tightest pool's reserved fraction
        (paged), or the occupied-slot fraction (dense)."""
        if not self.allocators:
            return float(self.active.sum()) / max(1, self.max_slots)
        return max(a.reserved_pages / max(1, a.spec.n_pages) for a in self.allocators)

    def _alloc_rows(self, req: Request, slot: int, share=None):
        """Reserve the request's pages in every pool of the slot's replica
        (shard-local page ids on sharded pools); returns ``(rows,
        starts, srcs, dsts, flat_rows)``, the first four mirroring the
        cache tree (None at non-paged nodes): the (nb,) block-table row,
        the copy-on-write share boundary ``m`` in tokens (0 unshared), and
        the owner's and this slot's page of the divergent page (-1 when
        the boundary is page-aligned and nothing is copied); ``flat_rows``
        are the rows in pool order (prefix index). ``share`` is an
        ``(entry, m)`` match: the entry's first ``m // page_size`` full
        pages are adopted (refcount, no free-list charge)."""
        total = len(req.tokens) + req.max_new_tokens
        pools = self.replica_allocators[self._slot_replica(slot)]
        ps = self.page_size
        entry, m = share if share is not None else (None, 0)
        s = m // ps
        need_cow = s * ps < m
        ai = 0
        rows, starts, srcs, dsts = [], [], [], []
        flat_rows: list[np.ndarray] = []
        for stage in self.caches:
            rst, sst, srst, dst = [], [], [], []
            for node in stage:
                if not isinstance(node, PAGED_CACHE_TYPES):
                    for lst in (rst, sst, srst, dst):
                        lst.append(None)
                    continue
                alloc = pools[ai]
                shared = None if entry is None else entry.rows[ai][:s]
                row = alloc.allocate(slot, alloc.blocks_for(total), shared=shared).copy()
                flat_rows.append(row)
                rst.append(row)
                sst.append(m)
                srst.append(int(entry.rows[ai][s]) if need_cow else -1)
                dst.append(int(row[s]) if need_cow else -1)
                ai += 1
            rows.append(rst)
            starts.append(sst)
            srcs.append(srst)
            dsts.append(dst)
        if m:
            self.prefix_hits += 1
            self.prefix_pages_adopted += s * ai
            if need_cow:
                self.cow_page_splits += ai
        return rows, starts, srcs, dsts, flat_rows

    def _admit(self, req: Request, slot: int) -> Optional[RequestOutput]:
        """Orchestrated admission: prefill + insert + bookkeeping."""
        return self.admit_prefix(self.prefill(self.model, req), slot)

    def admit_prefix(self, prefix: Prefix, slot: int) -> Optional[RequestOutput]:
        """Insert a (possibly handed-off, host-form) Prefix and register its
        request with the orchestrator's output bookkeeping. Returns the
        finished RequestOutput when the first token already hit a stop
        condition."""
        self.decode_state = self.insert(prefix, self.decode_state, slot)
        req = prefix.request
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
        # retirement precedes the slot's release: the prompt pages take
        # their ("prefix", uid) reference while the slot still holds them
        if self.prefix_share:
            self._retire_prefix(uid, toks)
        self._draft_donor.pop(uid, None)
        self._donor_ok.pop(uid, None)
        # the pages go back to the host free list; the device cache is
        # untouched (no live block table maps them)
        for alloc in self.allocators:
            alloc.release(slot)
        # a stale temperature on a free slot would keep the sampling path on
        self.temps[slot] = 0.0
        self.topks[slot] = 0
        self.seeds[slot] = 0
        self.eos_ids[slot] = -1
        return out

    def step(self, *, decode_steps: int | None = None) -> list[RequestOutput]:
        """Admit what fits (strict FIFO: when the head request cannot get a
        slot and its pages, later ones wait too), then run one decode
        block. Returns the requests that finished during this step."""
        finished: list[RequestOutput] = []
        while self.queue:
            slot = self.try_place(self.queue[0])
            if slot is None:
                break
            done = self._admit(self.queue.popleft(), slot)
            if done is not None:
                finished.append(done)

        self.peak_active = max(self.peak_active, int(self.active.sum()))
        reserved, used, _, _ = self._cache_usage()
        self.peak_reserved_bytes = max(self.peak_reserved_bytes, reserved)
        self.peak_used_bytes = max(self.peak_used_bytes, used)
        if not self.active.any():
            return finished

        prev_active = self.active.copy()
        self.decode_state, out = self.generate(self.model, self.decode_state,
                                               steps=decode_steps)
        _, used, _, _ = self._cache_usage()
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
        self.prefix_hits = 0
        self.prefix_pages_adopted = 0
        self.cow_page_splits = 0
        self.spec_verify_calls = 0
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0

    def _cache_usage(self) -> tuple[int, int, int, int]:
        """(reserved_bytes, used_bytes, pages_total, pages_free) now. Dense:
        every occupied slot reserves its whole slab. Paged: the pages the
        allocators handed out. ``used`` counts the tokens written either
        way, so the gap is what the paged layout gives back."""
        occupied = np.nonzero(self.slot_uid >= 0)[0]
        reserved = used = pages_total = pages_free = 0
        if self.allocators:
            for alloc in self.allocators:
                pages_total += alloc.spec.n_pages
                pages_free += alloc.free_pages
                reserved += alloc.reserved_bytes
                used += alloc.spec.token_bytes * sum(
                    alloc.used_tokens(int(self.pos[s])) for s in occupied
                    if alloc.owns(int(s)))
        else:
            for node in cache_lib.kv_cache_nodes(self.caches):
                S = node.k.shape[2]
                tb = cache_lib.kv_token_bytes(node)
                reserved += len(occupied) * S * tb
                used += tb * sum(min(max(int(self.pos[s]), 0), S) for s in occupied)
        return reserved, used, pages_total, pages_free

    def cache_telemetry(self) -> dict:
        """Reserved-vs-used KV telemetry (core.stats.serving_cache_metrics)."""
        reserved, used, pages_total, pages_free = self._cache_usage()
        return stats_lib.serving_cache_metrics(
            reserved_bytes=reserved, used_bytes=used,
            capacity_bytes=self._kv_capacity_bytes,
            pages_total=pages_total, pages_free=pages_free,
            compression_x=self.kv_compression_x)

    def stats(self) -> dict:
        lat = sorted(self.latency_samples)
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
            "buckets_enabled": self.prefill_buckets,
            "replica_shards": self.n_replicas,
            "prefix_share": self.prefix_share,
            "prefix_hits": self.prefix_hits,
            "prefix_pages_adopted": self.prefix_pages_adopted,
            "cow_page_splits": self.cow_page_splits,
            "shared_pages_now": sum(a.shared_pages for a in self.allocators),
            "retired_prefixes": len(self._retired),
            "speculative_k": self.speculative_k,
            "spec_verify_calls": self.spec_verify_calls,
            "spec_tokens_drafted": self.spec_tokens_drafted,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_accept_rate": (self.spec_tokens_accepted / self.spec_tokens_drafted
                                 if self.spec_tokens_drafted else 0.0),
            "peak_active": self.peak_active,
            "peak_kv_reserved_bytes": self.peak_reserved_bytes,
            "peak_kv_used_bytes": self.peak_used_bytes,
            # per pool: stored format, true bytes per token (scales
            # included) and pages minted
            "cache_pools": {
                label: {"format": fmt, "token_bytes": a.spec.token_bytes,
                        "pages": a.spec.n_pages}
                for label, fmt, a in zip(self.pool_labels, self.pool_formats,
                                         self.allocators)},
        }
        out.update(self.cache_telemetry())
        return out
