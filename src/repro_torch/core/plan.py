"""CompressionPlan: declarative per-site activation compression (the port
of ``repro/core/plan.py``: same grammar, sites, ids and resolution).

The paper's policy object compressed exactly one thing — the fused QKV
projection — and every extension (RG-LRU inputs, Mamba in-projections,
kernels, shard-local blocking) grew another flat ``RunConfig`` boolean.
This module replaces that with a *plan*: a compact rule spec resolved
against the architecture's compression **sites**.

A site is (stage, block kind, projection role). Roles:

  ``attn.qkv``       fused Q/K/V input projection (one shared state, Fig. 2)
  ``attn.cross_kv``  cross-attention K/V over image embeddings
  ``ffn.gate`` / ``ffn.up`` / ``ffn.down``   dense SwiGLU projections
  ``moe.expert``     batched expert gate/up projections (per-expert states)
  ``ssm.in``         Mamba-2 in-projection
  ``rglru.in``       RG-LRU recurrent-branch input projection
  ``lm_head``        final logits projection (chunked cross-entropy)

Cache sites (``cache.kv``) extend the same grammar to the *serving* KV
cache: ``cache.kv=int8 | int4(group=64) | svd(r=1/4)`` selects the stored
page format per attention cache group (DESIGN.md §9). Rules carrying a
cache-only policy never touch training sites, and vice versa; ``none``
resets either.

Spec grammar (full reference in DESIGN.md §2)::

    plan     := rule (';' rule)*
    rule     := pattern '=' policy
    policy   := name [ '(' key '=' value (',' key '=' value)* ')' ]

    "attn.qkv=pamm(r=1/512,eps=inf);ffn.*=compact(r=1/4);ssm.in=none"

Patterns are fnmatch globs tested against the site's role (``ffn.gate``),
its ``/``-qualified kind and stage forms (``moe/attn.qkv``,
``stage2/rec/rglru.in``) and its dotted path (``stage2.rec.rglru.in``).
**The last matching rule wins**; unmatched sites stay exact. Policy names: ``pamm``, ``uniform_crs`` (alias
``crs``), ``compact``, ``none`` (alias ``exact``). PAMM args: ``r``
(ratio, fractions allowed), ``eps`` (float or ``inf``), ``blocks``
(int or ``auto`` = data-parallel degree of the mesh at resolution time),
``k_max`` (int or ``none``), ``backend`` (``auto`` | ``jnp`` | ``pallas``).
``uniform_crs`` / ``compact`` take ``r``.

In the port ``backend=`` is accepted and validated for spec compatibility,
and every value means the same thing: the kernels (K1, K2) on a CUDA
tensor, their plain versions on a CPU tensor. ``blocks=auto`` resolves to
the data x context degree of the mesh given to :func:`resolve_for_run`
(``launch.mesh.Mesh``), 1 without one. Cache
rules (``cache.kv=int8|int4|svd``) are parsed and validated here; the
paged-serving slice uses them.
"""
from __future__ import annotations

import dataclasses
import math
import re
import warnings
from fnmatch import fnmatchcase
from typing import Any

import torch

from repro_torch.core.linear import STATS_LEN, CompressedSite, _exact_linear
from repro_torch.core.policies import (
    CompActPolicy,
    CompressionPolicy,
    ExactPolicy,
    PammPolicy,
    UniformCRSPolicy,
)

__all__ = [
    "Site",
    "Rule",
    "CacheFormat",
    "CacheSite",
    "CompressionPlan",
    "ResolvedPlan",
    "SiteCtx",
    "enumerate_sites",
    "enumerate_cache_sites",
    "cache_plan_from_spec",
    "make_run_plan",
    "plan_spec_from_legacy",
    "resolve_for_run",
    "as_resolved",
    "exact_ctx",
    "resolved_from_policy",
]

_EXACT = ExactPolicy()

ROLES = (
    "attn.qkv", "attn.cross_kv",
    "ffn.gate", "ffn.up", "ffn.down",
    "moe.expert", "ssm.in", "rglru.in", "lm_head",
)

# Cache sites extend the taxonomy beyond training activations: one
# ``cache.kv`` site per self-attention cache group (stage, kind) selects
# the *stored format* of that group's decode KV pages. Cross-attention
# image K/V is fixed-size and stays in the base dtype, and rec/ssm state
# is O(1) per slot — neither gets a cache site.
CACHE_ROLES = ("cache.kv",)
_CACHE_KINDS = ("attn", "swa", "latt", "moe")

_ATTN_FFN = ("attn.qkv", "ffn.gate", "ffn.up", "ffn.down")


def _roles_for(kind: str, cfg) -> tuple[str, ...]:
    if kind in ("attn", "swa", "latt"):
        return _ATTN_FFN
    if kind == "moe":
        roles = ("attn.qkv", "moe.expert")
        if cfg.n_shared_experts:
            roles = roles + ("ffn.gate", "ffn.up", "ffn.down")
        return roles
    if kind == "xattn":
        return ("attn.qkv", "attn.cross_kv", "ffn.gate", "ffn.up", "ffn.down")
    if kind == "rec":
        return ("rglru.in", "ffn.gate", "ffn.up", "ffn.down")
    if kind == "ssm":
        return ("ssm.in",)
    raise ValueError(f"unknown block kind {kind!r}")


def _role_n_in(kind: str, role: str, cfg) -> int:
    """Input width of the projection at a role (analytic memory reports)."""
    if role == "ffn.down":
        # only the moe kind's ffn.* roles are the shared-expert FFN; dense
        # blocks in hybrid MoE models keep their own d_ff
        if kind == "moe" and cfg.n_shared_experts:
            return cfg.moe_d_ff * cfg.n_shared_experts
        return cfg.d_ff
    return cfg.d_model  # every other role projects the residual stream


@dataclasses.dataclass(frozen=True)
class Site:
    """Identity of one compressible projection in the architecture."""

    stage: int    # stage index; -1 for model-level sites (lm_head)
    kind: str     # block kind, or "head"
    role: str
    n_in: int = 0
    multiplicity: int = 1  # layers covered: stage repeat x kind count in unit

    @property
    def path(self) -> str:
        if self.stage < 0:
            return self.role
        return f"stage{self.stage}.{self.kind}.{self.role}"

    def matches(self, pattern: str) -> bool:
        # Kind/stage qualification uses '/' so role globs cannot collide
        # with kind names ('attn.*' must not match kind=attn role=ffn.gate).
        cands = (
            self.role,
            f"{self.kind}/{self.role}",
            f"stage{self.stage}/{self.kind}/{self.role}",
            self.path,
        )
        return any(fnmatchcase(c, pattern) for c in cands)


def enumerate_sites(cfg) -> list[Site]:
    """Canonical site enumeration for an architecture.

    Order (and therefore each site's ``site_id``) is deterministic: stages
    in order, kinds in first-appearance order within the unit, roles in the
    kind's role order, then ``lm_head``. Both the legacy shim and explicit
    plan specs resolve against this same enumeration, which is what makes
    their PRNG streams (``fold_in(key, site_id)``) line up exactly.
    """
    sites: list[Site] = []
    for si, (unit, rep) in enumerate(cfg.stages):
        for kind in dict.fromkeys(unit):
            mult = rep * sum(1 for k in unit if k == kind)
            for role in _roles_for(kind, cfg):
                sites.append(Site(si, kind, role, _role_n_in(kind, role, cfg), mult))
    sites.append(Site(-1, "head", "lm_head", cfg.d_model, 1))
    return sites


def enumerate_cache_sites(cfg) -> list[Site]:
    """One ``cache.kv`` site per self-attention cache group, in the same
    deterministic stage/kind order as :func:`enumerate_sites`. These match
    rules through the same glob machinery (``cache.kv``, ``swa/cache.kv``,
    ``stage0.attn.cache.kv``) but resolve to a :class:`CacheFormat`, not a
    training CompressionPolicy."""
    sites: list[Site] = []
    for si, (unit, rep) in enumerate(cfg.stages):
        for kind in dict.fromkeys(unit):
            if kind not in _CACHE_KINDS:
                continue
            mult = rep * sum(1 for k in unit if k == kind)
            sites.append(Site(si, kind, "cache.kv", 0, mult))
    return sites


@dataclasses.dataclass(frozen=True)
class CacheFormat:
    """Stored format of one attention group's decode KV cache.

    ``kind``: ``none`` (base dtype), ``int8`` / ``int4`` (absmax-scaled
    integer pages, fp32 scales per ``group``-wide slice of head_dim;
    group 0 = one scale per token per kv head), or ``svd`` (rank-r
    factored pages, r = round(rank * head_dim), KQ-SVD idiom).
    """

    kind: str = "none"
    group: int = 0      # quant scale-group width along head_dim (0 = dh)
    rank: float = 0.25  # svd rank as a fraction of head_dim

    def __post_init__(self):
        if self.kind not in ("none", "int8", "int4", "svd"):
            raise ValueError(f"cache format kind must be none|int8|int4|svd, "
                             f"got {self.kind!r}")
        if self.group:
            if self.group < 1 or self.group & (self.group - 1):
                # the fused-dequant kernel reshapes the padded (lane-aligned)
                # kv tile into scale groups, so the group width must divide
                # the 128-lane padding too — powers of two do by construction
                raise ValueError(
                    f"quant scale group must be a power of two, got {self.group}")
        if self.kind == "svd" and not 0.0 < self.rank <= 1.0:
            raise ValueError(f"svd rank fraction must be in (0, 1], got {self.rank}")

    @property
    def is_compressed(self) -> bool:
        return self.kind != "none"

    def n_groups(self, dh: int) -> int:
        """Scale groups per head row (quant kinds)."""
        g = min(self.group or dh, dh)
        if dh % g:
            raise ValueError(f"scale group {g} must divide head_dim {dh}")
        return dh // g

    def svd_rank(self, dh: int) -> int:
        return max(1, round(self.rank * dh))

    def token_bytes(self, kv: int, dh: int, base_itemsize: int) -> int:
        """K+V bytes per cached token for ONE layer (scales included)."""
        if self.kind == "int8":
            return 2 * kv * (dh + 4 * self.n_groups(dh))
        if self.kind == "int4":
            if dh % 2:
                raise ValueError(f"int4 packing needs an even head_dim, got {dh}")
            return 2 * kv * (dh // 2 + 4 * self.n_groups(dh))
        if self.kind == "svd":
            return 2 * kv * self.svd_rank(dh) * base_itemsize
        return 2 * kv * dh * base_itemsize

    def __str__(self) -> str:
        if self.kind in ("int8", "int4") and self.group:
            return f"{self.kind}(group={self.group})"
        if self.kind == "svd":
            return f"svd(r={self.rank:g})"
        return self.kind


@dataclasses.dataclass(frozen=True)
class CacheSite:
    """A resolved cache site: which attention group, stored how."""

    path: str
    stage: int
    kind: str
    fmt: CacheFormat


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str
    policy_name: str
    args: tuple[tuple[str, Any], ...] = ()


_POLICY_RE = re.compile(r"^\s*([\w.]+)\s*(?:\((.*)\))?\s*$", re.S)

_POLICY_ALIASES = {"exact": "none", "crs": "uniform_crs",
                   "fp16": "none", "bf16": "none", "fp32": "none"}
_POLICY_ARGS = {
    "pamm": {"r", "eps", "blocks", "k_max", "backend"},
    "uniform_crs": {"r"},
    "compact": {"r"},
    "none": set(),
    # cache-side policies (cache.kv sites only): stored-page formats
    "int8": {"group"},
    "int4": {"group"},
    "svd": {"r"},
}
# Policies that only make sense as a stored cache format. A rule carrying
# one applies exclusively to cache sites (so ``*=int8`` cannot silently
# turn training matmuls into no-ops); ``none`` is shared by both vocabularies
# and resets whichever site type its pattern matches.
_CACHE_ONLY = {"int8", "int4", "svd"}


def _parse_value(s: str):
    s = s.strip()
    low = s.lower()
    if low in ("inf", "+inf", "infinity"):
        return math.inf
    if low == "none":
        return None
    if low in ("true", "false"):
        return low == "true"
    if "/" in s:
        num, den = s.split("/", 1)
        return float(num) / float(den)
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return low


def _parse_rule(text: str) -> Rule:
    if "=" not in text:
        raise ValueError(f"plan rule {text!r}: expected 'pattern=policy'")
    pattern, policy = text.split("=", 1)
    pattern = pattern.strip()
    if not pattern:
        raise ValueError(f"plan rule {text!r}: empty site pattern")
    m = _POLICY_RE.match(policy)
    if not m:
        raise ValueError(f"plan rule {text!r}: cannot parse policy {policy!r}")
    name = _POLICY_ALIASES.get(m.group(1).lower(), m.group(1).lower())
    if name not in _POLICY_ARGS:
        raise ValueError(
            f"plan rule {text!r}: unknown policy {m.group(1)!r}; "
            f"have {sorted(_POLICY_ARGS)}"
        )
    args = []
    if m.group(2) and m.group(2).strip():
        for piece in m.group(2).split(","):
            if "=" not in piece:
                raise ValueError(
                    f"plan rule {text!r}: policy arg {piece.strip()!r} "
                    "must be key=value"
                )
            k, v = piece.split("=", 1)
            k = k.strip().lower()
            if k == "ratio":
                k = "r"
            if k not in _POLICY_ARGS[name]:
                raise ValueError(
                    f"plan rule {text!r}: {name} does not accept arg {k!r} "
                    f"(allowed: {sorted(_POLICY_ARGS[name])})"
                )
            args.append((k, _parse_value(v)))
    if name in _CACHE_ONLY and not _pattern_can_match_cache(pattern):
        raise ValueError(
            f"plan rule {text!r}: unknown policy {m.group(1)!r} for "
            f"training sites — {name} is a cache-only stored format; "
            "target a cache site (e.g. 'cache.kv=" + name + "')"
        )
    return Rule(pattern, name, tuple(args))


def _pattern_can_match_cache(pattern: str) -> bool:
    """Whether a rule pattern could select any ``cache.kv`` site on some
    architecture (cache-only policies on training-only patterns are a
    spec error, caught at parse time — see Site.matches for candidates)."""
    for role in CACHE_ROLES:
        cands = [role]
        for kind in _CACHE_KINDS:
            cands.append(f"{kind}/{role}")
            cands.extend(f"stage{i}/{kind}/{role}" for i in range(64))
            cands.extend(f"stage{i}.{kind}.{role}" for i in range(64))
        if any(fnmatchcase(c, pattern) for c in cands):
            return True
    return False


_KINDS = ("attn", "swa", "moe", "latt", "xattn", "rec", "ssm", "head")


def _pattern_plausible(pattern: str) -> bool:
    """Could this pattern match a site of SOME architecture?

    Tests the pattern against the universal role and kind/role vocabulary
    (stage- or path-scoped patterns are arch-specific by construction, so
    a miss there is reported). Used to tell cross-arch rules from typos.
    """
    for r in ROLES + CACHE_ROLES:
        if fnmatchcase(r, pattern):
            return True
        for k in _KINDS:
            if fnmatchcase(f"{k}/{r}", pattern):
                return True
    return False


def _mesh_data_degree(mesh) -> int:
    if mesh is None:
        return 1
    # one source of truth with the mesh executor: blocks=auto resolves to
    # the degree it shards keys over -- data x context, since each (data,
    # context) coordinate compresses its own (batch slice, sequence slice)
    # block with its own key stream
    from repro_torch.runtime.sharding import cp_degree, dp_degree

    return dp_degree(mesh) * cp_degree(mesh)


def _build_policy(rule: Rule, mesh=None) -> CompressionPolicy:
    args = dict(rule.args)
    if rule.policy_name == "none":
        return _EXACT
    if rule.policy_name == "uniform_crs":
        return UniformCRSPolicy(ratio=float(args.get("r", 1.0 / 512.0)))
    if rule.policy_name == "compact":
        return CompActPolicy(ratio=float(args.get("r", 1.0 / 4.0)))
    # pamm
    blocks = args.get("blocks", "auto")
    if blocks == "auto":
        blocks = _mesh_data_degree(mesh)
    backend = args.get("backend", "auto")
    if backend not in ("auto", "jnp", "pallas"):
        raise ValueError(f"pamm backend must be auto|jnp|pallas, got {backend!r}")
    k_max = args.get("k_max")
    return PammPolicy(
        ratio=float(args.get("r", 1.0 / 512.0)),
        eps=float(args.get("eps", math.inf)),
        n_blocks=int(blocks),
        k_max=None if k_max is None else int(k_max),
    )


def _build_cache_format(rule: Rule) -> CacheFormat:
    args = dict(rule.args)
    if rule.policy_name == "int8":
        return CacheFormat("int8", group=int(args.get("group", 0)))
    if rule.policy_name == "int4":
        return CacheFormat("int4", group=int(args.get("group", 64)))
    if rule.policy_name == "svd":
        return CacheFormat("svd", rank=float(args.get("r", 0.25)))
    return CacheFormat("none")


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """An unresolved plan: an ordered rule list (last match wins)."""

    rules: tuple[Rule, ...] = ()
    spec: str = ""

    @classmethod
    def parse(cls, spec: str) -> "CompressionPlan":
        rules = tuple(
            _parse_rule(part)
            for part in spec.split(";")
            if part.strip()
        )
        return cls(rules=rules, spec=spec)

    def resolve(self, cfg, mesh=None) -> "ResolvedPlan":
        """Bind the plan to an architecture; ``blocks=auto`` resolves to
        the mesh's data x context degree (1 without a mesh)."""
        # build (and thereby validate) each rule's policy exactly once, so a
        # bad arg fails uniformly on every arch, not only where it matches.
        # Cache-only rules (int8/int4/svd) never apply to training sites;
        # they validate through _build_cache_format instead.
        rule_policies = [None if rule.policy_name in _CACHE_ONLY
                         else _build_policy(rule, mesh) for rule in self.rules]
        rule_formats = [_build_cache_format(rule)
                        if rule.policy_name in _CACHE_ONLY | {"none"} else None
                        for rule in self.rules]
        sites = []
        matched = [False] * len(self.rules)
        for sid, site in enumerate(enumerate_sites(cfg)):
            policy = _EXACT
            for ri, rule in enumerate(self.rules):
                if rule.policy_name in _CACHE_ONLY:
                    continue
                if site.matches(rule.pattern):
                    matched[ri] = True
                    policy = rule_policies[ri]
            sites.append(
                CompressedSite(
                    path=site.path, site_id=sid, policy=policy,
                    n_in=site.n_in, multiplicity=site.multiplicity,
                )
            )
        cache_sites = []
        for site in enumerate_cache_sites(cfg):
            fmt = CacheFormat("none")
            for ri, rule in enumerate(self.rules):
                if rule_formats[ri] is None:
                    continue
                if site.matches(rule.pattern):
                    matched[ri] = True
                    fmt = rule_formats[ri]
            if fmt.is_compressed:
                # fail at resolution (with the site named), not at cache init
                fmt.token_bytes(max(1, cfg.n_kv_heads), cfg.head_dim, 2)
            cache_sites.append(CacheSite(site.path, site.stage, site.kind, fmt))
        for ri, hit in enumerate(matched):
            # A rule may legitimately miss this architecture (one spec is
            # shared across archs — ssm.in on a dense model, attn.* on a
            # pure-SSM model), so only warn when the pattern would not match
            # ANY site in the universal role/kind vocabulary: that is a typo
            # that would otherwise silently train uncompressed.
            if not hit and not _pattern_plausible(self.rules[ri].pattern):
                warnings.warn(
                    f"compression rule {self.rules[ri].pattern!r} matches no "
                    f"site of {getattr(cfg, 'name', '?')} and no known "
                    f"role (roles: {list(ROLES + CACHE_ROLES)})",
                    stacklevel=2,
                )
        return ResolvedPlan(sites=_link_shared_sites(sites), plan=self,
                            cache_sites=tuple(cache_sites))


def _link_shared_sites(sites: list[CompressedSite]) -> tuple[CompressedSite, ...]:
    """Mark ffn.up as sharing ffn.gate's compressed state when both sites of
    a block carry the same non-exact policy (they read the same x — the
    paper's Fig.-2 sharing). Telemetry and memory reports then attribute
    the one state to ffn.gate instead of double-counting."""
    by_path = {s.path: s for s in sites}
    out = []
    for s in sites:
        if s.path.endswith("ffn.up") and not s.is_exact:
            gate = by_path.get(s.path[: -len("ffn.up")] + "ffn.gate")
            if gate is not None and gate.policy == s.policy:
                s = dataclasses.replace(s, shared_with=gate.path)
        out.append(s)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    """Per-site policies bound to one architecture."""

    sites: tuple[CompressedSite, ...]
    plan: CompressionPlan | None = None
    cache_sites: tuple[CacheSite, ...] = ()

    def __post_init__(self):
        lookup = {}
        for s in self.sites:
            lookup[s.path] = s
        object.__setattr__(self, "_lookup", lookup)

    def site(self, stage: int, kind: str, role: str) -> CompressedSite | None:
        if stage < 0:
            return self._lookup.get(role)
        return self._lookup.get(f"stage{stage}.{kind}.{role}")

    def cache_format(self, stage: int, kind: str) -> CacheFormat | None:
        """The stored KV format of (stage, kind)'s cache group, or None
        when the group keeps the base dtype (no site, or kind=none)."""
        path = f"stage{stage}.{kind}.cache.kv"
        for cs in self.cache_sites:
            if cs.path == path and cs.fmt.is_compressed:
                return cs.fmt
        return None

    @property
    def compressed_cache_sites(self) -> tuple[CacheSite, ...]:
        return tuple(cs for cs in self.cache_sites if cs.fmt.is_compressed)

    def head_site(self) -> CompressedSite | None:
        return self._lookup.get("lm_head")

    @property
    def compressed_sites(self) -> tuple[CompressedSite, ...]:
        return tuple(s for s in self.sites if not s.is_exact)

    def with_site_key_fn(self, key_fn) -> "ResolvedPlan":
        """A copy whose sites derive their keys with ``key_fn(key,
        site_id)`` instead of ``key.fold_in(site_id)``: the mesh executor
        hands each shard the stream of its block of the blocked
        single-process compress."""
        return ResolvedPlan(
            sites=tuple(dataclasses.replace(s, key_fn=key_fn) for s in self.sites),
            plan=self.plan,
            cache_sites=self.cache_sites,
        )

    def map_policies(self, fn) -> "ResolvedPlan":
        """A copy with ``fn(policy)`` applied to every non-exact site's
        policy (e.g. localizing blocked PAMM to per-shard blocks)."""
        return ResolvedPlan(
            sites=tuple(
                s if s.is_exact else dataclasses.replace(s, policy=fn(s.policy))
                for s in self.sites
            ),
            plan=self.plan,
            cache_sites=self.cache_sites,
        )

    def zero_telemetry(self, device="cpu") -> dict[str, torch.Tensor]:
        """Fresh telemetry accumulator: one STATS_LEN f32 vector per
        compressed site, on ``device``. Sites sharing another site's state
        (shared_with) have no entry — their stats live on the owning site."""
        return {
            s.path: torch.zeros((STATS_LEN,), dtype=torch.float32, device=device)
            for s in self.compressed_sites
            if s.shared_with is None
        }

    def ctx(self, stage: int, kind: str, tele: dict | None, mode=None) -> "SiteCtx":
        return SiteCtx(self, stage, kind, tele, mode)

    def describe(self) -> str:
        lines = []
        for s in self.sites:
            lines.append(f"{s.path:40s} -> {s.policy.name}"
                         + ("" if s.is_exact else f" {s.policy}"))
        for cs in self.cache_sites:
            lines.append(f"{cs.path:40s} -> {cs.fmt}")
        return "\n".join(lines)


class SiteCtx:
    """Runtime handle given to a block: site lookup + telemetry recording.

    The telemetry dict is updated in place, so per-layer contributions
    accumulate over the layer loop. A ``None`` resolved plan (or missing
    site) degrades to exact matmuls — that is the decode/prefill path.
    ``mode``: the :class:`core.linear.SiteMode` of a region that runs twice
    (a rematerialised layer, a reversible stage), handed to every site.
    """

    __slots__ = ("resolved", "stage", "kind", "tele", "mode")

    def __init__(self, resolved: ResolvedPlan | None, stage: int, kind: str,
                 tele: dict | None, mode=None):
        self.resolved = resolved
        self.stage = stage
        self.kind = kind
        self.tele = tele
        self.mode = mode

    def site(self, role: str) -> CompressedSite | None:
        if self.resolved is None:
            return None
        return self.resolved.site(self.stage, self.kind, role)

    def record(self, site: CompressedSite, stats) -> None:
        if self.tele is not None and stats is not None and site.path in self.tele:
            self.tele[site.path] = self.tele[site.path] + stats

    def apply(self, role: str, x, w, bias, key=None, split=None):
        """``split``: the model group of a row-parallel site's input slice
        (``CompressedSite.apply_shared``)."""
        site = self.site(role)
        if site is None:
            lead = x.shape[:-1]
            return _exact_linear(x.reshape(-1, w.shape[0]), w, bias).reshape(
                *lead, w.shape[1]
            )
        z, stats = site.apply(x, w, bias, key, self.mode, split)
        self.record(site, stats)
        return z

    def apply_shared(self, role: str, x, ws, biases, key=None):
        site = self.site(role)
        if site is None:
            lead = x.shape[:-1]
            x2d = x.reshape(-1, ws[0].shape[0])
            return [
                _exact_linear(x2d, w, b).reshape(*lead, w.shape[1])
                for w, b in zip(ws, biases)
            ]
        outs, stats = site.apply_shared(x, ws, biases, key, self.mode)
        self.record(site, stats)
        return outs


def exact_ctx() -> SiteCtx:
    """A context that applies every projection exactly (decode/prefill)."""
    return SiteCtx(None, -1, "head", None)


# ---------------------------------------------------------------------------
# legacy RunConfig shim
# ---------------------------------------------------------------------------
def _fmt(v: float) -> str:
    if v == math.inf:
        return "inf"
    return repr(float(v))


def plan_spec_from_legacy(rcfg) -> str:
    """Map the deprecated flat RunConfig knobs onto an equivalent plan spec.

    The five legacy fields (``policy_name``/``pamm_ratio``/``pamm_eps`` plus
    ``use_kernel``, ``pamm_blocks``, ``pamm_k_max``, ``pamm_on_recurrent``,
    ``pamm_on_ssm_inproj``) become explicit rules, so the resolved per-site
    policies match what the JAX package's legacy dispatch produced.
    """
    name = getattr(rcfg, "policy_name", "none")
    if name == "pamm":
        args = [f"r={_fmt(rcfg.pamm_ratio)}", f"eps={_fmt(rcfg.pamm_eps)}"]
        args.append(f"backend={'pallas' if rcfg.use_kernel else 'jnp'}")
        args.append(f"blocks={int(rcfg.pamm_blocks)}")
        if rcfg.pamm_k_max is not None:
            args.append(f"k_max={int(rcfg.pamm_k_max)}")
        expr = "pamm(" + ",".join(args) + ")"
    elif name in ("uniform_crs", "compact"):
        expr = f"{name}(r={_fmt(rcfg.pamm_ratio)})"
    else:
        expr = "none"
    if expr == "none":
        return ""
    rules = [f"attn.*={expr}"]  # attn.qkv + attn.cross_kv (when present)
    if getattr(rcfg, "pamm_on_recurrent", False):
        rules.append(f"rglru.in={expr}")
    if getattr(rcfg, "pamm_on_ssm_inproj", False):
        rules.append(f"ssm.in={expr}")
    return ";".join(rules)


def cache_plan_from_spec(spec: str) -> CompressionPlan:
    """Parse a cache-compression spec. Accepts the full rule grammar
    (``cache.kv=int8;swa/cache.kv=none``) plus the bare-policy shorthand
    the CLI uses (``int8``, ``int4(group=64)``, ``svd(r=1/4)`` — sugar for
    ``cache.kv=<policy>``)."""
    spec = (spec or "").strip()
    if spec and "=" not in spec.split("(", 1)[0]:
        spec = f"cache.kv={spec}"
    return CompressionPlan.parse(spec)


def make_run_plan(rcfg) -> CompressionPlan:
    """The canonical RunConfig -> plan entry point.

    ``rcfg.compression`` (a plan spec string) wins; when empty, the legacy
    flat flags are translated via :func:`plan_spec_from_legacy`.
    """
    spec = getattr(rcfg, "compression", "") or plan_spec_from_legacy(rcfg)
    return CompressionPlan.parse(spec)


def resolved_from_policy(policy: CompressionPolicy, cfg, rcfg) -> ResolvedPlan:
    """Wrap one legacy global policy object as a resolved plan.

    Attention roles get the policy; RG-LRU / SSM inputs only behind their
    opt-in flags; everything else exact (the JAX package's legacy
    dispatch).
    """
    on_rec = getattr(rcfg, "pamm_on_recurrent", False)
    on_ssm = getattr(rcfg, "pamm_on_ssm_inproj", False)
    exact = isinstance(policy, ExactPolicy)
    sites = []
    for sid, site in enumerate(enumerate_sites(cfg)):
        pol = _EXACT
        if not exact:
            if site.role in ("attn.qkv", "attn.cross_kv"):
                pol = policy
            elif site.role == "rglru.in" and on_rec:
                pol = policy
            elif site.role == "ssm.in" and on_ssm:
                pol = policy
        sites.append(
            CompressedSite(
                path=site.path, site_id=sid, policy=pol,
                n_in=site.n_in, multiplicity=site.multiplicity,
            )
        )
    return ResolvedPlan(sites=_link_shared_sites(sites))


def as_resolved(plan, cfg, rcfg) -> ResolvedPlan:
    """Normalize anything callers may pass as 'the plan'.

    Accepts a ResolvedPlan, a CompressionPlan, a spec string, a legacy
    CompressionPolicy object, or None (derive from ``rcfg``).
    """
    if isinstance(plan, ResolvedPlan):
        return plan
    if isinstance(plan, CompressionPlan):
        return plan.resolve(cfg)
    if isinstance(plan, str):
        return CompressionPlan.parse(plan).resolve(cfg)
    if plan is None:
        return make_run_plan(rcfg).resolve(cfg)
    if isinstance(plan, CompressionPolicy):
        return resolved_from_policy(plan, cfg, rcfg)
    raise TypeError(f"cannot interpret {type(plan).__name__} as a compression plan")


def resolve_for_run(cfg, rcfg, mesh=None) -> ResolvedPlan:
    """The run's plan bound to ``cfg`` -- and to ``mesh`` when given, so
    ``blocks=auto`` is the mesh's data x context degree."""
    resolved = make_run_plan(rcfg).resolve(cfg, mesh)
    if getattr(rcfg, "moe_token_blocks", 1) > 1:
        # the blocked (2D DP x EP) MoE dispatch path runs without
        # compression; surface the downgrade here, visibly. Only the sites
        # inside the MoE FFN are affected.
        hot = [
            s.path for s in resolved.compressed_sites
            if re.match(r"stage\d+\.moe\.(moe\.expert$|ffn\.)", s.path)
        ]
        if hot:
            warnings.warn(
                f"moe_token_blocks={rcfg.moe_token_blocks} > 1: the blocked "
                f"MoE dispatch path does not compress MoE-block sites; "
                f"{hot} will train exact this run",
                stacklevel=2,
            )
    return resolved
