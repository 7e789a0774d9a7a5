"""Compressed linear layer (paper Alg. 2/3) as a ``torch.autograd.Function``,
the port of ``repro/core/linear.py``.

The compressed state is computed outside the Function (from a detached
x, under ``no_grad``) and handed in, so the Function saves exactly
``(w, state)`` for backward -- x itself is never saved, which is the
paper's memory claim in PyTorch terms (``saved_tensors_hooks`` sees no
(b, n) tensor). The forward output is the exact ``x @ w (+ bias)``;
``grad_x`` and ``grad_bias`` are exact, and only ``grad_w`` is the
policy's estimate. Without autograd (serving) nothing is saved, so a site
skips compression altogether: the JAX package gets the same by dead-code
elimination.

A region that runs twice -- a rematerialised layer, recomputed in backward,
or a reversible stage, whose backward re-runs each sublayer -- hands its
sites a :class:`SiteMode`. It says whether the recompute takes the states
the first run compressed (``remat='pamm'``, the JAX package's
``save_only_these_names('pamm_state')``) or compresses again from the same
key (``remat='full'``, reversible), and it keeps telemetry to the first run.

Under tensor parallelism a column-parallel site (``attn.qkv``,
``ffn.gate`` / ``ffn.up``, ``lm_head``, and ``attn.cross_kv`` over the
whole image rows) is handed the whole input and this rank's columns of
``w``: every model rank derives the same site key
(``train/distributed.py`` keeps the model coordinate out of it), so K1
yields the same state on each, K2 takes the rank's columns of dZ, and the
input's gradient is summed over the model group by the caller's
``runtime.collectives.copy_to_model``. A compressed row-parallel site
(``ffn.down``) is handed this rank's column slice of its input and its
rows of ``w`` (``split``: the model group): the policy's
``compress_split`` draws the same rows on every rank and completes what
needs the whole row over the group (PAMM: K1's split route, whose one
all-reduce sums the slices' dot products), so alpha, assign and beta are
the single process's on every rank, and ``grad_w`` gives this rank's rows.
Its telemetry counts the generators' slices summed over the group.
``apply_batched`` under expert parallelism (``experts``) compresses a
rank's share of the experts, each from the key one process gives it.

Weights keep the JAX layout ``w (n_in, n_out)`` applied as ``x @ w``.
``apply_batched`` (the MoE experts) takes ``xs (E, T, n)`` and ``w (E, n,
m)`` and keeps one state per expert, all compressed in one K1 launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.core.policies import CompressionPolicy, ExactPolicy

__all__ = ["CompressedSite", "SiteMode", "STATS_LEN"]

# Per-site telemetry vector layout (summed over layers):
#   [stored_bytes, kept_rows, total_rows, beta_sum, n_observations]
STATS_LEN = 5


def _exact_linear(x2d, w, bias):
    z2d = x2d @ w.to(x2d.dtype)
    if bias is not None:
        z2d = z2d + bias.to(z2d.dtype)
    return z2d


def _leaves(state) -> tuple:
    return tuple(state) if isinstance(state, tuple) else (state,)


_TENSOR = object()   # a state leaf saved through save_for_backward


class _CompressedMatmul(torch.autograd.Function):
    """``x2d @ w (+ bias)`` whose backward reads only ``(w, state)``;
    ``batched``: the experts' ``xs (E, T, n) @ w (E, n, m)``, no bias."""

    @staticmethod
    def forward(ctx, x2d, w, bias, policy, state, batched=False):
        leaves = _leaves(state)
        ctx.save_for_backward(w, *(t for t in leaves if isinstance(t, torch.Tensor)))
        # the state's structure and its non-tensor leaves (a CompAct key)
        ctx.rebuild = (type(state) if isinstance(state, tuple) else None,
                       [_TENSOR if isinstance(t, torch.Tensor) else t for t in leaves])
        ctx.policy, ctx.has_bias, ctx.batched = policy, bias is not None, batched
        if batched:
            return torch.bmm(x2d, w.to(x2d.dtype))
        return _exact_linear(x2d, w, bias)

    @staticmethod
    def backward(ctx, g):
        w, *tensors = ctx.saved_tensors
        kind, slots = ctx.rebuild
        it = iter(tensors)
        leaves = [next(it) if s is _TENSOR else s for s in slots]
        state = kind(*leaves) if kind is not None else leaves[0]
        dx = (g @ w.transpose(-2, -1).to(g.dtype)) if ctx.needs_input_grad[0] else None
        if ctx.batched:
            dw = ctx.policy.grad_w_batched(state, g, w.shape[-2]).to(w.dtype)
        else:
            dw = ctx.policy.grad_w(state, g, w.shape[0]).to(w.dtype)
        dbias = g.sum(0).to(w.dtype) if ctx.has_bias else None
        return dx, dw, dbias, None, None, None


def _stats_vector(stored, kept, rows, beta, n, device) -> torch.Tensor:
    """[stored_bytes, kept_rows, rows, beta, n_observations] as STATS_LEN
    f32 on ``device``, filled in place so that nothing waits for the card
    (kept and beta may be tensors on it)."""
    out = torch.empty(STATS_LEN, dtype=torch.float32, device=device)
    out[0] = float(stored)
    out[1] = kept
    out[2] = float(rows)
    out[3] = beta
    out[4] = float(n)
    return out


def _state_stats(policy: CompressionPolicy, state, b: int, device, tp: int = 1) -> torch.Tensor:
    """Telemetry vector of one compressed state: [stored_bytes,
    kept_rows, b, beta, 1]; ``tp``: the model degree a split state's
    column slices are summed over."""
    kept, beta = policy.state_stats(state, b)
    stored = policy.stored_bytes(state) + (tp - 1) * policy.split_bytes(state)
    return _stats_vector(stored, kept, b, beta, 1, device)


def _batched_stats(policy: CompressionPolicy, state, b: int, n_experts: int,
                   device) -> torch.Tensor:
    """Telemetry of a batched (per-expert) state: the experts' vectors
    summed, [stored_bytes, kept_rows, E b, beta summed, E]."""
    kept, beta, stored = policy.batched_stats(state, b, n_experts)
    return _stats_vector(stored, kept, n_experts * b, beta, n_experts, device)


class SiteMode:
    """How the compressed sites of one region behave when it runs twice.

    ``keep_states``: the first run records each state, in call order, and
    the recompute takes them back in the same order instead of
    compressing (``remat='pamm'``); otherwise the recompute compresses
    again from the same key, which gives the same state.
    ``stats_without_grad``: the first run compresses for its telemetry
    although autograd is off (a reversible stage's forward, which saves no
    state). The recompute runs inside the mode (``with mode:``, the
    context ``torch.utils.checkpoint`` enters around its recompute) and
    reports no telemetry. One mode serves one region of one step: it
    holds that region's states until autograd frees the region's graph."""

    def __init__(self, *, keep_states: bool = False, stats_without_grad: bool = False):
        self.keep_states = keep_states
        self.stats_without_grad = stats_without_grad
        self.recomputing = False
        self._states: list = []
        self._pos = 0

    def __enter__(self):
        self.recomputing, self._pos = True, 0
        return self

    def __exit__(self, *exc):
        self.recomputing = False

    def checkpoint_contexts(self):
        """``context_fn`` of ``torch.utils.checkpoint``: (forward, recompute)."""
        return contextlib.nullcontext(), self

    def compress(self, policy: CompressionPolicy, x2d, key, batched: bool = False,
                 split=None):
        """``batched``: x2d is the experts' (E, b, n) and key their keys;
        ``split``: the model group of a row-parallel site's slice."""
        if self.recomputing and self.keep_states:
            state = self._states[self._pos]
            self._pos += 1
            return state
        state = _compress(policy, x2d, key, split) if not batched else \
            policy.compress_batched(x2d, key)
        if self.keep_states:
            self._states.append(state)
        return state


def _compress(policy: CompressionPolicy, x2d, key, split):
    return policy.compress(x2d, key) if split is None else policy.compress_split(x2d, key, split)


def _wants_grad(x, ws, biases) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *ws, *biases))


@dataclasses.dataclass(frozen=True)
class CompressedSite:
    """One resolved compression site: (path, id, policy).

    The single runtime entry point for compressed projections. It owns the
    site's key -- ``key.fold_in(site_id)`` of the per-block key -- and
    reports per-site telemetry (stored bytes, kept-row fraction, beta).
    ``shared_with`` names a sibling whose compressed state backs this site
    too (ffn.up sharing ffn.gate's state, Fig. 2)."""

    path: str
    site_id: int
    policy: CompressionPolicy
    n_in: int = 0
    multiplicity: int = 1
    shared_with: str | None = None
    # ``key_fn(key, site_id)`` in place of ``key.fold_in(site_id)``: the
    # mesh executor (train/distributed.py) gives each (data, context) shard
    # the key of its block of the blocked single-process compress. Not part
    # of the site's identity.
    key_fn: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_exact(self) -> bool:
        return isinstance(self.policy, ExactPolicy)

    def derive_key(self, key):
        if key is None:
            return None
        if self.key_fn is not None:
            return self.key_fn(key, self.site_id)
        return key.fold_in(self.site_id)

    def apply(self, x, w, bias, key, mode: SiteMode | None = None, split=None):
        """``x @ w (+ bias)`` under this site's policy: (z, stats), stats
        None when nothing was compressed."""
        (z,), stats = self.apply_shared(x, [w], [bias], key, mode, split)
        return z, stats

    def apply_shared(self, x, ws, biases, key, mode: SiteMode | None = None, split=None):
        """Several projections of one input sharing ONE compressed state
        (paper Fig. 2: Q, K, V all read the same X). ``mode``: the
        :class:`SiteMode` of a region that runs twice; ``split``: the
        model group whose ranks each hold a column slice of x, this rank's
        rows of the ws (a row-parallel site, module docstring)."""
        n = ws[0].shape[0]
        lead = x.shape[:-1]
        x2d = x.reshape(-1, n)
        grad = _wants_grad(x, ws, biases)
        for_stats = mode is not None and mode.stats_without_grad and not mode.recomputing
        if self.is_exact or not (grad or for_stats):
            outs = [_exact_linear(x2d, w, b).reshape(*lead, w.shape[1])
                    for w, b in zip(ws, biases)]
            return outs, None
        site_key = self.derive_key(key)
        if site_key is None:
            raise ValueError(f"site {self.path!r} ({self.policy.name}) needs a key")
        with torch.no_grad():
            x_in = x2d.detach()
            state = (_compress(self.policy, x_in, site_key, split) if mode is None
                     else mode.compress(self.policy, x_in, site_key, split=split))
        if grad:
            outs = [_CompressedMatmul.apply(x2d, w, b, self.policy, state).reshape(
                        *lead, w.shape[1]) for w, b in zip(ws, biases)]
        else:
            outs = [_exact_linear(x2d, w, b).reshape(*lead, w.shape[1])
                    for w, b in zip(ws, biases)]
        if mode is not None and mode.recomputing:
            return outs, None
        return outs, _state_stats(self.policy, state, x2d.shape[0], x.device,
                                  1 if split is None else split.tp)

    def apply_batched(self, xs, ws, key, mode: SiteMode | None = None, experts=None):
        """The MoE experts: ``xs (E, T, n)``, each w in ws ``(E, n, m)``,
        returns ``([z (E, T, m)...], stats)``. One compressed state per
        expert, shared by the ws (gate and up), expert e's drawn from
        ``key.fold_in(site_id).split(E)[e]`` (``jax.random.split(site_key,
        e)``); all experts compress in one K1 launch and each weight's
        gradient runs one K2 launch. Stats are summed over the experts.
        ``experts``: (first, E') when xs holds experts [first, first + E)
        of E' (a rank's share under expert parallelism); their keys are
        those experts' of ``split(E')``."""
        grad = _wants_grad(xs, ws, ())
        for_stats = mode is not None and mode.stats_without_grad and not mode.recomputing
        if self.is_exact or not (grad or for_stats):
            return [torch.bmm(xs, w.to(xs.dtype)) for w in ws], None
        site_key = self.derive_key(key)
        if site_key is None:
            raise ValueError(f"site {self.path!r} ({self.policy.name}) needs a key")
        first, total = experts if experts is not None else (0, xs.shape[0])
        keys = site_key.split(total)[first:first + xs.shape[0]]
        with torch.no_grad():
            x_in = xs.detach()
            state = (self.policy.compress_batched(x_in, keys) if mode is None
                     else mode.compress(self.policy, x_in, keys, batched=True))
        if grad:
            outs = [_CompressedMatmul.apply(xs, w, None, self.policy, state, True)
                    for w in ws]
        else:
            outs = [torch.bmm(xs, w.to(xs.dtype)) for w in ws]
        if mode is not None and mode.recomputing:
            return outs, None
        return outs, _batched_stats(self.policy, state, xs.shape[1], xs.shape[0], xs.device)
