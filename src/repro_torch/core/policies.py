"""Activation-compression policies (``repro/core/policies.py``).

Every policy answers three questions about a linear layer ``Z = X W``:

  * ``compress(x2d, key)``   -> what do we *store* instead of X?
  * ``grad_w(state, gz2d)``  -> how do we rebuild ``grad_W ~ X^T dZ``?
  * ``stored_elements(b,n)`` -> how many scalars does the state cost?

Policies (all from the paper):
  * ``pamm``        -- the paper's contribution (eps = inf by default);
                       compress / apply run K1 / K2 on a CUDA tensor.
  * ``uniform_crs`` -- PAMM with eps = 0: keep only the k sampled rows,
                       de-biased by beta = b/k.
  * ``compact``     -- CompAct: Gaussian sketch X P along the hidden axis,
                       E[P P^T] = I. P is drawn from the site's key, so a
                       caller injects it through the key's sampler.
  * ``none``        -- exact training: store X itself.

CRS and CompAct have no Pallas kernel in the JAX package and stay torch
ops here. ``key`` is a :class:`repro_torch.core.keys.Key`.

``compress_split(x_local, key, mg)`` serves a compressed row-parallel
site under tensor parallelism: each rank of the model group ``mg`` holds
a column slice of the rows, draws what one process draws from the same
key, and keeps the state whose :meth:`CompressionPolicy.grad_w` is its
rows of the weight gradient (PAMM: K1's split route, one all-reduce of
the dot products; CRS: its slice of the sampled rows; CompAct: its rows
of the projection, the sketch summed over the group).

The ``*_batched`` methods serve the MoE site (one state per expert, the
JAX package's ``vmap`` over experts): inputs carry a leading expert axis
and so do the state's leaves. The base class loops over the experts; PAMM
compresses and applies every expert in one K1 / K2 launch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import pamm as pamm_lib
from repro_torch.runtime.collectives import model_sum_

__all__ = [
    "CompressionPolicy",
    "PammPolicy",
    "UniformCRSPolicy",
    "CompActPolicy",
    "ExactPolicy",
    "make_policy",
]


def _tensor_bytes(state) -> int:
    leaves = state if isinstance(state, tuple) else (state,)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _stack_states(states: list):
    """Per-expert states -> one state whose leaves carry the expert axis
    (tensors stacked, other leaves -- a CompAct key -- listed)."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    leaves = zip(*states)
    return type(first)(*(torch.stack(list(ls)) if isinstance(ls[0], torch.Tensor)
                         else list(ls) for ls in leaves))


def _state_at(state, e: int):
    """Expert ``e``'s state of a batched one."""
    if isinstance(state, torch.Tensor):
        return state[e]
    return type(state)(*(leaf[e] for leaf in state))


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Base class. Frozen and hashable, like the JAX policies."""

    name: str = "base"

    def compress(self, x2d: torch.Tensor, key) -> Any:
        raise NotImplementedError

    def grad_w(self, state: Any, gz2d: torch.Tensor, n: int) -> torch.Tensor:
        """Approximate X^T dZ (f32). ``n`` is the hidden width of X."""
        raise NotImplementedError

    def stored_elements(self, b: int, n: int) -> int:
        raise NotImplementedError

    def state_stats(self, state: Any, b: int) -> tuple[Any, Any]:
        """(kept_rows, beta) telemetry read off a compressed state.
        Defaults: every row contributes, no de-bias scaling."""
        del state
        return float(b), 1.0

    def stored_bytes(self, state: Any) -> int:
        """Bytes the state holds for backward (its tensors)."""
        return _tensor_bytes(state)

    def compress_split(self, x2d: torch.Tensor, key, mg) -> Any:
        """The state of rows split by columns over the model group ``mg``
        (module docstring), ``x2d`` this rank's (b, n / tp) slice."""
        raise NotImplementedError(f"policy {self.name!r} has no row-parallel route")

    def split_bytes(self, state: Any) -> int:
        """Bytes of a :meth:`compress_split` state that hold this rank's
        column slice; the model ranks' slices together are tp times these."""
        del state
        return 0

    def compress_batched(self, xs: torch.Tensor, keys) -> Any:
        """One state per expert of ``xs (E, b, n)``, expert e's from
        ``keys[e]``; the leaves carry the expert axis."""
        return _stack_states([self.compress(x, key) for x, key in zip(xs, keys)])

    def grad_w_batched(self, state: Any, gz: torch.Tensor, n: int) -> torch.Tensor:
        """(E, n, m) f32: each expert's :meth:`grad_w`."""
        return torch.stack([self.grad_w(_state_at(state, e), gz[e], n)
                            for e in range(gz.shape[0])])

    def batched_stats(self, state: Any, b: int, n_experts: int) -> tuple[Any, Any, int]:
        """(kept_rows, beta, stored_bytes), each summed over the experts of
        a batched state (the JAX package sums the experts' telemetry)."""
        per = [_state_at(state, e) for e in range(n_experts)]
        stats = [self.state_stats(s, b) for s in per]
        return (sum(k for k, _ in stats), sum(beta for _, beta in stats),
                sum(self.stored_bytes(s) for s in per))


@dataclasses.dataclass(frozen=True)
class ExactPolicy(CompressionPolicy):
    name: str = "none"

    def compress(self, x2d, key):
        del key
        return x2d

    def grad_w(self, state, gz2d, n):
        del n
        return state.float().T @ gz2d.float()

    def stored_elements(self, b, n):
        return b * n


@dataclasses.dataclass(frozen=True)
class PammPolicy(CompressionPolicy):
    """Paper default: r down to 1/512, eps = inf (§4.1).

    n_blocks > 1 switches to shard-local (blocked) PAMM; k_max caps the
    generators per block; block_share is the per-shard view of a blocked
    global run (``repro/core/policies.py:PammPolicy``). The JAX policy's
    ``use_kernel`` has no counterpart: the tensor's device picks the
    kernel or its plain version."""

    name: str = "pamm"
    ratio: float = 1.0 / 512.0
    eps: float = math.inf
    n_blocks: int = 1
    k_max: int | None = None
    block_share: int = 1

    def k_for(self, b: int) -> int:
        f = max(1, self.block_share)
        k = pamm_lib.num_generators(b * f, self.ratio)
        if self.k_max is not None:
            nb = max(1, self.n_blocks) * f
            k = min(k, max(nb, self.k_max * nb))
        return max(1, k // f)

    def compress(self, x2d, key):
        k = self.k_for(x2d.shape[0])
        if self.n_blocks > 1:
            return pamm_lib.pamm_compress_blocked(x2d, k, self.eps, key, self.n_blocks)
        return pamm_lib.pamm_compress(x2d, k, self.eps, key)

    def compress_split(self, x2d, key, mg):
        k = self.k_for(x2d.shape[0])
        sum_ = lambda t: model_sum_(t, mg)
        if self.n_blocks > 1:
            return pamm_lib.pamm_compress_blocked(x2d, k, self.eps, key, self.n_blocks,
                                                  reduce_=sum_)
        return pamm_lib.pamm_compress(x2d, k, self.eps, key, reduce_=sum_)

    def split_bytes(self, state):
        return _tensor_bytes(state.generators)

    def grad_w(self, state, gz2d, n):
        del n
        if state.alpha.dim() == 2:
            return pamm_lib.pamm_apply_blocked(state, gz2d)
        return pamm_lib.pamm_apply(state, gz2d)

    def stored_elements(self, b, n):
        return pamm_lib.stored_elements(b, n, self.k_for(b))

    def state_stats(self, state, b):
        # alpha != 0 marks rows that contribute: eps survivors, excluding
        # all-zero rows (padding), which never contribute
        kept = (state.alpha != 0).float().sum()
        return kept, state.beta.float().mean()

    def compress_batched(self, xs, keys):
        """Every expert in one K1 launch. Blocked: each expert's rows split
        into ``n_blocks`` blocks drawn from ``keys[e].split(n_blocks)`` (as
        :func:`pamm_lib.pamm_compress_blocked` per expert), all E x blocks
        problems in one launch; leaves (E, S, ...)."""
        E, b, n = xs.shape
        k = self.k_for(b)
        if self.n_blocks <= 1:
            return pamm_lib.pamm_compress_batched(xs, k, self.eps, keys)
        s = self.n_blocks if b % self.n_blocks == 0 else 1
        sub = [kb for key in keys for kb in (key.split(s) if s > 1 else [key])]
        st = pamm_lib.pamm_compress_batched(xs.reshape(E * s, b // s, n),
                                            max(1, k // s), self.eps, sub)
        return pamm_lib.PammState(*(leaf.reshape(E, s, *leaf.shape[1:]) for leaf in st))

    def grad_w_batched(self, state, gz, n):
        if state.alpha.dim() == 2:
            return pamm_lib.pamm_apply_batched(state, gz)
        E, s, b_loc = state.alpha.shape
        flat = pamm_lib.PammState(*(leaf.reshape(E * s, *leaf.shape[2:]) for leaf in state))
        parts = pamm_lib.pamm_apply_batched(flat, gz.reshape(E * s, b_loc, gz.shape[-1]))
        parts = parts.view(E, s, *parts.shape[1:])
        out = parts[:, 0]
        for i in range(1, s):      # the blocks in order, as pamm_apply_blocked sums them
            out = out + parts[:, i]
        return out

    def batched_stats(self, state, b, n_experts):
        kept = (state.alpha != 0).float().sum()
        beta = state.beta.float().reshape(n_experts, -1).mean(1).sum()
        return kept, beta, _tensor_bytes(state)


class _CRSState(NamedTuple):
    rows: torch.Tensor  # (k, n) sampled rows of X
    idx: torch.Tensor   # (k,)   their positions in [b], int32


@dataclasses.dataclass(frozen=True)
class UniformCRSPolicy(CompressionPolicy):
    """Column-row sampling: grad_W ~ (b/k) * X[I]^T dZ[I] (PAMM @ eps=0)."""

    name: str = "uniform_crs"
    ratio: float = 1.0 / 512.0

    def k_for(self, b: int) -> int:
        return pamm_lib.num_generators(b, self.ratio)

    def compress(self, x2d, key):
        b = x2d.shape[0]
        idx = key.choice(b, self.k_for(b), x2d.device)
        return _CRSState(x2d.index_select(0, idx), idx.to(torch.int32))

    def compress_split(self, x2d, key, mg):
        del mg      # the same rows on every rank: its slice of them
        return self.compress(x2d, key)

    def split_bytes(self, state):
        return _tensor_bytes(state.rows)

    def grad_w(self, state, gz2d, n):
        del n
        b = gz2d.shape[0]
        k = state.idx.shape[0]
        gsel = gz2d.float().index_select(0, state.idx.long())
        return (b / k) * (state.rows.float().T @ gsel)

    def stored_elements(self, b, n):
        return self.k_for(b) * (n + 1)

    def state_stats(self, state, b):
        k = state.idx.shape[-1]
        return float(k), b / k


class _CompActState(NamedTuple):
    sketch: torch.Tensor  # (b, kp) = X P
    key: Any              # the site key; P is drawn again in backward
    # a split state's (first row, whole n) of P: this rank's rows of it
    rows: Any = None


# bytes of the key JAX keeps in a CompAct state (threefry key data, two
# uint32 words): counted so stored-bytes telemetry matches the JAX package
_KEY_DATA_BYTES = 8


@dataclasses.dataclass(frozen=True)
class CompActPolicy(CompressionPolicy):
    """CompAct: X~ = X P, P ~ N(0, 1/kp), E[P P^T] = I_n; grad_W ~ P (X~^T
    dZ). P is ``key.normal((n, kp)) / sqrt(kp)``, drawn again in backward
    from the stored key (the key's sampler injects it)."""

    name: str = "compact"
    ratio: float = 1.0 / 4.0  # over the hidden axis: kp = ceil(ratio * n)

    def kp_for(self, n: int) -> int:
        return max(1, min(n, math.ceil(self.ratio * n)))

    def _proj(self, key, n: int, kp: int, device) -> torch.Tensor:
        return key.normal((n, kp), device) / math.sqrt(kp)

    def compress(self, x2d, key):
        n = x2d.shape[1]
        p = self._proj(key, n, self.kp_for(n), x2d.device)
        return _CompActState(x2d.float() @ p, key)

    def compress_split(self, x2d, key, mg):
        """P drawn whole (n, kp), kp of the whole n; this rank's rows of it,
        the sketch ``x_local P_local`` summed over the group."""
        n_loc = x2d.shape[1]
        n, start = n_loc * mg.tp, mg.index * n_loc
        p = self._proj(key, n, self.kp_for(n), x2d.device)[start:start + n_loc]
        return _CompActState(model_sum_(x2d.float() @ p, mg), key, (start, n))

    def grad_w(self, state, gz2d, n):
        kp = state.sketch.shape[1]
        if state.rows is None:
            p = self._proj(state.key, n, kp, gz2d.device)
        else:
            start, whole = state.rows
            p = self._proj(state.key, whole, kp, gz2d.device)[start:start + n]
        return p @ (state.sketch.T @ gz2d.float())

    def stored_elements(self, b, n):
        return b * self.kp_for(n)

    def stored_bytes(self, state):
        return _tensor_bytes(state) + _KEY_DATA_BYTES


_REGISTRY = {
    "pamm": PammPolicy,
    "uniform_crs": UniformCRSPolicy,
    "compact": CompActPolicy,
    "none": ExactPolicy,
}


def make_policy(name: str, **kwargs) -> CompressionPolicy:
    if name not in _REGISTRY:
        raise ValueError(f"unknown compression policy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
