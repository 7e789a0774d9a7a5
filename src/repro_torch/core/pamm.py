"""PAMM -- Point-Approximate Matrix Multiplication (paper §3.2, Alg. 1),
the port of ``repro/core/pamm.py``.

PAMM approximates ``O = A^T B`` (``A: (b, n)``, ``B: (b, m)``) by
compressing ``A`` into ``k = ceil(r * b)`` generators (rows sampled
uniformly without replacement) plus a coefficient and an index per row:

    f(i)    = argmax_j |csim(A_i, C_j)|              (Lemma 1)
    alpha_i = csim(A_i, C_{f(i)}) * ||A_i|| / ||C_{f(i)}||
    O ~ beta * C^T @ Btilde,   Btilde_j = sum_{i: f(i)=j} alpha_i * B_i

with the neighbourhood test ``csim^2 >= 1 - eps^2`` and the de-bias
``beta = b / (b - eta)`` over rows that can contribute (see the JAX
module). Compress and apply run through :mod:`repro_torch.kernels.ops`, so
a CUDA tensor always reaches K1 (csim arg-max) and K2 (segment sum), and a
CPU tensor their plain versions. The generators are ``A[idx]`` in A's
dtype, as in the JAX package's kernel path (``kernels/ops.py``): in
bfloat16 the stored state is bfloat16, where ``repro/core/pamm.py`` keeps
f32 rows.

The draw of generator rows is injectable: ``idx`` given, or drawn from
``key`` (:class:`repro_torch.core.keys.Key`). ``reduce_`` compresses rows
split by columns over the ranks of a model group (a row-parallel site):
each rank passes its slice, the same rows are drawn on every rank, and
K1's split route sums the slices' dot products and row norms with
``reduce_`` between its two passes (``kernels/ops.pamm_compress_split``). The blocked (shard-local)
variants loop over the blocks where JAX uses ``vmap``. The batched
variants (the MoE site's experts, ``vmap`` over experts in the JAX
package) take a leading expert axis and run one K1 / K2 launch for all
experts.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.keys import choice_batched

__all__ = [
    "PammState",
    "num_generators",
    "pamm_compress",
    "pamm_apply",
    "pamm_compress_blocked",
    "pamm_apply_blocked",
    "pamm_compress_batched",
    "pamm_apply_batched",
    "pamm_reconstruct",
    "stored_elements",
]


class PammState(NamedTuple):
    """Compressed representation of A (the saved-for-backward payload)."""

    generators: torch.Tensor  # (k, n)  C -- sampled rows of A
    alpha: torch.Tensor       # (b,)    projection coefficients (0 => dropped row)
    assign: torch.Tensor      # (b,)    int32 generator index f(i)
    beta: torch.Tensor        # ()      de-bias factor b / (b - eta)


def num_generators(b: int, ratio: float) -> int:
    """k = ceil(r * b), clamped to [1, b] (paper §4.1; k=1 is valid)."""
    return max(1, min(b, math.ceil(ratio * b)))


def pamm_compress(a, k: int, eps: float, key=None, *, idx=None, reduce_=None) -> PammState:
    """Compress ``a: (b, n)`` into ``k`` generators (Alg. 1 COMPRESS).

    ``idx``: the generator rows, (min(k, b),); drawn from ``key`` when not
    given. eps = inf (paper's best setting) keeps every row; eps = 0
    reduces PAMM to Uniform-CRS. ``reduce_``: ``a`` is a column slice of
    the rows (module docstring)."""
    from repro_torch.kernels import ops

    b = a.shape[0]
    k = min(k, b)
    if idx is None:
        if key is None:
            raise ValueError("pamm_compress needs the generator rows idx or a key")
        idx = key.choice(b, k, a.device)
    if reduce_ is not None:
        return ops.pamm_compress_split(a, k, eps, idx, reduce_)
    return ops.pamm_compress(a, k, eps, idx)


def pamm_apply(state: PammState, bmat) -> torch.Tensor:
    """Approximate ``A^T @ B`` (n, m) f32 from the state (Alg. 1 APPROXMM)."""
    from repro_torch.kernels import ops

    return ops.pamm_apply(state, bmat)


def pamm_compress_blocked(a, k: int, eps: float, key, n_blocks: int, *,
                          reduce_=None) -> PammState:
    """Shard-local PAMM: split the token axis into ``n_blocks`` contiguous
    blocks and compress each with ``max(1, k // n_blocks)`` generators
    drawn from ``key.split(n_blocks)[s]``. Returns a state whose leaves
    carry a leading block axis: generators (S, k_loc, n), alpha (S, b_loc),
    assign (S, b_loc), beta (S,). A token axis the blocks cannot divide
    degrades to one block, as in the JAX package. ``reduce_`` as in
    :func:`pamm_compress`, block by block."""
    b, n = a.shape
    if n_blocks <= 1 or b % n_blocks:
        states = [pamm_compress(a, k, eps, key, reduce_=reduce_)]
    else:
        b_loc = b // n_blocks
        k_loc = max(1, k // n_blocks)
        states = [pamm_compress(a[s * b_loc:(s + 1) * b_loc], k_loc, eps, ks, reduce_=reduce_)
                  for s, ks in enumerate(key.split(n_blocks))]
    return PammState(*(torch.stack(leaves) for leaves in zip(*states)))


def pamm_apply_blocked(state: PammState, bmat) -> torch.Tensor:
    """Apply for a blocked state: the sum of per-block C_s^T Btilde_s."""
    n_blocks, b_loc = state.alpha.shape
    out = None
    for s in range(n_blocks):
        part = pamm_apply(PammState(*(leaf[s] for leaf in state)),
                          bmat[s * b_loc:(s + 1) * b_loc])
        out = part if out is None else out + part
    return out


def pamm_compress_batched(a, k: int, eps: float, keys) -> PammState:
    """Compress each expert's ``a[e]`` (``a: (E, b, n)``) into ``k``
    generators drawn from ``keys[e]`` (all in one draw with the default
    sampler), one K1 launch for all experts. The
    state's leaves carry the expert axis: generators (E, k, n), alpha and
    assign (E, b), beta (E,)."""
    from repro_torch.kernels import ops

    b = a.shape[1]
    k = min(k, b)
    return ops.pamm_compress_batched(a, k, eps, choice_batched(keys, b, k, a.device))


def pamm_apply_batched(state: PammState, bmat) -> torch.Tensor:
    """Approximate each expert's ``A_e^T @ B_e`` (``bmat: (E, b, m)``), (E,
    n, m) f32, one K2 launch for all experts."""
    from repro_torch.kernels import ops

    return ops.pamm_apply_batched(state, bmat)


def pamm_reconstruct(state: PammState) -> torch.Tensor:
    """Materialize Atilde (b, n) -- for analysis and tests only."""
    rows = state.generators.float().index_select(0, state.assign.long())
    return state.alpha[:, None] * rows


def stored_elements(b: int, n: int, k: int) -> int:
    """Elements kept by PAMM: C (k*n) + alpha (b) + f (b) (paper App. J)."""
    return k * n + 2 * b
