"""The offset operand of the port's K3 / K4 / K5 on the CPU: the plain
versions with ``offs = (q_off, k_off)`` against the JAX Pallas kernels'
scalar-prefetch offset variants (``_fwd_impl`` / ``_bwd_impl`` with
``offs=``, interpret mode), on chunk pairs of the zigzag layout that ring
context parallelism hands them (``zigzag_shard_positions`` at cp = 2 and
3): the diagonal, fully visible pairs, window-edge pairs whose late rows
see no key, and dead pairs (the q chunk before the k chunk).

The JAX kernels run with 16-row tiles, so a chunk of 24 or 40 rows ends
in a padded tile. Forward: o and lse are compared on the rows that see a
key (absolute tolerance: f32 1e-5, the same f32 math in another order;
bf16 2e-2, o rounded to bf16 in both packages); a row that sees no key
must have lse <= NEG_INF / 2 and a finite o in both, the convention the
ring merge needs (``repro_torch/kernels/flash_attention.py``'s docstring).
Backward: both take the same merged lse and o, as the ring's
``_pair_bwd`` does (the pair's lse merged with the other chunks', finite
on every row), and dq, dk, dv are compared on every row, relative to the
JAX gradient's norm: f32 1e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd_impl, _fwd_impl
from repro.kernels.ring_attention import zigzag_shard_positions
from repro_torch.kernels import launches, ops
from repro_torch.kernels.flash_attention import (NEG_INF, _iota_mask,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_BLOCK = 16
CASES = [
    # cp, C, H, KV, dh, window, (q shard, q half), (k shard, k half)
    (2, 16, 4, 2, 16, 0, (0, 0), (0, 0)),     # diagonal at 0
    (2, 24, 4, 2, 80, 0, (0, 1), (1, 1)),     # fully visible, C past one tile
    (2, 16, 2, 2, 16, 8, (1, 0), (0, 0)),     # window edge, G 1
    (2, 40, 4, 2, 16, 8, (1, 1), (1, 0)),     # window edge, C 40
    (2, 48, 4, 2, 80, 8, (0, 1), (1, 1)),     # window edge, dh 80
    (3, 24, 4, 2, 80, 0, (0, 1), (0, 0)),     # fully visible, far apart
    (3, 48, 4, 2, 16, 8, (1, 1), (2, 1)),     # window edge
    (3, 40, 2, 2, 16, 8, (1, 0), (1, 0)),     # diagonal with a window, G 1
    (3, 16, 4, 2, 80, 0, (2, 0), (2, 1)),     # dead: q chunk before k chunk
    (3, 24, 2, 2, 16, 0, (1, 1), (0, 1)),     # dead, G 1
]
IDS = ["diag", "visible", "edge-g1", "edge-c40", "edge-dh80", "visible-cp3",
       "edge-cp3", "diag-window", "dead", "dead-g1"]


def _offsets(cp, C, q_chunk, k_chunk):
    """Global positions of the first query and key of a chunk pair, from
    the zigzag shard positions at L = 2 * cp * C."""
    L = 2 * cp * C
    (qs, qh), (ks, kh) = q_chunk, k_chunk
    q_off = int(np.asarray(zigzag_shard_positions(qs, L, cp))[qh * C])
    k_off = int(np.asarray(zigzag_shard_positions(ks, L, cp))[kh * C])
    return q_off, k_off


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb > 0 else float(np.linalg.norm(a))


def _inputs(C, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return rng, [rng.standard_normal(s, dtype=np.float32)
                 for s in ((1, C, H, dh), (1, C, KV, dh), (1, C, KV, dh))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cp,C,H,KV,dh,window,q_chunk,k_chunk", CASES, ids=IDS)
def test_k3_offsets_plain_matches_jax_kernel(cp, C, H, KV, dh, window, q_chunk, k_chunk,
                                             dtype):
    offs = _offsets(cp, C, q_chunk, k_chunk)
    _, arrays = _inputs(C, H, KV, dh, seed=C * 11 + dh + window)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrays)
    o, lse = flash_attention_fwd_ref(qt, kt, vt, causal=True, window=window, offs=offs)
    o_j, lse_j = _fwd_impl(qj, kj, vj, True, window, JAX_BLOCK, JAX_BLOCK, True,
                           offs=jnp.array(offs, jnp.int32))
    o, lse, o_j, lse_j = _np(o), _np(lse), _np(o_j), _np(lse_j)
    seen = _iota_mask(C, True, window, "cpu", offs).any(-1).numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(o[:, seen], o_j[:, seen], atol=tol, rtol=0)
    np.testing.assert_allclose(lse[..., seen], lse_j[..., seen], atol=tol, rtol=0)
    for out, stat in ((o, lse), (o_j, lse_j)):    # rows that see no key
        assert np.isfinite(out).all()
        assert (stat[..., ~seen] <= NEG_INF / 2).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cp,C,H,KV,dh,window,q_chunk,k_chunk", CASES, ids=IDS)
def test_k45_offsets_plain_matches_jax_kernels(cp, C, H, KV, dh, window, q_chunk, k_chunk,
                                               dtype):
    offs = _offsets(cp, C, q_chunk, k_chunk)
    rng, arrays = _inputs(C, H, KV, dh, seed=C * 13 + dh + window)
    o = rng.standard_normal((1, C, H, dh), dtype=np.float32)     # the merged o
    do = rng.standard_normal((1, C, H, dh), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt), (oj, ot), (doj, dot) = (
        _pair(a, dtype) for a in (*arrays, o, do))
    # the pair's lse merged with another chunk's partial: finite on every row
    _, lse_pair = flash_attention_fwd_ref(qt, kt, vt, causal=True, window=window, offs=offs)
    other = torch.from_numpy(rng.uniform(-1.0, 2.0, (1, H, C)).astype(np.float32))
    lse = torch.logaddexp(lse_pair, other)
    grads = flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, causal=True, window=window,
                                    offs=offs)
    grads_j = _bwd_impl(qj, kj, vj, oj, jnp.asarray(lse.numpy()), doj, True, window,
                        JAX_BLOCK, JAX_BLOCK, True, offs=jnp.array(offs, jnp.int32))
    for name, g, gj, x in zip(("dq", "dk", "dv"), grads, grads_j, (qt, kt, vt)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert _rel(g, gj) < TOL[dtype], (name, _rel(g, gj))


def test_offsets_zero_are_the_plain_lowering_and_reach_autograd():
    """``offs=(0, 0)`` gives the offset-free result bit for bit, and
    ``ops.flash_attention`` carries ``offs`` through its autograd Function
    to the backward (against autograd of the masked plain forward)."""
    _, (q, k, v) = _inputs(24, 4, 2, 16, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for a, b in zip(flash_attention_fwd_ref(tq, tk, tv, window=8),
                    flash_attention_fwd_ref(tq, tk, tv, window=8, offs=(0, 0))):
        assert torch.equal(a, b)
    offs = (40, 24)
    seen = _iota_mask(24, True, 8, "cpu", offs).any(-1)
    assert not seen.all() and seen.any()           # a window-edge pair
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    launches.reset()
    out = ops.flash_attention(*leaves, causal=True, window=8, offs=offs)
    # the pair's own lse is NEG_INF on rows that see no key; their output
    # gradient is 0 here, as a dead row's is in a merged ring
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    do[:, ~seen] = 0
    got = torch.autograd.grad(out, leaves, do)
    assert launches.counts() == {"flash_attention_fwd_ref": 1, "flash_attention_bwd_ref": 1}
    ref_leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    qg = ref_leaves[0].reshape(1, 24, 2, 2, 16)
    s = torch.einsum("bqkgd,blkd->bkgql", qg, ref_leaves[1]) * 16 ** -0.5
    s = s.masked_fill(~_iota_mask(24, True, 8, "cpu", offs), NEG_INF)
    ref = torch.einsum("bkgql,blkd->bqkgd", torch.softmax(s, -1), ref_leaves[2])
    ref = ref.reshape(1, 24, 4, 16)
    torch.testing.assert_close(out[:, seen], ref[:, seen], rtol=0, atol=2e-5)
    for g, r in zip(got, torch.autograd.grad(ref, ref_leaves, do)):
        assert _rel(g, r) < 1e-5
