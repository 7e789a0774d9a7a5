"""The port's attention backward on the CPU: the plain version of K4/K5
(``flash_attention_bwd_ref``, probabilities recomputed from lse) against
``jax.grad`` through the JAX Pallas flash kernels in interpret mode, and
against torch autograd of the plain forward; and ``ops.flash_attention``
(the autograd Function joining K3 with K4/K5) against the same. The CUDA
kernels are compared with this plain version on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).

Tolerances: f32 1e-5 relative (the norm of the difference over the norm
of the JAX gradient; the same f32 math in another order, the bound of the
JAX package's own ``tests/test_flash_bwd.py``); bf16 2e-2 relative (the
gradients are rounded to bf16 in both packages; the JAX test's bound).

The numerics budget of the CUDA kernels' bf16 route (tensor cores): its
rounding points, emulated here on the plain backward, against the plain
version at the card's tolerances (``chip_smoke.py``'s TOL_K45 2e-2 of each
gradient's largest magnitude and TOL_ROW 1e-2 of each row's norm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import launches, ops
from repro_torch.kernels.flash_attention import (NEG_INF, _delta, _iota_mask,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # B, L, H, KV, dh, causal, window
    (1, 40, 4, 2, 16, True, 0),       # GQA
    (2, 33, 4, 1, 80, True, 0),       # MQA, odd L, dh 80
    (1, 130, 4, 2, 128, True, 24),    # window, L past one tile, dh 128
    (1, 33, 2, 2, 16, True, 8),       # MHA, odd L, window
    (1, 24, 2, 1, 16, False, 0),      # non-causal
    (1, 40, 16, 1, 256, True, 0),     # recurrentgemma's heads: MQA, G 16 at dh 256
    (1, 33, 4, 1, 256, True, 8),      # dh 256, a window, odd L
]


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(B, L, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh), (B, L, H, dh))]


def _plain_attention(q, k, v, causal, window):
    """Differentiable plain attention (materialized probabilities)."""
    B, L, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, L, KV, H // KV, dh).float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k.float()) * dh ** -0.5
    s = s.masked_fill(~_iota_mask(L, causal, window, q.device), -1e30)
    o = torch.einsum("bkgql,blkd->bqkgd", torch.softmax(s, -1), v.float())
    return o.reshape(B, L, H, dh).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,causal,window", CASES)
def test_k45_plain_matches_jax_grad_and_torch_autograd(B, L, H, KV, dh, causal, window,
                                                        dtype):
    q, k, v, do = _inputs(B, L, H, KV, dh, seed=L * 3 + dh)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal, window=window,
                                                interpret=True), jq, jk, jv)
    grads_j = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal=causal, window=window)
    grads = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    for g, gj, x in zip(grads, grads_j, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel(g, gj) < TOL[dtype]
    if dtype == "float32":
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = _plain_attention(*leaves, causal, window)
        for g, ga in zip(grads, torch.autograd.grad(out, leaves, tdo)):
            assert _rel(g, ga.numpy()) < TOL[dtype]


@pytest.mark.parametrize("window", [0, 16], ids=["causal", "sliding-window"])
def test_flash_attention_function_matches_plain_autograd(window):
    """ops.flash_attention under autograd: K3 forward (saving q, k, v, o,
    lse) and K4/K5 backward -- here their plain versions, counted as such
    -- equal autograd through the materialized attention."""
    q, k, v, do = _inputs(2, 50, 4, 2, 32, seed=window)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    launches.reset()
    out = ops.flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert launches.counts() == {"flash_attention_fwd_ref": 1, "flash_attention_bwd_ref": 1}
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref_out = _plain_attention(*ref_leaves, True, window)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=2e-5)
    for g, r in zip(got, torch.autograd.grad(ref_out, ref_leaves, torch.from_numpy(do))):
        assert _rel(g, r.numpy()) < 1e-5
    # without autograd nothing is saved and only the forward runs
    launches.reset()
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=True, window=window)
    assert launches.counts() == {"flash_attention_fwd_ref": 1}


LOG2E = 1.4426950408889634


def _bf16_route(q, k, v, o, lse, do, causal, window):
    """The rounding points of K4/K5's bf16 route on the plain backward: bf16
    operands, every product summed in f32, P = exp2 of log2(e)-scaled
    operands, and P and dS rounded to bf16 before the products that take
    them (dV = P^T dO; dQ = dS K, dK = dS^T Q); outputs in bf16."""
    B, L, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qg = q.reshape(B, L, KV, G, dh).float()
    dog = do.reshape(B, L, KV, G, dh).float()
    k32, v32 = k.float(), v.float()
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k32) * (scale * LOG2E)
    s = s.masked_fill(~_iota_mask(L, causal, window, q.device), NEG_INF * LOG2E)
    p = torch.exp2(s - lse.reshape(B, KV, G, L, 1) * LOG2E)
    dp = torch.einsum("bqkgd,blkd->bkgql", dog, v32)
    ds = p * (dp - _delta(o, do).reshape(B, KV, G, L, 1)) * scale
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bkgql,blkd->bqkgd", ds16, k32).reshape(B, L, H, dh)
    dk = torch.einsum("bkgql,bqkgd->blkd", ds16, qg)
    dv = torch.einsum("bkgql,bqkgd->blkd", p16, dog)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _row_err(a, ref) -> float:
    """chip_smoke.py's row_err: the largest |a_row - ref_row| relative to
    |ref_row| + 1e-2 of the largest reference row."""
    a, ref = a.float(), ref.float()
    den = ref.norm(dim=-1)
    return float(((a - ref).norm(dim=-1) / (den + 1e-2 * den.max()).clamp_min(1e-30)).max())


@pytest.mark.parametrize("window", [0, 256], ids=["causal", "sliding-window"])
def test_k45_bf16_route_rounding_fits_the_card_tolerances(window):
    """P and dS rounded to bf16 (the tensor-core route) keep dq, dk, dv
    within 2e-2 of each gradient's largest magnitude and 1e-2 of each row's
    norm of the f32 plain version, at a GQA shape (8 query heads on 2 kv
    heads) with L 1024 and dh 128, causal with and without a window."""
    B, L, H, KV, dh = 1, 1024, 8, 2, 128
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(B, L, H, KV, dh, seed=window + 7))
    o, lse = flash_attention_fwd_ref(q, k, v, causal=True, window=window)
    got = _bf16_route(q, k, v, o, lse, do, True, window)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 2e-2 * float(r.float().abs().max()), (name, err)
        assert _row_err(a, r) <= 1e-2, (name, _row_err(a, r))
        assert not torch.equal(a, r), name        # the rounding points do move the result
