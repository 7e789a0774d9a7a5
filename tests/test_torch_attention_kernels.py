"""The port's attention kernels on the CPU: the plain versions of K3
(prefill flash attention) and K6 (flash decode) against the JAX Pallas
kernels run in interpret mode and against the JAX oracles, plus the
dispatch rules (CPU tensor -> plain version; a CUDA kernel never falls
back). The CUDA kernels themselves are compared with these plain versions
on the card (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).

Tolerances: f32 atol 2e-5 (the same math summed in another order); bf16
atol 5e-2 (outputs rounded to bf16 in both packages, ~2^-8 relative, on
values of order 1), the tolerances of the JAX package's own kernel tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.flash_decode import flash_decode_kernel
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import launches, ops
from repro_torch.kernels.flash_attention import (flash_attention_fwd_cuda,
                                                 flash_attention_fwd_ref)
from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_ref

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round the f32 draw to bf16 the same way)."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K3: prefill flash attention
# ---------------------------------------------------------------------------
K3_CASES = [
    # B, L, H, KV, dh, causal, window
    (1, 40, 4, 2, 16, True, 0),       # GQA, dh 16
    (2, 33, 4, 1, 80, True, 0),       # MQA, dh 80, odd L
    (1, 70, 4, 2, 128, True, 16),     # sliding window, dh 128
    (1, 130, 2, 1, 16, True, 24),     # L past one 128-row tile, window
    (1, 24, 2, 2, 16, False, 0),      # non-causal
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,KV,dh,causal,window", K3_CASES)
def test_k3_plain_matches_jax_kernel_and_oracle(B, L, H, KV, dh, causal, window, dtype):
    rng = np.random.default_rng(L * 7 + dh)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    o, lse = flash_attention_fwd_ref(qt, kt, vt, causal=causal, window=window)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, L)
    o_k, lse_k = flash_attention_fwd(qj, kj, vj, causal=causal, window=window,
                                     interpret=True)
    o_ref = flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_k), atol=tol)
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=tol)
    np.testing.assert_allclose(_np(lse), _np(lse_k), atol=tol)


def test_k3_lse_is_logsumexp_of_visible_scores():
    rng = np.random.default_rng(3)
    B, L, H, KV, dh, window = 1, 20, 2, 1, 16, 5
    q = torch.from_numpy(rng.standard_normal((B, L, H, dh), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, L, KV, dh), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, L, KV, dh), dtype=np.float32))
    _, lse = flash_attention_fwd_ref(q, k, v, causal=True, window=window)
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * dh ** -0.5
    i = torch.arange(L)
    vis = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# K6: flash decode
# ---------------------------------------------------------------------------
K6_CASES = [   # the case grid of tests/test_serving.py (flash_decode kernel)
    (2, 64, 4, 2, 64, 0, 64),       # GQA
    (1, 96, 4, 1, 32, 0, 50),       # MQA, partially filled cache
    (2, 37, 8, 2, 80, 0, 37),       # non-divisible S, non-128 head dim
    (1, 16, 2, 2, 128, 8, 16),      # ring cache: S == window
]


def _decode_inputs(B, S, H, KV, dh, n_valid, dtype, seed=0):
    rng = np.random.default_rng(seed + S)
    q = _pair(rng.standard_normal((B, 1, H, dh), dtype=np.float32), dtype)
    k = _pair(rng.standard_normal((B, S, KV, dh), dtype=np.float32), dtype)
    v = _pair(rng.standard_normal((B, S, KV, dh), dtype=np.float32), dtype)
    spos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    spos = np.where(spos < n_valid, spos, -1).astype(np.int32)
    qpos = np.full((B,), n_valid - 1, np.int32)
    return q, k, v, spos, qpos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,window,n_valid", K6_CASES)
def test_k6_plain_matches_jax_kernel_and_oracle(B, S, H, KV, dh, window, n_valid, dtype):
    (qj, qt), (kj, kt), (vj, vt), spos, qpos = _decode_inputs(B, S, H, KV, dh, n_valid, dtype)
    o = flash_decode_ref(qt, kt, vt, torch.from_numpy(qpos), torch.from_numpy(spos),
                         causal=True, window=window)
    assert o.dtype == qt.dtype and tuple(o.shape) == (B, 1, H, dh)
    o_k = flash_decode_kernel(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(spos),
                              causal=True, window=window, bk=16, interpret=True)
    o_r = jax_decode_ref(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(spos),
                         causal=True, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_k), atol=tol)
    np.testing.assert_allclose(_np(o), _np(o_r), atol=tol)


def test_k6_parked_row_is_finite_and_matches_jax_oracle():
    """A parked slot (q_pos = -1) masks every key: the output must stay
    finite (the engine discards it), as the JAX kernel's does."""
    (qj, qt), (kj, kt), (vj, vt), spos, qpos = _decode_inputs(3, 40, 4, 2, 32, 30, "float32")
    qpos[1] = -1
    o = flash_decode_ref(qt, kt, vt, torch.from_numpy(qpos), torch.from_numpy(spos))
    assert torch.isfinite(o).all()
    o_k = flash_decode_kernel(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(spos),
                              bk=16, interpret=True)
    assert np.isfinite(np.asarray(o_k)).all()
    o_r = jax_decode_ref(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(spos))
    np.testing.assert_allclose(_np(o), _np(o_r), atol=2e-5)
    live = [0, 2]   # the kernel pads S to its tile, so only live rows compare
    np.testing.assert_allclose(_np(o)[live], _np(o_k)[live], atol=2e-5)


def test_k6_plain_multi_row_queries_match_jax_oracle():
    """Lq > 1 with per-row positions (the speculative-verify form the
    paged slice will reuse)."""
    rng = np.random.default_rng(5)
    B, Lq, S, H, KV, dh = 2, 3, 24, 4, 2, 16
    q = rng.standard_normal((B, Lq, H, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    spos = np.where(np.arange(S) < 20, np.arange(S), -1).astype(np.int32)[None].repeat(B, 0)
    qpos = np.array([[17, 18, 19], [5, 6, 7]], np.int32)
    o = flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v, qpos, spos)), window=6)
    o_r = jax_decode_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, spos)), window=6)
    np.testing.assert_allclose(_np(o), _np(o_r), atol=2e-5)


def test_plain_kernels_match_the_position_masked_sdpa():
    """Both plain versions against the port's chunked sdpa reference (the
    position-masked math of the JAX ``models/attention.py::sdpa``), which
    is itself held against the JAX sdpa."""
    from repro.models.attention import sdpa as jax_sdpa
    from repro_torch.models.attention import sdpa

    rng = np.random.default_rng(9)
    B, L, H, KV, dh, window = 2, 21, 4, 2, 16, 6
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, L, H, dh), (B, L, KV, dh), (B, L, KV, dh)))
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    qt, kt, vt, pt = (torch.from_numpy(a) for a in (q, k, v, pos))
    o_s = sdpa(qt, kt, vt, pt, pt, causal=True, window=window, chunk=5)
    o_j = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal=True,
                   window=window, chunk=5)
    np.testing.assert_allclose(_np(o_s), _np(o_j), atol=2e-5)
    o3, _ = flash_attention_fwd_ref(qt, kt, vt, causal=True, window=window)
    torch.testing.assert_close(o3, o_s, atol=2e-5, rtol=0)
    spos = torch.where(pt < 15, pt, -1).to(torch.int32)
    qpos = torch.tensor([14, 9], dtype=torch.int32)
    o6 = flash_decode_ref(qt[:, :1], kt, vt, qpos, spos, causal=True, window=window)
    o_s1 = sdpa(qt[:, :1], kt, vt, qpos[:, None], spos, causal=True, window=window,
                chunk=1)
    torch.testing.assert_close(o6, o_s1, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# dispatch: CPU -> plain version, counted; CUDA wrappers never fall back
# ---------------------------------------------------------------------------
def test_ops_routes_cpu_tensors_to_plain_versions_and_counts():
    launches.reset()
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    o = ops.flash_attention(q, k, k, causal=True)
    o_ref, _ = flash_attention_fwd_ref(q, k, k, causal=True)
    torch.testing.assert_close(o, o_ref)
    qd = torch.randn(1, 1, 2, 16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    ops.flash_decode(qd, k, k, torch.tensor([7], dtype=torch.int32), pos)
    assert launches.counts() == {"flash_attention_fwd_ref": 2, "flash_decode_ref": 1}
    launches.reset()
    assert launches.counts() == {}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises: handed a CPU tensor it raises
    instead of quietly running the plain version."""
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q[:, :1], k, k, torch.tensor([7], dtype=torch.int32),
                          torch.arange(8, dtype=torch.int32)[None])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
