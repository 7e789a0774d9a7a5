"""The port's PAMM kernels on the CPU: the plain versions of K1 (csim
arg-max) and K2 (segment sum) against the JAX Pallas kernels run in
interpret mode and against ``repro/kernels/ref.py``, over the shape sweeps
of ``tests/test_kernels.py``; and the port's ``ops.pamm_compress`` /
``ops.pamm_apply`` (and the blocked variants) against the JAX package's
under the same generator rows. The CUDA kernels themselves are compared
with these plain versions on the card (``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``).

Tolerances: |cs| and norms f32 2e-5, bf16 5e-2 (both packages read the
same bf16 values and sum in f32 in another order; the JAX test's own
tolerances); idx equal wherever the plain top-2 |csim| margin exceeds the
tolerance. K2 f32 1e-4, bf16 5e-2 (the JAX test's). The full PAMM ops in
f32: 1e-5 relative (the same f32 math in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pamm as jax_pamm
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.pamm_apply import segment_matmul
from repro.kernels.pamm_compress import csim_argmax
from repro_torch.core import pamm as torch_pamm
from repro_torch.core.keys import Key
from repro_torch.kernels import launches, ops
from repro_torch.kernels.pamm_apply import segment_matmul_ref
from repro_torch.kernels.pamm_compress import csim_argmax_ref
from tests.test_torch_linear import JaxSampler


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,n,k", [
    (64, 16, 4), (512, 64, 16), (300, 200, 7), (1024, 512, 128), (100, 33, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_jax_kernel_and_oracle(b, n, k, dtype):
    rng = np.random.default_rng(b + n + k)
    xj, xt = _pair(rng.standard_normal((b, n), dtype=np.float32), dtype)
    idx = rng.permutation(b)[:k]
    cs, f, na = csim_argmax_ref(xt, xt[torch.from_numpy(idx)])
    cs_k, f_k, na_k = csim_argmax(xj, xj[idx], interpret=True)
    cs_r, f_r, na_r = jax_ref.csim_argmax_ref(xj, xj[idx])
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    assert f.dtype == torch.int32 and int(f.max()) < k
    for cs_j, na_j in ((cs_k, na_k), (cs_r, na_r)):
        np.testing.assert_allclose(np.abs(_np(cs)), np.abs(_np(cs_j)), atol=tol)
        np.testing.assert_allclose(_np(na), _np(na_j), rtol=tol, atol=tol)
    # the index wherever the top-2 |csim| margin is clear of the tolerance
    x32, c32 = xt.float(), xt[torch.from_numpy(idx)].float()
    csim = (x32 @ c32.T) / (x32.norm(dim=1)[:, None] * c32.norm(dim=1)[None])
    top2 = csim.abs().topk(min(2, k), dim=1).values
    clear = ((top2[:, 0] - top2[:, -1]) > tol).numpy() if k > 1 else np.ones(b, bool)
    np.testing.assert_array_equal(f.numpy()[clear], np.asarray(f_k)[clear])
    np.testing.assert_array_equal(f.numpy()[clear], np.asarray(f_r)[clear])


def test_k1_plain_ties_zero_rows_and_zero_generators():
    """Ties go to the lowest generator; a zero row gets csim 0, index 0; a
    zero generator never wins over a nonzero csim."""
    x = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, 2.0], [1.0, 1.0]])
    c = torch.tensor([[0.0, 0.0], [3.0, 0.0], [0.0, -1.0], [5.0, 0.0]])
    cs, f, na = csim_argmax_ref(x, c)
    assert f.tolist() == [1, 0, 2, 1]              # row 0 ties 1 and 3 -> 1
    assert cs[1] == 0 and cs[2] == pytest.approx(-1.0)
    torch.testing.assert_close(na, torch.tensor([1.0, 0.0, 2.0, math.sqrt(2)]))


@pytest.mark.parametrize("b,m,k", [
    (64, 16, 4), (512, 48, 16), (300, 200, 7), (2048, 1024, 128), (16, 8, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_jax_kernel_and_oracle(b, m, k, dtype):
    rng = np.random.default_rng(b * m + k)
    f = rng.integers(0, k, b).astype(np.int32)
    alpha = rng.standard_normal(b, dtype=np.float32)
    gzj, gzt = _pair(rng.standard_normal((b, m), dtype=np.float32), dtype)
    mine = segment_matmul_ref(torch.from_numpy(f), torch.from_numpy(alpha), gzt, k)
    assert mine.dtype == torch.float32 and tuple(mine.shape) == (k, m)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    for other in (segment_matmul(jnp.asarray(f), jnp.asarray(alpha), gzj, k, interpret=True),
                  jax_ref.segment_matmul_ref(jnp.asarray(f), jnp.asarray(alpha), gzj, k)):
        np.testing.assert_allclose(mine.numpy(), _np(other), rtol=tol, atol=tol)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("eps", [math.inf, 1.0, 0.5])
@pytest.mark.parametrize("zero_rows", [False, True])
def test_pamm_ops_match_jax_ops_under_the_same_rows(eps, zero_rows):
    """ops.pamm_compress / pamm_apply == repro.kernels.ops under the idx
    that ``jax.random.choice`` draws from the JAX key."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((512, 128), dtype=np.float32)
    if zero_rows:
        x[::4] = 0.0                                 # capacity-style padding
    gz = rng.standard_normal((512, 96), dtype=np.float32)
    key = jax.random.key(8)
    st_j = jax_ops.pamm_compress(jnp.asarray(x), 32, eps, key, interpret=True)
    idx = torch.from_numpy(np.array(jax.random.choice(key, 512, (32,), replace=False)))
    st_t = ops.pamm_compress(torch.from_numpy(x), 32, eps, idx)
    np.testing.assert_array_equal(st_t.generators.numpy(), np.asarray(st_j.generators))
    np.testing.assert_array_equal(st_t.assign.numpy(), np.asarray(st_j.assign))
    np.testing.assert_allclose(st_t.alpha.numpy(), np.asarray(st_j.alpha), rtol=1e-5, atol=1e-6)
    assert float(st_t.beta) == pytest.approx(float(st_j.beta), rel=1e-6)
    out_t = ops.pamm_apply(st_t, torch.from_numpy(gz))
    out_j = jax_ops.pamm_apply(st_j, jnp.asarray(gz), interpret=True)
    assert _rel(out_t, out_j) < 1e-5
    # and the JAX jnp path (core.pamm) on the same key
    assert _rel(out_t, jax_pamm.pamm_apply(jax_pamm.pamm_compress(jnp.asarray(x), 32, eps, key),
                                           jnp.asarray(gz))) < 1e-5


def test_pamm_core_draws_from_the_key_and_blocks_like_jax():
    """core.pamm with a Key whose sampler replays the JAX chain: the single
    and the blocked (2 blocks) compress match the JAX functions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 32), dtype=np.float32)
    gz = rng.standard_normal((256, 24), dtype=np.float32)
    key = Key(5, sampler=JaxSampler())
    st = torch_pamm.pamm_compress(torch.from_numpy(x), 16, math.inf, key)
    st_j = jax_pamm.pamm_compress(jnp.asarray(x), 16, math.inf, jax.random.key(5))
    assert _rel(st.generators, st_j.generators) == 0.0
    np.testing.assert_array_equal(st.assign.numpy(), np.asarray(st_j.assign))
    blk = torch_pamm.pamm_compress_blocked(torch.from_numpy(x), 16, 0.9, key, 2)
    blk_j = jax_pamm.pamm_compress_blocked(jnp.asarray(x), 16, 0.9, jax.random.key(5), 2)
    assert tuple(blk.generators.shape) == (2, 8, 32) and tuple(blk.alpha.shape) == (2, 128)
    np.testing.assert_array_equal(blk.assign.numpy(), np.asarray(blk_j.assign))
    np.testing.assert_allclose(blk.beta.numpy(), np.asarray(blk_j.beta), rtol=1e-6)
    assert _rel(torch_pamm.pamm_apply_blocked(blk, torch.from_numpy(gz)),
                jax_pamm.pamm_apply_blocked(blk_j, jnp.asarray(gz))) < 1e-5
    assert _rel(torch_pamm.pamm_reconstruct(st), jax_pamm.pamm_reconstruct(st_j)) < 1e-6
    assert torch_pamm.stored_elements(256, 32, 16) == jax_pamm.stored_elements(256, 32, 16)
    assert torch_pamm.num_generators(8192, 1 / 512) == 16


def test_pamm_cpu_tensors_take_the_plain_versions():
    launches.reset()
    x = torch.randn(64, 16)
    st = torch_pamm.pamm_compress(x, 4, math.inf, idx=torch.arange(4))
    torch_pamm.pamm_apply(st, torch.randn(64, 8))
    assert launches.counts() == {"csim_argmax_ref": 1, "segment_matmul_ref": 1}
    with pytest.raises(ValueError, match="idx must hold"):
        ops.pamm_compress(x, 4, math.inf, torch.arange(3))
    with pytest.raises(ValueError, match="needs CUDA"):
        from repro_torch.kernels.pamm_compress import csim_argmax_cuda

        csim_argmax_cuda(x, x[:4])
