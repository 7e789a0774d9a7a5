"""The arithmetic of the K1 and K2 CUDA kernels, on the CPU.

The kernels (``csrc/pamm_compress.cu``, ``csrc/pamm_apply.cu``) run only on
the card. What they compute is pinned here by torch emulations of the same
steps, held against the JAX Pallas kernels in interpret mode, the JAX
oracles (``repro/kernels/ref.py``) and the port's plain versions:

* K2 splits the rows into S contiguous ranges (:func:`_splits`, a function
  of b, m and k alone); in a split, warp w of 4 adds rows w, w + 4, ... in
  order into its own f32 accumulator at row f_i (a row with f_i outside
  [0, k) is skipped), the block sums its warps in order, and a second pass
  sums the splits in the order s = 0..S-1.
* The batched K2 (the MoE site's experts in one launch) runs the same
  split-and-merge per expert, S from :func:`_splits_batched` (e, b, m, k),
  which counts the experts' blocks together.
* K1 walks the generators in chunks of 16 and keeps a running best per
  row, replaced only by a strictly larger |csim| of a later chunk, so a tie
  across a chunk boundary goes to the lower index, as in the plain arg-max.

Tolerances: K2 1e-5 of max |Btilde| (f32 sums in another order); K1 |cs|
and norms 1e-5 relative (f32 sums in another order), the index equal
wherever the plain top-2 |csim| margin exceeds 1e-4, and exactly on the
rows built to tie (integer data: every sum exact).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.pamm_apply import segment_matmul
from repro.kernels.pamm_compress import csim_argmax
from repro_torch.kernels.pamm_apply import (_splits, _splits_batched, segment_matmul_batched_cuda,
                                            segment_matmul_batched_ref, segment_matmul_cuda,
                                            segment_matmul_ref)
from repro_torch.kernels.pamm_compress import (NORM_EPS, csim_argmax_batched_cuda,
                                               csim_argmax_batched_ref, csim_argmax_cuda,
                                               csim_argmax_ref)

TOL = 1e-5
MARGIN = 1e-4
WARPS = 4    # K2's warps a block
CHUNK = 16   # K1's generators a chunk (bf16 route)


def split_merge(f, alpha, gz, k, nsplit, per):
    """K2's split-and-merge in torch f32: acc (S, W, k, m); at step t warp
    w of split s adds its t-th row, s * per + w + W t."""
    b, m = gz.shape
    z = gz.float()
    acc = torch.zeros(nsplit, WARPS, k, m)
    s_idx = torch.arange(nsplit)[:, None].expand(nsplit, WARPS)
    w_idx = torch.arange(WARPS)[None, :].expand(nsplit, WARPS)
    for t in range(-(-per // WARPS)):
        rows = s_idx * per + w_idx + WARPS * t
        live = (w_idx + WARPS * t < per) & (rows < b)
        rows = rows.clamp_max(b - 1)
        j = f.long()[rows]
        live &= (j >= 0) & (j < k)
        s, w, j, r = s_idx[live], w_idx[live], j[live], rows[live]
        acc[s, w, j] += alpha[r, None] * z[r]           # one row per (s, w): no collision
    parts = acc[:, 0]
    for w in range(1, WARPS):
        parts = parts + acc[:, w]
    out = parts[0]
    for s in range(1, nsplit):
        out = out + parts[s]
    return out


def chunked_argmax(x, c, chunk=CHUNK):
    """K1's chunk walk in torch f32: per chunk the first max of |csim|,
    taken over the running best only when strictly larger."""
    x32, c32 = x.float(), c.float()
    na = torch.linalg.vector_norm(x32, dim=1)
    nc = torch.linalg.vector_norm(c32, dim=1)
    inv_na = 1.0 / na.clamp_min(NORM_EPS)
    inv_c = torch.where(nc > 0, 1.0 / nc.clamp_min(NORM_EPS), torch.zeros_like(nc))
    b = x.shape[0]
    best_abs = torch.full((b,), -1.0)
    best_j = torch.zeros(b, dtype=torch.long)
    best_cs = torch.zeros(b)
    for j0 in range(0, c.shape[0], chunk):
        cs = (x32 @ c32[j0:j0 + chunk].T) * inv_na[:, None] * inv_c[None, j0:j0 + chunk]
        jj = torch.argmax(cs.abs(), dim=1)
        c_cs = torch.gather(cs, 1, jj[:, None])[:, 0]
        take = c_cs.abs() > best_abs                     # strict: ties stay earlier
        best_abs = torch.where(take, c_cs.abs(), best_abs)
        best_j = torch.where(take, jj + j0, best_j)
        best_cs = torch.where(take, c_cs, best_cs)
    return best_cs, best_j.to(torch.int32), na


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------
def test_k2_split_rule_is_a_function_of_the_shapes_alone():
    assert list(inspect.signature(_splits).parameters) == ["b", "m", "k"]
    # the training slice: wq (m 2048) and wk / wv (m 1024) at b 8192, k 16
    assert _splits(8192, 2048, 16) == (33, 249)
    assert _splits(8192, 1024, 16) == (66, 125)
    for m in (2048, 1024):
        S, _ = _splits(8192, m, 16)
        assert S * (m // 256) == 2 * 132                    # two blocks an SM
        assert S * 16 * m * 4 == 4.125 * 2**20              # the scratch: 4.125 MiB
    assert _splits(16, 8, 1) == (1, 64)                     # small: one split, no merge
    for b in (1, 31, 128, 129, 1000, 8192, 70001, 10**7):
        for m in (1, 203, 1024, 4096):
            for k in (1, 16, 17, 512):
                S, per = _splits(b, m, k)
                assert per >= 64 and S <= 65535
                assert (S - 1) * per < b <= S * per         # no split is empty
                assert _splits(b, m, k) == (S, per)


def fixed_splits(n):
    """K2's split rule with the count fixed at ``n`` (at most one a row):
    what the card tests and chip_smoke.py swap in for ``_splits`` to reach
    other split counts."""
    def splits(b, m, k):
        per = -(-b // n)
        return -(-b // per), per
    return splits


def test_k2_forced_split_counts():
    assert (list(inspect.signature(fixed_splits(3)).parameters)
            == list(inspect.signature(_splits).parameters))
    assert fixed_splits(3)(8192, 1024, 16) == (3, 2731)
    assert fixed_splits(7)(300, 203, 5) == (7, 43)
    assert fixed_splits(64)(10, 8, 1) == (10, 1)            # every split holds a row
    for b in (1, 10, 300, 8192):
        for n in (1, 3, 17, 64):
            S, per = fixed_splits(n)(b, 64, 16)
            assert S <= n and (S - 1) * per < b <= S * per  # no split is empty


@pytest.mark.parametrize("b,m,k,splits", [
    (2048, 256, 16, None),      # the rule: 32 splits of 64 rows
    (1000, 203, 5, None),       # m not a multiple of 8
    (1000, 203, 5, 3),
    (1000, 203, 5, 7),
    (512, 48, 40, 2),           # three k tiles
    (300, 64, 1, 1),            # k 1, one split
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_split_merge_matches_jax_kernel_and_oracle(b, m, k, splits, dtype):
    rng = np.random.default_rng(b + m + k)
    f = rng.integers(0, k, b).astype(np.int32)
    f[::37] = -1                                            # outside [0, k): skipped
    f[5::41] = k + 3
    alpha = rng.standard_normal(b, dtype=np.float32)
    gz = rng.standard_normal((b, m), dtype=np.float32)
    gzj, gzt = jnp.asarray(gz, getattr(jnp, dtype)), torch.from_numpy(gz).to(getattr(torch, dtype))
    nsplit, per = (_splits if splits is None else fixed_splits(splits))(b, m, k)
    mine = split_merge(torch.from_numpy(f), torch.from_numpy(alpha), gzt, k, nsplit, per)
    keep = (f >= 0) & (f < k)
    plain = segment_matmul_ref(torch.from_numpy(f[keep]), torch.from_numpy(alpha[keep]),
                               gzt[torch.from_numpy(keep)], k)
    fj, aj = jnp.asarray(f), jnp.asarray(alpha)
    for other in (segment_matmul(fj, aj, gzj, k, interpret=True),
                  jax_ref.segment_matmul_ref(fj, aj, gzj, k), plain):
        other = np.asarray(other, np.float32)
        scale = float(np.abs(other).max())
        np.testing.assert_allclose(mine.numpy(), other, rtol=0, atol=TOL * scale)


def test_k2_batched_split_rule_counts_the_experts_blocks():
    assert list(inspect.signature(_splits_batched).parameters) == ["e", "b", "m", "k"]
    assert _splits_batched(40, 2048, 512, 4) == (4, 621)    # the MoE site (granite)
    S, _ = _splits_batched(40, 2048, 512, 4)
    assert S * 2 * 40 == 320                                # 2 column tiles x 40 experts
    for b in (1, 129, 2048, 8192, 70001):
        for m in (1, 203, 512, 4096):
            for k in (1, 4, 16, 17):
                assert _splits_batched(1, b, m, k) == _splits(b, m, k)
                for e in (3, 40, 384):
                    S, per = _splits_batched(e, b, m, k)
                    assert per >= 64 and S <= 65535
                    assert (S - 1) * per < b <= S * per     # no split is empty
                    assert S <= _splits(b, m, k)[0]         # more experts, fewer splits


@pytest.mark.parametrize("E", [1, 3, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_batched_split_merge_matches_jax_kernel_and_oracle(E, dtype):
    """Each expert's split-and-merge at the batched rule's S against the
    JAX kernel vmapped over the experts (interpret mode) and the batched
    plain version; expert 0's rows all skipped (an all-zero Btilde)."""
    b, m, k = 300, 72, 4
    rng = np.random.default_rng(E)
    f = rng.integers(0, k, (E, b)).astype(np.int32)
    f[0] = -1
    alpha = rng.standard_normal((E, b), dtype=np.float32)
    gz = rng.standard_normal((E, b, m), dtype=np.float32)
    gzt = torch.from_numpy(gz).to(getattr(torch, dtype))
    nsplit, per = _splits_batched(E, b, m, k)
    mine = torch.stack([split_merge(torch.from_numpy(f[e]), torch.from_numpy(alpha[e]),
                                    gzt[e], k, nsplit, per) for e in range(E)])
    assert float(mine[0].abs().max()) == 0
    keep = f >= 0
    plain = segment_matmul_batched_ref(torch.from_numpy(np.where(keep, f, 0)),
                                       torch.from_numpy(np.where(keep, alpha, 0)), gzt, k)
    jk = jax.vmap(lambda ff, aa, gg: segment_matmul(ff, aa, gg, k, interpret=True))(
        jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(gz, getattr(jnp, dtype)))
    for other in (jk, plain):
        other = np.asarray(other, np.float32)
        scale = float(np.abs(other).max())
        np.testing.assert_allclose(mine.numpy(), other, rtol=0, atol=TOL * scale)


def test_k1_k2_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise: a CPU tensor goes to the plain
    version through ops, never through a wrapper."""
    with pytest.raises(ValueError, match="CUDA"):
        segment_matmul_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                            torch.zeros(4, 8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        csim_argmax_cuda(torch.zeros(4, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        segment_matmul_batched_cuda(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4),
                                    torch.zeros(2, 4, 8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        csim_argmax_batched_cuda(torch.zeros(2, 4, 8), torch.zeros(2, 2, 8))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
def _clear(x, c):
    x32, c32 = x.float(), c.float()
    csim = (x32 @ c32.T) / (x32.norm(dim=1).clamp_min(NORM_EPS)[:, None]
                            * c32.norm(dim=1).clamp_min(NORM_EPS)[None])
    top2 = csim.abs().topk(min(2, c.shape[0]), dim=1).values
    return (top2[:, 0] - top2[:, -1]) > MARGIN


@pytest.mark.parametrize("b,n,k", [(512, 256, 16), (300, 200, 7), (256, 96, 128), (100, 33, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_chunk_walk_matches_jax_kernel_and_oracle(b, n, k, dtype):
    rng = np.random.default_rng(b + n + k)
    x = rng.standard_normal((b, n), dtype=np.float32)
    x[3] = 0                                                # a zero row, not a generator
    sel = rng.permutation(np.delete(np.arange(b), 3))[:k]   # (the JAX oracle flushes 1e-40)
    xj, xt = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    cs, f, na = chunked_argmax(xt, xt[torch.from_numpy(sel)])
    assert f.dtype == torch.int32 and int(f.max()) < k and int(f[3]) == 0 and float(cs[3]) == 0
    clear = _clear(xt, xt[torch.from_numpy(sel)]).numpy()
    plain = csim_argmax_ref(xt, xt[torch.from_numpy(sel)])
    for o_cs, o_f, o_na in (plain, csim_argmax(xj, xj[sel], interpret=True),
                            jax_ref.csim_argmax_ref(xj, xj[sel])):
        o_cs, o_na = np.asarray(o_cs, np.float32), np.asarray(o_na, np.float32)
        np.testing.assert_allclose(np.abs(cs.numpy()), np.abs(o_cs), rtol=0, atol=TOL)
        np.testing.assert_allclose(na.numpy(), o_na, rtol=TOL, atol=1e-6)
        np.testing.assert_array_equal(f.numpy()[clear], np.asarray(o_f)[clear])


def test_k1_chunk_walk_breaks_ties_across_chunks_to_the_lowest_index():
    """Integer data, so every dot and norm is exact in f32: generator 19
    (chunk 1) and 35 (chunk 2) repeat generator 3 (chunk 0), 35 with the
    opposite sign. A row equal to c_3 ties at 3, 19
    and 35 and must take 3 with cs +1; a row equal to -c_19 takes 3 with
    cs -1; a zero row takes 0 with cs 0."""
    rng = np.random.default_rng(17)
    b, n, k = 64, 64, 40
    c = rng.integers(-2, 3, (k, n)).astype(np.float32)
    c[19], c[35] = c[3], -c[3]
    x = rng.integers(-2, 3, (b, n)).astype(np.float32)
    x[0], x[1], x[2] = c[3], -c[19], 0
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    cs, f, na = chunked_argmax(xt, ct)
    assert f[:3].tolist() == [3, 3, 0]
    assert cs[:3].tolist() == [pytest.approx(1.0, abs=1e-6), pytest.approx(-1.0, abs=1e-6), 0.0]
    clear = _clear(xt, ct).numpy()
    clear[:3] = True
    for o_cs, o_f, _ in (csim_argmax_ref(xt, ct),
                         csim_argmax(jnp.asarray(x), jnp.asarray(c), interpret=True),
                         jax_ref.csim_argmax_ref(jnp.asarray(x), jnp.asarray(c))):
        np.testing.assert_array_equal(f.numpy()[clear], np.asarray(o_f)[clear])
        np.testing.assert_allclose(cs.numpy()[:3], np.asarray(o_cs)[:3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("E", [1, 3])
def test_k1_batched_chunk_walk_matches_the_batched_plain_version(E):
    """The batched K1 runs the 2-D body per expert (blockIdx.y): each
    expert's chunk walk against the batched plain version, the indices
    where the margin is clear; an all-zero expert gives cs 0, index 0 and
    norm 0."""
    b, n, k = 200, 64, 20
    rng = np.random.default_rng(E + 11)
    x = rng.standard_normal((E, b, n), dtype=np.float32)
    x[0] = 0
    sel = np.stack([rng.permutation(b)[:k] for _ in range(E)])
    xt = torch.from_numpy(x)
    c = xt[torch.arange(E)[:, None], torch.from_numpy(sel)]
    cs, f, na = csim_argmax_batched_ref(xt, c)
    assert float(cs[0].abs().max()) == 0 and int(f[0].abs().max()) == 0
    assert float(na[0].max()) == 0
    for e in range(E):
        cs_e, f_e, na_e = chunked_argmax(xt[e], c[e])
        np.testing.assert_allclose(np.abs(cs_e.numpy()), np.abs(cs[e].numpy()), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(na_e.numpy(), na[e].numpy(), rtol=TOL, atol=1e-6)
        clear = _clear(xt[e], c[e]).numpy()
        np.testing.assert_array_equal(f_e.numpy()[clear], f[e].numpy()[clear])
