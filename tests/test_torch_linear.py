"""The port's compressed linear layer (``core/linear.py``): a compressed
site saves no (b, n) tensor for backward, its forward and grad_x /
grad_bias are exact, and its grad_W equals the JAX package's
``compressed_linear`` for every policy when both draw the same rows
(the JAX key chain replayed by :class:`JaxSampler`). After
``tests/test_linear_vjp.py``.

Tolerances: forward, grad_x and grad_bias 1e-5 against the exact f32
products (the same f32 math); grad_W 1e-5 relative against JAX (the same
estimator on the same rows, f32 sums in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_policy as jax_make_policy
from repro.core.linear import compressed_linear
from repro.core.policies import PammPolicy as JaxPamm
from repro_torch.core.keys import Key
from repro_torch.core.linear import CompressedSite
from repro_torch.core.policies import (CompActPolicy, ExactPolicy, PammPolicy,
                                       UniformCRSPolicy)


class JaxSampler:
    """Draws of the JAX package: replays a Key's path on
    ``jax.random.key(seed)`` and draws with threefry."""

    @staticmethod
    def key(seed, path):
        key = jax.random.key(seed)
        for op in path:
            if op[0] == "fold_in":
                key = jax.random.fold_in(key, op[1])
            else:
                key = jax.random.split(key, op[1])[op[2]]
        return key

    def choice(self, seed, path, b, k, device):
        idx = jax.random.choice(self.key(seed, path), b, (k,), replace=False)
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device)

    def normal(self, seed, path, shape, device):
        p = jax.random.normal(self.key(seed, path), shape, jnp.float32)
        return torch.from_numpy(np.array(p)).to(device)


def _data(seed=0, b=256, n=32, m=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, n)).astype(np.float32)
    x = centers[rng.integers(0, 6, b)] + 0.01 * rng.standard_normal((b, n)).astype(np.float32)
    w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
    return x, w


POLICIES = {
    "pamm": (lambda: PammPolicy(ratio=1 / 8), lambda: JaxPamm(ratio=1 / 8)),
    "pamm_eps": (lambda: PammPolicy(ratio=1 / 8, eps=0.5),
                 lambda: JaxPamm(ratio=1 / 8, eps=0.5)),
    "pamm_blocked": (lambda: PammPolicy(ratio=1 / 8, n_blocks=2),
                     lambda: JaxPamm(ratio=1 / 8, n_blocks=2)),
    "uniform_crs": (lambda: UniformCRSPolicy(ratio=1 / 8),
                    lambda: jax_make_policy("uniform_crs", ratio=1 / 8)),
    "compact": (lambda: CompActPolicy(ratio=1 / 4),
                lambda: jax_make_policy("compact", ratio=1 / 4)),
}


def _site(policy):
    return CompressedSite(path="stage0.attn.attn.qkv", site_id=0, policy=policy)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_grad_w_matches_jax_compressed_linear(name):
    make_t, make_j = POLICIES[name]
    x, w = _data(1)
    g = np.random.default_rng(2).standard_normal((x.shape[0], w.shape[1])).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_()
    # the site folds its id into the key, as CompressedSite.derive_key does
    z, stats = _site(make_t()).apply(torch.from_numpy(x), wt, None,
                                     Key(4, sampler=JaxSampler()))
    (dw,) = torch.autograd.grad(z, wt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda w_: compressed_linear(
        jnp.asarray(x), w_, None, jax.random.fold_in(jax.random.key(4), 0), make_j()),
        jnp.asarray(w))
    (dw_j,) = vjp(jnp.asarray(g))
    dw_j = np.asarray(dw_j)
    assert np.linalg.norm(dw.numpy() - dw_j) / np.linalg.norm(dw_j) < 1e-5
    assert stats.shape == (5,) and float(stats[0]) > 0


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_compressed_site_saves_no_input_sized_tensor(name):
    """The paper's memory claim: the backward of a compressed projection
    holds (w, state) and never x (b, n)."""
    b, n, m = 256, 32, 24
    x = torch.randn(b, n, requires_grad=True)
    ws = [torch.randn(n, m, requires_grad=True) for _ in range(3)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs, _ = _site(POLICIES[name][0]()).apply_shared(x, ws, [None] * 3, Key(0))
    assert saved, "nothing saved: the site did not compress"
    assert (b, n) not in saved and all(math.prod(s) < b * n for s in saved), saved
    # the exact site, by contrast, saves x
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _site(ExactPolicy()).apply_shared(x, ws, [None] * 3, Key(0))
    assert (b, n) in saved


@pytest.mark.parametrize("policy", [PammPolicy(ratio=1 / 8), UniformCRSPolicy(ratio=1 / 8),
                                    CompActPolicy(ratio=1 / 4)], ids=lambda p: p.name)
def test_forward_and_grad_x_and_bias_exact(policy):
    """Only grad_W is approximated; z, grad_X and grad_bias are exact."""
    x, w = _data(3)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w)
    bias = torch.full((w.shape[1],), 0.3, requires_grad=True)
    z, _ = _site(policy).apply(xt, wt.requires_grad_(), bias, Key(5))
    torch.testing.assert_close(z, xt @ wt + bias, rtol=0, atol=1e-5)
    gx, gb = torch.autograd.grad(torch.sin(z).sum(), (xt, bias))
    x2, b2 = xt.detach().requires_grad_(), bias.detach().requires_grad_()
    gx_e, gb_e = torch.autograd.grad(torch.sin(x2 @ wt.detach() + b2).sum(), (x2, b2))
    torch.testing.assert_close(gx, gx_e, rtol=0, atol=1e-5)
    torch.testing.assert_close(gb, gb_e, rtol=0, atol=1e-5)


def test_shared_state_matches_separate_and_keys_are_required():
    """Q/K/V sharing one compressed x == separate calls with the same key;
    a stochastic site without a key raises; no grad -> nothing compressed."""
    x, w1 = _data(6)
    w2 = np.random.default_rng(7).standard_normal(w1.shape).astype(np.float32) * 0.1
    site = _site(PammPolicy(ratio=1 / 8))
    ws = [torch.from_numpy(w).requires_grad_() for w in (w1, w2)]
    z1, z2 = site.apply_shared(torch.from_numpy(x), ws, [None, None], Key(8))[0]
    g_shared = torch.autograd.grad((z1 ** 2).sum() + (z2 ** 2).sum(), ws)
    g_sep = [torch.autograd.grad((site.apply(torch.from_numpy(x), w, None, Key(8))[0] ** 2)
                                 .sum(), w)[0] for w in ws]
    for a, b in zip(g_shared, g_sep):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="needs a key"):
        site.apply(torch.from_numpy(x), ws[0], None, None)
    with torch.no_grad():
        z, stats = site.apply(torch.from_numpy(x), ws[0], None, None)
    assert stats is None and torch.allclose(z, torch.from_numpy(x) @ ws[0])


def test_grad_w_is_close_to_exact_on_clustered_rows():
    x, w = _data(4, b=1024)
    wt = torch.from_numpy(w).requires_grad_()
    z, _ = _site(PammPolicy(ratio=1 / 16)).apply(torch.from_numpy(x), wt, None, Key(5))
    (g,) = torch.autograd.grad((z ** 2).sum(), wt)
    g_e = 2 * torch.from_numpy(x).T @ (torch.from_numpy(x) @ torch.from_numpy(w))
    assert float((g - g_e).norm() / g_e.norm()) < 0.05


def test_torch_sampler_is_deterministic_and_path_dependent():
    k = Key(3).fold_in(1).split(4)[2].fold_in(7)
    a, b = k.choice(100, 10, "cpu"), k.choice(100, 10, "cpu")
    assert torch.equal(a, b) and len(set(a.tolist())) == 10
    assert not torch.equal(a, Key(3).fold_in(1).split(4)[1].fold_in(7).choice(100, 10, "cpu"))
    assert k.path == (("fold_in", 1), ("split", 4, 2), ("fold_in", 7))
    assert math.isfinite(float(k.normal((3, 2), "cpu").sum()))
