"""Random draws of the compression sites, keyed by where they happen.

The JAX package derives every site's randomness from one threefry key
chain: ``fold_in(seed_key, step)`` per step, then per stage / layer /
block / site (``fold_in``, ``split``), and draws generator rows with
``jax.random.choice`` and CompAct projections with ``jax.random.normal``.
PyTorch cannot reproduce threefry, so the port keeps the chain as a
*path*: a :class:`Key` records the same ``fold_in`` / ``split`` steps, and
a sampler turns (seed, path) into draws.

The default sampler, :class:`TorchSampler`, seeds a ``torch.Generator`` on
the site's device with a hash of (seed, path) and draws
``torch.randperm(b)[:k]`` or ``torch.randn`` (the experts of a MoE site
in one draw: :func:`choice_batched`). A caller that wants other
draws (a test holding the port to the JAX package's threefry streams, or a
check that compares the card with the CPU) passes its own sampler with the
same two methods; the path is what makes both streams line up.
"""
from __future__ import annotations

import hashlib

import torch


class TorchSampler:
    """Draws from a ``torch.Generator`` seeded with a hash of (seed, path),
    on the device the draw is for."""

    @staticmethod
    def _generator(seed: int, path: tuple, device) -> torch.Generator:
        digest = hashlib.blake2b(repr((seed, path)).encode(), digest_size=8).digest()
        return torch.Generator(device=device).manual_seed(
            int.from_bytes(digest, "little") & (2**63 - 1))

    def choice(self, seed: int, path: tuple, b: int, k: int, device) -> torch.Tensor:
        """``k`` distinct row indices of ``range(b)`` (int64)."""
        gen = self._generator(seed, path, device)
        return torch.randperm(b, generator=gen, device=device)[:k]

    def normal(self, seed: int, path: tuple, shape, device) -> torch.Tensor:
        """Standard normal f32 draws of ``shape``."""
        gen = self._generator(seed, path, device)
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    def choice_batched(self, seed: int, paths: tuple, b: int, k: int,
                       device) -> torch.Tensor:
        """``k`` distinct rows of ``range(b)`` for each path, (len(paths), k)
        int64, from one generator and one sort: the rows of a uniform
        random permutation per path (f64 keys, so ties are negligible).
        Paths that are children of one ``split(num)`` draw what the whole
        split draws and keep their own rows of it, so a subset of the
        experts (a rank's share under expert parallelism) draws what those
        experts draw together with the others."""
        parent, last = paths[0][:-1], paths[0][-1] if paths[0] else ("",)
        if last[0] == "split" and all(p[:-1] == parent and p[-1][:2] == last[:2]
                                      for p in paths):
            gen = self._generator(seed, parent + (last[:2],), device)
            rows = torch.tensor([p[-1][2] for p in paths], device=device)
            keys = torch.rand((last[1], b), generator=gen, device=device,
                              dtype=torch.float64)[rows]
        else:
            gen = self._generator(seed, paths, device)
            keys = torch.rand((len(paths), b), generator=gen, device=device,
                              dtype=torch.float64)
        return keys.argsort(dim=1)[:, :k]


class Key:
    """A point of the key chain: the run seed plus the ``fold_in`` /
    ``split`` steps that lead to it, and the sampler that draws there."""

    __slots__ = ("seed", "path", "sampler")

    def __init__(self, seed: int, path: tuple = (), sampler=None):
        self.seed = int(seed)
        self.path = tuple(path)
        self.sampler = sampler if sampler is not None else TorchSampler()

    def fold_in(self, data: int) -> "Key":
        return Key(self.seed, self.path + (("fold_in", int(data)),), self.sampler)

    def split(self, num: int) -> list["Key"]:
        return [Key(self.seed, self.path + (("split", int(num), i),), self.sampler)
                for i in range(num)]

    def choice(self, b: int, k: int, device) -> torch.Tensor:
        """``k`` distinct rows of ``range(b)`` (jax.random.choice without
        replacement)."""
        return self.sampler.choice(self.seed, self.path, b, k, device)

    def normal(self, shape, device) -> torch.Tensor:
        return self.sampler.normal(self.seed, self.path, tuple(shape), device)

    def __repr__(self) -> str:
        return f"Key(seed={self.seed}, path={self.path})"


def choice_batched(keys: list[Key], b: int, k: int, device) -> torch.Tensor:
    """Each key's :meth:`Key.choice`, stacked (len(keys), k): the MoE
    site's experts. The keys share a seed and a sampler (``Key.split``);
    :class:`TorchSampler` draws them all at once, and any other sampler (a
    test's threefry or numpy draws) key by key."""
    sampler = keys[0].sampler
    if isinstance(sampler, TorchSampler):
        return sampler.choice_batched(keys[0].seed, tuple(key.path for key in keys),
                                      b, k, device)
    return torch.stack([key.choice(b, k, device) for key in keys])
