"""Parameter bridge between the JAX package's tree and the port's modules.

The JAX ``models.init_model`` returns a nested dict::

    {"embed": (V, d), "stages": [[{ "norm1": (rep, d), "attn": {"wq": ...},
     "norm2": ..., "ffn": {...}} per unit kind] per stage],
     "final_norm": (d,), "head": (d, V)}

with every block leaf stacked over its stage's layers. Given that tree
with each leaf converted to numpy (``np.asarray``; the caller does that,
so nothing here imports JAX), :func:`from_jax_params` builds the port's
:class:`~repro_torch.models.Model` name for name and layer for layer, in
the same layouts (``w`` is ``(n_in, n_out)``). :func:`to_jax_params` is
the inverse, returning numpy leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import blocks as blk
from repro_torch.models.model import Model, resolve_device


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def from_jax_params(params: dict, cfg, device="cuda") -> Model:
    """Port model holding the JAX parameters ``params`` (numpy leaves)."""
    device = resolve_device(device)
    conv = lambda a: _to_torch(a, device)
    if "embed" not in params:
        raise NotImplementedError("embed-input archs are not served by the port")
    stages = [[blk.Block(kind, _tree(node, conv)) for kind, node in zip(unit, stage)]
              for (unit, _), stage in zip(cfg.stages, params["stages"])]
    return Model(conv(params["embed"]), stages, conv(params["final_norm"]),
                 conv(params["head"]))


def _module_tree(mod: torch.nn.Module) -> dict:
    out = {name: _to_numpy(p) for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        out[name] = _module_tree(child)
    return out


def to_jax_params(model: Model) -> dict:
    """Inverse of :func:`from_jax_params`: the JAX tree with numpy leaves."""
    return {
        "embed": _to_numpy(model.embed),
        "stages": [[_module_tree(block) for block in stage] for stage in model.stages],
        "final_norm": _to_numpy(model.final_norm),
        "head": _to_numpy(model.head),
    }
