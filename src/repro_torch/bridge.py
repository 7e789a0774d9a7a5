"""Parameter bridge between the JAX package's tree and the port's modules.

The JAX ``models.init_model`` returns a nested dict::

    {"embed": (V, d), "stages": [[{ "norm1": (rep, d), "attn": {"wq": ...},
     "norm2": ..., "ffn": {...}} per unit kind] per stage],
     "final_norm": (d,), "head": (d, V)}

with every block leaf stacked over its stage's layers; an embed-input
arch's tree (musicgen) has no ``embed`` leaf, and its head is (d, V x
n_codebooks). Given that tree
with each leaf converted to numpy (``np.asarray``; the caller does that,
so nothing here imports JAX), :func:`from_jax_params` builds the port's
:class:`~repro_torch.models.Model` name for name and layer for layer, in
the same layouts (``w`` is ``(n_in, n_out)``). :func:`to_jax_params` is
the inverse, returning numpy leaves.

:func:`opt_state_to_jax` and :func:`opt_state_from_jax` carry an optimizer
state the same way: the JAX ``OptState`` as ``(step, m, v)`` with ``m``
and ``v`` trees of numpy leaves shaped like the parameter tree.

:func:`train_state_tree` gives a port ``TrainState`` the JAX
``TrainState``'s tree with the port's own tensors as leaves (what the
checkpointer writes, under the JAX paths), and
:func:`install_train_state_tree` puts such a tree back.
:func:`gathered_train_state_tree` does it for a rank of the mesh executor:
the parameters and moments gathered whole over the model axis, the ZeRO-1
moments over the data axis, and the error-feedback residues of every rank
stacked, as the JAX ``TrainState`` holds them. :func:`shard_jax_params`
gives one rank of a mesh with a model degree above 1 its slices of a JAX
tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import blocks as blk
from repro_torch.models.model import Model, _padded_vocab, resolve_device, shard_module_
from repro_torch.runtime import sharding as sh


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


def from_jax_params(params: dict, cfg, device="cuda", trainable: bool = False) -> Model:
    """Port model holding the JAX parameters ``params`` (numpy leaves);
    with ``trainable`` its parameters require grad."""
    device = resolve_device(device)
    conv = lambda a: _to_torch(a, device)
    stages = [[blk.Block(kind, _tree(node, conv), trainable)
               for kind, node in zip(unit, stage)]
              for (unit, _), stage in zip(cfg.stages, params["stages"])]
    embed = conv(params["embed"]) if "embed" in params else None
    return Model(embed, stages, conv(params["final_norm"]), conv(params["head"]), trainable)


def shard_jax_params(params: dict, cfg, mesh, device="cuda", trainable: bool = True) -> Model:
    """One rank's port model of the JAX tree ``params`` (numpy leaves, the
    whole model): of every leaf the model axis of ``mesh`` splits
    (``runtime.sharding.model_cut``), this rank's slice; the other leaves
    whole."""
    return shard_module_(from_jax_params(params, cfg, device=device, trainable=trainable),
                         mesh, cfg)


def _module_tree(mod: torch.nn.Module) -> dict:
    out = {name: _to_numpy(p) for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        out[name] = _module_tree(child)
    return out


def to_jax_params(model: Model) -> dict:
    """Inverse of :func:`from_jax_params`: the JAX tree with numpy leaves
    (``embed`` only where the model has one)."""
    tree = {} if model.embed is None else {"embed": _to_numpy(model.embed)}
    tree.update(stages=[[_module_tree(block) for block in stage] for stage in model.stages],
                final_norm=_to_numpy(model.final_norm), head=_to_numpy(model.head))
    return tree


def _nest(flat: dict, model: Model) -> dict:
    """A flat dict keyed by the model's parameter names -> the JAX tree."""
    out: dict = {"stages": [[{} for _ in stage] for stage in model.stages]}
    for name, val in flat.items():
        parts = name.split(".")
        if parts[0] != "stages":
            out[name] = val
            continue
        node = out["stages"][int(parts[1])][int(parts[2])]
        for part in parts[3:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    """The JAX tree -> a flat dict keyed like ``model.named_parameters()``."""
    out = {}
    for name, val in tree.items():
        if name == "stages" and not prefix:
            for si, stage in enumerate(val):
                for bi, node in enumerate(stage):
                    out.update(_flatten(node, f"stages.{si}.{bi}."))
        elif isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = val
    return out


def opt_state_to_jax(opt, model: Model):
    """The port's ``OptState`` -> (step, m, v): numpy leaves in the JAX
    parameter tree's structure."""
    return (np.int32(int(opt.step)),
            _nest({n: _to_numpy(t) for n, t in opt.m.items()}, model),
            _nest({n: _to_numpy(t) for n, t in opt.v.items()}, model))


def opt_state_from_jax(step, m: dict, v: dict, model: Model):
    """(step, m, v) with numpy leaves in the JAX tree -> the port's
    ``OptState`` on the model's device."""
    from repro_torch.optim import OptState

    dev = model.device
    conv = lambda tree: {n: _to_torch(a, dev) for n, a in _flatten(tree).items()}
    return OptState(step=int(np.asarray(step)), m=conv(m), v=conv(v))


def train_state_tree(state):
    """A port ``TrainState`` as the JAX ``TrainState``'s tree, its leaves
    the port's tensors (no copy): ``params`` the JAX parameter tree,
    ``opt`` an ``OptState`` of an int32 step and the moments in that tree."""
    from repro_torch.optim import OptState
    from repro_torch.train.train_step import TrainState

    model = state.params
    params = _nest({n: p.detach() for n, p in model.named_parameters()}, model)
    return TrainState(params=params, opt=OptState(
        step=np.int32(state.opt.step), m=_nest(state.opt.m, model),
        v=_nest(state.opt.v, model)))


def install_train_state_tree(state, tree):
    """Inverse of :func:`train_state_tree`: copies ``tree``'s parameters
    into ``state``'s model in place and returns the ``TrainState`` with
    the tree's optimizer state."""
    from repro_torch.optim import OptState
    from repro_torch.train.train_step import TrainState

    model = state.params
    flat = _flatten(tree.params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(flat[name])
    opt = OptState(step=int(tree.opt.step), m=_flatten(tree.opt.m), v=_flatten(tree.opt.v))
    return TrainState(params=model, opt=opt)


def gathered_train_state_tree(state, mesh, rcfg, cfg=None):
    """A mesh rank's ``TrainState`` as the JAX ``TrainState``'s tree, whole:
    the parameters and AdamW moments gathered over the model axis (its
    slices of them; ``cfg`` says which leaves are split, needed for a model
    degree above 1), the moments from the data ranks' ZeRO-1 slices first,
    and, under int8_ef, every rank's error-feedback residues stacked
    (n_shards, *param.shape) in shard order (``ef``; None otherwise). A
    collective: every rank of the mesh calls it."""
    from repro_torch.optim import OptState
    from repro_torch.runtime.collectives import gather_model_
    from repro_torch.train.distributed import gathered_error_buffers, gathered_moments
    from repro_torch.train.train_step import TrainState

    model = state.params
    m, v = gathered_moments(state, mesh, rcfg)
    ef = gathered_error_buffers(state, mesh)
    flat = {n: p.detach() for n, p in model.named_parameters()}
    if sh.tp_degree(mesh) > 1:
        if cfg is None:
            raise ValueError("gathering over the model axis needs the model config (cfg=)")
        v_pad, e_pad = _padded_vocab(cfg, rcfg), sh.padded_experts(cfg, rcfg)
        layout = sh.model_layout(flat, cfg, v_pad, e_pad)
        mg = sh.make_model_group(mesh, cfg, rcfg, v_pad)
        flat, m, v = (gather_model_(t, layout, mg) for t in (flat, m, v))
    params = _nest(flat, model)
    return TrainState(params=params,
                      opt=OptState(step=np.int32(state.opt.step), m=_nest(m, model),
                                   v=_nest(v, model)),
                      ef=None if ef is None else _nest(ef, model))
