"""What the gloo ranks of ``tests/test_torch_ring.py``,
``tests/test_torch_distributed.py``, ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_expert_parallel.py``,
``tests/test_torch_ssm_rec_parallel.py`` and
``tests/test_torch_xattn_audio_rev_parallel.py`` run (``repro_torch.launch.ranks``
starts them). This module imports neither JAX nor the JAX package, so a
spawned rank starts in the time torch takes to import; draws of the JAX
key chain reach a rank as a table (:class:`TableSampler`) recorded in the
test process.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config
from repro_torch.kernels import ring_attention as tring
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.runtime import sharding as tsh
from repro_torch.train import init_distributed_state, make_shard_map_train_step
from repro_torch.train.distributed import zero1_of

TIMEOUT = 240


class TableSampler:
    """Generator rows looked up by (seed, path, b, k), and normal draws by
    (seed, path, shape), in a table recorded from another sampler; a draw
    the table lacks raises KeyError."""

    def __init__(self, table: dict):
        self.table = table

    def choice(self, seed, path, b, k, device):
        return torch.from_numpy(self.table[(seed, path, b, k)]).to(device)

    def normal(self, seed, path, shape, device):
        return torch.from_numpy(self.table[(seed, path, tuple(shape))]).to(device)


def _gate_before_exit(gate, out, mg, split):
    """An xattn block's gate on the row-parallel partial sums, before they
    leave the model group."""
    from repro_torch.runtime.collectives import tp_exit

    return tp_exit(torch.tanh(gate.to(out.dtype)) * out, mg, split)


# fault: (module under repro_torch.models, or a dotted path under
# repro_torch; attribute; what replaces it)
PLANTS = {
    # a wrong share of MoE's balance loss's gradient: on every rank, on none
    "aux_doubled": ("moe", "aux_grad_share", lambda tp: 1.0),
    "aux_missing": ("moe", "aux_grad_share", lambda tp: 0.0),
    # the ssm out_norm's sum of squares over the rank's columns only
    "norm_local": ("ssm", "model_sum", lambda t, mg: t),
    # Mamba-2's whole B / C columns' gradient left as each rank's part
    "bc_unsummed": ("ssm", "copy_cols_to_model", lambda w, mg, start, stop: w),
    # RG-LRU's whole lambda: each rank's part of its gradient left unsummed
    "lambda_unsummed": ("rglru", "copy_to_model", lambda t, mg: t),
    # gate_attn applied to each rank's partial sums of the xattn output
    "gate_before_exit": ("attention", "_gate", _gate_before_exit),
    # under seq_shard, gate_attn's gradient left as this rank's chunk's
    "gate_unsummed": ("attention", "seq_param", lambda p, mg: p),
    # musicgen's head cut in one contiguous slice (whole codebooks a rank)
    "head_contiguous": ("runtime.sharding", "head_parts",
                        lambda cfg, v: ((v * max(1, cfg.n_codebooks), True),)),
    # under seq_shard, the reversible sublayers' norms without seq_param
    "rev_norm_unsummed": ("blocks", "seq_param", lambda p, mg: p),
}


def _plant(fault: str | None):
    """Plant ``fault`` (:data:`PLANTS`) in this rank's modules; returns
    what undoes it."""
    import importlib

    if fault is None:
        return lambda: None
    name, attr, fake = PLANTS[fault]
    mod = importlib.import_module(f"repro_torch.{name}" if "." in name
                                  else f"repro_torch.models.{name}")
    real = getattr(mod, attr)
    setattr(mod, attr, fake)

    def undo():
        setattr(mod, attr, real)
    return undo


def _recording_split_states(out: list):
    """Record the (alpha, assign, beta) of every PAMM state K1's split route
    makes, and the sketch of every split CompAct state; returns what
    undoes it."""
    from repro_torch.core import policies

    reals = {c: c.compress_split for c in (policies.PammPolicy, policies.CompActPolicy)}

    def wrap(real):
        def compress_split(self, x2d, key, mg):
            st = real(self, x2d, key, mg)
            leaves = (st.alpha, st.assign, st.beta) if hasattr(st, "alpha") else (st.sketch,)
            out.append([t.detach().cpu().numpy().copy() for t in leaves])
            return st
        return compress_split

    for c, real in reals.items():
        c.compress_split = wrap(real)

    def undo():
        for c, real in reals.items():
            c.compress_split = real
    return undo


def _recording_streams(out: list):
    """Record every reversible stream add (``blocks._dd_add``) of the next
    loss and backward as (hi, lo, b, out_hi, out_lo); returns what undoes
    it."""
    from repro_torch.models import blocks

    real = blocks._dd_add

    def recording(hi, lo, b):
        got = real(hi, lo, b)
        out.append([t.detach().clone() for t in (hi, lo, b, *got)])
        return got

    blocks._dd_add = recording

    def undo():
        blocks._dd_add = real
    return undo


def _streams_rebuilt(calls: list) -> list:
    """Per (layer, block) of a one-stage, one-kind reversible stack, from
    its recorded adds: whether the backward rebuilt both input streams
    (hi and lo) and recomputed F and G bit for bit. The forward's 2n adds
    (y1 = x1 + F(x2), y2 = x2 + G(y1)) come first, then the backward's,
    top down (x2 = y2 - G(y1), then x1 = y1 - F(x2))."""
    n = len(calls) // 4
    fwd, bwd = calls[:2 * n], calls[2 * n:]
    out = []
    for r in range(n):
        a, b, c, d = fwd[2 * r], fwd[2 * r + 1], bwd[2 * (n - 1 - r)], bwd[2 * (n - 1 - r) + 1]
        out.append(bool(torch.equal(c[2], -b[2]) and torch.equal(d[2], -a[2])
                        and torch.equal(c[3], b[0]) and torch.equal(c[4], b[1])
                        and torch.equal(d[3], a[0]) and torch.equal(d[4], a[1])))
    return out


def _ring_cases(mesh, cases):
    """This rank's shard of o and of the gradients of sum(sin(o)) for each
    (q, k, v, window) over the whole sequence."""
    cp, c = tsh.cp_degree(mesh), mesh.coord("context")
    out = []
    with tsh.context_parallel(mesh) as ring:
        for q, k, v, window in cases:
            L = q.shape[1]
            keep = tring.zigzag_permutation(L, cp)[c * L // cp:(c + 1) * L // cp]
            qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(x[:, keep])).requires_grad_()
                          for x in (q, k, v))
            o = tring.ring_attention(qs, ks, vs, ring=ring, causal=True, window=window)
            grads = torch.autograd.grad(torch.sin(o).sum(), (qs, ks, vs))
            out.append([t.detach().numpy() for t in (o, *grads)])
    return out


def _numpy(tree: dict) -> dict:
    return {n: t.detach().cpu().numpy().copy() for n, t in tree.items()}


def _train(mesh, rank, run: dict) -> dict:
    """One run of the mesh executor: per-step metrics (floats), and what
    ``run["collect"]`` asks for. ``run["cfg"]``: fields of the arch's
    config to replace; ``run["start"]``: the first step's index; the
    parameters ``run["params"]`` (the whole JAX tree) reach each rank as
    its model-axis slices, and ``params`` / ``state`` come back whole."""
    cfg = dataclasses.replace(get_config(run["arch"]), **run.get("cfg", {}))
    rcfg = RunConfig(**run["rcfg"])
    out = {"metrics": [], "ef_norms": [], "split_states": []}
    # planted before the parameters are sliced: a fault of the layout
    # slices them its way
    undo = [_plant(run.get("plant"))]
    model = None
    if run.get("params") is not None:
        model = bridge.shard_jax_params(run["params"], cfg, mesh, device="cpu")
    state = init_distributed_state(cfg, rcfg, mesh, device="cpu", model=model)
    start = run.get("start", 0)
    step = make_shard_map_train_step(cfg, rcfg, total_steps=run.get(
        "total_steps", start + len(run["batches"])), mesh=mesh, sampler=run.get("sampler"))
    collect = run.get("collect", ())
    if "split_states" in collect:
        undo.append(_recording_split_states(out["split_states"]))
    calls = []
    if "streams" in collect:        # the first step's
        undo.append(_recording_streams(calls))
    if "router_grads" in collect:
        # the first batch's gradients after the sync, the router leaves'
        from repro_torch.train.distributed import make_shard_map_grads

        grads_fn = make_shard_map_grads(cfg, rcfg, mesh=mesh, sampler=run.get("sampler"))
        _, _, g = grads_fn.rank_grads(state.params, run["batches"][0], start)
        g, _ = grads_fn.sync_grads(g, state.ef)
        out["router_grads"] = _numpy({n: t for n, t in g.items() if n.endswith("router")})
    for i, batch in enumerate(run["batches"], start=start):
        state, m = step(state, batch, i)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if calls and "streams" not in out:
            out["streams"] = _streams_rebuilt(calls)
            undo.pop()()
        if state.ef is not None:
            out["ef_norms"].append(float(torch.sqrt(sum((e * e).sum()
                                                        for e in state.ef.values()))))
    for u in undo:
        u()
    params = dict(state.params.named_parameters())
    if "params" in collect:
        whole = params
        if tsh.tp_degree(mesh) > 1:
            tree = bridge.gathered_train_state_tree(state, mesh, rcfg, cfg)
            whole = bridge._flatten(tree.params)
        if rank == 0:
            out["params"] = _numpy(whole)
    if "state" in collect:
        tree = bridge.gathered_train_state_tree(state, mesh, rcfg, cfg)
        if rank == 0:
            out["m"] = _numpy(bridge._flatten(tree.opt.m))
            out["v"] = _numpy(bridge._flatten(tree.opt.v))
            out["ef"] = None if tree.ef is None else _numpy(bridge._flatten(tree.ef))
    if "local" in collect:
        zero1 = zero1_of(rcfg, mesh, params)
        out["layout"] = None if zero1 is None else zero1[0]
        out["m_local"] = _numpy(state.opt.m)
        out["ef_local"] = None if state.ef is None else _numpy(state.ef)
    return out


def _psum(mesh, rank, g):
    """``compressed_psum`` of this rank's row of ``g`` from a zero residue,
    over the sync group: (the mean, this rank's new residue)."""
    from repro_torch.runtime.grad_compress import compressed_psum

    x = torch.from_numpy(g[rank])
    out, err = compressed_psum(x, torch.zeros_like(x), mesh.sync_group, mesh.size, mesh.comm)
    return out.numpy(), err.numpy()


def job(rank, world, shape, ring_cases, runs, psum=None):
    """One mesh shape's work on one rank: the ring cases, the runs, and a
    ``compressed_psum`` of ``psum``'s rows when given."""
    mesh = make_debug_mesh(*shape, timeout=TIMEOUT)
    return {"ring": _ring_cases(mesh, ring_cases),
            "runs": [_train(mesh, rank, run) for run in runs],
            "psum": None if psum is None else _psum(mesh, rank, psum)}


def fail_on(rank, world, bad):
    """Rank ``bad`` raises; the others wait for it at a barrier."""
    import torch.distributed as dist

    if rank == bad:
        raise ValueError(f"rank {rank} was told to fail")
    dist.barrier()


def sleep(rank, world, seconds):
    import time

    time.sleep(seconds)
