"""Integrity-checked, atomic, async checkpointing in the JAX package's
on-disk format (``repro/checkpoint/checkpointer.py``).

Layout of a checkpoint directory::

    <root>/step_000123/
        arrays.npz          # flattened tree, keyed by the path JAX's
                            # keystr gives (".params['stages'][0][0]['attn']['wq']")
        manifest.json       # step, extra metadata; shape, dtype, crc32 per array

so a checkpoint the JAX package wrote loads here and one written here
loads there. A tree is nested dicts, lists, tuples and NamedTuples with
tensor, numpy or Python-number leaves; a NamedTuple's field is ``.name``,
a dict key ``['key']``, a sequence index ``[i]``, as in keystr.
:func:`repro_torch.bridge.train_state_tree` gives a port ``TrainState``
the JAX ``TrainState``'s tree.

  * atomic publish: written to ``<dir>.tmp``, then ``os.rename``;
  * CRC32 of every array's bytes, verified on load;
  * async save on a thread (:class:`CheckpointManager`), keep-last-N;
  * bf16 leaves: numpy has no such dtype, and JAX writes them as raw void
    bytes (``V2``) with ``"bfloat16"`` in the manifest. The port writes and
    reads them the same way, moving the bits through an int16, so it
    needs no ``ml_dtypes``.

Elastic re-sharding on load (``shardings=``) waits for the multi-GPU slice.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

LATER_SLICE_SHARDINGS = ("elastic re-sharding on load (shardings=) arrives with the "
                         "port's multi-GPU slice")
_STEP_RE = re.compile(r"^step_(\d{9})$")
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(keystr piece, child) of a container node; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in sorted(tree.items())]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = ""):
    """(keystr path, leaf) pairs; None leaves are empty nodes, as in JAX."""
    items = _items(tree)
    if items is None:
        if tree is not None:
            yield prefix, tree
        return
    for piece, child in items:
        yield from _leaves(child, prefix + piece)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (the array npz stores, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # its bits, as JAX's raw 2-byte words
            return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree):
    """The tree with every tensor leaf copied to the host now."""
    items = _items(tree)
    if items is None:
        return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree
    kids = [_snapshot(child) for _, child in items]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), kids))
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    return type(tree)(kids)


def save(root: str, step: int, tree, *, extra_meta: dict | None = None) -> str:
    """Synchronous atomic save. Returns the published directory."""
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "extra": extra_meta or {},
        "arrays": {
            k: {"shape": list(v.shape), "dtype": dtypes[k],
                "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
            for k, v in arrays.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(root, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _from_numpy(arr: np.ndarray, dtype_name: str, like):
    """A stored array as a leaf of ``like``'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        if arr.dtype.kind == "V":
            if dtype_name != "bfloat16":
                raise TypeError(f"no torch view for a stored {dtype_name} leaf")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if arr.dtype.kind == "V":
        raise TypeError(f"a {dtype_name} leaf loads only into a tensor")
    if isinstance(like, np.ndarray | np.generic):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def _rebuild(like, values):
    items = _items(like)
    if items is None:
        return None if like is None else next(values)
    kids = [_rebuild(child, values) for _, child in items]
    if isinstance(like, dict):
        return dict(zip(sorted(like), kids))
    if _is_namedtuple(like):
        return type(like)(*kids)
    return type(like)(kids)


def load(root: str, like_tree, *, step: int | None = None, shardings=None,
         verify: bool = True):
    """Restore into the structure of ``like_tree`` (each leaf takes the
    kind, dtype and device of its ``like`` leaf). Returns (tree, step)."""
    if shardings is not None:
        raise NotImplementedError(LATER_SLICE_SHARDINGS)
    steps = available_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step = steps[-1] if step is None else step
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    values = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, like in _leaves(like_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            meta = manifest["arrays"][key]
            if verify and zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
                raise IOError(f"CRC mismatch for {key}: checkpoint corrupt")
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
            values.append(_from_numpy(arr, meta["dtype"], like))
    return _rebuild(like_tree, iter(values)), manifest["step"]


class CheckpointManager:
    """Async save + keep-last-N GC."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(root, exist_ok=True)

    def wait(self):
        """Join the pending save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra_meta=None):
        self.wait()
        host_tree = _snapshot(tree)   # the leaves as they are now

        def work():
            try:
                save(self.root, step, host_tree, extra_meta=extra_meta)
                self._gc()
            except Exception as err:   # re-raised by wait()
                self._error = err

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree, extra_meta=None):
        self.wait()
        save(self.root, step, tree, extra_meta=extra_meta)
        self._gc()

    def _gc(self):
        steps = available_steps(self.root)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = available_steps(self.root)
        return steps[-1] if steps else None
