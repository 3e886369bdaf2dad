"""Atomic checkpoints of a tree of tensors — counterpart of
`repro.checkpointing.checkpoint`, in the same format.

Format: `<path>.npz` of path-flattened leaves plus `<path>.manifest.json`
(step, each leaf's dtype and shape, user metadata). A tree is nested
dicts, lists / tuples and NamedTuples (fields by name) whose leaves are
tensors or numpy arrays; other values (ints such as `QuantMoment.size`,
None) are structure and come from the target tree on restore. Keys join
the path with "/", as the JAX package's do. Writes go to a temp name and
are renamed into place (`os.replace`), so a preempted writer never
leaves a half checkpoint that restore would accept.

numpy has no bfloat16: a bf16 leaf is saved as its uint16 view with
"bfloat16" in the manifest and restored bit for bit. `restore(...,
device=)` puts every leaf on one device (the reference's `shardings=`):
a checkpoint written from the card restores on the CPU and the other way
round; by default each leaf goes where the target's leaf lives.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

_SEP = "/"


def _items(tree, prefix=()):
    """(path tuple, leaf) for every tensor / array leaf, in tree order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _items(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))


def _rebuild(tree, leaves):
    """`tree`'s structure with its tensor / array leaves taken in order
    from the iterator `leaves`."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaves) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _flatten(tree) -> dict:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save(path: str, tree, step: int = 0, metadata: Optional[dict] = None) -> str:
    """Atomic save of `<path>.npz` and `<path>.manifest.json`; returns path."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": int(step),
        "keys": {k: [dtype, list(a.shape)] for k, (a, dtype) in flat.items()},
        "metadata": metadata or {},
    }
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    mtmp = tmp + ".manifest"
    try:
        np.savez(tmp, **{k: a for k, (a, _) in flat.items()})
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path + ".npz")
        os.replace(mtmp, path + ".manifest.json")
    finally:
        for t in (tmp, mtmp):
            if os.path.exists(t):
                os.unlink(t)
    return path


def load_manifest(path: str) -> dict:
    with open(path + ".manifest.json") as f:
        return json.load(f)


def _leaf(arr: np.ndarray, dtype: str, target, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(target, np.ndarray):
        return t.numpy().astype(target.dtype)
    dev = target.device if device is None else torch.device(device)
    return t.to(device=dev, dtype=target.dtype)


def restore(path: str, target_tree, device=None):
    """Restore into the structure of `target_tree` (shapes must match),
    each leaf cast to the target leaf's dtype and put on `device` (None:
    the target leaf's device)."""
    dtypes = {k: v[0] for k, v in load_manifest(path)["keys"].items()}
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    out = []
    for p, leaf in _items(target_tree):
        key = _SEP.join(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(leaf.shape)}")
        out.append(_leaf(arr, dtypes.get(key, str(arr.dtype)), leaf, device))
    return _rebuild(target_tree, iter(out))
