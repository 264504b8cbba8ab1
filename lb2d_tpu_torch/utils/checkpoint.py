"""Checkpoint / resume of simulation states (counterpart of
``lb2d_tpu.utils.checkpoint``).

A state (a tensor, or dicts, lists and tuples of tensors, numpy arrays and
None) saves to one self-describing ``.npz``: the leaves as ``leaf_<i>`` and
the container structure as JSON in ``__structure__``, the JAX package's
format, so a file written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state", "save_model", "restore_model"]


def _describe(obj, leaves: list):
    """Describe a tree of dict/list/tuple/None containers, appending its
    leaves to ``leaves`` in traversal order."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        return {"t": "dict",
                "keys": list(obj.keys()),
                "vals": [_describe(v, leaves) for v in obj.values()]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "items": [_describe(v, leaves) for v in obj]}
    i = len(leaves)
    leaves.append(obj)
    return {"t": "leaf", "i": i}


def _rebuild(desc, leaves):
    t = desc["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _rebuild(v, leaves)
                for k, v in zip(desc["keys"], desc["vals"])}
    if t in ("list", "tuple"):
        seq = [_rebuild(v, leaves) for v in desc["items"]]
        return seq if t == "list" else tuple(seq)
    return leaves[desc["i"]]


def tree_leaves(tree) -> list:
    """The leaves of a tree of dict/list/tuple/None containers in
    ``jax.tree_util`` order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    """``leaves`` (an iterator) in the structure of ``like``."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        seq = [_unflatten(v, leaves) for v in like]
        return seq if isinstance(like, list) else tuple(seq)
    return next(leaves)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x):
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def save_state(path: str, state) -> None:
    """Save a state to ``path`` (.npz) with its structure."""
    leaves: list = []
    desc = _describe(state, leaves)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__structure__"] = np.frombuffer(
        json.dumps(desc).encode(), dtype=np.uint8)
    arrays["__num_leaves__"] = np.asarray(len(leaves))
    np.savez(path, **arrays)


def load_state(path: str, like=None):
    """Load a state saved by :func:`save_state`, as numpy arrays.

    Returns the structure recorded in the file. With ``like`` (an example
    state of the same structure) the leaves are cast to its leaves' dtypes
    and returned in its structure. Files without the structure record
    return a flat leaf list (or fill ``like`` in its leaf order).
    """
    with np.load(path) as data:
        n = int(data["__num_leaves__"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        desc = None
        if "__structure__" in data:
            desc = json.loads(bytes(data["__structure__"]).decode())

    if like is not None:
        like_leaves = tree_leaves(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                             f"expected {len(like_leaves)}")
        if desc is not None:
            # the file records traversal order; match like's leaf order
            leaves = tree_leaves(_rebuild(desc, leaves))
        cast = [np.asarray(a, dtype=_np_dtype(b))
                for a, b in zip(leaves, like_leaves)]
        return _unflatten(like, iter(cast))

    if desc is None:
        return leaves  # legacy format: structure unknown
    return _rebuild(desc, leaves)


def save_model(path: str, model) -> None:
    """Save ``model.state``; a sharded model (whose ``state`` is the list of
    its shards) saves its global state, gathered (``state_numpy()``)."""
    state = model.state
    save_state(path, model.state_numpy() if isinstance(state, list)
               else state)


def restore_model(path: str, model):
    """Restore a saved state into ``model`` (the structure must match), its
    leaves as tensors on the devices of the model's state; a sharded model
    cuts the global state into its shards (``load_numpy_state``)."""
    if isinstance(model.state, list):
        model.load_numpy_state(load_state(path))
        return model
    restored = load_state(path, like=model.state)
    leaves = [torch.as_tensor(a, device=t.device)
              for a, t in zip(tree_leaves(restored),
                              tree_leaves(model.state))]
    model.state = _unflatten(restored, iter(leaves))
    return model
