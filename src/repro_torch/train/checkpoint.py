"""Flat-npz checkpoints of parameter trees (params + optimizer state), in
``repro.train.checkpoint``'s format, so a checkpoint written by either
package restores in the other.

Keys are the '/'-joined tree paths as JAX names them: a dict key as it
is, a list or tuple index as its number, a named-tuple field as ``.name``
(``{"params": [...], "opt": OptState}`` gives ``params/0/w_self`` and
``opt/.mu/0/b``).  ``__step__`` holds the step counter, and a ``::bf16``
suffix marks bfloat16 leaves stored as raw uint16 bits.  Restore rebuilds
into a given structure and refuses a shape or dtype that differs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_BF16_SUFFIX = "::bf16"
_STEP_KEY = "__step__"


def _paths(tree, prefix=()):
    """(path parts, leaf) pairs in JAX's flattening order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _paths(v, prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    flat = {}
    for parts, leaf in _paths(tree):
        for part in parts:
            if "/" in part:
                raise ValueError(
                    f"checkpoint key component {part!r} contains '/': "
                    f"ambiguous with '/'-joined tree paths")
            if _BF16_SUFFIX in part:
                raise ValueError(
                    f"checkpoint key component {part!r} contains the "
                    f"reserved bfloat16 marker {_BF16_SUFFIX!r}")
        key = "/".join(parts)
        if key == _STEP_KEY:
            raise ValueError(f"checkpoint key {_STEP_KEY!r} is reserved for "
                             f"the step counter")
        if key in flat or key + _BF16_SUFFIX in flat:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + _BF16_SUFFIX] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            flat[key] = t.numpy()
    return flat


def save_checkpoint(path: str, tree, *, step: int | None = None) -> None:
    """Write ``tree`` (and ``step``) to ``path`` atomically."""
    flat = _flatten(tree)
    if step is not None:
        flat[_STEP_KEY] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _rebuild(like, leaves):
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def restore_checkpoint(path: str, like):
    """Restore into the structure of ``like`` -> ``(tree, step)``.

    Leaves come back as tensors on the device of the matching ``like``
    leaf.  A stored shape or dtype that differs from ``like``'s raises
    ``ValueError``: casting optimizer moments on resume would corrupt
    training.
    """
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop(_STEP_KEY)) if _STEP_KEY in flat else None

    new_leaves = []
    for parts, leaf in _paths(like):
        key = "/".join(parts)
        leaf = torch.as_tensor(leaf)
        if key + _BF16_SUFFIX in flat:
            arr = torch.from_numpy(flat[key + _BF16_SUFFIX].view(
                np.int16)).view(torch.bfloat16)
        elif key in flat:
            arr = torch.from_numpy(np.array(flat[key]))
        else:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                             f"{tuple(leaf.shape)}")
        if arr.dtype != leaf.dtype:
            raise ValueError(
                f"{key}: stored dtype {arr.dtype} != expected {leaf.dtype} "
                f"(refusing to cast: a silent cast corrupts optimizer "
                f"state on resume)")
        new_leaves.append(arr.to(leaf.device))
    return _rebuild(like, iter(new_leaves)), step
