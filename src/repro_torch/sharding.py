"""Logical-axis -> mesh-axis sharding rules (counterpart of
``repro.sharding``, rule for rule).

The placement policy follows the paper's hybrid-partitioning principle:
replicate what is small (norms, biases, routers, SSM scalars), shard what is
big (embeddings, FFN, attention projections, expert banks).

Rules are divisibility-checked against the actual shapes: a dim that does
not divide its target axis falls back (expert dim -> d_model FSDP-style
sharding; head-coupled dims -> replicate), so every spec splits evenly.

A spec is a ``PartitionSpec``: one entry per tensor dim, each ``None``, a
mesh axis name, or a tuple of names (the dim split over those axes, the
first one major).  The rules take any mesh-like object with ``.shape``
(axis name -> size) and ``.axis_names``; a ``DeviceMesh`` is adapted by
``mesh_axes``.  ``placements`` turns a spec into DTensor placements and
``distribute`` builds DTensors from each rank's own shard, with no
communication.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name or a tuple of axis
    names.  ``PartitionSpec()`` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshAxes:
    """A ``DeviceMesh`` seen as the rules see a mesh: ``.shape`` maps each
    axis name to its size, ``.axis_names`` lists them in mesh order."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def mesh_axes(mesh):
    """``mesh`` as the rules read it (a ``DeviceMesh`` gets ``MeshAxes``;
    anything with ``.shape`` as a dict and ``.axis_names`` is kept)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return mesh
    return MeshAxes(mesh)


def _axsize(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(_axsize(mesh, a) for a in axis)
    return mesh.shape[axis]


def dp_axes(mesh):
    """Data-parallel axes: ('pod','data') on the multi-pod mesh."""
    mesh = mesh_axes(mesh)
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _fit(mesh, dim: int, axis):
    """axis if it divides dim, else None."""
    return axis if axis is not None and dim % _axsize(mesh, axis) == 0 \
        else None


def spec_for_param(path: str, shape: tuple[int, ...], mesh) -> P:
    """Sharding rule for one parameter, keyed on its tree path."""
    mesh = mesh_axes(mesh)
    nd = len(shape)
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    leaf = path.rsplit("/", 1)[-1]

    def make(assign: dict[int, Any]) -> P:
        spec = [None] * nd
        for dim, axis in assign.items():
            d = dim % nd
            spec[d] = _fit(mesh, shape[d], axis)
        return P(*spec)

    # embeddings ------------------------------------------------------------
    if path.endswith("embed/tokens") or path.endswith("embed/head"):
        # vocab-sharded on model axis; vocab dim is the bigger one
        vdim = 0 if shape[0] > shape[-1] else nd - 1
        return make({vdim: "model"})

    # MoE expert banks (L, E, d_in, d_out) ------------------------------
    if "/moe/" in path:
        if leaf == "router":
            return P(*([None] * nd))
        # experts -> data-parallel axes (expert parallel); inner ffn dim
        # -> model.  If E doesn't divide, FSDP-shard the d_model dim on
        # 'data' instead (mixtral's E=8 case).
        e_ax = _fit(mesh, shape[1], dpa) or _fit(mesh, shape[1], "data")
        if leaf in ("w1", "w3"):
            assign = {1: e_ax, 3: "model"}
            if e_ax is None:
                assign[2] = "data"
            return make(assign)
        if leaf == "w2":
            assign = {1: e_ax, 2: "model"}
            if e_ax is None:
                assign[3] = "data"
            return make(assign)

    # attention / mlp / ssm projections --------------------------------
    if leaf in ("wq", "wk", "wv", "w1", "w3", "in_proj"):
        return make({nd - 1: "model"})
    if leaf in ("wo", "w2", "out_proj"):
        return make({nd - 2: "model"})

    # everything small: norms, biases, conv taps, SSM scalars, dt ------
    return P(*([None] * nd))


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` (nested
    dicts, tuples, named tuples and dataclasses; ``None`` stays ``None``),
    keeping its structure.  ``path`` joins the steps with ``/`` as
    ``repro``'s tree paths do: a dict's key, or the position of a tuple's
    item or a dataclass's field (``repro``'s pytree classes flatten their
    fields in that order)."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=sub(k))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return type(tree)(**{
            n: tree_map_with_path(fn, getattr(tree, n),
                                  *(getattr(r, n) for r in rest), path=sub(i))
            for i, n in enumerate(names)})
    if isinstance(tree, tuple) and not isinstance(tree, PartitionSpec):
        items = [tree_map_with_path(fn, v, *(r[i] for r in rest), path=sub(i))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return fn(path, tree, *rest)


def param_specs(params, mesh):
    """PartitionSpec tree matching ``params`` (a nested dict of tensors)."""
    return tree_map_with_path(
        lambda path, x: spec_for_param(path, tuple(x.shape), mesh), params)


def param_shardings(params, mesh):
    """The placements tree of ``params`` on the ``DeviceMesh`` ``mesh``."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              param_specs(params, mesh))


def batch_spec(shape: tuple[int, ...], mesh) -> P:
    """Shard the leading (batch) dim over the data-parallel axes when it
    divides; sub-group fallbacks for small batches; replicate batch=1."""
    mesh = mesh_axes(mesh)
    dp = dp_axes(mesh)
    b = shape[0]
    for cand in (dp, ("data",), ("pod",)):
        if all(a in mesh.axis_names for a in cand) \
                and b % _axsize(mesh, tuple(cand)) == 0:
            ax = cand if len(cand) > 1 else cand[0]
            return P(ax, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def cache_spec(shape: tuple[int, ...], mesh, *, batch_dim: int = 1,
               kv_head_dim: int = 3) -> P:
    """KV cache (L, B, C, Hkv, Dh): batch over dp; kv heads over model when
    divisible, else shard the cache length over model (flash-decoding
    style partial-softmax placement), else replicate."""
    mesh = mesh_axes(mesh)
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    spec = [None] * len(shape)
    spec[batch_dim] = _fit(mesh, shape[batch_dim], dpa) \
        or _fit(mesh, shape[batch_dim], "data")
    if _fit(mesh, shape[kv_head_dim], "model"):
        spec[kv_head_dim] = "model"
    elif len(shape) > 2 and _fit(mesh, shape[2], "model"):
        spec[2] = "model"
    return P(*spec)


# ---------------------------------------------------------------------------
# specs -> DTensor placements and local shards
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``, one per
    mesh dim: ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()``.  A tuple of axes on one dim becomes ``Shard(d)`` on
    each of them; it must list them in mesh order (major first), as a
    ``DeviceMesh`` splits a dim over its mesh dims in that order, which is
    JAX's major-to-minor order for the same spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor that one rank holds under ``spec``
    (every split is even: the rules only shard dims that divide)."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axsize(axes, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def shard_of(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec``, a copy
    (its coordinate on ``mesh``; no communication)."""
    coord = mesh.get_coordinate()
    names = tuple(mesh.mesh_dim_names)
    out = t
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        idx = 0
        for a in axes:                       # first axis major
            idx = idx * mesh.shape[names.index(a)] + coord[names.index(a)]
        size = t.shape[d] // _axsize(mesh_axes(mesh), entry)
        out = out.narrow(d, idx * size, size)
    return out.clone()


def distribute(tree, specs, mesh, *, make=None):
    """DTensors on ``mesh`` from the leaves of ``tree`` under the matching
    ``specs`` tree, each built from this rank's own shard with
    ``DTensor.from_local`` (no communication).  By default the shard is cut
    from the full leaf (``shard_of``); ``make(local_shape, dtype)`` builds it
    instead (then only the leaf's shape and dtype are read, so the leaf may
    be on the meta device).  ``requires_grad`` is kept."""
    from torch.distributed.tensor import DTensor

    def one(path, t, spec):
        if make is not None:
            local = make(local_shape(t.shape, spec, mesh), t.dtype)
        else:
            local = shard_of(t.detach(), spec, mesh)
        out = DTensor.from_local(local, mesh, placements(spec, mesh),
                                 run_check=False, shape=t.shape,
                                 stride=_contiguous_stride(t.shape))
        return out.requires_grad_(t.requires_grad)

    return tree_map_with_path(one, tree, specs)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
