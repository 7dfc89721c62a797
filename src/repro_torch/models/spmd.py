"""DTensor hooks of the LM models: the reshards that GSPMD inserts silently
in ``repro`` (and ``repro``'s ``with_sharding_constraint`` calls), made
explicit for a model whose tensors are DTensors on a ``DeviceMesh``.

Every hook is the identity on a plain tensor, so the one-device path is
bit for bit what it was; the models call them only where a DTensor needs
a layout that DTensor's own propagation does not reach.
"""
from __future__ import annotations

import math

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shards_dim(p, dim: int) -> bool:
    return p.is_shard() and p.dim == dim


def _replicate_where(x, pred):
    """``x`` with every mesh dim whose placement satisfies ``pred``
    redistributed to ``Replicate()`` (a Partial one is reduced)."""
    from torch.distributed.tensor import Replicate
    new = [Replicate() if pred(p) else p for p in x.placements]
    if list(new) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, new)


def split_dim(x, dim: int, sizes) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped to ``sizes`` (outer first).

    On a DTensor whose ``dim`` is sharded: the shards must hold whole rows
    of the outer size (heads, for a head reshape), so a sharding of
    ``dim`` is kept only when ``sizes[0]`` divides over its mesh dims, and
    is otherwise replicated first.  That is GSPMD's reshard before an
    uneven head split, made visible.  A Partial sum is reduced first."""
    dim = dim % x.ndim
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if not is_dtensor(x):
        return x.reshape(shape)
    mesh = x.device_mesh
    along = [i for i, p in enumerate(x.placements) if _shards_dim(p, dim)]
    n = math.prod(mesh.size(i) for i in along)
    uneven = bool(along) and sizes[0] % n
    # a Partial sum is reduced here too: the reshaped tensor feeds
    # products, where DTensor cannot carry it
    x = _replicate_where(x, lambda p: p.is_partial()
                         or (uneven and _shards_dim(p, dim)))
    return x.reshape(shape)


def match(x, like) -> torch.Tensor:
    """``x`` laid out as ``like`` is on each mesh dim (a Partial of
    ``like`` read as Replicate): the LM pins its residual stream to the
    tokens' layout (batch over the data axes, replicated on ``model``),
    the Megatron layout GSPMD settles on for ``repro``.  The identity on
    plain tensors."""
    if not is_dtensor(x) or not is_dtensor(like):
        return x
    from torch.distributed.tensor import Replicate
    target = [p if p.is_shard() and p.dim < x.ndim else Replicate()
              for p in like.placements]
    if list(target) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


class _Merge(torch.autograd.Function):
    """A reshape of DTensors whose gradient goes back through
    ``split_dim``: DTensor may hand the merged dim's gradient back sharded
    where the forward's split would not divide."""

    @staticmethod
    def forward(ctx, x, dim, sizes, shape):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None, None


class _GradAs(torch.autograd.Function):
    """The identity, whose gradient is laid out as its input was."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and list(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_input(x) -> torch.Tensor:
    """``x``, with its gradient redistributed to ``x``'s own layout on the
    way back (the identity on a plain tensor).  On a mesh of three dims
    DTensor hands some products' output gradients back sharded along the
    sequence on ``model`` (the logits', the SSM's in_proj's), which the
    weight's gradient would read as a strided shard of the (batch x
    sequence) rows, for which its mm has no strategy."""
    if not is_dtensor(x):
        return x
    return _GradAs.apply(x)


def merge_dims(x, dim: int, n: int) -> torch.Tensor:
    """``x`` with dims ``dim .. dim + n - 1`` merged into one: a reshape
    (on DTensors, one whose gradient is split back by ``split_dim``)."""
    dim = dim % x.ndim
    sizes = tuple(x.shape[dim:dim + n])
    shape = (*x.shape[:dim], math.prod(sizes), *x.shape[dim + n:])
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Merge.apply(x, dim, sizes, shape)


def embed_rows(table, ids) -> torch.Tensor:
    """``table[ids]``.  On DTensors a vocab-parallel lookup, each rank on
    its own shards: a rank whose table holds a slice of the vocab looks up
    the ids in its slice and gives zeros for the others, and the result is
    a Partial sum over those mesh dims (reduced where the model pins its
    stream); batch shards of ``ids`` stay.  DTensor's own index ops have
    no strategy for a vocab-sharded table under a batch split over two
    mesh dims, and their gradient normalises no negative shard dim in
    torch 2.11."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [p.is_shard() and p.dim == 0 for p in table.placements]
    batch = [not v and is_dtensor(ids) and p.is_shard() and p.dim == 0
             for v, p in zip(vocab, ids.placements)] if is_dtensor(ids) \
        else [False] * mesh.ndim
    t_target = [Shard(0) if v else Replicate() for v in vocab]
    table = table.redistribute(mesh, t_target)
    grad = [Shard(0) if v else Partial() if b else Replicate()
            for v, b in zip(vocab, batch)]
    local = table.to_local(grad_placements=grad)
    if is_dtensor(ids):
        ids = ids.redistribute(mesh, [Shard(0) if b else Replicate()
                                      for b in batch]).to_local()
    n = local.shape[0]
    block = 0
    coord = mesh.get_coordinate()
    for i, v in enumerate(vocab):               # mesh order: major first
        if v:
            block = block * mesh.size(i) + coord[i]
    rel = ids.long() - block * n
    mine = (rel >= 0) & (rel < n)
    rows = local[torch.where(mine, rel, 0)]
    if any(vocab):
        rows = rows * mine[..., None].to(rows.dtype)
    out = [Partial() if v else Shard(0) if b else Replicate()
           for v, b in zip(vocab, batch)]
    return DTensor.from_local(rows, mesh, out, run_check=False)


def arange_like(x, dim: int) -> torch.Tensor:
    """``arange(x.shape[dim])`` on ``x``'s device; on a DTensor, a 1-d
    DTensor sharded as ``x``'s dim ``dim`` is (each rank makes only its
    slice's ids, so a comparison with ``x``'s shard stays local)."""
    n = x.shape[dim]
    if not is_dtensor(x):
        return torch.arange(n, device=x.device)
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.ndim
    ids = from_plain(torch.arange(n, device=x.to_local().device),
                     x.device_mesh)
    return ids.redistribute(x.device_mesh, [
        Shard(0) if _shards_dim(p, dim) else Replicate()
        for p in x.placements])


def replicate_dims(x, *dims) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` unsharded (the identity on a plain
    tensor or where no mesh dim shards them).  Used before an op that
    DTensor cannot run on those dims sharded, or that would read a strided
    shard after a merge of dims."""
    if not is_dtensor(x):
        return x
    dims = {d % x.ndim for d in dims}
    return _replicate_where(x, lambda p: p.is_shard() and p.dim in dims)


def replicate(x) -> torch.Tensor:
    """``x`` replicated on every mesh dim (Partial sums reduced)."""
    if not is_dtensor(x):
        return x
    return _replicate_where(x, lambda p: True)


def constrain(x, *specs) -> torch.Tensor:
    """``repro``'s ``with_sharding_constraint`` trying specs in order: the
    first spec whose axes all exist on ``x``'s mesh, and whose sharded
    dims divide, wins (``x`` is redistributed to it); the identity on a
    plain tensor or when none applies."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    for spec in specs:
        axes = [(d, a) for d, e in enumerate(spec) if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        if any(a not in names for _, a in axes):
            continue
        new = [Replicate()] * mesh.ndim
        sizes = {}
        for d, a in axes:
            new[names.index(a)] = Shard(d)
            sizes[d] = sizes.get(d, 1) * mesh.size(names.index(a))
        if any(x.shape[d] % n for d, n in sizes.items()):
            continue
        return x.redistribute(mesh, new)
    return x


def to_plain(x):
    """A replicated DTensor's full value as a plain tensor (``to_local``
    of the replicated DTensor: every rank holds it all), and the mesh, for
    ``from_plain``; a plain tensor passes through with ``None``."""
    if not is_dtensor(x):
        return x, None
    return replicate(x).to_local(), x.device_mesh


def from_plain(t, mesh, like=None) -> torch.Tensor:
    """The inverse of ``to_plain``: a plain tensor every rank computed
    alike, as a replicated DTensor on ``mesh`` (``t`` itself when ``mesh``
    is ``None``), then redistributed to ``like``'s placements when given."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    out = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if like is not None and is_dtensor(like):
        from torch.distributed.tensor import Partial
        target = [Replicate() if isinstance(p, Partial) else p
                  for p in like.placements]
        out = out.redistribute(mesh, target)
    return out


def write_slot(buf, dim: int, slot, new) -> None:
    """``buf.index_copy_(dim, slot, new)`` for a one-element index
    ``slot``; ``buf`` is written in place.

    On a DTensor each rank writes its own shard: where a mesh dim shards
    ``dim`` (a KV cache sharded along its length), the rank holding the
    slot writes ``new`` and the others write back what they hold (a
    masked write, no collective and no host sync: the slot is data).
    ``new`` (a DTensor on the same mesh) is first laid out as ``buf`` is,
    apart from ``dim``."""
    if not is_dtensor(buf):
        buf.index_copy_(dim, slot, new)
        return
    from torch.distributed.tensor import Replicate
    dim = dim % buf.ndim
    mesh = buf.device_mesh
    target = [Replicate() if _shards_dim(p, dim) else p
              for p in buf.placements]
    new = new.redistribute(mesh, target)
    slot = slot.full_tensor() if is_dtensor(slot) else slot
    local, local_new = buf.to_local(), new.to_local()
    n_local = local.shape[dim]
    coord = mesh.get_coordinate()
    start = 0
    for i, p in enumerate(buf.placements):      # mesh order: major first
        if _shards_dim(p, dim):
            start = start * mesh.size(i) + coord[i]
    start *= n_local
    rel = slot - start
    mine = (rel >= 0) & (rel < n_local)
    rel = torch.where(mine, rel, 0)
    old = local.index_select(dim, rel)
    local.index_copy_(dim, rel, torch.where(mine, local_new.to(local.dtype),
                                            old))



def local_rows(fn, x, *weights):
    """``fn(x, *weights)``, work that splits over the rows of ``x`` (dim 0,
    the batch), run on each rank's rows with the ``weights`` whole: their
    gradient is then a Partial sum over the batch's mesh dims.  DTensor's
    own ``F.pad`` along a sequence dim fails to plan its reshard in torch
    2.11 (the SSM's causal conv).  Plain tensors: ``fn(x, *weights)``."""
    if not is_dtensor(x):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = [p.is_shard() and p.dim == 0 for p in x.placements]
    rows = [Shard(0) if b else Replicate() for b in batch]
    grad = [Partial() if b else Replicate() for b in batch]
    ws = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad) if is_dtensor(w) else w for w in weights]
    out = fn(x.redistribute(mesh, rows).to_local(), *ws)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def local_heads(fn, q, *args, heads: bool = True, head_args=None,
                out_head_dims=2):
    """``fn(q, *args)``, attention-like work that splits over batch (dim 0
    of every tensor) and heads (dim 2 of ``q`` and of the ``args`` that
    ``head_args`` marks, by default the 4-d ones: KV tensors, whose heads
    serve ``q``'s in groups), run on each rank's shards.

    DTensor would run the products as bmm's over a (batch x heads) merge,
    a strided shard it has no strategy for; here each rank runs ``fn`` on
    its own batch rows and heads, which is what GSPMD does.  Per mesh dim:
    batch stays sharded where ``q``'s is; ``q``'s heads stay sharded where
    they split evenly (``heads=False``: never) and each rank takes the KV
    heads of its query heads (sharded alike where they split, else cut
    from a replicated copy); everything else is replicated.  ``fn``'s
    output (a tensor or a tuple) is sharded as ``q`` on batch and on dim
    ``out_head_dims`` (one per output).  With an argument sharded on
    another dim (a cache sharded along its length) ``fn`` runs on the
    DTensors as they are.  Plain tensors: ``fn(q, *args)``."""
    if not is_dtensor(q):
        return fn(q, *args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if any(is_dtensor(a) and any(p.is_shard() and p.dim not in (0, 2)
                                 for p in a.placements) for a in args):
        return fn(q, *args)
    if head_args is None:
        head_args = [getattr(a, "ndim", 0) == 4 for a in args]
    mesh = q.device_mesh
    coord = mesh.get_coordinate()
    H = q.shape[2]
    kv_heads = [a.shape[2] for a, h in zip(args, head_args) if h]
    roles, n_head = [], 1
    for i, p in enumerate(q.placements):
        if p.is_shard() and p.dim == 0:
            roles.append("batch")
        elif heads and p.is_shard() and p.dim == 2 \
                and H % (n_head * mesh.size(i)) == 0 \
                and all(_heads_align(H, h, n_head * mesh.size(i))
                        for h in kv_heads):
            roles.append("head")
            n_head *= mesh.size(i)
        else:
            roles.append(None)
    # this rank's block of query heads, in mesh order (major first)
    block = 0
    for i, r in enumerate(roles):
        if r == "head":
            block = block * mesh.size(i) + coord[i]
    h_lo, h_n = block * (H // n_head), H // n_head

    def local(t, with_heads: bool):
        if not is_dtensor(t):
            return t
        split = with_heads and t.shape[2] % n_head == 0
        target = [Shard(0) if r == "batch" and t.ndim else
                  Shard(2) if r == "head" and split else Replicate()
                  for r in roles]
        t = t.redistribute(mesh, target)
        if not with_heads or n_head == 1 or split:
            return t.to_local()
        # each rank reads only the KV heads of its query heads: the
        # gradient of the replicated tensor is a Partial sum over them
        grad = [Partial() if r == "head" else pl
                for r, pl in zip(roles, target)]
        full = t.to_local(grad_placements=grad)
        g = H // t.shape[2]
        return full[:, :, h_lo // g:(h_lo + h_n - 1) // g + 1]

    out = fn(local(q, True), *(local(a, h) for a, h in zip(args, head_args)))

    def wrap(t, head_dim):
        pl = [Shard(0) if r == "batch" else Shard(head_dim)
              if r == "head" else Replicate() for r in roles]
        return DTensor.from_local(t, mesh, pl, run_check=False)

    if isinstance(out, tuple):
        dims = out_head_dims if isinstance(out_head_dims, tuple) \
            else (out_head_dims,) * len(out)
        return tuple(wrap(t, d) for t, d in zip(out, dims))
    return wrap(out, out_head_dims)


def _heads_align(H: int, Hkv: int, n: int) -> bool:
    """Do ``n`` equal blocks of ``H`` query heads each read whole KV
    heads (a block holds whole groups, or lies within one group)?"""
    g, per = H // Hkv, H // n
    return per % g == 0 or g % per == 0
