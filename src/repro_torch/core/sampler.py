"""Fixed-shape layered neighbour sampling (§3.1 eqs. 4–5, Algorithm 1).

Counterpart of ``repro.core.sampler``: variable-length neighbour lists
become fixed-fanout padded tensors with validity masks, and the hash-map
relabel of Algorithm 1 becomes a sort-based unique with static capacity.
A node with deg <= fanout contributes all of its neighbours once; a node
with deg > fanout contributes ``fanout`` uniform draws.

Randomness is a stateless per-node hash of (node id, level salt, slot), so
a node's sampled neighbourhood does not depend on which worker samples it.
The hash reproduces ``repro``'s uint32 arithmetic bit for bit in int64
tensors: every product and sum is reduced modulo 2**32, and products are
split into 16-bit halves so no intermediate leaves the int64 range.

Every function takes seeds with any leading dims: ``(S,)`` for one worker,
``(P, S)`` for the stacked worker axis the port uses instead of ``vmap``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.mfg import MFG

_SENTINEL = 2 ** 31 - 1
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` in [0, 2**32), without int64 overflow."""
    c &= _U32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_u32(x: torch.Tensor, salt) -> torch.Tensor:
    """SplitMix32-style integer hash of ``repro.core.sampler.hash_u32``:
    int64 tensor in, values in [0, 2**32) out (the uint32 bit pattern)."""
    x = (x.long() & _U32) + ((int(salt) * 0x9E3779B9) & _U32)
    x = x & _U32
    x = _mul_u32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_u32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def level_salt(salt: int, depth: int) -> int:
    """Per-level sampling salt, ``uint32(salt) * 1000003 + depth`` modulo
    2**32 — the one derivation every scheme uses."""
    return ((int(salt) & _U32) * 1000003 + depth) & _U32


def draw_columns(v: torch.Tensor, deg: torch.Tensor, fanout: int, salt):
    """The per-(seed, slot) column draw shared by the samplers and the
    fused kernel's plain version.

    v: (...,) int64 node ids (>= 0); deg: (...,) int64 degrees the draw
    ranges over.  Returns (col (..., F) int64, valid (..., F) bool) where
    ``valid`` marks slot < min(deg, fanout).
    """
    slots = torch.arange(fanout, dtype=torch.int64, device=v.device)
    bits = hash_u32((_mul_u32(v[..., None], 2654435761) + slots) & _U32,
                    salt)
    rand_idx = torch.remainder(bits, deg.clamp(min=1)[..., None])
    take_all = (deg <= fanout)[..., None]
    col = torch.where(take_all, slots, rand_idx)
    valid = slots < deg.clamp(max=fanout)[..., None]
    return col, valid


def _gather_indices(indices: torch.Tensor, pos: torch.Tensor):
    # jnp clamps out-of-range gathers; torch raises, so clamp explicitly
    # (the clamped lanes are always masked invalid by the caller)
    return indices[pos.clamp(0, max(indices.shape[0] - 1, 0))]


def sample_neighbors(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                     salt):
    """Per-seed neighbour draws: ``Choose(C_G[R_G[v]:R_G[v+1]]; N_l)``.

    seeds: (..., S) int32 global node ids, -1 = padding.
    Returns (samples (..., S, F) int32 global ids [-1 invalid],
             valid (..., S, F) bool).
    """
    seed_ok = seeds >= 0
    v = seeds.clamp(min=0).long()
    start = graph.indptr[v].long()
    deg = graph.indptr[v + 1].long() - start
    col, valid = draw_columns(v, deg, fanout, salt)
    valid = valid & seed_ok[..., None]
    samples = _gather_indices(graph.indices, start[..., None] + col)
    samples = torch.where(valid, samples, -1).to(torch.int32)
    return samples, valid


def relabel(seeds: torch.Tensor, samples: torch.Tensor,
            valid: torch.Tensor):
    """Compact (seeds ∪ samples) into local ids — Algorithm 1's second loop,
    as a sort-based unique (new nodes come out sorted ascending).

    seeds (..., S), samples/valid (..., S, F).  Returns
    (edges_local (..., S, F) int32, src_nodes (..., S + S*F) int32 padded
    -1, num_src (...) int32); ``src_nodes[..., :S] == seeds``.
    """
    lead = seeds.shape[:-1]
    S = seeds.shape[-1]
    cap = samples.shape[-2] * samples.shape[-1]
    seeds2 = seeds.reshape(-1, S)
    flat = samples.reshape(-1, cap).contiguous()
    flat_valid = valid.reshape(-1, cap)
    B = seeds2.shape[0]
    dev = seeds.device

    seed_ok = seeds2 >= 0
    seeds_key = torch.where(seed_ok, seeds2, _SENTINEL).to(torch.int32)
    seed_order = torch.argsort(seeds_key, dim=-1, stable=True)
    seeds_sorted = torch.gather(seeds_key, -1, seed_order).contiguous()

    # membership of each sample in the seed set
    pos = torch.searchsorted(seeds_sorted, flat)
    pos_c = pos.clamp(0, S - 1)
    is_seed = (torch.gather(seeds_sorted, -1, pos_c) == flat) & flat_valid
    seed_local = torch.gather(seed_order, -1, pos_c)

    # unique over non-seed samples
    nonseed = torch.where(flat_valid & ~is_seed, flat, _SENTINEL)
    ns_sorted = torch.sort(nonseed, dim=-1).values
    first = torch.ones_like(ns_sorted, dtype=torch.bool)
    first[:, 1:] = ns_sorted[:, 1:] != ns_sorted[:, :-1]
    is_new = first & (ns_sorted != _SENTINEL)
    rank = torch.cumsum(is_new, dim=-1) - 1
    num_new = is_new.sum(dim=-1)

    # compact the unique new nodes (sorted ascending): the masked scatter
    # writes dropped lanes into an extra column that is cut off afterwards
    new_nodes = torch.full((B, cap + 1), _SENTINEL, dtype=torch.int32,
                           device=dev)
    new_nodes.scatter_(-1, torch.where(is_new, rank, cap), ns_sorted)
    new_nodes = new_nodes[:, :cap].contiguous()

    # local id of each non-seed sample = S + its rank among new nodes
    ns_rank = torch.searchsorted(new_nodes, flat)
    local = torch.where(is_seed, seed_local, S + ns_rank)
    local = torch.where(flat_valid, local, -1).to(torch.int32)

    src_nodes = torch.cat([torch.where(seed_ok, seeds2, -1),
                           torch.where(new_nodes == _SENTINEL, -1,
                                       new_nodes)], dim=-1)
    num_src = (S + num_new).to(torch.int32)
    return (local.reshape(samples.shape),
            src_nodes.to(torch.int32).reshape(*lead, S + cap),
            num_src.reshape(lead))


def build_indptr(valid: torch.Tensor) -> torch.Tensor:
    """The R_l vector of Algorithm 1: running total of per-seed valid
    counts, (..., S, F) -> (..., S + 1) int32."""
    counts = valid.sum(dim=-1, dtype=torch.int32)
    zero = torch.zeros((*counts.shape[:-1], 1), dtype=torch.int32,
                       device=valid.device)
    return torch.cat([zero, torch.cumsum(counts, dim=-1,
                                         dtype=torch.int32)], dim=-1)


def sample_level(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                 salt) -> MFG:
    """One sampling level -> one MFG (the unfused two-step reference)."""
    samples, valid = sample_neighbors(graph, seeds, fanout, salt)
    edges, src_nodes, num_src = relabel(seeds, samples, valid)
    return MFG(dst_nodes=seeds, src_nodes=src_nodes, num_src=num_src,
               edges=edges, edge_mask=valid, indptr=build_indptr(valid))


def unfused_coo_csc_pass(samples: torch.Tensor, valid: torch.Tensor):
    """The DGL-style COO materialize -> sort -> recount -> CSC passes that
    the fused kernel eliminates (§3.2, Fig. 1).

    Returns (samples, valid, indptr) — values identical to the fused path,
    computed through the redundant intermediate representation.
    """
    S, fanout = samples.shape[-2:]
    lead = samples.shape[:-2]
    smp = samples.reshape(-1, S * fanout)
    vld = valid.reshape(-1, S * fanout)
    B = smp.shape[0]
    dev = samples.device
    # -- step 1: COO materialization
    dst_pos = torch.arange(S, device=dev).repeat_interleave(fanout)
    # -- step 2: COO -> CSC conversion (redundant sort + recount)
    sort_key = torch.where(vld, dst_pos, S)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    src_sorted = torch.gather(smp, -1, order)
    key_sorted = torch.gather(sort_key, -1, order)
    counts = torch.zeros((B, S + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(-1, sort_key, torch.ones_like(sort_key,
                                                      dtype=torch.int32))
    indptr = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(counts[:, :S], dim=-1,
                                     dtype=torch.int32)], dim=-1)
    # scatter back to the padded (S, F) layout to relabel (undo the sort)
    inv = torch.argsort(order, dim=-1)
    samples_rt = torch.gather(src_sorted, -1, inv).reshape(samples.shape)
    valid_rt = (torch.gather(key_sorted, -1, inv) < S).reshape(valid.shape)
    return samples_rt, valid_rt, indptr.reshape(*lead, S + 1)


def sample_level_unfused(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                         salt) -> MFG:
    """DGL-style two-step baseline the fused kernel replaces (§3.2);
    output identical to ``sample_level``."""
    samples, valid = sample_neighbors(graph, seeds, fanout, salt)
    samples_rt, valid_rt, indptr = unfused_coo_csc_pass(samples, valid)
    edges, src_nodes, num_src = relabel(seeds, samples_rt, valid_rt)
    return MFG(dst_nodes=seeds, src_nodes=src_nodes, num_src=num_src,
               edges=edges, edge_mask=valid_rt, indptr=indptr)


# --------------------------------------------------------------------------
# level-backend registry
# --------------------------------------------------------------------------
# A level backend is any ``level_fn(graph, seeds, fanout, salt) -> MFG``.

_LEVEL_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, level_fn: Callable, *,
                     overwrite: bool = False) -> None:
    """Register ``level_fn`` under ``name`` (see ``resolve_backend``)."""
    if not overwrite and name in _LEVEL_BACKENDS \
            and _LEVEL_BACKENDS[name] is not level_fn:
        raise ValueError(f"backend {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _LEVEL_BACKENDS[name] = level_fn


def available_backends() -> tuple[str, ...]:
    """Names currently registered (kernel backends appear once imported)."""
    return tuple(sorted(_LEVEL_BACKENDS))


def resolve_backend(name: str) -> Callable:
    """Look up a level backend by name.

    Built-ins: ``"reference"`` (fused-semantics plain path), ``"unfused"``
    (DGL-style COO->CSC baseline), ``"fused_cuda"`` (the fused sampling
    kernel, registered by ``repro_torch.kernels.ops``, imported here on
    first use).
    """
    if name not in _LEVEL_BACKENDS:
        import repro_torch.kernels.ops  # noqa: F401
    try:
        return _LEVEL_BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown sampling backend {name!r}; "
                       f"available: {available_backends()}") from None


register_backend("reference", sample_level)
register_backend("unfused", sample_level_unfused)


def sample_mfgs(graph: CSCGraph, seeds: torch.Tensor,
                fanouts: Sequence[int], salt, level_fn=None,
                backend: str | None = None) -> list[MFG]:
    """Recursive L-level sampling (eqs. 4–5).

    fanouts: (N_L, ..., N_1) — top level first.  Returns MFGs top level
    first; a GNN consumes them in reverse.
    """
    if level_fn is not None and backend is not None:
        raise ValueError("pass either level_fn or backend, not both")
    if level_fn is None:
        level_fn = resolve_backend(backend or "reference")
    mfgs = []
    frontier = seeds
    for depth, fanout in enumerate(fanouts):
        mfg = level_fn(graph, frontier, int(fanout),
                       level_salt(salt, depth))
        mfgs.append(mfg)
        frontier = mfg.src_nodes
    return mfgs
