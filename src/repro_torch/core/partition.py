"""Graph partitioning (§3.3) and the contiguous-ownership layout.

Counterpart of ``repro.core.partition``.  The paper uses METIS for
edge-cut partitioning with three balance targets: nodes, edges and
labeled nodes per partition (so every machine draws the same number of
seeds per epoch).  Partitioners form a registry selected by
``PlanSpec(partitioner=...)``:

  ``"ldg"``        BFS-ordered linear deterministic greedy over the in-
                   and out-neighbours (the default); ``assign_stream``
                   runs its single pass over an edge stream instead
                   (``partition_graph_streaming``).
  ``"labelprop"``  LDG, then capacity-constrained label propagation that
                   accepts only strictly cut-reducing moves
                   (``refine_partition``); ``"labelprop(K)"`` sets the
                   sweep budget.  The pure-numpy stand-in for METIS.
  ``"metis"``      the paper's METIS through the optional ``pymetis``
                   (an ``ImportError`` when it is absent), caps repaired
                   and two refinement sweeps.
  ``"random"`` / ``"hash"``  hash-shuffled round robin, the locality-free
                   baseline.

All of it is host-side numpy, step for step the same as ``repro``'s, so
assignments and layouts are bit-identical.  ``refine_partition`` and the
LDG placer are Python loops over nodes whose moves see the moves before
them; they stay loops.

After partitioning, nodes are relabeled so partition p owns the contiguous
id range [offsets[p], offsets[p+1]); ownership is then one searchsorted and
a local index is ``id - offsets[p]``.  ``build_layout`` moves the relabeled
topology and the per-owner feature shards to the pipeline's device;
``build_vanilla`` slices each partition's in-edge lists out of it for the
schemes whose workers sample their own partition (``vanilla``,
``hybrid_partial``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import (CSCGraph, csc_from_numpy_edges,
                                    csr_view, mix64)


# --------------------------------------------------------------------------
# assignment
# --------------------------------------------------------------------------

def _caps(n: int, num_parts: int, labeled: np.ndarray, slack: float,
          labeled_slack: float | None) -> tuple[float, float]:
    """(node cap, labeled cap) per partition."""
    if labeled_slack is None:
        labeled_slack = slack
    return (slack * n / num_parts,
            max(1.0, labeled_slack * labeled.sum() / num_parts))


class _LDGState:
    """Mutable state of the linear deterministic greedy placer:
    per-partition loads, capacities, and the growing ``assign`` vector."""

    def __init__(self, num_nodes: int, num_parts: int,
                 labeled: np.ndarray, slack: float,
                 labeled_slack: float | None):
        self.num_parts = num_parts
        self.labeled = labeled
        self.cap_nodes, self.cap_labeled = _caps(
            num_nodes, num_parts, labeled, slack, labeled_slack)
        self.assign = np.full(num_nodes, -1, np.int32)
        self.load_nodes = np.zeros(num_parts)
        self.load_labeled = np.zeros(num_parts)

    def place(self, v: int, nb: np.ndarray) -> int:
        """Score node ``v`` against its neighbour list ``nb`` and commit it
        to the winning partition (LDG gain: already-assigned neighbours
        per partition, discounted by fullness; over-capacity partitions
        are forbidden)."""
        score = np.zeros(self.num_parts)
        if nb.size:
            anb = self.assign[nb]
            anb = anb[anb >= 0]
            if anb.size:
                score = np.bincount(anb, minlength=self.num_parts
                                    ).astype(float)
        penalty = 1.0 - self.load_nodes / self.cap_nodes
        full = self.load_nodes >= self.cap_nodes
        if self.labeled[v]:
            full = full | (self.load_labeled >= self.cap_labeled)
        gain = np.where(full, -np.inf,
                        (score + 1e-3) * np.maximum(penalty, 1e-6))
        if np.isfinite(gain).any():
            p = int(np.argmax(gain))
        else:
            # the joint node+labeled caps can be infeasible for this
            # order: fall back to node-open partitions, least labeled first
            ok = self.load_nodes < self.cap_nodes
            p = int(np.argmin(np.where(ok, self.load_labeled, np.inf)))
        self.assign[v] = p
        self.load_nodes[p] += 1
        if self.labeled[v]:
            self.load_labeled[p] += 1
        return p


def _bfs_order(out_indptr, out_indices, n, rng):
    seen = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    k = 0
    starts = rng.permutation(n)
    si = 0
    q: deque[int] = deque()
    while k < n:
        while si < n and seen[starts[si]]:
            si += 1
        if si < n and not q:
            q.append(starts[si])
            seen[starts[si]] = True
        while q:
            v = q.popleft()
            order[k] = v
            k += 1
            for u in out_indices[out_indptr[v]:out_indptr[v + 1]]:
                if not seen[u]:
                    seen[u] = True
                    q.append(u)
    return order


def partition_graph(graph: CSCGraph, num_parts: int,
                    labeled_mask: np.ndarray, seed: int = 0,
                    slack: float = 1.05,
                    labeled_slack: float | None = None) -> np.ndarray:
    """BFS-ordered LDG edge-cut partitioning; returns ``assign``
    (num_nodes,) int32 in [0, num_parts)."""
    indptr, indices = graph.numpy()
    n = graph.num_nodes
    labeled = np.asarray(labeled_mask).astype(bool)

    view = csr_view(graph)
    out_indptr, out_indices = view.indptr, view.indices

    rng = np.random.default_rng(seed)
    order = _bfs_order(out_indptr, out_indices, n, rng)

    state = _LDGState(n, num_parts, labeled, slack, labeled_slack)
    for v in order:
        nb = np.concatenate([indices[indptr[v]:indptr[v + 1]],
                             out_indices[out_indptr[v]:out_indptr[v + 1]]])
        state.place(v, nb)
    return state.assign


def partition_graph_streaming(edge_chunks, num_nodes: int, num_parts: int,
                              labeled_mask: np.ndarray,
                              slack: float = 1.05,
                              labeled_slack: float | None = None
                              ) -> np.ndarray:
    """Single-pass LDG over an edge stream (``(dst, src)`` chunks, see
    ``repro_torch.data.ingest``): each chunk's unassigned nodes are placed
    in order of first appearance, scored against the chunk's edges of the
    node (plus everything already assigned); nodes no edge touches are
    placed last by load alone.  The result depends on the chunking, not
    equal to ``partition_graph``'s."""
    labeled = np.asarray(labeled_mask).astype(bool)
    state = _LDGState(num_nodes, num_parts, labeled, slack, labeled_slack)

    for dst, src in edge_chunks:
        dst = np.asarray(dst, np.int64)
        src = np.asarray(src, np.int64)
        # chunk-local bidirectional adjacency: one CSR over concat(edges)
        nodes = np.concatenate([dst, src])
        peers = np.concatenate([src, dst])
        order = np.argsort(nodes, kind="stable")
        nodes_s, peers_s = nodes[order], peers[order]
        uniq, starts = np.unique(nodes_s, return_index=True)
        bounds = np.append(starts, nodes_s.size)
        # place unassigned nodes in chunk first-appearance order
        first = np.full(uniq.size, nodes.size, np.int64)
        np.minimum.at(first, np.searchsorted(uniq, nodes),
                      np.arange(nodes.size))
        for i in np.argsort(first, kind="stable"):
            v = int(uniq[i])
            if state.assign[v] >= 0:
                continue
            state.place(v, peers_s[starts[i]:bounds[i + 1]])

    empty = np.empty(0, np.int64)
    for v in np.flatnonzero(state.assign < 0):
        state.place(int(v), empty)       # isolated nodes: load balance only
    return state.assign


def edge_cut(graph: CSCGraph, assign: np.ndarray) -> int:
    """Number of edges whose endpoints live in different partitions."""
    _, indices = graph.numpy()
    dsts = csr_view(graph).dsts
    return int(np.sum(assign[dsts] != assign[indices]))


# --------------------------------------------------------------------------
# partitioner registry
# --------------------------------------------------------------------------

def _validate_assign(assign: np.ndarray, num_nodes: int, num_parts: int,
                     slack: float, who: str) -> np.ndarray:
    """Totality, range, dtype and the node balance cap of ``assign``."""
    assign = np.asarray(assign)
    if assign.shape != (num_nodes,):
        raise ValueError(f"partitioner {who!r} returned shape "
                         f"{assign.shape}, expected ({num_nodes},)")
    if not np.issubdtype(assign.dtype, np.integer):
        raise ValueError(f"partitioner {who!r} returned dtype "
                         f"{assign.dtype}, expected an integer type")
    if assign.size and (assign.min() < 0 or assign.max() >= num_parts):
        raise ValueError(f"partitioner {who!r} assigned ids outside "
                         f"[0, {num_parts})")
    counts = np.bincount(assign, minlength=num_parts)
    cap = slack * num_nodes / num_parts + 1
    if counts.max() > cap:
        raise ValueError(
            f"partitioner {who!r} violated the node balance cap: max "
            f"partition holds {int(counts.max())} nodes, cap is {cap:.1f}")
    return assign.astype(np.int32)


class Partitioner:
    """Base class of registry entries: ``assign`` (and, where
    ``supports_streaming``, ``assign_stream``) validates what the
    subclass's ``_assign`` (``_assign_stream``) returns.  Entries are
    deterministic in ``(graph, num_parts, labeled_mask, seed)``."""

    name: str = "?"
    supports_streaming: bool = False

    def assign(self, graph: CSCGraph, num_parts: int, labeled_mask,
               *, seed: int = 0, slack: float = 1.05,
               labeled_slack: float | None = None) -> np.ndarray:
        """Partition ``graph``; returns validated (n,) int32 in [0, P)."""
        labeled = np.asarray(labeled_mask).astype(bool)
        out = self._assign(graph, num_parts, labeled, seed=seed,
                           slack=slack, labeled_slack=labeled_slack)
        return _validate_assign(out, graph.num_nodes, num_parts, slack,
                                self.name)

    def assign_stream(self, edge_chunks, num_nodes: int, num_parts: int,
                      labeled_mask, *, seed: int = 0, slack: float = 1.05,
                      labeled_slack: float | None = None) -> np.ndarray:
        """Partition from an edge-chunk stream (``(dst, src)`` pairs, see
        ``repro_torch.data.ingest``); the same validated contract."""
        if not self.supports_streaming:
            raise NotImplementedError(
                f"partitioner {self.name!r} has no streaming variant; "
                f"materialize the graph (repro_torch.data."
                f"csc_from_edge_stream) and call assign, or use 'ldg'")
        labeled = np.asarray(labeled_mask).astype(bool)
        out = self._assign_stream(edge_chunks, num_nodes, num_parts,
                                  labeled, seed=seed, slack=slack,
                                  labeled_slack=labeled_slack)
        return _validate_assign(out, num_nodes, num_parts, slack, self.name)

    def _assign(self, graph, num_parts, labeled, *, seed, slack,
                labeled_slack) -> np.ndarray:
        raise NotImplementedError

    def _assign_stream(self, edge_chunks, num_nodes, num_parts, labeled,
                       *, seed, slack, labeled_slack) -> np.ndarray:
        raise NotImplementedError


class LDGPartitioner(Partitioner):
    """BFS-ordered linear deterministic greedy (the default), with the
    single-pass stream variant behind the same entry."""

    name = "ldg"
    supports_streaming = True

    def _assign(self, graph, num_parts, labeled, *, seed, slack,
                labeled_slack):
        return partition_graph(graph, num_parts, labeled, seed=seed,
                               slack=slack, labeled_slack=labeled_slack)

    def _assign_stream(self, edge_chunks, num_nodes, num_parts, labeled,
                       *, seed, slack, labeled_slack):
        # the stream's order decides the placement: no seed to vary
        return partition_graph_streaming(edge_chunks, num_nodes, num_parts,
                                         labeled, slack=slack,
                                         labeled_slack=labeled_slack)


def _hash_assign(num_nodes: int, num_parts: int, labeled: np.ndarray,
                 seed: int) -> np.ndarray:
    """Hash-shuffled round robin: labeled and unlabeled nodes are dealt
    separately, so both balance targets hold within one node per
    partition."""
    salt = np.uint64((int(seed) * 0x9E3779B97F4A7C15
                      + 0x632BE59BD9B4E019) % (2 ** 64))
    key = mix64(np.arange(num_nodes, dtype=np.uint64) + salt)
    order = np.argsort(key, kind="stable")
    assign = np.empty(num_nodes, np.int32)
    lab_order = order[labeled[order]]
    unlab_order = order[~labeled[order]]
    assign[lab_order] = np.arange(lab_order.size) % num_parts
    # deal the unlabeled remainder against per-partition quotas so the
    # total counts stay within one of n/P
    sizes = np.full(num_parts, num_nodes // num_parts, np.int64)
    sizes[: num_nodes % num_parts] += 1
    lab_counts = np.bincount(assign[lab_order], minlength=num_parts) \
        if lab_order.size else np.zeros(num_parts, np.int64)
    quota = sizes - lab_counts
    while (quota < 0).any():         # labeled ceil landed on a floor slot
        quota[int(np.argmin(quota))] += 1
        quota[int(np.argmax(quota))] -= 1
    seq = np.repeat(np.arange(num_parts, dtype=np.int32), quota)
    assign[unlab_order] = seq[: unlab_order.size]
    return assign


class HashPartitioner(Partitioner):
    """``random`` / ``hash``: ignores the topology (edge cut about 1 -
    1/P), the floor every locality-aware entry is measured against; its
    stream variant reads no edge."""

    name = "random"
    supports_streaming = True

    def _assign(self, graph, num_parts, labeled, *, seed, slack,
                labeled_slack):
        return _hash_assign(graph.num_nodes, num_parts, labeled, seed)

    def _assign_stream(self, edge_chunks, num_nodes, num_parts, labeled,
                       *, seed, slack, labeled_slack):
        return _hash_assign(num_nodes, num_parts, labeled, seed)


def refine_partition(graph: CSCGraph, assign: np.ndarray, num_parts: int,
                     labeled_mask, *, slack: float = 1.05,
                     labeled_slack: float | None = None,
                     sweeps: int = 10) -> np.ndarray:
    """Capacity-constrained label-propagation refinement.

    Sweeps nodes in id order; a node moves to the partition holding the
    most of its (in + out) neighbours iff the move strictly reduces the
    edge cut and the target is below the node cap and (for labeled nodes)
    the labeled cap.  A move changes the scores of the nodes after it in
    the same sweep, so the sweep is a loop.  Deterministic (ties keep the
    lowest partition id); stops early when a sweep moves nothing.
    """
    n = graph.num_nodes
    indptr, indices = graph.numpy()
    view = csr_view(graph)
    out_indptr, out_indices = view.indptr, view.indices
    labeled = np.asarray(labeled_mask).astype(bool)
    assign = np.asarray(assign, np.int32).copy()
    cap_nodes, cap_labeled = _caps(n, num_parts, labeled, slack,
                                   labeled_slack)
    load_nodes = np.bincount(assign, minlength=num_parts).astype(float)
    load_labeled = np.bincount(assign[labeled],
                               minlength=num_parts).astype(float)
    for _ in range(int(sweeps)):
        moved = 0
        for v in range(n):
            nb = np.concatenate(
                [indices[indptr[v]:indptr[v + 1]],
                 out_indices[out_indptr[v]:out_indptr[v + 1]]])
            if nb.size == 0:
                continue
            cur = int(assign[v])
            score = np.bincount(assign[nb], minlength=num_parts)
            ok = load_nodes < cap_nodes
            if labeled[v]:
                ok &= load_labeled < cap_labeled
            ok[cur] = False
            gain = np.where(ok, score - score[cur], -1)
            best = int(np.argmax(gain))
            if gain[best] > 0:
                assign[v] = best
                load_nodes[cur] -= 1
                load_nodes[best] += 1
                if labeled[v]:
                    load_labeled[cur] -= 1
                    load_labeled[best] += 1
                moved += 1
        if moved == 0:
            break
    return assign


class LabelPropPartitioner(Partitioner):
    """LDG placement, then ``refine_partition`` sweeps: its edge cut is at
    most LDG's on every graph (the refinement only accepts strictly
    cut-reducing, cap-respecting moves).  ``"labelprop(K)"`` sets the
    sweep budget."""

    name = "labelprop"

    def __init__(self, sweeps: float = 10, *extra):
        if extra:
            raise ValueError(
                f"labelprop takes at most one parameter (sweeps), got "
                f"{(sweeps,) + extra}")
        sweeps = int(sweeps)
        if sweeps < 1:
            raise ValueError(f"labelprop sweeps must be >= 1, got {sweeps}")
        self.sweeps = sweeps

    def _assign(self, graph, num_parts, labeled, *, seed, slack,
                labeled_slack):
        base = partition_graph(graph, num_parts, labeled, seed=seed,
                               slack=slack, labeled_slack=labeled_slack)
        return refine_partition(graph, base, num_parts, labeled,
                                slack=slack, labeled_slack=labeled_slack,
                                sweeps=self.sweeps)


class MetisPartitioner(Partitioner):
    """The paper's partitioner, through the optional ``pymetis`` package
    (constructing it raises ``ImportError`` when that is absent).  METIS
    balances nodes but not the labeled target, so its result is
    cap-repaired and then refined for two sweeps with both caps on."""

    name = "metis"

    def __init__(self):
        try:
            import pymetis
        except ImportError:
            raise ImportError(
                "partitioner 'metis' needs the optional dependency "
                "pymetis (pip install pymetis); use 'labelprop' for a "
                "pure-numpy clustering partitioner") from None
        self._pymetis = pymetis

    def _assign(self, graph, num_parts, labeled, *, seed, slack,
                labeled_slack):
        n = graph.num_nodes
        indices = graph.numpy()[1].astype(np.int64)
        dsts = csr_view(graph).dsts.astype(np.int64)
        # METIS wants a symmetric, loop-free adjacency
        u = np.concatenate([dsts, indices])
        w = np.concatenate([indices, dsts])
        keep = u != w
        pairs = np.unique(np.stack([u[keep], w[keep]], axis=1), axis=0)
        xadj = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(pairs[:, 0], minlength=n), out=xadj[1:])
        kwargs = {}
        options = getattr(self._pymetis, "Options", None)
        if options is not None:
            try:
                kwargs["options"] = options(seed=int(seed))
            except TypeError:       # older pymetis: unseedable, still
                pass                # deterministic for fixed inputs
        try:
            _, membership = self._pymetis.part_graph(
                num_parts, xadj=xadj, adjncy=pairs[:, 1], **kwargs)
        except TypeError:           # a build without the options kwarg
            _, membership = self._pymetis.part_graph(
                num_parts, xadj=xadj, adjncy=pairs[:, 1])
        assign = _repair_caps(graph, np.asarray(membership, np.int32),
                              num_parts, labeled, slack, labeled_slack)
        return refine_partition(graph, assign, num_parts, labeled,
                                slack=slack, labeled_slack=labeled_slack,
                                sweeps=2)


def _repair_caps(graph: CSCGraph, assign: np.ndarray, num_parts: int,
                 labeled: np.ndarray, slack: float,
                 labeled_slack: float | None) -> np.ndarray:
    """Evict lowest-degree nodes from over-cap partitions into the
    least-loaded open ones until both balance targets hold (for
    partitioners, like METIS, whose own balancing ignores the caps)."""
    n = graph.num_nodes
    assign = np.asarray(assign, np.int32).copy()
    deg = np.diff(graph.numpy()[0])
    cap_nodes, cap_labeled = _caps(n, num_parts, labeled, slack,
                                   labeled_slack)
    load_nodes = np.bincount(assign, minlength=num_parts).astype(float)
    load_labeled = np.bincount(assign[labeled],
                               minlength=num_parts).astype(float)

    def evict(p: int, need_labeled: bool) -> None:
        members = np.flatnonzero(assign == p)
        if need_labeled:
            members = members[labeled[members]]
        members = members[np.argsort(deg[members], kind="stable")]
        for v in members:
            ok = load_nodes < cap_nodes
            if labeled[v]:
                ok &= load_labeled < cap_labeled
            ok[p] = False
            if not ok.any():
                break
            q = int(np.argmin(np.where(ok, load_nodes, np.inf)))
            assign[v] = q
            load_nodes[p] -= 1
            load_nodes[q] += 1
            if labeled[v]:
                load_labeled[p] -= 1
                load_labeled[q] += 1
            over = load_labeled[p] > cap_labeled if need_labeled \
                else load_nodes[p] > cap_nodes
            if not over:
                break

    for p in range(num_parts):
        if load_nodes[p] > cap_nodes:
            evict(p, need_labeled=False)
    for p in range(num_parts):
        if load_labeled[p] > cap_labeled:
            evict(p, need_labeled=True)
    return assign


_PARTITIONERS: dict[str, Callable[..., Partitioner]] = {}


def register_partitioner(name: str, factory: Callable[..., Partitioner],
                         *, overwrite: bool = False) -> None:
    """Register ``factory(*params) -> Partitioner`` under ``name``."""
    if not overwrite and name in _PARTITIONERS \
            and _PARTITIONERS[name] is not factory:
        raise ValueError(f"partitioner {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _PARTITIONERS[name] = factory


def available_partitioners() -> tuple[str, ...]:
    """Sorted names of registered partitioners."""
    return tuple(sorted(_PARTITIONERS))


def resolve_partitioner(name: str) -> Partitioner:
    """Instantiate the partitioner registered under ``name``, which may
    carry inline parameters (``"labelprop(4)"``).  ``KeyError`` for an
    unknown name; ``"metis"`` raises ``ImportError`` without
    ``pymetis``."""
    from repro_torch.data.naming import parse_param_name
    base, params = parse_param_name(name, "partitioner")
    try:
        factory = _PARTITIONERS[base]
    except KeyError:
        raise KeyError(f"unknown partitioner {name!r}; "
                       f"available: {available_partitioners()}") from None
    return factory(*params)


def _no_params(cls):
    def factory(*params):
        if params:
            raise ValueError(f"partitioner {cls.name!r} takes no "
                             f"parameters, got {params}")
        return cls()
    return factory


register_partitioner("ldg", _no_params(LDGPartitioner))
register_partitioner("labelprop", lambda *p: LabelPropPartitioner(*p))
register_partitioner("metis", _no_params(MetisPartitioner))
register_partitioner("random", _no_params(HashPartitioner))
register_partitioner("hash", _no_params(HashPartitioner))


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionLayout:
    """Relabeled graph + ownership metadata, on the pipeline's device
    (``perm`` stays on the host, and so do the host copies of ``offsets``
    and ``labels`` that the seed draw reads: ``host_offsets_labels``).

    ``local_parts`` marks a rank-local build (a fleet executor's rank):
    only the partitions in ``range(*local_parts)`` have their feature rows;
    the other rows of ``features`` are zero and the rank never reads them.
    ``labels`` and ``node_valid`` stay full on every rank: the host seed
    draw scans the whole labeled table."""
    graph: CSCGraph              # relabeled global topology
    offsets: torch.Tensor        # (P+1,) int32 ownership ranges
    perm: np.ndarray             # new id -> old id
    features: torch.Tensor       # (P, n_max, D) per-owner feature shards
    labels: torch.Tensor         # (P, n_max) int32, -1 where unlabeled/pad
    node_valid: torch.Tensor     # (P, n_max) bool
    num_parts: int
    offsets_host: np.ndarray | None = dataclasses.field(default=None,
                                                        compare=False)
    labels_host: np.ndarray | None = dataclasses.field(default=None,
                                                       compare=False)
    local_parts: tuple[int, int] | None = None    # rank-local [lo, hi)

    def host_offsets_labels(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets (P+1,) int64, labels (P, n_max) int32) on the host,
        copied from the device once, at first use, when ``build_layout``
        did not keep them.  The per-step seed draw reads these, so it
        queues no device copy (which would wait behind the training step
        on the default stream)."""
        if self.offsets_host is None or self.labels_host is None:
            object.__setattr__(self, "offsets_host",
                               self.offsets.cpu().numpy().astype(np.int64))
            object.__setattr__(self, "labels_host",
                               self.labels.cpu().numpy())
        return self.offsets_host, self.labels_host

    @property
    def n_max(self) -> int:
        return self.features.shape[1]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "PartitionLayout":
        """The same layout with its tensors on ``device``."""
        return dataclasses.replace(
            self, graph=self.graph.to(device),
            offsets=self.offsets.to(device),
            features=self.features.to(device),
            labels=self.labels.to(device),
            node_valid=self.node_valid.to(device))


def build_layout(graph: CSCGraph, features: np.ndarray, labels: np.ndarray,
                 assign: np.ndarray, num_parts: int,
                 device=torch.device("cpu"),
                 local_parts: tuple[int, int] | None = None
                 ) -> PartitionLayout:
    """Relabel so each partition owns a contiguous id range; shard
    features; place the result on ``device``.

    ``local_parts=(lo, hi)`` builds a rank-local layout: only partitions
    ``lo .. hi-1`` get their feature rows, the rest of the (P, n_max, D)
    table stays zero.  Topology, offsets, labels and ``node_valid`` stay
    full."""
    n = graph.num_nodes
    assign = np.asarray(assign)
    perm_new_to_old = np.argsort(assign, kind="stable")
    old_to_new = np.empty(n, np.int64)
    old_to_new[perm_new_to_old] = np.arange(n)

    counts = np.bincount(assign, minlength=num_parts)
    offsets = np.zeros(num_parts + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    n_max = int(counts.max())

    # relabel edges
    _, indices = graph.numpy()
    dsts_old = csr_view(graph).dsts
    new_dst = old_to_new[dsts_old].astype(np.int64)
    new_src = old_to_new[indices].astype(np.int64)
    new_graph = csc_from_numpy_edges(new_dst, new_src, n)

    if local_parts is not None:
        lo, hi = int(local_parts[0]), int(local_parts[1])
        if not 0 <= lo < hi <= num_parts:
            raise ValueError(
                f"local_parts {local_parts!r} out of range for "
                f"num_parts={num_parts}")
        local_parts = (lo, hi)
        feature_parts = range(lo, hi)
    else:
        feature_parts = range(num_parts)

    D = features.shape[1]
    feat = np.zeros((num_parts, n_max, D), features.dtype)
    lab = np.full((num_parts, n_max), -1, np.int32)
    valid = np.zeros((num_parts, n_max), bool)
    for p in range(num_parts):
        ids_old = perm_new_to_old[offsets[p]:offsets[p + 1]]
        k = ids_old.size
        if p in feature_parts:
            feat[p, :k] = features[ids_old]
        lab[p, :k] = labels[ids_old]
        valid[p, :k] = True

    return PartitionLayout(
        graph=new_graph.to(device),
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
        perm=perm_new_to_old,
        features=torch.from_numpy(feat).to(device),
        labels=torch.from_numpy(lab).to(device),
        node_valid=torch.from_numpy(valid).to(device),
        num_parts=num_parts,
        offsets_host=offsets.astype(np.int64),
        labels_host=lab,
        local_parts=local_parts,
    )


@dataclasses.dataclass(frozen=True)
class VanillaPlan:
    """The paper's baseline: each worker stores only its partition's
    in-edge lists, ``local_indptr`` (P, n_max + 1) and ``local_indices``
    (P, nnz_max) int32 on the layout's device.

    Legacy container, as in ``repro``; the registry's counterpart is
    ``repro_torch.core.placement.resolve_scheme("vanilla").build(layout)``.
    """
    layout: PartitionLayout
    local_indptr: torch.Tensor
    local_indices: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """The paper's contribution: topology replicated, features
    partitioned.

    Legacy container, as in ``repro``; the registry's counterpart is
    ``repro_torch.core.placement.resolve_scheme("hybrid").build(layout)``.
    """
    layout: PartitionLayout


def build_vanilla(layout: PartitionLayout) -> VanillaPlan:
    """Slice each partition's in-edge lists out of the global CSC, on the
    host, into a ``VanillaPlan`` on the layout's device.  Row p of
    ``local_indptr`` is worker p's row pointer from 0, its tail repeating
    the last entry; ``local_indices`` holds global source ids padded with
    -1 to the largest slice (at least 1 wide), as ``repro`` pads it."""
    indptr, indices = layout.graph.numpy()
    offsets = layout.host_offsets_labels()[0]
    P = layout.num_parts
    n_max = layout.n_max

    nnz = [int(indptr[offsets[p + 1]] - indptr[offsets[p]]) for p in range(P)]
    nnz_max = max(max(nnz), 1)
    li = np.zeros((P, n_max + 1), np.int32)
    lx = np.full((P, nnz_max), -1, np.int32)
    for p in range(P):
        lo, hi = offsets[p], offsets[p + 1]
        rows = indptr[lo:hi + 1] - indptr[lo]
        li[p, :rows.size] = rows
        li[p, rows.size:] = rows[-1]
        lx[p, :nnz[p]] = indices[indptr[lo]:indptr[hi]]
    return VanillaPlan(layout=layout,
                       local_indptr=torch.from_numpy(li).to(layout.device),
                       local_indices=torch.from_numpy(lx).to(layout.device))


def build_hybrid(layout: PartitionLayout) -> HybridPlan:
    """The hybrid placement's legacy container: the layout itself."""
    return HybridPlan(layout=layout)


# --------------------------------------------------------------------------
# minibatch seeds
# --------------------------------------------------------------------------

def seeds_per_worker_host(layout: PartitionLayout, batch: int,
                          epoch_salt: int) -> np.ndarray:
    """Host half of ``seeds_per_worker``: each labeled node gets a hash
    rank from (global id, epoch_salt) and every worker takes its ``batch``
    lowest-ranked labeled nodes (ties by column order).  Returns a host
    ``(P, batch)`` int32 array, -1 padded; the same numpy program as
    ``repro``'s, so the seeds are bit-identical.  It reads the layout's
    host copies only, so a staging thread can call it while the device is
    busy."""
    P = layout.num_parts
    offsets, labels = layout.host_offsets_labels()
    n_max = labels.shape[1]

    gids = offsets[:-1, None] + np.arange(n_max, dtype=np.int64)[None, :]
    # fold the salt in Python-int space (arbitrary precision, then wrap)
    salt64 = np.uint64((int(epoch_salt) * 0x9E3779B97F4A7C15) % (2 ** 64))
    key = mix64(gids.astype(np.uint64) + salt64)
    key = np.where(labels >= 0, key, np.uint64(np.iinfo(np.uint64).max))

    m = min(batch, n_max)
    order = np.argsort(key, axis=1, kind="stable")[:, :m]
    picked = np.take_along_axis(gids, order, axis=1)
    take = np.minimum((labels >= 0).sum(axis=1), m)
    valid = np.arange(m)[None, :] < take[:, None]
    out = np.full((P, batch), -1, np.int32)
    out[:, :m] = np.where(valid, picked, -1)
    return out


def seeds_per_worker(layout: PartitionLayout, batch: int,
                     epoch_salt: int) -> torch.Tensor:
    """Each worker draws its minibatch from its own labeled nodes (paper
    §4), deterministic in ``epoch_salt``: (P, batch) int32 global ids, -1
    padded, on the layout's device."""
    return torch.from_numpy(seeds_per_worker_host(
        layout, batch, epoch_salt)).to(layout.device)
