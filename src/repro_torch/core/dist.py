"""Distributed sampling-based step primitives on a stacked worker axis
(§3.3, Fig. 3).

Counterpart of ``repro.core.dist``.  ``repro`` writes one per-worker program
against a named axis and runs it under ``jax.vmap``; the port has no vmap,
so every function here takes the workers' data stacked on a leading axis
and does all their work at once (worker p is row p).  Collectives
become tensor operations on that axis:

  * ``exchange`` (all_to_all) is a transpose of the stacked ``(P, P, cap,
    ...)`` buffer: row q of sender p lands in row p of receiver q.  It
    returns a view, so a round moves no bytes until its reply is gathered.
  * ``pmean_ordered`` / ``psum_ordered`` reduce over the worker axis in
    index order and return the one replicated value.

In a fleet (``repro_torch.pipeline.executor.FleetExecutor``) each OS
process is one rank of a ``torch.distributed`` job and stacks only its own
workers, global indices ``lo .. hi-1`` (a ``RankGroup``).  The same
functions then take ``group=``: ``exchange`` becomes one
``all_to_all_single`` over the ranks and the reductions an
``all_gather`` followed by the same reduction in worker order, so their
results equal the stacked ones bit for bit; the functions that index the
worker axis take the rank's slice of the partition offsets.  Every
cross-rank message goes through ``_collective`` (gloo; on a machine with
one card all ranks share it, and gloo moves their messages through host
memory).

Communication schemes (the paper's accounting), which ``RoundCounter``
records per step:

  * vanilla: topology and features partitioned.  The top level samples
    locally; each of the L-1 lower levels needs a request round and a
    reply round (``exchange_sample_level``); the feature fetch 2 more:
    2L rounds.
  * hybrid: topology replicated, features partitioned: 2 rounds.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.mfg import MFG
from repro_torch.core.sampler import (build_indptr, draw_columns,
                                      level_salt, relabel, sample_level,
                                      sample_mfgs, sample_neighbors,
                                      unfused_coo_csc_pass)
from repro_torch.kernels.feature_gather import feature_gather
from repro_torch.obs import trace as _trace


class RoundCounter:
    """Counts communication rounds, categorized as ``"sampling"`` vs
    ``"feature"``, with the buffer capacity (bytes) of each.

    ``repro`` ticks at trace time, once per traced step; the port runs
    eagerly, so a counter ticks on every call: give the step a counter for
    one step to read that step's structure.
    """

    def __init__(self):
        self.kinds: list[str] = []
        self.bytes_per_round: list[int] = []

    @property
    def rounds(self) -> int:
        return len(self.kinds)

    @property
    def sampling_rounds(self) -> int:
        return sum(k == "sampling" for k in self.kinds)

    @property
    def feature_rounds(self) -> int:
        return sum(k == "feature" for k in self.kinds)

    def tick(self, buf: torch.Tensor, kind: str = "other") -> None:
        """Record one round of category ``kind`` carrying ``buf`` (the
        stacked buffer of all workers; bytes are per worker, as in
        ``repro``)."""
        self.kinds.append(kind)
        self.bytes_per_round.append(
            buf[0].numel() * buf.element_size())


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One rank's place in a fleet: the process group its collectives run
    over (``pg``; ``None`` is the default group) and the workers it hosts,
    global indices ``lo .. hi-1``, stacked on axis 0 of every tensor it
    holds.  Every rank of the group hosts ``hi - lo`` workers."""
    lo: int
    hi: int
    num_parts: int
    pg: object = None

    @property
    def local(self) -> int:
        """Workers this rank hosts."""
        return self.hi - self.lo

    @property
    def num_procs(self) -> int:
        return self.num_parts // self.local

    @property
    def parts(self) -> tuple[int, int]:
        return self.lo, self.hi


def rank_group(num_parts: int, pg=None) -> RankGroup:
    """This process's ``RankGroup`` in the process group ``pg`` (default:
    the world of the initialized ``torch.distributed`` job): rank r of R
    hosts workers ``r * P/R .. (r+1) * P/R - 1``."""
    import torch.distributed as tdist

    if not tdist.is_initialized():
        raise RuntimeError(
            "a fleet executor needs an initialized torch.distributed job; "
            "start the ranks with repro_torch.launch.multihost.launch and "
            "call multihost.init_from_env() in each")
    size = tdist.get_world_size(pg)
    if num_parts % size:
        raise ValueError(f"num_parts={num_parts} must divide evenly across "
                         f"{size} ranks")
    per = num_parts // size
    r = tdist.get_rank(pg)
    return RankGroup(lo=r * per, hi=(r + 1) * per, num_parts=num_parts,
                     pg=pg)


def _collective(op: str, send: torch.Tensor, group: RankGroup,
                what: str = "") -> torch.Tensor:
    """The transport of every cross-rank message.

    ``op`` ``"all_to_all"``: ``send`` (R * k, ...) is R equal chunks on
    axis 0, chunk j for rank j; returns the same shape, chunk j from rank
    j.  ``"all_gather"``: ``send`` (k, ...) from every rank; returns
    (R * k, ...) in rank order.

    Tensors go to the group's backend as they are.  gloo takes CUDA
    tensors for both collectives (checked on an H100 with torch 2.11):
    it copies them through pinned host memory inside the call, so no copy
    is made here, and the collective's time includes gloo's two copies.
    The call first waits for the current stream (gloo would wait for it
    anyway), in a span of its own, so that the ``comm/<op>`` span
    (``repro_torch.obs.trace``, with the op, ``what`` and the bytes sent)
    times the transport alone.
    """
    import torch.distributed as tdist

    send = send.contiguous()
    args = {"op": op, "what": what,
            "bytes": send.numel() * send.element_size()}
    if send.is_cuda:
        with _trace.span("comm/device_wait", cat="comm", **args):
            torch.cuda.current_stream(send.device).synchronize()
    with _trace.span(f"comm/{op}", cat="comm", **args):
        if op == "all_to_all":
            recv = torch.empty_like(send)
            tdist.all_to_all_single(recv, send, group=group.pg)
            return recv
        if op == "all_gather":
            parts = [torch.empty_like(send) for _ in range(group.num_procs)]
            tdist.all_gather(parts, send, group=group.pg)
            return torch.cat(parts)
    raise ValueError(f"unknown collective {op!r}")


class TransportCollectives:
    """A ``with`` block in which the functional collectives that DTensor
    issues (``_c10d_functional``) go through ``_collective``'s transport:
    gloo's ``all_gather`` and ``all_to_all_single``, which take CUDA
    tensors, and reductions in rank order over an all_gather.  Gloo's own
    ops for DTensor's collectives are not known to take CUDA tensors:
    ``train --devices 2`` on the card lost a rank to a segfault through
    them.  DTensor ops pass on to DTensor, whose local ops and
    collectives then come back here."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return outer._dispatch(func, types, args, kwargs or {})
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    @staticmethod
    def _group(name: str) -> RankGroup:
        import torch.distributed as tdist
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        pg = _resolve_process_group(name)
        return rank_group(tdist.get_world_size(pg), pg)

    def _reduce(self, t, op: str, group: RankGroup):
        every = _collective("all_gather", t.unsqueeze(0), group)
        if op in ("sum", "avg"):
            out = every.sum(0)
            return out / group.num_procs if op == "avg" else out
        if op in ("max", "min"):
            return every.amax(0) if op == "max" else every.amin(0)
        raise NotImplementedError(f"reduce op {op!r} over the transport")

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace not in ("_c10d_functional",
                                  "_c10d_functional_autograd"):
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name == "wait_tensor":
            return args[0]
        if name == "all_gather_into_tensor":
            return _collective("all_gather", args[0], self._group(args[2]))
        if name in ("all_reduce", "all_reduce_"):
            out = self._reduce(args[0], args[1], self._group(args[2]))
            return args[0].copy_(out) if name == "all_reduce_" else out
        if name == "reduce_scatter_tensor":
            import torch.distributed as tdist
            group = self._group(args[3])
            out = self._reduce(args[0], args[1], group)
            return out.chunk(group.num_procs)[tdist.get_rank(group.pg)
                                              ].contiguous()
        if name == "all_to_all_single" and not any(
                args[i] and len(set(args[i])) > 1 for i in (1, 2)):
            return _collective("all_to_all", args[0], self._group(args[3]))
        if "gather" in name or "reduce" in name or "all_to_all" in name \
                or "broadcast" in name:
            raise NotImplementedError(f"{func} over the transport")
        return func(*args, **kwargs)        # the namespace's other ops


def exchange(buf: torch.Tensor, counter: RoundCounter | None,
             kind: str = "other", group: RankGroup | None = None
             ) -> torch.Tensor:
    """One all_to_all round over the worker axis.

    ``buf`` is (P, P, cap, ...): ``buf[p, q]`` is the payload worker p
    sends to worker q.  Returns the same layout where ``out[q, p]`` is the
    payload worker q received from worker p (a transposed view).  With a
    ``group`` the leading axis holds the rank's own workers only, (L, P,
    cap, ...), and so does the result; the round is one
    ``all_to_all_single`` over the ranks.
    """
    if counter is not None:
        counter.tick(buf, kind=kind)
    if group is None:
        return buf.transpose(0, 1)
    L, R = group.local, group.num_procs
    rest = buf.shape[2:]
    # chunk j of the send buffer holds what every local worker sends to
    # rank j's workers: (R, L_src, L_dst, ...)
    send = buf.reshape(L, R, L, *rest).transpose(0, 1)
    recv = _collective("all_to_all", send, group, what=kind)
    # recv[j, s, d] came from worker j * L + s for local worker d
    return recv.transpose(0, 2).transpose(1, 2).reshape(L, R * L, *rest)


def all_workers(x: torch.Tensor, group: RankGroup | None = None,
                what: str = "reduce") -> torch.Tensor:
    """Every worker's rows of ``x`` in worker order, on every rank: ``x``
    itself when stacked, else the all_gather of the ranks' (L, ...) rows
    into (P, ...) (``what`` labels its ``comm/all_gather`` span)."""
    if group is None:
        return x
    return _collective("all_gather", x, group, what=what)


def pmean_ordered(x: torch.Tensor, group: RankGroup | None = None,
                  what: str = "reduce") -> torch.Tensor:
    """Mean over the worker axis in index order (``repro``'s all_gather +
    local mean), as the one replicated value."""
    return torch.mean(all_workers(x, group, what), dim=0)


def psum_ordered(x: torch.Tensor, group: RankGroup | None = None,
                 what: str = "reduce") -> torch.Tensor:
    """Sum over the worker axis in index order, as the replicated value."""
    return torch.sum(all_workers(x, group, what), dim=0)


def require_same_on_ranks(digest: bytes, group: RankGroup,
                          what: str) -> None:
    """Raise unless every rank of ``group`` holds the same ``digest`` of
    ``what`` (its first 8 bytes, through one all_gather)."""
    mine = torch.tensor([int.from_bytes(digest[:8], "little", signed=True)])
    every = _collective("all_gather", mine, group, what=what).tolist()
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: digests {every} "
                           f"in rank order")


def local_offsets(offsets: torch.Tensor, group: RankGroup | None = None
                  ) -> torch.Tensor:
    """The partition boundaries of the workers this rank hosts: all P + 1
    of them when stacked, ``offsets[lo : hi + 1]`` in a fleet."""
    if group is None:
        return offsets
    return offsets[group.lo:group.hi + 1]


# --------------------------------------------------------------------------
# owner-based packing
# --------------------------------------------------------------------------

def owner_of(offsets: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Owning worker of each (relabeled, contiguously-owned) node id.

    offsets: (P + 1,) partition boundaries; ids: any shape.  Returns int32
    worker indices (-1 for ids below offsets[0], e.g. padding).
    """
    out = torch.searchsorted(offsets.contiguous(),
                             ids.to(offsets.dtype).contiguous(), right=True)
    return (out - 1).to(torch.int32)


def pack_by_owner(ids: torch.Tensor, owner: torch.Tensor, num_parts: int):
    """Group each worker's ``ids`` into per-peer request buffers.

    ids, owner: (..., N) — a row per worker; -1 ids are padding and land
    in no buffer.  Returns ``(buf (..., P, N) int32 padded -1, owner_idx
    (..., N) int32, slot_idx (..., N) int32)``: element i of a row sits at
    ``buf[..., owner_idx[i], slot_idx[i]]``.
    """
    lead = ids.shape[:-1]
    N = ids.shape[-1]
    ids2 = ids.reshape(-1, N)
    B = ids2.shape[0]
    dev = ids.device
    key = torch.where(ids2 >= 0, owner.reshape(-1, N).long(), num_parts)
    order = torch.argsort(key, dim=-1, stable=True)
    ids_s = torch.gather(ids2, -1, order)
    key_s = torch.gather(key, -1, order).contiguous()
    parts = torch.arange(num_parts, device=dev).expand(B, num_parts)
    seg_start = torch.searchsorted(key_s, parts.contiguous())
    key_c = key_s.clamp(0, num_parts - 1)
    slot = torch.arange(N, device=dev) - torch.gather(seg_start, -1, key_c)

    # the masked scatter sends padding lanes to an extra column that is
    # cut off afterwards
    in_buf = key_s < num_parts
    buf = torch.full((B, num_parts, N + 1), -1, dtype=torch.int32,
                     device=dev)
    flat = key_c * (N + 1) + torch.where(in_buf, slot, N)
    buf.view(B, -1).scatter_(-1, flat, torch.where(in_buf, ids_s, -1)
                             .to(torch.int32))
    buf = buf[..., :N]

    owner_idx = torch.zeros((B, N), dtype=torch.int32, device=dev)
    owner_idx.scatter_(-1, order, key_c.to(torch.int32))
    slot_idx = torch.zeros((B, N), dtype=torch.int32, device=dev)
    slot_idx.scatter_(-1, order, slot.clamp(0, N - 1).to(torch.int32))
    return (buf.reshape(*lead, num_parts, N), owner_idx.reshape(*lead, N),
            slot_idx.reshape(*lead, N))


# --------------------------------------------------------------------------
# per-worker state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerShard:
    """The workers' slices of the partitioned data, stacked on axis 0.

    ``local_indptr`` / ``local_indices`` are each worker's in-edge slice
    (``repro_torch.core.partition.build_vanilla``), read by the schemes
    whose workers sample their own partition (vanilla, hybrid_partial);
    hybrid workers read the replicated topology and leave them ``None``.
    """
    features: torch.Tensor      # (P, n_max, D)
    labels: torch.Tensor        # (P, n_max)
    local_indptr: torch.Tensor | None = None   # (P, n_max + 1) int32
    local_indices: torch.Tensor | None = None  # (P, nnz_max) int32


# --------------------------------------------------------------------------
# local-CSC sampling (partitioned workers store only their in-edges)
# --------------------------------------------------------------------------

def worker_ranges(offsets: torch.Tensor, group: RankGroup | None = None):
    """(my_offset (P,), n_local (P,)) of every worker this rank hosts,
    int64."""
    offsets = local_offsets(offsets, group).long()
    return offsets[:-1], offsets[1:] - offsets[:-1]


def sample_neighbors_local(local_indptr: torch.Tensor,
                           local_indices: torch.Tensor,
                           my_offset: torch.Tensor, n_local: torch.Tensor,
                           ids: torch.Tensor, fanout: int, salt
                           ) -> torch.Tensor:
    """Each worker's draws for the (globally identified) ``ids`` it owns.

    local_indptr (P, n_max+1) / local_indices (P, nnz_max): the workers'
    slices; my_offset, n_local: (P,); ids: (P, N) global ids.  Row p
    draws from worker p's slice only, with the hash stream of
    ``sampler.sample_neighbors`` (``draw_columns``), so partitioned and
    replicated sampling draw the same neighbours.  Returns (P, N, F) int32
    global ids, -1 where the id is padding or not the worker's.
    """
    P, nnz_max = local_indices.shape
    n_rows = local_indptr.shape[1]
    local = ids.long() - my_offset.view(P, 1)
    owned = (ids >= 0) & (local >= 0) & (local < n_local.view(P, 1))
    # jnp clamps out-of-range gathers; the clamped rows are never owned
    lrow = local.clamp(0, n_rows - 2)
    start = torch.gather(local_indptr, 1, lrow).long()
    end = torch.gather(local_indptr, 1, lrow + 1).long()
    deg = torch.where(owned, end - start, 0)
    col, valid = draw_columns(ids.clamp(min=0).long(), deg, fanout, salt)
    # a flat (P * nnz_max) view with a per-row base; masked slots clamp
    # inside their own row, so no draw reads a neighbour's slice
    pos = (start[..., None] + col).clamp(0, nnz_max - 1)
    base = torch.arange(P, device=ids.device).view(P, 1, 1) * nnz_max
    samples = local_indices.reshape(-1)[base + pos]
    return torch.where(valid, samples, -1).to(torch.int32)


def exchange_sample_level(shard: WorkerShard, offsets: torch.Tensor,
                          num_parts: int, frontier: torch.Tensor,
                          fanout: int, salt,
                          counter: RoundCounter | None,
                          group: RankGroup | None = None):
    """One lower level of the partitioned sampling protocol (2 rounds):
    pack each worker's frontier by owner, ``exchange`` the requests, draw
    on the owning worker, ``exchange`` the replies back to the requesting
    slots.  Shared by the vanilla scheme (its whole frontier) and
    ``hybrid_partial`` (the cold remainder).

    frontier: (P, N) global ids, -1 padded.  Returns ``(samples (P, N, F)
    int32, utilized_bytes (P,) f32)``: the valid request ids and their
    replies each worker contributed, ``m * 4 * (1 + fanout)``.
    """
    P, N = frontier.shape
    my_offset, n_local = worker_ranges(offsets, group)
    own = owner_of(offsets, frontier)
    buf, oidx, sidx = pack_by_owner(frontier, own, num_parts)
    reqs = exchange(buf, counter, kind="sampling",
                    group=group)                           # round: ids
    got = sample_neighbors_local(
        shard.local_indptr, shard.local_indices, my_offset, n_local,
        reqs.reshape(P, -1), fanout, salt)
    reply = exchange(got.view(P, num_parts, N, fanout), counter,
                     kind="sampling", group=group)         # round: nbrs
    p = torch.arange(P, device=frontier.device).view(P, 1)
    samples = reply[p, oidx.long(), sidx.long()]
    ok = frontier >= 0
    samples = torch.where(ok[..., None], samples, -1)
    m = ok.sum(dim=-1).to(torch.float32)
    return samples, m * 4.0 * (1.0 + fanout)


def finish_level(frontier: torch.Tensor, samples: torch.Tensor,
                 fused: bool) -> MFG:
    """One level's raw draws -> its MFG, the level-construction tail the
    partitioned protocols share.  ``fused`` builds the row pointer
    directly; False pays the DGL-style COO->CSC passes first (the values
    are the same either way, the cost is not)."""
    valid = samples >= 0
    if fused:
        indptr = build_indptr(valid)
    else:
        samples, valid, indptr = unfused_coo_csc_pass(samples, valid)
    edges, src_nodes, num_src = relabel(frontier, samples, valid)
    return MFG(dst_nodes=frontier, src_nodes=src_nodes, num_src=num_src,
               edges=edges, edge_mask=valid, indptr=indptr)


# --------------------------------------------------------------------------
# the two sampling schemes
# --------------------------------------------------------------------------

def hybrid_sample(graph: CSCGraph, seeds: torch.Tensor,
                  fanouts: Sequence[int], salt,
                  level_fn=sample_level) -> list[MFG]:
    """Multi-level sampling under the hybrid scheme: topology replicated,
    so sampling is local (0 communication rounds).  ``seeds`` is (P,
    batch), one row per worker; every MFG field carries the P axis."""
    return sample_mfgs(graph, seeds, fanouts, salt, level_fn=level_fn)


def vanilla_sample(shard: WorkerShard, offsets: torch.Tensor,
                   num_parts: int, seeds: torch.Tensor,
                   fanouts: Sequence[int], salt,
                   counter: RoundCounter | None, fused: bool = False, *,
                   hot_graph: CSCGraph | None = None,
                   hot_mask: torch.Tensor | None = None,
                   all_hot: bool = False,
                   group: RankGroup | None = None):
    """Multi-level sampling under the vanilla scheme: topology
    partitioned, so 2 rounds per level below the top (Fig. 3).  The draws
    equal ``hybrid_sample``'s (the paper's §4.2 equivalence).

    With ``hot_graph`` / ``hot_mask`` (``hybrid_partial``'s replicated
    in-edge lists of the hot nodes) each lower level draws the hot
    frontier on the replica and exchanges only the cold remainder; with
    ``all_hot`` no level exchanges at all.  Hot and cold draws merge
    before the relabel.

    seeds: (P, batch), each worker's own labeled nodes (the rank's
    workers only, with a ``group``).  Returns ``(mfgs,
    sampling_utilized_bytes (P,) f32)``.
    """
    my_offset, n_local = worker_ranges(offsets, group)
    util = torch.zeros(seeds.shape[0], dtype=torch.float32,
                       device=seeds.device)
    mfgs = []
    frontier = seeds
    for depth, fanout in enumerate(fanouts):
        fanout = int(fanout)
        salt_d = level_salt(salt, depth)
        if depth == 0:
            # top level: the seeds are the worker's own nodes
            samples = sample_neighbors_local(
                shard.local_indptr, shard.local_indices, my_offset, n_local,
                frontier, fanout, salt_d)
        else:
            cold = frontier
            if hot_graph is not None:
                is_hot = (hot_mask[frontier.clamp(min=0).long()]
                          & (frontier >= 0))
                hot_samples, _ = sample_neighbors(
                    hot_graph, torch.where(is_hot, frontier, -1), fanout,
                    salt_d)
                cold = torch.where(is_hot, -1, frontier)
            if all_hot:
                samples = hot_samples
            else:
                samples, level_bytes = exchange_sample_level(
                    shard, offsets, num_parts, cold, fanout, salt_d,
                    counter, group)
                util = util + level_bytes
                if hot_graph is not None:
                    samples = torch.where(is_hot[..., None], hot_samples,
                                          samples)
        mfg = finish_level(frontier, samples, fused)
        mfgs.append(mfg)
        frontier = mfg.src_nodes
    return mfgs, util


def owner_local_ids(reqs: torch.Tensor, offsets: torch.Tensor,
                    n_local: int, group: RankGroup | None = None
                    ) -> torch.Tensor:
    """Row ids into each owner's shard for the requests it received.

    reqs: (P, P, N) where ``reqs[q, p]`` are the global ids worker p asked
    worker q for.  Returns (P, P * N) int32 local row ids, -1 for padding
    and for ids the owner does not hold — the input of the
    ``feature_gather`` kernel.
    """
    P = reqs.shape[0]
    local = reqs - local_offsets(offsets, group)[:-1].view(P, 1, 1)
    ok = (reqs >= 0) & (local >= 0) & (local < n_local)
    return torch.where(ok, local, -1).to(torch.int32).reshape(P, -1)


def fetch_features(src_nodes: torch.Tensor, offsets: torch.Tensor,
                   num_parts: int, features: torch.Tensor,
                   counter: RoundCounter | None,
                   group: RankGroup | None = None) -> torch.Tensor:
    """The 2 feature rounds (ids out, rows back) for every worker.

    src_nodes: (P, N) global ids to fetch per worker (-1 padding yields
    +0.0 rows); features: (P, n_max, D) the owners' shards.  Returns
    (P, N, D) rows aligned with ``src_nodes``.  The owners' local row
    gather runs through the ``feature_gather`` kernel.
    """
    P, N = src_nodes.shape
    own = owner_of(offsets, src_nodes)
    buf, oidx, sidx = pack_by_owner(src_nodes, own, num_parts)
    reqs = exchange(buf, counter, kind="feature",
                    group=group)                           # round: ids
    ids = owner_local_ids(reqs, offsets, features.shape[1], group)
    rows = feature_gather(ids, features).view(P, num_parts, N, -1)
    reps = exchange(rows, counter, kind="feature",
                    group=group)                           # round: rows
    p = torch.arange(P, device=src_nodes.device).view(P, 1)
    h = reps[p, oidx.long(), sidx.long()]
    return torch.where((src_nodes >= 0)[..., None], h,
                       torch.zeros((), dtype=h.dtype, device=h.device))


def cache_lookup(cache, src_nodes: torch.Tensor):
    """Hot-set probe: one batched left-side ``searchsorted`` per worker
    over the cache's sorted id rows.

    cache: a ``repro_torch.core.cache.FeatureCache`` ((P, K) ids);
    src_nodes: (P, N) global ids, -1 padded.  Returns ``(is_hit (P, N)
    bool, pos_c (P, N) int64)``: ``pos_c`` is the clamped slot of each id
    in its worker's cache, meaningful where ``is_hit``.
    """
    K = cache.capacity
    pos = torch.searchsorted(cache.ids, src_nodes.contiguous())
    pos_c = pos.clamp(0, K - 1)
    is_hit = (torch.gather(cache.ids, -1, pos_c) == src_nodes) \
        & (src_nodes >= 0)
    return is_hit, pos_c


def fetch_features_cached(src_nodes: torch.Tensor, offsets: torch.Tensor,
                          num_parts: int, features: torch.Tensor, cache,
                          counter: RoundCounter | None = None,
                          group: RankGroup | None = None):
    """Cache-aware feature fetch, rows bit-identical to
    ``fetch_features``.

    Hits are served from the worker's cache and never enter the request
    buffer (their slot carries -1), so utilized bytes drop by the hit rate
    while the buffer capacity is unchanged.  Returns ``(h (P, N, D),
    hits (P,) int64)``.
    """
    is_hit, pos_c = cache_lookup(cache, src_nodes)
    p = torch.arange(src_nodes.shape[0], device=src_nodes.device).view(-1, 1)
    hit_rows = cache.rows[p, pos_c]
    miss_ids = torch.where(is_hit, -1, src_nodes)
    h_miss = fetch_features(miss_ids, offsets, num_parts, features, counter,
                            group)
    h = torch.where(is_hit[..., None], hit_rows.to(h_miss.dtype), h_miss)
    return h, is_hit.sum(dim=-1)


# --------------------------------------------------------------------------
# the seed API's train step (deprecated shim; see repro_torch.pipeline)
# --------------------------------------------------------------------------

def make_worker_step(*, graph_replicated: CSCGraph | None,
                     offsets: torch.Tensor, num_parts: int,
                     fanouts: Sequence[int], scheme: str,
                     loss_fn: Callable, level_fn=sample_level,
                     counter: RoundCounter | None = None,
                     vanilla_fused: bool = False,
                     group: RankGroup | None = None):
    """Deprecated: the train step of ``repro``'s seed API.

    Use ``repro_torch.pipeline.Pipeline`` (or, for the raw step program,
    ``repro_torch.pipeline.worker.make_worker_step``), to which this
    delegates.  Returns ``step(params, shards, seeds, salt) -> (loss,
    grads)``: the mean over the workers, the metrics dropped.  ``group``
    builds a fleet rank's step, for ``make_shard_map_step``.
    """
    warnings.warn(
        "repro_torch.core.dist.make_worker_step is deprecated; use "
        "repro_torch.pipeline.Pipeline.from_layout(...).step_fn(...) or "
        "repro_torch.pipeline.worker.make_worker_step",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline.worker import make_worker_step as _make

    inner = _make(graph_replicated=graph_replicated, offsets=offsets,
                  num_parts=num_parts, fanouts=fanouts, scheme=scheme,
                  loss_fn=loss_fn, level_fn=level_fn, counter=counter,
                  vanilla_fused=vanilla_fused, group=group)

    def step(params, shards: WorkerShard, seeds, salt):
        loss, grads, _metrics = inner(params, shards, seeds, salt)
        return loss, grads

    step.group = group
    return step


def run_stacked(step, params, shards: WorkerShard, seeds, salt):
    """Run the seed API's step over all P stacked workers; returns the
    mean loss and gradients.  ``repro`` maps its per-worker step with
    ``vmap`` and takes worker 0's copy of the replicated mean; the port's
    step is already the stacked program under ``repro``'s gradient rule
    (each worker's own backward, then the mean in worker order), with the
    one replicated value as its result, so this is a call."""
    return step(params, shards, seeds, salt)


def make_shard_map_step(step, group: RankGroup):
    """A fleet rank's run of the seed API's step, ``repro``'s
    ``shard_map`` wrapper: ``run(params, shards, seeds, salt) -> (loss,
    grads)`` takes the (P, ...) stacked shards and seeds of all workers,
    keeps the rank's block (rows ``group.lo .. group.hi - 1``, where
    ``repro`` keeps a device's ``a[0]``) and runs ``step`` on it; the loss
    and gradients are reduced over all P workers, the same on every rank.

    ``repro``'s mesh becomes the rank's ``group`` (``dist.rank_group``),
    and ``step`` must be built with it (``make_worker_step(group=...)``).
    Its three partition specs have no counterpart: the parameters are
    replicated on every rank and the stacked arguments split on axis 0.
    """
    if getattr(step, "group", None) != group:
        raise ValueError(
            f"the step was built for group {getattr(step, 'group', None)!r}"
            f", not {group!r}; build it with make_worker_step(group=...)")
    rows = slice(group.lo, group.hi)

    def run(params, shards: WorkerShard, seeds, salt):
        mine = WorkerShard(**{
            f.name: None if getattr(shards, f.name) is None
            else getattr(shards, f.name)[rows]
            for f in dataclasses.fields(shards)})
        return step(params, mine, seeds[rows], salt)

    return run
