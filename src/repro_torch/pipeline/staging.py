"""Host-side asynchronous seed and feature staging (counterpart of
``repro.pipeline.staging``).

``SeedStager`` is a background thread that draws future steps' seeds on
the host (``SeedStream.seeds_host``, numpy only) and starts their copies to
the device, keeping a ring of ``depth + lead`` staged slots warm:

  * ``depth`` — prepared batches the consuming driver keeps in flight
                (``PrefetchSpec.depth``); the ring covers its refills;
  * ``lead``  — slots staged beyond the driver's own lookahead
                (``PrefetchSpec.lead``), the host's margin.

``FeatureStager`` adds the ``staged`` store's feature rows: it replays the
sampler on the host (``_frontier_src_nodes_host``), gathers the frontier's
rows from a host copy of the feature table into a pooled buffer and copies
them to the device.

On CUDA the thread sets the device, its copies go from pinned host memory
(``non_blocking``) on a CUDA stream of its own, and each slot carries an
event: ``get(k)`` makes the consumer's stream wait on it and records the
consumer's stream on the staged tensors, so the caching allocator does not
hand their memory out while the step still reads it.  A pooled pinned row
buffer is rewritten only after its last copy's event has completed.  On the
CPU the copy is a ``clone``.

Determinism: a slot is ``(stream.seeds(k), stream.salt_int(k))`` (and the
rows ``fetch_features`` would return for step k) for a concrete k, and the
stream is a function of k alone, so staged runs equal unstaged ones bit for
bit.  ``get(k)`` serves the ring head only when it is step k; any other k
drains the ring and refills it from k, as the drivers refill their FIFO.
Errors on the thread are raised by the next ``get``.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from repro_torch.obs import trace as _trace

# the longest a get() waits for one slot before it gives up (a produce at
# full width takes seconds)
_WAIT_S = 120.0
_U32 = 0xFFFFFFFF
_SENTINEL32 = np.iinfo(np.int32).max


class SeedStager:
    """Background staging of per-step seeds and salt.

    stream: a ``repro_torch.pipeline.prefetch.SeedStream``; the thread
            calls its host half (``seeds_host``, ``salt_int``) only.
    depth:  the consuming driver's prefetch depth (0 for the sync driver).
    lead:   slots staged beyond ``depth``, >= 1.
    device: where the staged seeds land.

    ``get(k)`` returns ``(seeds, salt)``: a (P, batch) int32 tensor on
    ``device`` and the Python-int salt.  ``stats()`` reports how often
    ``get`` found the ring empty and the pinned bytes; each produce, and
    each of its stages, is a ``stager/...`` span on the thread's own
    trace track (``repro_torch.obs.trace``).
    """

    def __init__(self, stream, *, depth: int = 0, lead: int = 1,
                 device=torch.device("cpu")):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        if lead < 1:
            raise ValueError(
                f"staging lead must be >= 1 (got {lead}); lead 0 would "
                f"stage nothing ahead of the driver's own lookahead")
        self.stream = stream
        self.slots = int(depth) + int(lead)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)
        self._cv = threading.Condition()
        self._ring: collections.deque = collections.deque()
        self._want: int | None = None     # next index the thread produces
        self._gen = 0                     # bumped on every drain (seek)
        self._error: BaseException | None = None
        self._closed = False
        self.empty_waits = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-seed-stager")
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """Start ``host``'s copy to the device (on the thread's stream)."""
        t = torch.from_numpy(host)
        if not self._cuda:
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _produce(self, k: int) -> tuple:
        """Step ``k``'s staged tensors, copies started (thread side)."""
        with _trace.span("stager/seeds_host", cat="stager"):
            seeds_np = self.stream.seeds_host(k)
        with _trace.span("stager/h2d", cat="stager"):
            seeds = self._to_device(seeds_np)
        return seeds, self.stream.salt_int(k)

    def _worker(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._closed and (
                        self._want is None
                        or len(self._ring) >= self.slots
                        or self._error is not None):
                    self._cv.wait()
                if self._closed:
                    return
                gen, k = self._gen, self._want
            try:
                # spans recorded here land on this thread's own track
                with _trace.span("stager/produce", cat="stager", step=k):
                    if self._cuda:
                        with torch.cuda.stream(self._copy_stream):
                            item = self._produce(k)
                            event = torch.cuda.Event()
                            event.record(self._copy_stream)
                    else:
                        item, event = self._produce(k), None
            except BaseException as e:  # raised by the next get()
                with self._cv:
                    if self._gen == gen:
                        self._error = e
                        self._cv.notify_all()
                continue
            with self._cv:
                if self._gen != gen or self._closed:
                    continue            # stale: a seek raced the produce
                self._ring.append((k, item, event))
                self._want = k + 1
                self._cv.notify_all()

    # ------------------------------------------------------------ consumer

    def _seek_locked(self, k: int) -> None:
        self._gen += 1
        self._ring.clear()
        self._error = None
        self._want = int(k)
        self._cv.notify_all()

    def seek(self, k: int) -> None:
        """Drain the ring and restart staging from step ``k``."""
        with self._cv:
            self._seek_locked(k)

    def get(self, k: int) -> tuple:
        """Staged tensors of step ``k``, ready for the caller's stream.

        Serves the ring head when it is step ``k``, else drains and
        refills from ``k``.  Blocks until the slot is staged (at most
        ``_WAIT_S`` seconds); re-raises an error the thread hit.  The
        ``stager/get`` span covers any such wait: a long one in a trace
        means the ring does not ride far enough ahead (raise
        ``PrefetchSpec.lead``)."""
        k = int(k)
        with _trace.span("stager/get", cat="stager", step=k), self._cv:
            if self._closed:
                raise RuntimeError("stager is closed")
            head = self._ring[0][0] if self._ring else self._want
            if head != k:
                self._seek_locked(k)
            if not self._ring:
                self.empty_waits += 1
            deadline = time.monotonic() + _WAIT_S
            while not self._ring:
                if self._error is not None:
                    err, self._error = self._error, None
                    self._cv.notify_all()   # let the thread retry
                    raise err
                if self._closed:
                    raise RuntimeError("stager is closed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"no staged slot for step {k} after {_WAIT_S} s")
                self._cv.wait(left)
            _, item, event = self._ring.popleft()
            self._cv.notify_all()           # a slot freed: keep staging
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in item:
                if isinstance(t, torch.Tensor):
                    t.record_stream(consumer)
        return item

    # ----------------------------------------------------------- lifecycle

    @property
    def pinned_bytes(self) -> int:
        """Host bytes this stager keeps pinned (its row pool)."""
        return 0

    def stats(self) -> dict:
        """``empty_waits`` (gets that found the ring empty) and
        ``pinned_bytes``."""
        with self._cv:
            return {"empty_waits": self.empty_waits,
                    "pinned_bytes": self.pinned_bytes}

    def close(self) -> None:
        """Stop the thread and drop staged slots (idempotent)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._ring.clear()
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "SeedStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _np_hash_u32(x: np.ndarray, salt: int) -> np.ndarray:
    """Numpy form of ``repro_torch.core.sampler.hash_u32`` (uint32
    wraparound), bit-identical."""
    x = x.astype(np.uint32) + np.uint32((salt * 0x9E3779B9) & _U32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _frontier_src_nodes_host(indptr: np.ndarray, indices: np.ndarray,
                             seeds: np.ndarray, fanouts, salt: int,
                             window: int | None = None) -> np.ndarray:
    """One worker's last-level frontier, replayed in numpy.

    ``sample_neighbors`` and the ``src_nodes`` half of ``relabel`` level by
    level: the same hash draws, the same sort-based unique, the same -1
    padding, so the result equals ``sample_mfgs(...)[-1].src_nodes``.
    ``window`` is the level backend's draw window: the fused backend draws
    from ``min(deg, window)`` neighbours (``fused_sample_plain``), the
    reference backend from all of them (``None``).
    """
    cur = np.asarray(seeds, np.int32)
    for depth, fanout in enumerate(fanouts):
        lsalt = (int(salt) * 1000003 + depth) & _U32
        seed_ok = cur >= 0
        v = np.where(seed_ok, cur, 0)
        start = indptr[v].astype(np.int64)
        deg = indptr[v + 1].astype(np.int64) - start
        if window is not None:
            deg = np.minimum(deg, window)
        cols = np.arange(fanout, dtype=np.int64)[None, :]
        bits = _np_hash_u32(
            v[:, None].astype(np.uint32) * np.uint32(2654435761)
            + np.arange(fanout, dtype=np.uint32)[None, :], lsalt)
        rand_idx = (bits % np.maximum(deg, 1)[:, None].astype(np.uint32)
                    ).astype(np.int64)
        col = np.where((deg <= fanout)[:, None], cols, rand_idx)
        valid = (cols < np.minimum(deg, fanout)[:, None]) \
            & seed_ok[:, None]
        idx = np.clip(start[:, None] + col, 0, indices.shape[0] - 1)
        samples = np.where(valid, indices[idx], -1).astype(np.int32)

        S = cur.shape[0]
        flat = samples.ravel()
        fv = valid.ravel()
        seeds_sorted = np.sort(np.where(seed_ok, cur, _SENTINEL32))
        pos = np.clip(np.searchsorted(seeds_sorted, flat), 0, S - 1)
        is_seed = (seeds_sorted[pos] == flat) & fv
        ns_sorted = np.sort(np.where(fv & ~is_seed, flat, _SENTINEL32))
        is_new = np.concatenate(
            [np.ones(1, bool), ns_sorted[1:] != ns_sorted[:-1]])
        is_new &= ns_sorted != _SENTINEL32
        new_nodes = np.full(flat.shape[0], -1, np.int32)
        n_new = int(is_new.sum())
        new_nodes[:n_new] = ns_sorted[is_new]
        cur = np.concatenate([np.where(seed_ok, cur, -1), new_nodes])
    return cur


class FeatureStager(SeedStager):
    """A ``SeedStager`` that also stages the step's feature rows for the
    ``staged`` store.  For step k the thread

      1. draws ``(seeds, salt)`` as ``SeedStager`` does;
      2. replays the sampler on the host (``_frontier_src_nodes_host``,
         with the level backend's window when the placement samples
         through the backend, else windowless), giving the frontier the
         device will sample;
      3. gathers the frontier's rows from a host copy of the (P, n_max, D)
         table into a pooled (P, N, D) buffer (+0.0 rows for padding), and
         zeroes the slots the pinned cache will serve when the store takes
         hits from the device cache;
      4. starts the copies of seeds and rows.

    The pool holds ``2 * depth + lead + 1`` buffers (``repro``'s size),
    pinned on CUDA.  A buffer is written incrementally (live slots
    gathered, slots live in its previous use re-zeroed) and only after the
    event of its previous copy has completed; the copy gives the device a
    buffer of its own, so, unlike ``repro``'s zero-copy buffers, a pooled
    buffer needs no fence on the step that reads it.  ``get(k)`` returns
    ``(seeds, salt, rows)``.
    """

    def __init__(self, stream, *, pipeline, depth: int = 0, lead: int = 1):
        from repro_torch.core.sampler import resolve_backend

        layout = pipeline.layout
        graph = pipeline.graph_replicated
        if graph is None:
            graph = layout.graph
        self._fanouts = tuple(int(f) for f in pipeline.spec.sampler.fanouts)
        # the device draws through the level backend (and its window) only
        # under a scheme that samples through it; the others draw
        # windowless whatever the backend
        self._window = None
        if pipeline.placement.scheme.uses_level_backend:
            self._window = getattr(
                resolve_backend(pipeline.spec.sampler.backend), "window",
                None)
        self._indptr_np, self._indices_np = graph.numpy()
        self._offsets_np = layout.host_offsets_labels()[0]
        self._feats_np = layout.features.cpu().numpy()
        self._dtype = layout.features.dtype
        cache = pipeline.cache
        hot = getattr(pipeline.feature_store, "hot_rows_from_cache", None)
        skip_hits = cache is not None and (
            hot is None or hot(pipeline.device))
        self._cache_ids_np = cache.ids.cpu().numpy() if skip_hits else None
        self._pool_n = 2 * int(depth) + int(lead) + 1
        self._pool: list | None = None        # pinned tensors
        self._pool_np: list | None = None     # numpy views of them
        self._pool_valid: list | None = None  # each buffer's live mask
        self._pool_events: list | None = None
        super().__init__(stream, depth=depth, lead=lead,
                         device=pipeline.device)

    @property
    def pinned_bytes(self) -> int:
        if not self._cuda or self._pool is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._pool)

    def _stage_rows(self, k: int, frontier: np.ndarray) -> int:
        """Write the (P, N) frontier's rows into pool buffer ``k % pool_n``
        and return its index."""
        valid = frontier >= 0
        ids = self._cache_ids_np
        if ids is not None:
            K = ids.shape[1]
            for p in range(ids.shape[0]):
                pos = np.clip(np.searchsorted(ids[p], frontier[p]), 0, K - 1)
                valid[p] &= ~((ids[p][pos] == frontier[p]) & valid[p])
        shape = frontier.shape + (self._feats_np.shape[2],)
        if self._pool is None or tuple(self._pool[0].shape) != shape:
            self._pool = [torch.zeros(shape, dtype=self._dtype,
                                      pin_memory=self._cuda)
                          for _ in range(self._pool_n)]
            self._pool_np = [t.numpy() for t in self._pool]
            self._pool_valid = [None] * self._pool_n
            self._pool_events = [None] * self._pool_n
        slot = k % self._pool_n
        if self._pool_events[slot] is not None:
            self._pool_events[slot].synchronize()
        rows, prev = self._pool_np[slot], self._pool_valid[slot]
        if prev is not None:
            rows[prev & ~valid] = 0.0
        src = frontier[valid]
        own = np.searchsorted(self._offsets_np, src, side="right") - 1
        rows[valid] = self._feats_np[own, src - self._offsets_np[own]]
        self._pool_valid[slot] = valid
        return slot

    def _produce(self, k: int) -> tuple:
        with _trace.span("stager/seeds_host", cat="stager"):
            seeds_np = self.stream.seeds_host(k)
            salt = self.stream.salt_int(k)
        with _trace.span("stager/frontier_replay", cat="stager"):
            frontier = np.stack([
                _frontier_src_nodes_host(self._indptr_np, self._indices_np,
                                         seeds_np[p], self._fanouts, salt,
                                         window=self._window)
                for p in range(seeds_np.shape[0])])
        with _trace.span("stager/gather_rows", cat="stager"):
            slot = self._stage_rows(k, frontier)
        with _trace.span("stager/h2d", cat="stager"):
            seeds = self._to_device(seeds_np)
            if not self._cuda:
                rows = self._pool[slot].clone()
            else:
                rows = self._pool[slot].to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
                self._pool_events[slot] = event
        return seeds, salt, rows


def make_stager(staging, stream, *, depth: int, pipeline):
    """Resolve a driver's ``staging`` argument into ``(stager, owned)``.

    ``staging`` is ``None`` (``spec.prefetch.staging`` decides), a bool, or
    a ``SeedStager`` the caller built (adopted: ``owned`` is False, so the
    driver's ``close`` leaves it running).  A store with
    ``external_rows`` (``staged``) always gets a ``FeatureStager``, and an
    adopted plain ``SeedStager`` is refused for it.
    """
    wants_rows = pipeline.feature_store.external_rows
    if staging is None:
        staging = pipeline.spec.prefetch.staging
    if isinstance(staging, SeedStager):
        if wants_rows and not isinstance(staging, FeatureStager):
            raise ValueError(
                "the staged feature store needs a FeatureStager (its "
                "slots carry the step's feature rows); got a seed-only "
                "SeedStager")
        return staging, False
    if not staging and not wants_rows:
        return None, False
    lead = pipeline.spec.prefetch.lead
    if wants_rows:
        return FeatureStager(stream, pipeline=pipeline, depth=depth,
                             lead=lead), True
    return SeedStager(stream, depth=depth, lead=lead,
                      device=pipeline.device), True
