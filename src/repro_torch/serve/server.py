"""``GNNServer``: the serving loop tying queue -> recycler -> microbatcher
-> ``Predictor`` together, plus latency/throughput accounting and trace
spans (counterpart of ``repro.serve.server``).

The server runs an open-loop simulation on a virtual clock: arrival times
come from the traffic generator, service times are MEASURED wall-clock
durations of the real inference step (``predict`` returns host arrays, so
each duration ends after the device finished), and completions are
scheduled on a single-server queue (a flush starts when both its trigger
time has passed and the device is free).

Per request: a ``RecyclingCache`` hit completes at once (no sampling, no
model); a miss joins the microbatcher, and the flush's fresh logits are
inserted into the recycler, stamped with the fresh-flush counter (the
recycler's ``tau`` clock).

Salt policy: ``"fixed"`` (default) reuses the predictor's base salt every
flush — deterministic serving, outputs and recycled hits bit-identical to
direct ``predict``; ``"step"`` advances the salt per flush, so recycled
entries are stale samples bounded by the recycler's tau / rho contract.

Tracing (``repro_torch.obs.trace``): each flush is a real-clock
``serve/predict`` span; each request's queue wait, batch delay and service
(and a recycled hit) are events on the virtual clock, one lane (tid) per
request, under a process of their own (``SERVE_VPID``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.obs import trace as _trace
from repro_torch.serve.batcher import (BucketSpec, MicroBatcher, Request,
                                      max_owner_count)
from repro_torch.serve.predictor import Predictor
from repro_torch.serve.recycler import RecyclingCache

#: pid of the virtual-clock request lanes in exported traces: the
#: simulation's per-request phases live on the virtual timeline, so they
#: are exported as explicit-timestamp events under this process rather
#: than on the real monotonic clock; ``merge_traces`` keeps virtual pids
#: rank-unique when ranks merge.
SERVE_VPID = 100


@dataclasses.dataclass
class ServeStats:
    """Latency/throughput summary of one serving run."""
    latencies: np.ndarray          # (N,) seconds, request order
    num_recycled: int
    num_flushes: int
    bucket_histogram: dict[int, int]
    compute_time: float            # total measured step seconds
    makespan: float                # first arrival -> last completion
    recycler: dict | None          # RecyclingCache.stats() or None

    @property
    def num_requests(self) -> int:
        return int(self.latencies.shape[0])

    @property
    def p50(self) -> float:
        return float(np.percentile(self.latencies, 50))

    @property
    def p99(self) -> float:
        return float(np.percentile(self.latencies, 99))

    @property
    def mean(self) -> float:
        return float(np.mean(self.latencies))

    @property
    def qps(self) -> float:
        return self.num_requests / self.makespan if self.makespan > 0 \
            else 0.0

    def summary(self) -> dict:
        """JSON-ready summary."""
        return {
            "num_requests": self.num_requests,
            "p50_ms": self.p50 * 1e3,
            "p99_ms": self.p99 * 1e3,
            "mean_ms": self.mean * 1e3,
            "qps": self.qps,
            "num_recycled": self.num_recycled,
            "recycled_fraction": (self.num_recycled / self.num_requests
                                  if self.num_requests else 0.0),
            "num_flushes": self.num_flushes,
            "bucket_histogram": {str(k): v for k, v
                                 in sorted(self.bucket_histogram.items())},
            "compute_time_s": self.compute_time,
            "makespan_s": self.makespan,
            "recycler": self.recycler,
        }


class GNNServer:
    """Single-device serving loop over a ``Predictor``.

    Parameters
    ----------
    predictor : Predictor
    buckets : sequence of int, optional
        Batch-shape buckets that size the microbatcher's flushes; the
        predictor's own when None.  The predictor still pads each flush
        to its own buckets, so keep them equal (the default does).
    max_delay : float
        Deadline (seconds) a request may wait for batchmates; 0 serves
        every request alone.
    recycler : RecyclingCache | None
        None disables recycling.
    salt_policy : "fixed" | "step"
        See the module docstring.
    device
        ``None`` means CUDA; it must be the predictor's device.
    """

    def __init__(self, predictor: Predictor, *,
                 buckets: Sequence[int] | None = None,
                 max_delay: float = 2e-3,
                 recycler: RecyclingCache | None = None,
                 salt_policy: str = "fixed", device=None):
        if resolve_device(device).type != predictor.device.type:
            raise ValueError(f"GNNServer on {resolve_device(device)} over "
                             f"a predictor on {predictor.device}")
        if salt_policy not in ("fixed", "step"):
            raise ValueError(f"salt_policy must be 'fixed' or 'step', "
                             f"got {salt_policy!r}")
        self.predictor = predictor
        self.buckets = (BucketSpec(buckets) if buckets is not None
                        else predictor.buckets)
        self.max_delay = float(max_delay)
        self.recycler = recycler
        self.salt_policy = salt_policy
        self.step = 0              # fresh-flush counter (recycler clock)

    def _salt(self) -> int:
        base = self.predictor.base_salt
        return base if self.salt_policy == "fixed" else base + self.step

    def run(self, arrivals, *, warmup: bool = True,
            collect_outputs: bool = False):
        """Serve ``arrivals`` (``(time, seed)`` pairs, time-sorted).

        Returns ``ServeStats``, or ``(ServeStats, outputs)`` with
        ``collect_outputs=True`` where ``outputs`` is (N, C) logits in
        arrival order (recycled rows are the recycled logits).
        """
        tracer = _trace.active_tracer()
        if tracer is not None:
            tracer.name_process(SERVE_VPID, "serve (virtual clock)")
        if warmup:
            self.predictor.warmup(buckets=self.buckets.sizes)
        arrivals = [(float(t), int(s)) for t, s in arrivals]
        if any(arrivals[i][0] > arrivals[i + 1][0]
               for i in range(len(arrivals) - 1)):
            raise ValueError("arrivals must be sorted by time")

        batcher = MicroBatcher(self.buckets, max_delay=self.max_delay)
        n = len(arrivals)
        latencies = np.zeros(n)
        outputs: list = [None] * n
        index_of: dict[int, int] = {}      # Request.uid -> arrival index
        bucket_hist: dict[int, int] = {}
        state = {"free": 0.0, "compute": 0.0, "flushes": 0,
                 "recycled": 0, "last_done": 0.0}

        def flush(at: float) -> None:
            reqs = batcher.flush()
            if not reqs:
                return
            start = max(at, state["free"])
            seeds = [r.seed for r in reqs]
            # the real-clock span times the whole sampled inference step
            # (predict returns host arrays, so it ends after the device);
            # the per-request phase events below live on the virtual clock
            with _trace.span("serve/predict", cat="serve",
                             batch=len(reqs)):
                t0 = time.perf_counter()
                logits = self.predictor.predict(seeds, salt=self._salt())
                dt = time.perf_counter() - t0
            done = start + dt
            state["free"] = done
            state["compute"] += dt
            state["flushes"] += 1
            state["last_done"] = max(state["last_done"], done)
            internal = self.predictor._to_internal(
                np.asarray(seeds, np.int64))
            b = self.buckets.bucket_for(
                max_owner_count(self.predictor.offsets, internal))
            bucket_hist[b] = bucket_hist.get(b, 0) + 1
            for r, row in zip(reqs, logits):
                i = index_of.pop(r.uid)
                latencies[i] = done - r.arrival
                outputs[i] = row
                if self.recycler is not None:
                    self.recycler.insert(r.seed, row, self.step)
                if tracer is not None:
                    # one lane (tid) per request: waiting for batchmates,
                    # then for the device, then in service
                    tracer.event("serve/queue_wait", r.arrival,
                                 max(0.0, at - r.arrival), tid=i,
                                 pid=SERVE_VPID, cat="serve",
                                 args={"seed": r.seed})
                    tracer.event("serve/batch_delay", at,
                                 max(0.0, start - at), tid=i,
                                 pid=SERVE_VPID, cat="serve")
                    tracer.event("serve/service", start, dt, tid=i,
                                 pid=SERVE_VPID, cat="serve",
                                 args={"bucket": b})
            self.step += 1

        for i, (t, seed) in enumerate(arrivals):
            while batcher.next_due() <= t:
                flush(batcher.next_due())
            if self.recycler is not None:
                t0 = time.perf_counter()
                hit = self.recycler.lookup(seed, self.step)
                dt = time.perf_counter() - t0
                if hit is not None:
                    latencies[i] = dt
                    outputs[i] = hit
                    state["recycled"] += 1
                    state["last_done"] = max(state["last_done"], t + dt)
                    if tracer is not None:
                        tracer.event("serve/recycled_hit", t, dt, tid=i,
                                     pid=SERVE_VPID, cat="serve",
                                     args={"seed": seed})
                    continue
            req = Request(seed=seed, arrival=t)
            index_of[req.uid] = i
            batcher.add(req)
            if batcher.due(t):
                flush(t)
        while len(batcher):
            flush(batcher.next_due())

        makespan = state["last_done"] - arrivals[0][0] if arrivals else 0.0
        stats = ServeStats(
            latencies=latencies, num_recycled=state["recycled"],
            num_flushes=state["flushes"], bucket_histogram=bucket_hist,
            compute_time=state["compute"], makespan=makespan,
            recycler=(self.recycler.stats() if self.recycler is not None
                      else None))
        if collect_outputs:
            return stats, np.stack(outputs) if n else np.zeros((0, 0))
        return stats
