"""Pod-scale dry-run of the paper's own workload: one rank of a 256-worker
(pod) or 512-worker (multipod) distributed GraphSAGE training job, one
worker a rank, traced once on fake tensors.

Counterpart of ``repro.launch.dryrun_gnn``, which lowers and compiles the
per-worker step under ``shard_map`` on placeholder host devices.  Here the
process is rank 0 of a ``W``-rank ``torch.distributed`` job on the
``"fake"`` backend (``FakeStore``: no peers, no network), its workers are
``RankGroup(0, 1, W)`` (``repro``'s shard_map layout), and the step
(``repro_torch.pipeline.worker.make_worker_step``) runs once on
``FakeTensorMode`` tensors of ``repro``'s shapes: the shard, the seeds, the
offsets, the placement plan and, for hybrid, the replicated topology are
built directly, with no partitioning and no validation, as ``repro``
builds its ``ShapeDtypeStruct``\\s.  Nothing is allocated and no card is
needed: fake CPU tensors take the plain versions of the kernels, as
``repro``'s dry-run runs on host devices.

Each scheme's record holds the round structure (a ``RoundCounter``), the
collectives of the step read from the ``comm/*`` spans that
``repro_torch.core.dist._collective`` opens (result-shape bytes, as
``repro``'s HLO count: an all_to_all's result is its send buffer, an
all_gather's R times what a rank sends), and the peak of the step's
tensors under ``torch.distributed._tools.mem_tracker.MemTracker``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --workers 256 \\
      --scheme both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Callable

import torch

from repro_torch.roofline import COLLECTIVE_KINDS

_KIND = {"all_to_all": "all-to-all", "all_gather": "all-gather"}
AVG_DEGREE = 29          # papers100M-like topology stand-in, as repro's


def model_config(features: int):
    """``repro``'s dry-run model: GraphSAGE features -> 256 -> 256 -> 172,
    fanouts (15, 10, 5), no dropout."""
    from repro_torch.models.gnn import GNNConfig
    return GNNConfig(in_dim=features, hidden_dim=256, num_classes=172,
                     num_layers=3, fanouts=(15, 10, 5), dropout=0.0)


@contextlib.contextmanager
def fake_job(workers: int):
    """This process as rank 0 of a ``workers``-rank job on the fake
    backend, for the ``with`` body: the job is made on entry and torn
    down on exit.  An initialized job of another size is refused; one of
    this size is used as it is and left in place."""
    import torch.distributed as tdist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if tdist.is_initialized():
        if tdist.get_world_size() != workers:
            raise RuntimeError(
                f"a {tdist.get_world_size()}-rank job is initialized; the "
                f"dry-run needs {workers} ranks")
        yield
        return
    hook = sys.excepthook        # the job's init wraps it with a prefix
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=workers)
    try:
        yield
    finally:
        tdist.destroy_process_group()
        sys.excepthook = hook


def build_rank(scheme: str, *, workers: int, nodes_per_worker: int,
               batch: int, features: int, make: Callable,
               partitioner: str = "ldg"):
    """Rank 0's inputs for ``scheme`` (``"vanilla"`` or ``"hybrid"``) at
    ``repro``'s dry-run shapes.

    ``make(shape, dtype, what)`` returns each tensor: ``what`` is one of
    ``"offsets"`` (the partition boundaries, ``nodes_per_worker`` apart),
    ``"features"``, ``"labels"``, ``"local_indptr"``, ``"local_indices"``,
    ``"seeds"``, ``"indptr"`` and ``"indices"`` (the replicated
    topology, ``AVG_DEGREE`` in-edges a node).  Returns ``(spec, plan,
    shard, seeds)``; the plan holds the offsets.
    """
    from repro_torch.core import dist
    from repro_torch.core.graph import CSCGraph
    from repro_torch.core.placement import (HybridPlacementPlan,
                                            PlacementPlan, resolve_scheme)
    from repro_torch.pipeline.specs import PipelineSpec

    W, n_max = workers, nodes_per_worker
    n_total = W * n_max
    cfg = model_config(features)
    spec = PipelineSpec.from_scheme(scheme, num_parts=W, fanouts=cfg.fanouts,
                                    partitioner=partitioner,
                                    executor="shard_map")
    placement = resolve_scheme(spec.plan.scheme)
    i32, f32 = torch.int32, torch.float32
    offsets = make((W + 1,), i32, "offsets")
    vanilla = spec.plan.scheme == "vanilla"
    shard = dist.WorkerShard(
        features=make((1, n_max, features), f32, "features"),
        labels=make((1, n_max), i32, "labels"),
        local_indptr=(make((1, n_max + 1), i32, "local_indptr")
                      if vanilla else None),
        local_indices=(make((1, n_max * AVG_DEGREE), i32, "local_indices")
                       if vanilla else None))
    seeds = make((1, batch), i32, "seeds")
    if vanilla:
        plan = PlacementPlan(scheme=placement, offsets=offsets,
                             num_parts=W)
    else:
        graph = CSCGraph(indptr=make((n_total + 1,), i32, "indptr"),
                         indices=make((n_total * AVG_DEGREE,), i32,
                                      "indices"))
        plan = HybridPlacementPlan(scheme=placement, offsets=offsets,
                                   num_parts=W, graph=graph)
    return spec, plan, shard, seeds


def run_step(spec, plan, shard, seeds, params, *, workers: int,
             features: int, salt: int = 1):
    """Run rank 0's step once (``RankGroup(0, 1, workers)``) with a fresh
    ``RoundCounter`` and a tracer of its own for the ``comm/*`` spans
    (it replaces any installed tracer, and leaves none).  Returns
    ``(loss, counter, comm spans)``: each span a dict with ``op``,
    ``what`` and ``bytes`` (sent by this rank)."""
    from repro_torch.core import dist
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.obs import trace as _trace
    from repro_torch.pipeline.worker import make_worker_step

    cfg = model_config(features)
    counter = dist.RoundCounter()
    step = make_worker_step(
        offsets=plan.offsets, num_parts=workers, fanouts=cfg.fanouts,
        loss_fn=lambda p, m, h, y, v: gnn_loss(p, m, h, y, v, cfg),
        plan=plan, backend=spec.sampler.backend, counter=counter,
        group=dist.RankGroup(0, 1, workers))
    tracer = _trace.start(None)
    try:
        loss, _grads, _metrics = step(params, shard, seeds, salt)
    finally:
        _trace.stop(export=False)
    spans = [ev["args"] for ev in tracer.events()
             if ev.get("ph") == "X" and ev["name"].startswith("comm/")
             and ev["name"] != "comm/device_wait"]
    return loss, counter, spans


def collective_record(spans, workers: int) -> dict:
    """Counts and result-shape bytes of the step's collectives (one rank a
    worker): by ``repro``'s kinds, by op and ``what``, and in all."""
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    by_kind = {k: 0 for k in COLLECTIVE_KINDS}
    by_what: dict[str, int] = {}
    for s in spans:
        kind = _KIND[s["op"]]
        result = s["bytes"] * (workers if s["op"] == "all_gather" else 1)
        counts[kind] += 1
        by_kind[kind] += result
        key = f"{kind}/{s['what']}"
        by_what[key] = by_what.get(key, 0) + result
    return {"collective_counts": counts,
            "collective_bytes_by_kind": by_kind,
            "collective_bytes_by_what": by_what,
            "collective_bytes_per_device": sum(by_kind.values())}


def dryrun(scheme: str, *, workers: int = 256, partitioner: str = "ldg",
           nodes_per_worker: int = 2000, batch: int = 1000,
           features: int = 128) -> dict:
    """One scheme's record: rank 0 of a ``workers``-rank job on fake
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.core.partition import resolve_partitioner
    from repro_torch.models.gnn import init_gnn_params

    resolve_partitioner(partitioner)
    cfg = model_config(features)
    real = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with fake_job(workers), FakeTensorMode() as mode:
        def make(shape, dtype, what):
            return torch.empty(shape, dtype=dtype)

        spec, plan, shard, seeds = build_rank(
            scheme, workers=workers, nodes_per_worker=nodes_per_worker,
            batch=batch, features=features, make=make,
            partitioner=partitioner)
        params = [{k: mode.from_tensor(v) for k, v in layer.items()}
                  for layer in real]
        tracker = MemTracker()
        tracker.track_external(*step_inputs(params, shard, seeds, plan))
        with tracker:
            _loss, counter, spans = run_step(
                spec, plan, shard, seeds, params, workers=workers,
                features=features)
        peak = peak_bytes(tracker)
    rec = {
        "workload": "gnn-distributed-train",
        "scheme": scheme, "workers": workers,
        "partitioner": spec.plan.partitioner,
        "executor": spec.executor, "prefetch_depth": 0,
        "rounds_traced": counter.rounds,
        "sampling_rounds_traced": counter.sampling_rounds,
        "feature_rounds_traced": counter.feature_rounds,
        "expected_rounds": spec.expected_rounds,
        "bytes_per_round": list(counter.bytes_per_round),
    }
    rec.update(collective_record(spans, workers))
    rec.update({"peak_estimate_bytes": peak, "status": "ok",
                "tensors": "fake (cpu, plain versions)"})
    return rec


def step_inputs(params, shard, seeds, plan) -> list:
    """Every tensor the step reads (for ``MemTracker.track_external``)."""
    out = [v for layer in params for v in layer.values()]
    out += [t for t in (shard.features, shard.labels, shard.local_indptr,
                        shard.local_indices, seeds, plan.offsets)
            if t is not None]
    graph = plan.replicated_graph
    if graph is not None:
        out += [graph.indptr, graph.indices]
    return out


def peak_bytes(tracker) -> int:
    """The peak of all tracked tensors, summed over devices."""
    peak = tracker.get_tracker_snapshot("peak")
    return int(sum(per_dev["Total"] for per_dev in peak.values()))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description="Trace rank 0 of a 256/512-worker GraphSAGE training "
                    "job on fake tensors (no card needed)")
    ap.add_argument("--workers", type=int, default=256, choices=[256, 512])
    ap.add_argument("--scheme", default="both",
                    choices=["vanilla", "hybrid", "both"])
    ap.add_argument("--partitioner", default="ldg",
                    help="partitioner registry name recorded with the "
                         "dry-run (checked against "
                         "repro_torch.core.partition; the fake-tensor "
                         "trace itself does not depend on the partition)")
    ap.add_argument("--nodes-per-worker", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=1000)   # paper's batch
    ap.add_argument("--features", type=int, default=128) # papers100M width
    ap.add_argument("--out", default="experiments/dryrun_gnn_torch")
    args = ap.parse_args(argv)

    schemes = ["vanilla", "hybrid"] if args.scheme == "both" \
        else [args.scheme]
    records = []
    for scheme in schemes:
        rec = dryrun(scheme, workers=args.workers,
                     partitioner=args.partitioner,
                     nodes_per_worker=args.nodes_per_worker,
                     batch=args.batch, features=args.features)
        print(json.dumps(rec))
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"gnn__{scheme}__w{args.workers}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
