"""Fenced per-stage step profiling: sampling / feature / compute
(counterpart of ``repro.obs.profile``).

The drivers overlap the step's halves (the prepare of step k + depth runs
while step k's consume is queued), so a span around any one call cannot
say where the time went.  This module answers the paper's Figure-1
question ("what share of a step is sampling?") by running the step as
**three separate calls** at the seams the prefetch boundary already
exposes, each over the stacked worker axis:

  sampling : ``prepare`` built with ``features=False``: the multi-level
             sampling (its pack/exchange rounds included) and the
             seed-label gather, nothing else.
  feature  : the standalone ``fetch`` stage: the frontier's feature rows
             through the pipeline's feature store (exchange / cache).
  compute  : ``consume`` on the fetched batch: the MFG forward and
             backward and the worker-axis gradient mean.

Each call is fenced (its CUDA streams synchronized) inside a cat-tagged
span.  The decomposition is of the *unoverlapped* step: the stage sum is
what a depth-0 step without staging costs.

Spans land in the installed tracer (``repro_torch.obs.trace``) with cats
``sampling`` / ``feature`` / ``compute`` and an ``arm`` tag, which is what
``repro_torch.obs.report`` aggregates into the share table.
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs import trace as _trace

#: stage names, in step order; also the Chrome trace cats the report
#: CLI aggregates
STAGES = ("sampling", "feature", "compute")


def profile_stages(pipeline, loss_fn, params, *, batch: int,
                   steps: int = 4, warmup: int = 1, base_salt: int = 0,
                   arm: str | None = None) -> dict:
    """Measure the sampling / feature / compute split of one step.

    pipeline: a built ``repro_torch.pipeline.Pipeline``.  Its feature
        store must fetch inside the step (``exchange`` / ``pinned_hot``);
        the ``staged`` store serves rows from a host ring and has no
        in-step feature stage to time.
    loss_fn, params: the training objective and model parameters
        (``consume`` runs the real forward and backward).
    batch: per-worker minibatch size (drives the deterministic seed
        stream, so two profiles of the same spec sample identically).
    steps, warmup: measured steps (median taken) and untimed warmup steps
        (kernel builds, library handles).
    arm: label stamped on the emitted spans' ``args`` (e.g. the placement
        scheme); the report CLI groups rows by it.

    Returns ``{"arm", "steps", "sampling_s", "feature_s", "compute_s",
    "step_s", "share": {stage: fraction}}``: per-stage median seconds and
    their share of the summed (unoverlapped) step.
    """
    from repro_torch.pipeline.prefetch import SeedStream

    store = pipeline.feature_store
    if getattr(store, "external_rows", False):
        raise ValueError(
            f"feature store {store.name!r} serves rows from a host-side "
            f"staging ring; there is no in-program feature stage to "
            f"profile.  Profile with the 'exchange' or 'pinned_hot' "
            f"store (the staged store's host cost shows up on the "
            f"stager thread's trace track instead)")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")

    prepare, fetch, consume = pipeline.make_prepare_fetch_consume(
        loss_fn, counted=False, device=pipeline.device)
    shards, cache = pipeline.shards, pipeline.cache

    def sample(seeds, salt):
        with torch.no_grad():
            return prepare(shards, seeds, salt, cache)

    def fetch_rows(batch_k):
        with torch.no_grad():
            return fetch(shards, batch_k, cache)

    def compute(batch_k):
        return consume(params, batch_k, shards, cache)

    stream = SeedStream(pipeline, batch,
                        strategy=pipeline.spec.prefetch.seed_stream,
                        base_salt=base_salt)
    tags = {"arm": arm} if arm is not None else {}

    def staged_call(name, fn, record):
        # fence INSIDE the span: device time lands on the stage that
        # caused it, whatever the tracer's fenced flag
        t0 = time.perf_counter()
        if record:
            with _trace.span(f"profile/{name}", cat=name, **tags):
                out = _trace.synchronize(fn())
        else:
            out = _trace.synchronize(fn())
        return out, time.perf_counter() - t0

    times: dict[str, list[float]] = {s: [] for s in STAGES}
    for k in range(warmup + steps):
        seeds = _trace.synchronize(stream.seeds(k))
        salt = stream.salt_int(k)
        record = k >= warmup          # warmup spans would skew the
        #                               report's shares with build time
        batch_k, dt_s = staged_call("sampling", lambda: sample(seeds, salt),
                                    record)
        fetched, dt_f = staged_call("feature", lambda: fetch_rows(batch_k),
                                    record)
        _, dt_c = staged_call("compute", lambda: compute(fetched), record)
        if record:
            times["sampling"].append(dt_s)
            times["feature"].append(dt_f)
            times["compute"].append(dt_c)

    med = {s: sorted(times[s])[steps // 2] for s in STAGES}
    total = sum(med.values())
    return {"arm": arm, "steps": steps,
            "sampling_s": med["sampling"], "feature_s": med["feature"],
            "compute_s": med["compute"], "step_s": total,
            "share": {s: (med[s] / total if total > 0 else 0.0)
                      for s in STAGES}}
