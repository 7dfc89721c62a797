"""The step's sampling, feature and compute stages, each timed alone.

Frozen copy of the timing arithmetic of
``src/repro_torch/obs/profile.py:profile_stages``: the step runs as three
separate calls at the seams of the program's public prepare / fetch /
consume halves (``Pipeline.make_prepare_fetch_consume``), each fenced by a
``torch.cuda.synchronize`` and timed by the host clock; the result is each
stage's median over the measured steps.  The stages run one after
another, so their sum is what an unoverlapped step without the optimizer
update costs; it does not describe an overlapped step.
"""
from __future__ import annotations

import time

STAGES = ("sampling", "feature", "compute")


def stage_seconds(pipeline, loss_fn, params, *, batch: int, salts, sync,
                  warmup: int = 1) -> dict:
    """{stage: median seconds} over the steps of ``salts`` after the first
    ``warmup`` of them, which are untimed; ``sync`` waits for the
    device."""
    import torch

    prepare, fetch, consume = pipeline.make_prepare_fetch_consume(
        loss_fn, counted=False, device=pipeline.device)
    shards, cache = pipeline.shards, pipeline.cache

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    times = {s: [] for s in STAGES}
    for i, salt in enumerate(salts):
        seeds = pipeline.seeds(batch, salt)
        with torch.no_grad():
            batch_k, t_s = timed(lambda: prepare(shards, seeds, salt, cache))
            fetched, t_f = timed(lambda: fetch(shards, batch_k, cache))
        _, t_c = timed(lambda: consume(params, fetched, shards, cache))
        if i >= warmup:
            times["sampling"].append(t_s)
            times["feature"].append(t_f)
            times["compute"].append(t_c)
    n = len(times["sampling"])
    if n == 0:
        raise ValueError("no measured step: pass more salts than warmup")
    return {s: sorted(v)[n // 2] for s, v in times.items()}
