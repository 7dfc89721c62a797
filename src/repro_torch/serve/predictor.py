"""``Predictor``: a ``Pipeline`` turned into an online scorer
(counterpart of ``repro.serve.predictor``).

Wraps the pipeline's inference step (the same sampling + feature-fetch
program training runs, minus loss/grad) behind a request-shaped API:

    pred = Predictor(pipeline, params, cfg)
    logits = pred.predict([seed ids])       # (N, num_classes) numpy

  * **id space** — requests use original node ids; the partition relabels
    nodes contiguously per owner, so seeds map through the inverse
    permutation on the way in.
  * **routing** — each worker's seed row may hold only seeds it owns, so
    the flat request batch is routed into the stacked (P, bucket) layout
    and the logits scattered back.
  * **bucketing** — batches are padded to a ``BucketSpec`` size.  Padding
    is row-local (-1 seeds), sampling is a stateless per-seed hash, and
    the model's products run in fixed row blocks, so a seed's logits are
    bit-identical across bucket sizes and co-batched seeds.

Under a fleet executor every rank calls ``predict`` with the same seeds:
each runs its own workers' rows and gets every worker's logits back.

``predict`` samples with the FIXED ``base_salt`` unless given ``salt=``,
so the same seed resamples the same subgraph (deterministic serving).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNNConfig, gnn_forward
from repro_torch.serve.batcher import (BucketSpec, max_owner_count,
                                       route_by_owner)


class Predictor:
    """Online sampled-subgraph inference over a pipeline.

    Parameters
    ----------
    pipeline : repro_torch.pipeline.Pipeline
    params
        Model parameters on the pipeline's device.
    cfg : GNNConfig
        The model: ``gnn_forward(params, mfgs, h, cfg)``.
    buckets : sequence of int
        Per-worker batch capacities (see ``BucketSpec``).
    base_salt : int
        The sampling salt of every ``predict``.
    device
        Where to run; ``None`` means CUDA, and it must be the pipeline's
        device.
    """

    def __init__(self, pipeline, params, cfg: GNNConfig, *,
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 base_salt: int = 0, device=None):
        self.device = resolve_device(device)

        def forward_fn(p, mfgs, h_src):
            return gnn_forward(p, mfgs, h_src, cfg)

        self.pipeline = pipeline
        self.params = params
        self.buckets = BucketSpec(buckets)
        self.base_salt = int(base_salt)
        self.offsets = pipeline.layout.offsets.cpu().numpy()
        self.num_classes: int | None = None
        self.last_metrics: dict | None = None
        perm = np.asarray(pipeline.layout.perm)
        self._old_to_new = np.empty_like(perm)
        self._old_to_new[perm] = np.arange(perm.shape[0])
        self._infer = pipeline.infer_step_fn(forward_fn, device=self.device)

    def _to_internal(self, seeds: np.ndarray) -> np.ndarray:
        if seeds.size and (seeds.min() < 0
                           or seeds.max() >= self.offsets[-1]):
            raise ValueError("seed ids out of range for this graph")
        return self._old_to_new[seeds].astype(np.int32)

    def _run(self, routed: np.ndarray, salt: int | None = None):
        salt = self.base_salt if salt is None else int(salt)
        with torch.inference_mode():
            # a fleet rank runs its own workers' rows and gets every
            # worker's logits back
            seeds = torch.from_numpy(
                np.ascontiguousarray(self.pipeline.local_rows(routed))).to(
                    self.device)
            logits, metrics = self._infer(self.params, seeds, salt)
            return (logits.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in metrics.items()})

    def warmup(self, *, buckets: Sequence[int] | None = None):
        """Run the step once per bucket up front (kernel builds and
        library handles land here, not in serving latencies)."""
        for b in (buckets or self.buckets.sizes):
            seeds = np.full((self.offsets.shape[0] - 1, b), -1, np.int32)
            seeds[:, 0] = self.offsets[:-1]        # one owned seed per row
            self._run(seeds)

    def predict(self, seeds, *, salt: int | None = None) -> np.ndarray:
        """Logits for a flat batch of seed node ids: (N, num_classes)
        float32 in request order, sampled with ``salt`` (default
        ``base_salt``).  Batches whose max per-owner count exceeds the
        largest bucket are served in several chunks.
        ``self.last_metrics`` holds the final chunk's step metrics."""
        seeds = np.asarray(seeds, dtype=np.int64).ravel()
        if seeds.size == 0:
            return np.zeros((0, self.num_classes or 0), np.float32)
        internal = self._to_internal(seeds)

        out: np.ndarray | None = None
        start = 0
        while start < internal.size:
            # grow the chunk until an owner would overflow the largest
            # bucket
            end = start + 1
            while end < internal.size and max_owner_count(
                    self.offsets, internal[start:end + 1]) \
                    <= self.buckets.max_size:
                end += 1
            chunk = internal[start:end]
            bucket = self.buckets.bucket_for(
                max_owner_count(self.offsets, chunk))
            routed, pos = route_by_owner(self.offsets, chunk, bucket)
            logits, metrics = self._run(routed, salt)
            if out is None:
                self.num_classes = logits.shape[-1]
                out = np.empty((seeds.size, self.num_classes),
                               logits.dtype)
            out[start:end] = logits[pos[:, 0], pos[:, 1]]
            self.last_metrics = metrics
            start = end
        return out
