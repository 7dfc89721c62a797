"""The *prepare* half of the step program and the batch it produces.

Counterpart of the prepare half of
``repro.pipeline.prefetch.make_prepare_fetch_consume``: multi-level
sampling through the placement plan, the seed-label gather and the feature
fetch, for all P workers at once (stacked on axis 0).  No model parameter
is read.  Double-buffered prefetch and the training consume half are not
ported yet; the inference step (``repro_torch.pipeline.infer``) consumes
the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core import dist
from repro_torch.core.sampler import resolve_backend


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Everything the consume half needs; every tensor has the P axis.

    mfgs:        the L sampled MFGs, top level first.
    h_src:       (P, src_capacity, D) gathered input features.
    seed_labels: (P, batch) labels of the seed nodes.
    seed_valid:  (P, batch) bool mask of non-padding seeds.
    comm:        per-worker utilized bytes and sampler window overflow,
                 each (P,): ``sampling_utilized_bytes``,
                 ``feature_utilized_bytes``, ``sampler_window_overflow``
                 (frontier nodes, summed over levels, whose degree
                 exceeded the fused kernel's window).
    """
    mfgs: tuple
    h_src: torch.Tensor
    seed_labels: torch.Tensor
    seed_valid: torch.Tensor
    comm: dict


def make_prepare(*, offsets: torch.Tensor, num_parts: int,
                 fanouts: Sequence[int], plan,
                 backend: str | None = None,
                 level_fn: Callable | None = None,
                 counter: dist.RoundCounter | None = None):
    """Build ``prepare(shard, seeds, salt) -> PreparedBatch``.

    ``seeds`` is (P, batch), row p holding seeds worker p owns (-1
    padding); ``salt`` is the uint32 sampling salt.  Sampling dispatches
    through ``plan`` (a ``PlacementPlan``); the level backend resolves by
    registry name unless ``level_fn`` is given.  Backends that count
    window overflow (``supports_overflow_sink``) surface it in ``comm``.
    """
    if backend is not None and level_fn is not None:
        raise ValueError("pass either backend or level_fn, not both")
    if level_fn is None:
        level_fn = resolve_backend(backend or "reference")
    sink_backend = getattr(level_fn, "supports_overflow_sink", False)

    def prepare(shard: dist.WorkerShard, seeds: torch.Tensor, salt):
        sink: list = []
        lf = level_fn
        if sink_backend:
            def lf(graph, frontier, fanout, level_salt):
                return level_fn(graph, frontier, fanout, level_salt,
                                overflow_sink=sink)
        mfgs, samp_bytes = plan.sample(shard, seeds, fanouts, salt,
                                       level_fn=lf, counter=counter)
        P = seeds.shape[0]
        overflow = (torch.stack(sink).sum(dim=0) if sink else
                    torch.zeros(P, dtype=torch.int64, device=seeds.device))
        local_seed = (seeds - offsets[:-1].view(-1, 1)).clamp(
            0, shard.labels.shape[1] - 1)
        seed_labels = torch.gather(shard.labels, 1, local_seed.long())
        src = mfgs[-1].src_nodes
        h_src = dist.fetch_features(src, offsets, num_parts,
                                    shard.features, counter)
        row_bytes = 4.0 + shard.features.shape[2] \
            * shard.features.element_size()
        feat_bytes = (src >= 0).sum(dim=-1).to(torch.float32) * row_bytes
        comm = {"sampling_utilized_bytes": samp_bytes.expand(P),
                "feature_utilized_bytes": feat_bytes,
                "sampler_window_overflow": overflow}
        return PreparedBatch(mfgs=tuple(mfgs), h_src=h_src,
                             seed_labels=seed_labels,
                             seed_valid=seeds >= 0, comm=comm)

    return prepare
