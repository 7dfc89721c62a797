"""The training step program over the stacked worker axis.

Counterpart of ``repro.pipeline.worker``: the step is the composition of
the *prepare* and *consume* halves
(``repro_torch.pipeline.prefetch.make_prepare_consume``), so

    step(params, shard, seeds, salt[, cache]) -> (loss, grads, metrics)

with ``loss`` and ``grads`` the means over the worker axis.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import dist
from repro_torch.pipeline.prefetch import make_prepare_consume


def make_worker_step(*, offsets: torch.Tensor, num_parts: int,
                     fanouts: Sequence[int], loss_fn: Callable, plan=None,
                     backend: str | None = None,
                     level_fn: Callable | None = None,
                     counter: dist.RoundCounter | None = None,
                     use_cache: bool = False, store=None,
                     group: dist.RankGroup | None = None,
                     scheme: str = "hybrid", graph_replicated=None,
                     vanilla_fused: bool | None = None):
    """Build the step for the placement plan ``plan`` (any registered
    scheme).

    ``loss_fn(params, mfgs, h_src, seed_labels, seed_valid)`` returns the
    per-worker losses; ``backend`` / ``level_fn`` select the level backend
    (mutually exclusive); ``store`` serves the frontier's rows (``None``
    = the exchange store).  With ``use_cache`` the step takes a trailing
    ``FeatureCache`` argument.  ``group`` builds a fleet rank's step
    (``repro_torch.pipeline.prefetch``).  ``scheme``, ``graph_replicated``
    and ``vanilla_fused`` are ``repro``'s legacy keywords: ``plan`` takes
    precedence, and without one they resolve through
    ``placement.plan_from_legacy``.
    """
    prepare, consume = make_prepare_consume(
        offsets=offsets, num_parts=num_parts, fanouts=fanouts,
        loss_fn=loss_fn, plan=plan, backend=backend, level_fn=level_fn,
        counter=counter, store=store, group=group, scheme=scheme,
        graph_replicated=graph_replicated, vanilla_fused=vanilla_fused)

    if use_cache:
        def step(params, shard, seeds, salt, cache):
            return consume(params, prepare(shard, seeds, salt, cache))
    else:
        def step(params, shard, seeds, salt):
            return consume(params, prepare(shard, seeds, salt))
    return step
