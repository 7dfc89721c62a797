"""The step program split at the prefetch boundary, the update, the seed
stream and the synchronous driver.

Counterpart of ``repro.pipeline.prefetch``.  The step is two halves over
the stacked worker axis (all P workers at once, on axis 0):

  prepare(shard, seeds, salt, cache) -> PreparedBatch
      multi-level sampling through the placement plan, the seed-label
      gather and the feature fetch through the feature store.  No model
      parameter is read.
  consume(params, batch) -> (loss, grads, metrics)
      the MFG forward and backward; loss and gradients are the mean over
      the worker axis, metrics are reduced over it in index order.

``SeedStream`` derives step k's seeds and salt from k alone, and
``SyncDriver`` runs one step after the other.  Double-buffered prefetch
(``repro``'s ``DoubleBufferDriver``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core import dist
from repro_torch.core.sampler import resolve_backend
from repro_torch.optim.optimizers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Everything the consume half needs; every tensor has the P axis.

    mfgs:        the L sampled MFGs, top level first.
    h_src:       (P, src_capacity, D) gathered input features.
    seed_labels: (P, batch) labels of the seed nodes.
    seed_valid:  (P, batch) bool mask of non-padding seeds.
    hits:        (P,) feature-cache hits (0 without a cache).
    comm:        per-worker utilized bytes and sampler window overflow:
                 ``sampling_utilized_bytes`` (P,),
                 ``feature_utilized_bytes`` (P,),
                 ``sampler_window_overflow`` (P,) (frontier nodes, summed
                 over levels, whose degree exceeded the fused kernel's
                 window) and ``sampler_window_overflow_per_level`` (P, L).
    """
    mfgs: tuple
    h_src: torch.Tensor
    seed_labels: torch.Tensor
    seed_valid: torch.Tensor
    hits: torch.Tensor
    comm: dict


def make_prepare(*, offsets: torch.Tensor, num_parts: int,
                 fanouts: Sequence[int], plan,
                 backend: str | None = None,
                 level_fn: Callable | None = None,
                 counter: dist.RoundCounter | None = None,
                 store=None):
    """Build ``prepare(shard, seeds, salt, cache=None) -> PreparedBatch``.

    ``seeds`` is (P, batch), row p holding seeds worker p owns (-1
    padding); ``salt`` is the uint32 sampling salt; ``cache`` the stacked
    ``FeatureCache`` or ``None``.  Sampling dispatches through ``plan`` (a
    ``PlacementPlan``); the level backend resolves by registry name unless
    ``level_fn`` is given.  ``store`` (a ``FeatureStore``, default
    ``"exchange"``) serves the frontier's rows.  Backends that count
    window overflow (``supports_overflow_sink``) surface it in ``comm``.
    """
    from repro_torch.core.feature_store import ExchangeStore

    if backend is not None and level_fn is not None:
        raise ValueError("pass either backend or level_fn, not both")
    if level_fn is None:
        level_fn = resolve_backend(backend or "reference")
    if store is None:
        store = ExchangeStore()
    sink_backend = getattr(level_fn, "supports_overflow_sink", False)
    L = len(fanouts)

    def prepare(shard: dist.WorkerShard, seeds: torch.Tensor, salt,
                cache=None):
        sink: list = []
        lf = level_fn
        if sink_backend:
            def lf(graph, frontier, fanout, level_salt):
                return level_fn(graph, frontier, fanout, level_salt,
                                overflow_sink=sink)
        mfgs, samp_bytes = plan.sample(shard, seeds, fanouts, salt,
                                       level_fn=lf, counter=counter)
        P = seeds.shape[0]
        per_level = torch.zeros((P, L), dtype=torch.int64,
                                device=seeds.device)
        for i, o in enumerate(sink):
            per_level[:, min(i, L - 1)] += o.to(torch.int64)
        local_seed = (seeds - offsets[:-1].view(-1, 1)).clamp(
            0, shard.labels.shape[1] - 1)
        seed_labels = torch.gather(shard.labels, 1, local_seed.long())
        src = mfgs[-1].src_nodes
        h_src, hits = store.fetch(src, shard, cache, offsets=offsets,
                                  num_parts=num_parts, counter=counter)
        row_bytes = 4.0 + shard.features.shape[2] \
            * shard.features.element_size()
        comm = {"sampling_utilized_bytes": samp_bytes.expand(P),
                "feature_utilized_bytes": store.utilized_bytes(
                    src, hits, row_bytes),
                "sampler_window_overflow": per_level.sum(dim=-1),
                "sampler_window_overflow_per_level": per_level}
        return PreparedBatch(mfgs=tuple(mfgs), h_src=h_src,
                             seed_labels=seed_labels,
                             seed_valid=seeds >= 0, hits=hits, comm=comm)

    return prepare


def make_prepare_consume(*, offsets: torch.Tensor, num_parts: int,
                         fanouts: Sequence[int], loss_fn: Callable, plan,
                         backend: str | None = None,
                         level_fn: Callable | None = None,
                         counter: dist.RoundCounter | None = None,
                         store=None):
    """Build the *prepare* / *consume* halves of the training step.

    ``loss_fn(params, mfgs, h_src, seed_labels, seed_valid)`` returns the
    per-worker losses (P,); the other arguments are as in
    ``make_prepare``.  ``consume(params, batch) -> (loss, grads,
    metrics)``: ``loss`` is the mean of the per-worker losses and
    ``grads`` (a tree like ``params``) its gradient, which is the mean of
    the per-worker gradients taken in worker order; ``metrics`` has
    ``repro``'s keys.
    """
    prepare = make_prepare(offsets=offsets, num_parts=num_parts,
                           fanouts=fanouts, plan=plan, backend=backend,
                           level_fn=level_fn, counter=counter, store=store)

    def consume(params, batch: PreparedBatch):
        mfgs = list(batch.mfgs)
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            per_worker = loss_fn(leaves, mfgs, batch.h_src,
                                 batch.seed_labels, batch.seed_valid)
            loss = dist.pmean_ordered(per_worker)
            flat = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        comm = batch.comm
        n_valid = (mfgs[-1].src_nodes >= 0).sum(dim=-1).clamp(min=1)
        metrics = {
            "cache_hit_rate": dist.pmean_ordered(
                (batch.hits / n_valid).to(torch.float32)),
            "sampling_utilized_bytes": dist.psum_ordered(
                comm["sampling_utilized_bytes"]),
            "feature_utilized_bytes": dist.psum_ordered(
                comm["feature_utilized_bytes"]),
            "sampler_window_overflow": dist.psum_ordered(
                comm["sampler_window_overflow"]).to(torch.float32),
            "sampler_window_overflow_per_level": dist.psum_ordered(
                comm["sampler_window_overflow_per_level"]).to(
                    torch.float32),
        }
        return loss.detach(), grads, metrics

    return prepare, consume


def make_update_fn(*, lr: float = 1e-3, optimizer: str = "adamw",
                   grad_clip: float | None = 1.0):
    """Gradient clip + optimizer apply: ``update(params, opt_state, grads,
    metrics) -> (params, opt_state, metrics)``, with ``grad_norm`` added to
    ``metrics`` when ``grad_clip`` is set."""
    from repro_torch.optim import apply_updates, clip_by_global_norm

    def update(params, opt_state, grads, metrics):
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
        params, opt_state = apply_updates(params, grads, opt_state,
                                          kind=optimizer, lr=lr)
        return params, opt_state, metrics

    return update


# --------------------------------------------------------------------------
# deterministic seed stream and the synchronous driver
# --------------------------------------------------------------------------

class SeedStream:
    """Step k's minibatch seeds and sampling salt from k alone (``repro``'s
    ``"counter"`` stream: salt_k = base_salt + k), so a restart at any k
    replays the same minibatches."""

    def __init__(self, pipeline, batch: int, base_salt: int = 0):
        self._pipeline = pipeline
        self.batch = int(batch)
        self.base_salt = int(base_salt)

    def salt(self, k: int) -> int:
        """The uint32 sampling salt of step ``k``."""
        return (self.base_salt + int(k)) % (2 ** 32)

    def seeds(self, k: int) -> torch.Tensor:
        """(P, batch) seed ids of step ``k`` on the pipeline's device."""
        return self._pipeline.seeds(self.batch, epoch_salt=self.salt(k))


class SyncDriver:
    """Depth-0 driver: one synchronous step program per step, with seeds
    and salt from the ``SeedStream`` — the same as driving
    ``Pipeline.train_step`` by hand."""

    def __init__(self, pipeline, loss_fn, *, batch: int, lr: float = 1e-3,
                 optimizer: str = "adamw", grad_clip: float | None = 1.0,
                 base_salt: int = 0, device=None):
        self._fn = pipeline.train_step(loss_fn, lr=lr, optimizer=optimizer,
                                       grad_clip=grad_clip, device=device)
        self.stream = SeedStream(pipeline, batch, base_salt=base_salt)
        self._next = 0

    def step(self, params, opt_state, step_idx: int | None = None):
        """Run step ``step_idx`` (defaults to the next sequential index).
        Returns ``(params, opt_state, loss, metrics)``."""
        k = self._next if step_idx is None else int(step_idx)
        out = self._fn(params, opt_state, self.stream.seeds(k),
                       self.stream.salt(k))
        self._next = k + 1
        return out

    def reset(self) -> None:
        """Restart the sequential step counter at 0."""
        self._next = 0
