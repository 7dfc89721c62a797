"""Training loops (counterpart of ``repro.train.loop``): the distributed
GNN trainer (the paper's workload) and a generic LM train step."""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
from repro_torch.optim import apply_updates, init_opt_state
from repro_torch.optim.optimizers import (clip_by_global_norm, tree_leaves,
                                          tree_map)
from repro_torch.pipeline import Pipeline, PipelineSpec


@dataclasses.dataclass
class GNNTrainer:
    """Distributed sampling-based GNN training (the paper's §4 setup) over
    the stacked worker axis on one device.

    scheme: ``"vanilla"`` | ``"hybrid"`` | ``"hybrid+fused"`` |
    ``"hybrid_partial(f)"`` or any registered placement scheme
    (``PipelineSpec.from_scheme``); every scheme draws the same minibatches
    (``hybrid+fused`` too while no frontier node's in-degree exceeds its
    kernel's window).  ``cache_capacity`` / ``cache_policy`` attach the §5
    feature cache and ``feature_store`` selects how frontier rows are
    served (``"exchange"``, ``"pinned_hot"`` or ``"staged"``);
    ``prefetch_depth`` double-buffers the prepare half against the consume
    half and ``staging`` draws the seeds on a host thread
    (``repro_torch.pipeline.staging``); each of these choices gives the
    same losses bit for bit.  Parameters are drawn from a CPU
    ``torch.Generator`` seeded with ``seed``; set ``params`` and
    ``opt_state`` to start elsewhere.  ``close()`` stops the staging
    thread.
    """
    layout: "PartitionLayout"                        # noqa: F821
    cfg: GNNConfig
    scheme: str = "hybrid+fused"
    lr: float = 0.006            # paper's §4 learning rate
    batch_per_worker: int = 1000  # paper's §4 batch size
    cache_capacity: int = 0
    cache_policy: str = "degree"
    feature_store: str = "exchange"
    prefetch_depth: int = 0
    staging: bool = False
    seed: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        spec = PipelineSpec.from_scheme(
            self.scheme, num_parts=self.layout.num_parts,
            fanouts=self.cfg.fanouts, cache_capacity=self.cache_capacity,
            cache_policy=self.cache_policy,
            feature_store=self.feature_store,
            prefetch_depth=self.prefetch_depth, staging=self.staging)
        self.pipeline = Pipeline.from_layout(self.layout, spec,
                                             device=self.device)
        self.counter = self.pipeline.counter

        def loss_fn(p, mfgs, h_src, labels, valid):
            return gnn_loss(p, mfgs, h_src, labels, valid, self.cfg)

        self.driver = self.pipeline.train_driver(
            loss_fn, batch=self.batch_per_worker, lr=self.lr,
            optimizer="adamw", grad_clip=1.0, device=self.device)
        self.params = init_gnn_params(
            self.cfg, torch.Generator().manual_seed(self.seed), self.device)
        self.opt_state = init_opt_state(self.params, kind="adamw")

    def run_epoch(self, epoch: int, steps_per_epoch: int = 10) -> dict:
        """Run steps ``epoch*steps_per_epoch .. +steps_per_epoch`` of the
        deterministic seed stream (re-running an epoch replays its exact
        minibatches); returns summary metrics: ``loss`` and
        ``cache_hit_rate`` averaged over the epoch's steps,
        ``final_loss``, ``epoch_time`` (s) and ``comm_rounds_per_step``
        (the round counter's growth over the epoch per step).  Each
        step's metrics go to the default registry
        (``repro_torch.obs.metrics``), which warns once when the sampler's
        window overflows."""
        from repro_torch.obs.metrics import get_registry

        registry = get_registry()
        t0 = time.perf_counter()
        rounds_before = self.counter.rounds
        losses, hit_rates = [], []
        for s in range(steps_per_epoch):
            k = epoch * steps_per_epoch + s
            self.params, self.opt_state, loss, metrics = self.driver.step(
                self.params, self.opt_state, step_idx=k)
            losses.append(float(loss))
            hit_rates.append(float(metrics["cache_hit_rate"]))
            # the float() above already waited for this step, so
            # absorbing its metrics adds no sync
            registry.observe_step(metrics, step=k)
        return {"loss": sum(losses) / len(losses),
                "final_loss": losses[-1],
                "epoch_time": time.perf_counter() - t0,
                "comm_rounds_per_step":
                    (self.counter.rounds - rounds_before) / steps_per_epoch,
                "cache_hit_rate": sum(hit_rates) / len(hit_rates)}

    def predictor(self, *, buckets=(1, 8, 32, 128), base_salt: int = 0):
        """The trained params as an online ``repro_torch.serve.Predictor``
        over this trainer's pipeline (same placement, sampler backend and
        feature cache).  It snapshots ``self.params`` at call time."""
        from repro_torch.serve import Predictor
        return Predictor(self.pipeline, self.params, self.cfg,
                         buckets=buckets, base_salt=base_salt,
                         device=self.device)

    def close(self) -> None:
        """Release the driver's staging thread (a no-op without one)."""
        self.driver.close()

    def __enter__(self) -> "GNNTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_lm_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                       remat: bool = True, optimizer: str = "adamw"):
    """Generic LM train step: ``lm_loss``, its gradient by autograd, the
    gradient clipped to global norm 1.0, then ``apply_updates``.  Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``repro``'s metrics (``ce``, ``aux``, ``loss``,
    ``grad_norm``); the inputs are left as they are."""

    def train_step(params, opt_state, batch):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        loss, metrics = lm.lm_loss(p, batch, cfg, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = apply_updates(params, grads, opt_state,
                                          kind=optimizer, lr=lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step
