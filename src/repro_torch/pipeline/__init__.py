"""``repro_torch.pipeline``: the composable API for distributed
sampling-based GNN training, the counterpart of ``repro.pipeline``.

Five independent components, each swappable without touching the others:

  ``PlanSpec``      where data lives: a placement-scheme registry name
                    (``repro_torch.core.placement``: "vanilla", "hybrid",
                    "hybrid_partial(f)"), a partitioner registry name
                    (``repro_torch.core.partition``), an optional hot
                    remote-feature cache (``cache_capacity``, built by the
                    ``cache_policy`` registry entry) and the feature
                    store.
  ``SamplerSpec``   how a level is sampled: fanouts and a level-backend
                    registry name (``repro_torch.core.sampler``:
                    "reference", "unfused", "fused_cuda").
  executor          how the step program meets the data
                    (``repro_torch.pipeline.executor``): "stacked" (alias
                    "vmap"; all workers on one device), "multiprocess"
                    and "shard_map" (a rank per process).
  ``PrefetchSpec``  how far the prepare half runs ahead of the consume
                    half: depth 0 is the "sync" driver, depth >= 1
                    "double_buffer", the same bits either way.
  ``DataSpec``      what graph to train on: a graph-source registry name
                    (``repro_torch.data``) or a saved dataset's path.

``Pipeline`` ties them together: partition -> layout -> plan -> shards ->
caches in one ``build`` call.

Example: the paper's hybrid+fused scenario with a 4096-entry cache and
depth-1 prefetch::

    from repro_torch.pipeline import (Pipeline, PipelineSpec, PlanSpec,
                                      PrefetchSpec, SamplerSpec)

    spec = PipelineSpec(
        plan=PlanSpec(num_parts=8, scheme="hybrid", cache_capacity=4096),
        sampler=SamplerSpec(fanouts=(15, 10, 5), backend="fused_cuda"),
        executor="stacked", prefetch=PrefetchSpec(depth=1))
    pipe = Pipeline.build(graph, features, labels, spec)

    driver = pipe.train_driver(loss_fn, lr=6e-3, batch=1024)
    for k in range(steps):
        params, opt_state, loss, metrics = driver.step(params, opt_state)
    # pipe.counter.rounds  -> communication rounds of the steps run
    # metrics["cache_hit_rate"] -> fraction of features served locally

``repro``'s seed API is kept as deprecated names that delegate here:
``repro_torch.core.dist.make_worker_step`` / ``run_stacked`` /
``make_shard_map_step``, ``repro_torch.core.cache.build_degree_caches`` /
``make_cached_worker_step`` / ``run_stacked_cached``, and the legacy
``VanillaPlan`` / ``HybridPlan`` containers of
``repro_torch.core.partition``; new code uses
``repro_torch.core.placement.resolve_scheme(name).build(layout)``.
"""
from repro_torch.core.cache import (HotSetScorer, available_cache_policies,
                                    available_hot_scorers,
                                    register_cache_policy,
                                    register_hot_scorer,
                                    resolve_cache_policy,
                                    resolve_hot_scorer)
from repro_torch.core.feature_store import (FeatureStore,
                                            available_feature_stores,
                                            register_feature_store,
                                            resolve_feature_store)
from repro_torch.core.partition import (Partitioner, available_partitioners,
                                        register_partitioner,
                                        resolve_partitioner)
from repro_torch.core.placement import (PlacementPlan, PlacementScheme,
                                        available_schemes, register_scheme,
                                        resolve_scheme)
from repro_torch.data.sources import (available_sources, register_source,
                                      resolve_source)
from repro_torch.data.spec import DataSpec, resolve_dataset
from repro_torch.pipeline.executor import (FleetExecutor,
                                           MultiprocessExecutor,
                                           ShardMapExecutor, StackedExecutor,
                                           VmapExecutor, available_executors,
                                           register_executor,
                                           resolve_executor)
from repro_torch.pipeline.pipeline import Pipeline
from repro_torch.pipeline.prefetch import (DoubleBufferDriver, PreparedBatch,
                                           SeedStream, SyncDriver,
                                           available_prefetchers,
                                           register_prefetcher,
                                           resolve_prefetcher)
from repro_torch.pipeline.specs import (PipelineSpec, PlanSpec, PrefetchSpec,
                                        SamplerSpec)
from repro_torch.pipeline.staging import FeatureStager, SeedStager

__all__ = [
    "Pipeline", "PipelineSpec", "PlanSpec", "SamplerSpec", "PrefetchSpec",
    "DataSpec", "resolve_dataset",
    "register_source", "resolve_source", "available_sources",
    "VmapExecutor", "ShardMapExecutor", "StackedExecutor", "FleetExecutor",
    "MultiprocessExecutor",
    "register_executor", "resolve_executor", "available_executors",
    "PlacementScheme", "PlacementPlan",
    "register_scheme", "resolve_scheme", "available_schemes",
    "Partitioner", "register_partitioner", "resolve_partitioner",
    "available_partitioners",
    "register_cache_policy", "resolve_cache_policy",
    "available_cache_policies",
    "HotSetScorer", "register_hot_scorer", "resolve_hot_scorer",
    "available_hot_scorers",
    "FeatureStore", "register_feature_store", "resolve_feature_store",
    "available_feature_stores",
    "PreparedBatch", "SeedStream", "SeedStager", "FeatureStager",
    "SyncDriver", "DoubleBufferDriver",
    "register_prefetcher", "resolve_prefetcher", "available_prefetchers",
]
