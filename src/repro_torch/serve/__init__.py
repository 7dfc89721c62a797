"""Online sampled-subgraph GNN inference serving (counterpart of
``repro.serve``):

  * ``Predictor``    — request-shaped API over the pipeline's inference
                       step (owner routing, bucketed batch shapes,
                       original-id mapping);
  * ``MicroBatcher`` — deadline-/size-triggered request accumulator;
  * ``RecyclingCache`` — LazyGNN-style reuse of recent results for hot
                       seeds under a tau / rho staleness contract;
  * ``GNNServer``    — the serving loop + latency/QPS accounting;
  * ``repro_torch.serve.traffic`` — open-loop synthetic arrivals.
"""
from repro_torch.serve.batcher import (BucketSpec, MicroBatcher, Request,
                                       max_owner_count, route_by_owner)
from repro_torch.serve.predictor import Predictor
from repro_torch.serve.recycler import RecyclingCache, hot_set_admit
from repro_torch.serve.server import GNNServer, ServeStats
from repro_torch.serve.traffic import (available_arrivals, hotset_arrivals,
                                       register_arrival, resolve_arrival,
                                       uniform_arrivals)

__all__ = [
    "BucketSpec", "MicroBatcher", "Request", "max_owner_count",
    "route_by_owner", "Predictor", "RecyclingCache", "hot_set_admit",
    "GNNServer", "ServeStats", "available_arrivals", "hotset_arrivals",
    "register_arrival", "resolve_arrival", "uniform_arrivals",
]
