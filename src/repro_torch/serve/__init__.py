"""Online sampled-subgraph GNN inference serving (counterpart of
``repro.serve``, without the recycling cache so far):

  * ``Predictor``    — request-shaped API over the pipeline's inference
                       step (owner routing, bucketed batch shapes,
                       original-id mapping);
  * ``MicroBatcher`` — deadline-/size-triggered request accumulator;
  * ``GNNServer``    — the serving loop + latency/QPS accounting;
  * ``repro_torch.serve.traffic`` — open-loop synthetic arrivals.
"""
from repro_torch.serve.batcher import (BucketSpec, MicroBatcher, Request,
                                       max_owner_count, route_by_owner)
from repro_torch.serve.predictor import Predictor
from repro_torch.serve.server import GNNServer, ServeStats
from repro_torch.serve.traffic import hotset_arrivals, uniform_arrivals

__all__ = [
    "BucketSpec", "MicroBatcher", "Request", "max_owner_count",
    "route_by_owner", "Predictor", "GNNServer", "ServeStats",
    "hotset_arrivals", "uniform_arrivals",
]
