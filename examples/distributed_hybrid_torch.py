"""The paper's experiment in miniature (PyTorch port): distributed GNN
training with the three Fig. 6 scenarios (vanilla / hybrid /
hybrid+fused), plus the §5 feature cache, on 8 workers, all through the
``repro_torch.pipeline`` API.

Verifies the 2L -> 2 communication-round reduction and the identical loss
trajectories, and reports per-scheme step times and communicated bytes.
All four pipelines share one partitioning via ``Pipeline.from_layout``.
The 8 workers are stacked on one device (the default executor); on the
GPU (the default) every step runs the port's CUDA kernels, and
``--device cpu`` runs their plain versions.

  PYTHONPATH=src python examples/distributed_hybrid_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.partition import build_layout, partition_graph
from repro_torch.data.synthetic_graph import make_power_law_graph
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
from repro_torch.obs.trace import synchronize
from repro_torch.optim import init_opt_state
from repro_torch.pipeline import Pipeline, PipelineSpec

P = 8
STEPS = 6


def main(argv=None, *, num_nodes: int = 30_000, batch: int = 128) -> dict:
    """Run the four pipelines and return their loss trajectories by name;
    the keyword arguments size the run (the command line keeps the
    defaults)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_power_law_graph(num_nodes, 10, num_features=100,
                              num_classes=47, seed=0)
    assign = partition_graph(ds.graph, P, ds.labeled_mask, seed=0)
    layout = build_layout(ds.graph, ds.features, ds.labels, assign, P,
                          device=dev)

    cfg = GNNConfig(in_dim=100, hidden_dim=128, num_classes=47,
                    num_layers=3, fanouts=(8, 5, 5), dropout=0.0)

    def loss_fn(p, mfgs, h_src, labels, valid):
        return gnn_loss(p, mfgs, h_src, labels, valid, cfg)

    variants = {
        "vanilla": PipelineSpec.from_scheme(
            "vanilla", num_parts=P, fanouts=cfg.fanouts),
        "hybrid": PipelineSpec.from_scheme(
            "hybrid", num_parts=P, fanouts=cfg.fanouts),
        "hybrid+fused": PipelineSpec.from_scheme(
            "hybrid+fused", num_parts=P, fanouts=cfg.fanouts),
        "hybrid+cache": PipelineSpec.from_scheme(
            "hybrid", num_parts=P, fanouts=cfg.fanouts,
            cache_capacity=2048),
    }
    expected_rounds = {"vanilla": 2 * cfg.num_layers, "hybrid": 2,
                       "hybrid+fused": 2, "hybrid+cache": 2}

    results = {}
    for name, spec in variants.items():
        pipe = Pipeline.from_layout(layout, spec, device=dev)
        if name == "vanilla":
            print(f"{P} workers, edge-cut {pipe.edge_cut_fraction:.1%}")
        train = pipe.train_step(loss_fn, lr=0.006,      # paper's lr
                                optimizer="adamw", grad_clip=None,
                                device=dev)

        params = init_gnn_params(cfg, torch.Generator().manual_seed(0), dev)
        opt_state = init_opt_state(params)

        # one warm-up step (the kernels load on the first call), discarded
        synchronize(train(params, opt_state, pipe.seeds(batch, 0), 0))
        rounds_before = pipe.counter.rounds
        bytes_before = len(pipe.counter.bytes_per_round)

        losses = []
        t0 = time.time()
        for s in range(STEPS):
            params, opt_state, loss, metrics = train(
                params, opt_state, pipe.seeds(batch, s), s)
            losses.append(float(loss))
        dt = (time.time() - t0) / STEPS
        results[name] = losses
        rounds = (pipe.counter.rounds - rounds_before) // STEPS
        bytes_step = sum(pipe.counter.bytes_per_round[bytes_before:]) \
            // STEPS
        assert rounds == expected_rounds[name], (name, rounds)
        hit = float(metrics["cache_hit_rate"])
        print(f"{name:13s} rounds/step={rounds:2d} "
              f"bytes/step={bytes_step:>12,} step={dt * 1e3:7.1f}ms "
              f"cache-hit={hit:5.1%} "
              f"losses={[round(x, 6) for x in losses[:3]]}...")

    assert len(set(map(tuple, results.values()))) == 1, \
        "schemes must be mathematically equivalent"
    print("\nall four pipelines produced IDENTICAL loss trajectories "
          "(paper §4.2) ✓")
    return results


if __name__ == "__main__":
    main()
