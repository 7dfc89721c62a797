"""Quickstart (PyTorch port): single-machine sampling-based GNN training
with FastSample.

Builds a synthetic ogbn-products-shaped graph, samples mini-batches with
the fused sampler, gathers their input rows and trains a 2-layer
GraphSAGE for a few epochs, through ``repro_torch``.  On the GPU (the
default) the sampler, the row gather and the neighbour mean run as the
port's CUDA kernels; ``--device cpu`` runs their plain versions.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.sampler import sample_mfgs
from repro_torch.data.synthetic_graph import make_power_law_graph
from repro_torch.device import resolve_device
from repro_torch.kernels.gather import gather_rows
from repro_torch.models.gnn import (GNNConfig, gnn_accuracy, gnn_loss,
                                    init_gnn_params)
from repro_torch.optim import apply_updates, init_opt_state, tree_leaves


def main(argv=None, *, num_nodes: int = 20_000, epochs: int = 5,
         steps: int = 8, batch: int = 512) -> float:
    """Train and return the last epoch's sampled accuracy; the keyword
    arguments size the run (the command line keeps the defaults)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_power_law_graph(num_nodes, 10, num_features=100,
                              num_classes=47, seed=0)
    g = ds.graph.to(dev)
    topo = (g.indptr.numel() + g.indices.numel()) * 4
    feat_bytes = ds.features.nbytes
    print(f"graph: {g.num_nodes:,} nodes, {g.num_edges:,} edges; "
          f"storage {feat_bytes / (feat_bytes + topo):.0%} features")

    cfg = GNNConfig(in_dim=100, hidden_dim=128, num_classes=47,
                    num_layers=2, fanouts=(10, 5), dropout=0.0)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), dev)
    opt_state = init_opt_state(params)
    feats = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    labeled = np.nonzero(ds.labels >= 0)[0]

    def minibatch(seeds, salt):
        mfgs = sample_mfgs(g, seeds, cfg.fanouts, salt, backend="fused_cuda")
        h0 = gather_rows(feats, mfgs[-1].src_nodes)   # +0.0 for padding
        lab = labels[seeds.clamp(min=0).long()]
        return mfgs, h0, lab, seeds >= 0

    def train_step(params, opt_state, seeds, salt):
        mfgs, h0, lab, valid = minibatch(seeds, salt)
        leaves = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in params]
        with torch.enable_grad():
            loss = gnn_loss(leaves, mfgs, h0, lab, valid, cfg)
            flat = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(flat)
        grads = [{k: next(it) for k in layer} for layer in leaves]
        params, opt_state = apply_updates(params, grads, opt_state, lr=0.01)
        return params, opt_state, loss.detach()

    def eval_acc(params, seeds, salt):
        return gnn_accuracy(params, *minibatch(seeds, salt), cfg)

    rng = np.random.default_rng(0)

    def draw():
        return torch.from_numpy(rng.choice(labeled, batch, replace=False)
                                .astype(np.int32)).to(dev)

    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for step in range(steps):
            params, opt_state, loss = train_step(
                params, opt_state, draw(), epoch * 100 + step)
            losses.append(float(loss))
        acc = float(eval_acc(params, draw(), 9999))
        print(f"epoch {epoch}: loss {np.mean(losses):.3f} "
              f"sample-acc {acc:.1%} ({time.time() - t0:.2f}s)")
    assert acc > 0.3, "should beat 47-class chance comfortably"
    print("quickstart OK")
    return acc


if __name__ == "__main__":
    main()
