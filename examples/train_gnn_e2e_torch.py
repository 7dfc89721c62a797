"""End-to-end driver (PyTorch port): train a wide GraphSAGE (in 1024 ->
hidden 4096 x 3 layers, about 42M parameters) for a few hundred steps
with distributed sampling through the ``repro_torch.pipeline`` API, with
checkpointing.

Any of the paper's three scenarios (vanilla / hybrid / hybrid+fused),
with or without the §5 feature cache, runs through the same spec.  The 4
workers are stacked on one device; on the GPU (the default) every step
runs the port's CUDA kernels, and ``--device cpu`` runs their plain
versions:

  PYTHONPATH=src python examples/train_gnn_e2e_torch.py [--steps 200]
  PYTHONPATH=src python examples/train_gnn_e2e_torch.py --scheme vanilla
  PYTHONPATH=src python examples/train_gnn_e2e_torch.py --scheme hybrid \\
      --cache-capacity 2048
  PYTHONPATH=src python examples/train_gnn_e2e_torch.py --device cpu \\
      --steps 6 --feature-dim 64 --hidden 128 --batch 32

The checkpoint goes to ``--ckpt`` (default under the git-ignored
``experiments/``) in the flat-npz format both packages read.
"""
import argparse
import time

import torch

from repro_torch.data.synthetic_graph import make_power_law_graph
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.pipeline import Pipeline, PipelineSpec
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

P = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scheme", default="hybrid+fused",
                    choices=["vanilla", "hybrid", "hybrid+fused"])
    ap.add_argument("--cache-capacity", type=int, default=0)
    ap.add_argument("--feature-dim", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt", default="experiments/gnn_e2e_torch.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def build(args, dev):
    """The graph, model and pipeline of ``args``: ``(pipe, cfg)``."""
    ds = make_power_law_graph(8_000, 8, num_features=args.feature_dim,
                              num_classes=47, seed=0)
    cfg = GNNConfig(in_dim=args.feature_dim, hidden_dim=args.hidden,
                    num_classes=47, num_layers=3, fanouts=(5, 5, 3),
                    dropout=0.0)
    spec = PipelineSpec.from_scheme(
        args.scheme, num_parts=P, fanouts=cfg.fanouts,
        cache_capacity=args.cache_capacity)
    return Pipeline.build(ds.graph, ds.features, ds.labels, spec,
                          device=dev), cfg


def main(argv=None) -> dict:
    """Train, save and restore; returns the first and last losses, every
    step's loss, the parameter count and the seconds a step."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    pipe, cfg = build(args, dev)

    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params, {P} workers, "
          f"{args.scheme} sampling"
          + (f" + cache({args.cache_capacity})"
             if args.cache_capacity else "") + f", on {dev}")

    def loss_fn(p, mfgs, h_src, labels, valid):
        return gnn_loss(p, mfgs, h_src, labels, valid, cfg)

    train = pipe.train_step(loss_fn, lr=1e-3, optimizer="adamw",
                            grad_clip=1.0, device=dev)
    opt_state = init_opt_state(params)

    t0 = time.time()
    losses = []
    for s in range(args.steps):
        seeds = pipe.seeds(args.batch, epoch_salt=s)
        params, opt_state, loss, metrics = train(params, opt_state, seeds,
                                                 s)
        losses.append(float(loss))
        if s % 25 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (s + 1):.2f}s/step)")
    first, last = losses[0], losses[-1]
    per_step = (time.time() - t0) / args.steps

    save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
    restored, rs = restore_checkpoint(args.ckpt, {"params": params})
    assert rs == args.steps
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(params)):
        assert torch.equal(a, b), "the checkpoint must restore the weights"
    print(f"loss {first:.3f} -> {last:.3f}; checkpoint roundtrip OK")
    assert last < first, "training must reduce the loss"
    return {"first": first, "last": last, "losses": losses,
            "params": n_params, "s_per_step": per_step}


if __name__ == "__main__":
    main()
