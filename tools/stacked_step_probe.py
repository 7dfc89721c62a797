"""Time the stacked executor's training step on one card, at the shapes of
``chip_smoke.py``'s phases 8, 10 and 12: ``powerlaw(1.8)`` at 500 000
nodes (average degree 24, 100 features, 47 classes), P = 4, ``ldg``,
1000 seeds a worker, AdamW (lr 0.006, clip 1.0), a 65 536-row ``degree``
cache with the ``pinned_hot`` store, the paper's GraphSAGE with dropout
0.  Arms: ``hybrid+fused`` (phase 8), ``vanilla`` (phase 10) and gat
with 4 heads under ``hybrid+fused`` (phase 12).  Each arm: 10
``SyncDriver`` steps from seeded weights (the step wall's median), then
2 steps profiled one by one (``chip_smoke.profiled_steps``: wall, device
busy ms and the step stream's device ops).  Then phase 6's serving: a
``Predictor`` (buckets 1, 8, 32, 128) over the ``hybrid+fused``
pipeline and 400 ``hotset`` arrivals through ``GNNServer`` at a fixed
200 requests a second (p50, p99, QPS).  Prints one JSON line.

It uses only APIs that older trees of the port have too, so two trees
can be compared on one card in one call, in turns:

    for src in build/parent/src src src build/parent/src; do
        PYTHONPATH=$src python3 tools/stacked_step_probe.py --label $src
    done

``--device cpu`` with a small ``--nodes`` rehearses it without a card
(no profiling, no times worth keeping).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = (("phase 8 hybrid+fused", "hybrid+fused", "sage"),
        ("phase 10 vanilla", "vanilla", "sage"),
        ("phase 12 gat", "hybrid+fused", "gat"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--nodes", type=int, default=500_000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    # the tree on PYTHONPATH first: chip_smoke puts this checkout's src on
    # sys.path when it is imported, and the package is then already loaded
    import repro_torch
    from repro_torch.configs.graphsage_paper import PRODUCTS
    from repro_torch.models.gnn import gnn_loss, init_gnn_params
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import DataSpec, Pipeline, PipelineSpec
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    card = "cpu (rehearsal)"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data = DataSpec(source="powerlaw(1.8)", num_nodes=args.nodes,
                    avg_degree=cs.AVG_DEGREE, num_features=PRODUCTS.in_dim,
                    num_classes=PRODUCTS.num_classes, split="random(0.3)",
                    seed=0)
    t0 = time.perf_counter()
    base = Pipeline.build_from_source(
        spec=PipelineSpec.from_scheme("hybrid+fused", num_parts=cs.NUM_PARTS,
                                      fanouts=PRODUCTS.fanouts, data=data),
        device=args.device)
    out = {"label": args.label, "package": os.path.relpath(
               os.path.dirname(repro_torch.__file__), HERE), "card": card,
           "torch": torch.__version__, "setup_s": time.perf_counter() - t0,
           "arms": {}}
    for name, scheme, conv in ARMS:
        cfg = dataclasses.replace(PRODUCTS, dropout=0.0, conv=conv,
                                  gat_heads=4)
        pipe = Pipeline.from_layout(base.layout, PipelineSpec.from_scheme(
            scheme, num_parts=cs.NUM_PARTS, fanouts=cfg.fanouts,
            cache_capacity=cs.CACHE_K, cache_policy="degree",
            feature_store="pinned_hot", data=data), device=args.device)
        params = init_gnn_params(cfg, torch.Generator().manual_seed(0),
                                 args.device)
        opt = init_opt_state(params)
        driver = pipe.train_driver(
            lambda p, m, h, y, v, cfg=cfg: gnn_loss(p, m, h, y, v, cfg),
            batch=cs.TRAIN_BATCH, lr=cs.TRAIN_LR, grad_clip=1.0,
            device=args.device)
        walls, losses = [], []
        for _ in range(args.steps):
            t1 = time.perf_counter()
            params, opt, loss, _ = driver.step(params, opt)
            losses.append(float(loss))            # waits for the step
            walls.append((time.perf_counter() - t1) * 1e3)
        arm = {"step_wall_median_ms": statistics.median(walls),
               "walls_ms": walls, "losses": losses}
        if args.device == "cuda":
            params, opt, prof = cs.profiled_steps(driver, params, opt)
            arm.update(prof)
        driver.close()
        out["arms"][name] = arm
        del pipe, driver, params, opt
        if args.device == "cuda":
            torch.cuda.empty_cache()
    out["serving"] = serving(base, PRODUCTS, args.device, cs)
    print(json.dumps(out), flush=True)
    return out


def serving(pipe, cfg, device, cs) -> dict:
    """Phase 6's predictor and 400 ``hotset`` arrivals at a fixed rate of
    200 a second through ``GNNServer`` (2 ms batching delay)."""
    import torch
    from repro_torch.models.gnn import init_gnn_params
    from repro_torch.serve import GNNServer, Predictor
    from repro_torch.serve.traffic import hotset_arrivals

    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), device)
    pred = Predictor(pipe, params, cfg, buckets=(1, 8, 32, 128),
                     base_salt=cs.SALT, device=device)
    pred.warmup()
    graph = pipe.dataset.graph
    arrivals = hotset_arrivals(400, 200.0, graph.num_nodes, graph=graph,
                               hot_k=64, seed=0)
    stats = GNNServer(pred, max_delay=2e-3, device=device).run(
        arrivals, warmup=False)
    s = stats.summary()
    return {k: s[k] for k in ("p50_ms", "p99_ms", "qps", "num_flushes")}


if __name__ == "__main__":
    main()
