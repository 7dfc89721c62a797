"""Online GNN inference serving launcher of the port (counterpart of
``repro.launch.serve_gnn``, the same flags and defaults): train briefly,
export a ``Predictor``, replay synthetic open-loop traffic through the
queue -> recycler -> microbatcher -> sampler path, and report latency/QPS.

  python -m repro_torch.launch.serve_gnn --devices 4 --recycle  # on the GPU
  python -m repro_torch.launch.serve_gnn --device cpu --devices 4 \\
      --requests 400 --arrival hotset --recycle --hot-scorer "blend(0.5)"
  python -m repro_torch.launch.serve_gnn --device cpu --devices 4 \\
      --no-batching --rate 500        # baseline arm: one request per step
  python -m repro_torch.launch.serve_gnn --device cpu --devices 4 \\
      --scheme vanilla                # the paper's partitioned baseline

``--rate 0`` (default) calibrates the arrival rate to twice the measured
single-request service capacity.  ``main(argv)`` returns the run's
summary, outputs and arrivals and the predictor, so a caller can check the
served outputs.  ``--scheme`` takes ``vanilla``, ``hybrid``,
``hybrid+fused`` or any registered placement scheme
(``"hybrid_partial(0.25)"``).  ``--trace OUT.json`` records the
real-clock ``serve/predict`` spans and each request's virtual-clock lanes
(``repro_torch.obs``).
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4,
                    help="workers (P), stacked on one device")
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    ap.add_argument("--dataset", default="powerlaw(1.8)",
                    help="graph source registry name or .npz path "
                         "(see repro_torch.data)")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--avg-degree", type=int, default=10)
    ap.add_argument("--scheme", default="hybrid",
                    help="vanilla | hybrid | hybrid+fused, or any "
                         "registered placement scheme, e.g. "
                         "'hybrid_partial(0.25)'")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="per-worker remote-feature cache entries")
    ap.add_argument("--train-steps", type=int, default=5,
                    help="quick training steps before exporting the "
                         "Predictor (0 = serve untrained params)")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate (req/s); 0 = calibrate to twice "
                         "the single-request service capacity")
    ap.add_argument("--arrival", default="hotset",
                    help="traffic pattern registry name (uniform | hotset)")
    ap.add_argument("--hot-k", type=int, default=64,
                    help="hot-set size for hotset traffic (ranked by "
                         "--hot-scorer)")
    ap.add_argument("--hot-scorer", default="degree",
                    help="hot-set scorer registry name ranking the "
                         "traffic's hot set (repro_torch.core.cache: "
                         "degree | frequency | blend(w))")
    ap.add_argument("--hot-prob", type=float, default=0.9,
                    help="probability a hotset arrival draws from the "
                         "hot set")
    ap.add_argument("--buckets", default="1,8,32,128",
                    help="comma-separated per-worker batch-shape buckets")
    ap.add_argument("--max-delay", type=float, default=2e-3,
                    help="microbatcher deadline (s)")
    ap.add_argument("--no-batching", action="store_true",
                    help="baseline arm: bucket (1,), zero delay")
    ap.add_argument("--recycle", action="store_true",
                    help="enable the LazyGNN-style recycling cache")
    ap.add_argument("--tau", type=int, default=64,
                    help="recycler staleness bound (fresh serve steps)")
    ap.add_argument("--rho", type=float, default=1.0,
                    help="max fraction of requests served recycled")
    ap.add_argument("--recycle-capacity", type=int, default=1024)
    ap.add_argument("--salt-policy", default="fixed",
                    choices=("fixed", "step"),
                    help="'fixed' resamples the same subgraph per seed "
                         "(deterministic serving); 'step' draws fresh "
                         "samples each flush")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event timeline "
                         "(repro_torch.obs): real-clock serve/predict "
                         "spans plus per-request queue-wait / "
                         "batch-delay / service lanes on the virtual "
                         "clock; viewable in Perfetto")
    args = ap.parse_args(argv)

    import time

    import numpy as np
    import torch

    from repro_torch.obs import trace as obs_trace

    if args.trace:
        obs_trace.start(args.trace, process_name="serve_gnn")

    from repro_torch.core.cache import resolve_hot_scorer
    from repro_torch.data.spec import DataSpec
    from repro_torch.device import resolve_device
    from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec
    from repro_torch.serve import GNNServer, Predictor, RecyclingCache
    from repro_torch.serve.traffic import resolve_arrival

    device = resolve_device(args.device)
    fanouts = (5, 5)
    data = DataSpec(source=args.dataset, num_nodes=args.nodes,
                    avg_degree=args.avg_degree, num_features=32,
                    num_classes=16, split="random(0.3)", seed=args.seed)
    spec = PipelineSpec.from_scheme(
        args.scheme, num_parts=args.devices, fanouts=fanouts,
        cache_capacity=args.cache_capacity, data=data)
    pipe = Pipeline.build_from_source(spec=spec, device=device)
    ds = pipe.dataset
    print(f"dataset: {ds.name}, {ds.graph.num_nodes} nodes, "
          f"{ds.graph.num_edges} edges; {args.devices} workers; "
          f"device {device}")

    cfg = GNNConfig(in_dim=ds.features.shape[1], hidden_dim=32,
                    num_classes=ds.num_classes, num_layers=len(fanouts),
                    fanouts=fanouts, dropout=0.0)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), device)
    if args.train_steps:
        def loss_fn(p, mfgs, h, y, v):
            return gnn_loss(p, mfgs, h, y, v, cfg)
        with pipe.train_driver(loss_fn, batch=64, lr=0.006,
                               device=device) as driver:
            opt = init_opt_state(params, kind="adamw")
            for k in range(args.train_steps):
                params, opt, loss, _ = driver.step(params, opt, k)
        print(f"trained {args.train_steps} steps, loss {float(loss):.4f}")

    buckets = (1,) if args.no_batching else \
        tuple(int(b) for b in args.buckets.split(","))
    max_delay = 0.0 if args.no_batching else args.max_delay
    predictor = Predictor(pipe, params, cfg, buckets=buckets,
                          base_salt=args.seed, device=device)
    predictor.warmup()

    rate = args.rate
    if rate <= 0:
        probe = resolve_hot_scorer("degree").top_ids(ds.graph, 8)
        t0 = time.perf_counter()
        for s in probe:
            predictor.predict([int(s)])
        t1 = (time.perf_counter() - t0) / probe.size
        rate = 2.0 / t1
        print(f"calibrated: single-request service {t1*1e3:.2f} ms "
              f"-> open-loop rate {rate:.0f} req/s")

    hot_ids = resolve_hot_scorer(args.hot_scorer).top_ids(
        ds.graph, args.hot_k)
    arrivals = resolve_arrival(args.arrival)(
        args.requests, rate, ds.graph.num_nodes, seed=args.seed,
        hot_ids=hot_ids, hot_prob=args.hot_prob)

    recycler = RecyclingCache(capacity=args.recycle_capacity,
                              tau=args.tau, rho=args.rho) \
        if args.recycle else None
    server = GNNServer(predictor, max_delay=max_delay, recycler=recycler,
                       salt_policy=args.salt_policy, device=device)
    stats, outputs = server.run(arrivals, warmup=False,
                                collect_outputs=True)

    s = stats.summary()
    print(f"served {s['num_requests']} requests "
          f"({args.arrival} arrivals @ {rate:.0f} req/s, "
          f"scheme={args.scheme}, buckets={buckets}, "
          f"recycle={'on' if args.recycle else 'off'})")
    print(f"  p50 {s['p50_ms']:.3f} ms   p99 {s['p99_ms']:.3f} ms   "
          f"QPS {s['qps']:.0f}")
    print(f"  flushes {s['num_flushes']} "
          f"buckets {s['bucket_histogram']} "
          f"recycled {s['num_recycled']} "
          f"({s['recycled_fraction']:.1%})")
    if recycler is not None:
        r = s["recycler"]
        print(f"  recycler: hit-rate {r['hit_rate']:.1%} "
              f"entries {r['entries']}/{r['capacity']} "
              f"tau={r['tau']} rho={r['rho']} "
              f"expired {r['expired']} deferrals {r['rho_deferrals']}")
    if args.trace:
        tracer = obs_trace.stop()
        print(f"trace written to {args.trace} "
              f"({tracer.num_recorded} spans); view at "
              f"https://ui.perfetto.dev")
    return {"summary": s, "outputs": outputs,
            "seeds": np.asarray([seed for _, seed in arrivals]),
            "predictor": predictor}


if __name__ == "__main__":
    main()
