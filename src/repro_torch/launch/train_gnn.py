"""Distributed GNN training launcher of the port — the paper's workload
through the ``repro_torch.pipeline`` API (counterpart of
``repro.launch.train_gnn``, same defaults).  By default all P workers are
stacked on one device; ``--executor multiprocess`` runs them as a fleet
of ``--num-procs`` ranks, one OS process each, and ``--executor
shard_map`` (or ``--shard-map``) as a fleet of P ranks, one worker each.

  python -m repro_torch.launch.train_gnn --devices 4        # on the GPU
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 4 --feature-store pinned_hot --cache-capacity 256 \\
      --epochs 1 --steps-per-epoch 3 --batch 32
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 4 --scheme vanilla --epochs 1 --steps-per-epoch 3 \\
      --batch 32
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 4 --scheme "hybrid_partial(0.25)" --epochs 1 \\
      --steps-per-epoch 3 --batch 32
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 4 --prefetch-depth 2 --staging --epochs 1 \\
      --steps-per-epoch 3 --batch 32
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 4 --feature-store staged --prefetch-depth 1 --epochs 1 \\
      --steps-per-epoch 3 --batch 32

  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \
      --devices 4 --epochs 1 --steps-per-epoch 3 --batch 32 \
      --trace t.json --trace-fence
  python -m repro_torch.obs.report t.json --summary

  python -m repro_torch.launch.train_gnn --device cpu --devices 4 \\
      --dataset "rmat(0.57,0.19,0.19,0.05)" --partitioner "labelprop(2)"
  python -m repro_torch.launch.train_gnn --devices 4 \\
      --dataset datasets/ogbn-arxiv.npz

  python -m repro_torch.launch.train_gnn --executor multiprocess \\
      --num-procs 2 --trace t.json          # 2 ranks x 4 workers, GPU
  python -m repro_torch.launch.train_gnn --device cpu --nodes 3000 \\
      --devices 2 --executor shard_map --epochs 1 --steps-per-epoch 3 \\
      --batch 32

``--dataset`` takes a source registry name or the path of a dataset
saved with ``repro_torch.data.save_dataset`` (or ``repro``'s).
``--scheme`` takes ``vanilla``, ``hybrid``, ``hybrid+fused`` or any
registered placement scheme (``"hybrid_partial(0.25)"``).  ``--executor``
takes ``vmap`` (``repro``'s name, the default) or ``stacked`` (both the
port's ``StackedExecutor``), ``multiprocess`` or ``shard_map``.  A fleet
run re-execs this command line as its ranks
(``repro_torch.launch.multihost``, per-rank logs in a temporary
directory it prints), prints rank 0's output, and fails if a rank fails
or the fleet outlives ``--mh-timeout``.  Every rank runs on the card the
parent would (``cuda`` unless ``--device cpu``); on a machine with one
card the ranks share it and their collectives go through host memory
(gloo).  A rank builds only its own partitions' feature rows unless a
cache or the ``staged`` store needs the whole table.  ``--trace OUT.json``
records the driver, prefetch, stager and collective spans
(``repro_torch.obs``); a fleet's ranks write ``OUT.json.rank<r>``, which
the parent merges into ``OUT.json`` (rank as pid).  ``--trace-fence``
synchronizes inside the spans.
"""
import argparse
import os
import sys
import time

_FLEET = ("multiprocess", "shard_map")


def _launch_fleet(ap, args, executor) -> None:
    """The parent of a fleet run: re-exec this command line as the ranks,
    then print rank 0's output and merge the ranks' traces."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import multihost

    num_procs = args.devices if executor == "shard_map" else args.num_procs
    if num_procs < 1 or args.devices % num_procs:
        ap.error(f"--devices {args.devices} must be divisible by "
                 f"--num-procs {num_procs}")
    device = resolve_device(args.device)
    log_dir = multihost.launch(
        [sys.executable, "-m", "repro_torch.launch.train_gnn"]
        + list(args.argv), num_procs=num_procs, device=device.type,
        timeout=args.mh_timeout)
    with open(os.path.join(log_dir, "rank0.out")) as f:
        sys.stdout.write(f.read())
    if args.trace:
        multihost.merge_rank_traces(args.trace, num_procs)
        print(f"merged fleet trace written to {args.trace}")
    print(f"{executor} run complete: {num_procs} ranks x "
          f"{args.devices // num_procs} workers; per-rank logs in "
          f"{log_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="workers (P), stacked on one device")
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    ap.add_argument("--dataset", default="powerlaw(1.8)",
                    help="graph source: a registry name from "
                         "repro_torch.data (uniform | powerlaw(alpha) | "
                         "rmat(a,b,c,d) | sbm(k,p_in,p_out)) or a path to "
                         "a dataset saved with save_dataset (.npz)")
    ap.add_argument("--split", default="random(0.3)",
                    help="labeled-node split policy (random(frac) | "
                         "degree_stratified(frac)); ignored for on-disk "
                         "datasets")
    ap.add_argument("--scheme", default="hybrid+fused",
                    help="vanilla | hybrid | hybrid+fused, or any "
                         "registered placement scheme, e.g. "
                         "'hybrid_partial(0.25)' for degree-aware partial "
                         "replication")
    ap.add_argument("--partitioner", default="ldg",
                    help="partitioner registry name "
                         "(repro_torch.core.partition): ldg (streaming "
                         "greedy, the default) | labelprop (LDG + "
                         "label-propagation refinement, lower edge "
                         "cut) | metis (needs pymetis) | random / hash "
                         "(locality-free baseline); parameterized forms "
                         "like 'labelprop(20)' set the sweep count")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="per-worker hot-remote-feature cache entries "
                         "(0 = off)")
    ap.add_argument("--cache-policy", default="degree",
                    help="cache-construction policy (degree | frequency)")
    ap.add_argument("--feature-store", default="exchange",
                    help="exchange (two-round all_to_all fetch) | "
                         "pinned_hot (cache's hot rows pinned in device "
                         "memory, needs --cache-capacity > 0) | staged "
                         "(rows gathered on a host thread and copied "
                         "ahead of the step, needs --prefetch-depth >= "
                         "1); rows are bit-identical across stores")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="prepared minibatches in flight ahead of the "
                         "model (0 = synchronous)")
    ap.add_argument("--staging", action="store_true",
                    help="draw the seeds (and the staged store's rows) "
                         "on a host thread ahead of the step")
    ap.add_argument("--staging-lead", type=int, default=1,
                    help="slots the stager rides ahead of the prefetch "
                         "depth")
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--avg-degree", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.006)   # paper §4
    ap.add_argument("--shard-map", action="store_true",
                    help="alias of --executor shard_map")
    ap.add_argument("--executor", default=None,
                    choices=("vmap", "stacked") + _FLEET,
                    help="vmap (the default) | stacked: all workers "
                         "stacked on one device; multiprocess: "
                         "--num-procs ranks of devices/num-procs workers "
                         "each, one OS process a rank; shard_map: one "
                         "rank a worker")
    ap.add_argument("--num-procs", type=int, default=2,
                    help="ranks of the multiprocess executor")
    ap.add_argument("--mh-timeout", type=float, default=600.0,
                    help="fleet wall-clock timeout in seconds (hang "
                         "detection)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event timeline of the run "
                         "(repro_torch.obs): driver/prefetch/stager spans, "
                         "viewable in Perfetto; a fleet's ranks write "
                         "OUT.json.rankR and the parent merges them into "
                         "OUT.json (rank as pid).  Render the span summary "
                         "with 'python -m repro_torch.obs.report OUT.json "
                         "--summary'")
    ap.add_argument("--trace-fence", action="store_true",
                    help="synchronize inside traced spans: honest "
                         "device-time attribution per span, at the cost "
                         "of the prepare/consume overlap (a profiling "
                         "mode, never for production numbers)")
    args = ap.parse_args(argv)
    args.argv = sys.argv[1:] if argv is None else list(argv)
    executor = args.executor or ("shard_map" if args.shard_map else "vmap")

    from repro_torch.launch import multihost

    if executor in _FLEET and not multihost.is_worker():
        _launch_fleet(ap, args, executor)
        return

    rank, local_parts = 0, None
    if executor in _FLEET:
        # a rank: join the process group first, then build only its own
        # partitions' feature rows unless a stage reads other ones (the
        # cache copies remote hot rows, the staged store's host gather
        # walks the whole table)
        rank, num_procs, _ = multihost.init_from_env()
        per = args.devices // num_procs
        if args.cache_capacity == 0 and args.feature_store != "staged":
            local_parts = (rank * per, (rank + 1) * per)

    from repro_torch.obs import trace as obs_trace

    trace_path = args.trace
    if args.trace:
        fleet = executor in _FLEET
        if fleet:
            trace_path = multihost.rank_trace_path(args.trace, rank)
        obs_trace.start(trace_path, fenced=args.trace_fence, pid=rank,
                        process_name=f"rank{rank}" if fleet
                        else "train_gnn")

    from repro_torch.data import DataSpec, dataset_stats, stats_label
    from repro_torch.device import resolve_device
    from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec

    import torch

    device = resolve_device(args.device)
    data = DataSpec(source=args.dataset, num_nodes=args.nodes,
                    avg_degree=args.avg_degree, num_features=100,
                    num_classes=47, split=args.split, seed=0)
    fanouts = (10, 10, 5)               # paper §4 defaults
    spec = PipelineSpec.from_scheme(
        args.scheme, num_parts=args.devices, fanouts=fanouts,
        cache_capacity=args.cache_capacity, cache_policy=args.cache_policy,
        partitioner=args.partitioner, feature_store=args.feature_store,
        prefetch_depth=args.prefetch_depth, staging=args.staging,
        staging_lead=args.staging_lead, executor=executor, data=data)
    pipe = Pipeline.build_from_source(spec=spec, local_parts=local_parts,
                                      device=device)
    ds = pipe.dataset
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"dataset: {stats_label(dataset_stats(ds))}; device {device}")

    cfg = GNNConfig(in_dim=ds.features.shape[1], hidden_dim=256,
                    num_classes=ds.num_classes, num_layers=len(fanouts),
                    fanouts=fanouts, dropout=0.0)
    say(f"partitioned into {args.devices} by {args.partitioner!r}: "
        f"edge-cut {pipe.edge_cut_fraction:.1%}")
    if pipe.group is not None:
        say(f"fleet: {pipe.group.num_procs} ranks x {pipe.group.local} "
            f"workers; rank-local build: "
            f"{'yes' if local_parts is not None else 'no'}")
    if hasattr(pipe.placement, "replicated_edge_fraction"):
        say(f"partial replication: "
            f"{pipe.placement.replicated_edge_fraction:.1%} of edges "
            f"replicated, expected rounds/step "
            f"{pipe.expected_rounds_estimate:.2f} "
            f"(hybrid=2, vanilla={2 * cfg.num_layers})")

    def loss_fn(p, mfgs, h_src, labels, valid):
        return gnn_loss(p, mfgs, h_src, labels, valid, cfg)

    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), device)
    opt_state = init_opt_state(params, kind="adamw")
    with pipe.train_driver(loss_fn, batch=args.batch, lr=args.lr,
                           optimizer="adamw", grad_clip=1.0,
                           device=device) as driver:
        _train(args, executor, pipe, driver, cfg, params, opt_state, say)
    if args.trace:
        tracer = obs_trace.stop()
        say(f"trace written to {trace_path} "
            f"({tracer.num_recorded} spans, {tracer.dropped} dropped); "
            f"view at https://ui.perfetto.dev or render with "
            f"python -m repro_torch.obs.report {args.trace} --summary")
    if pipe.group is not None:
        import torch.distributed as tdist
        tdist.destroy_process_group()


def _train(args, executor, pipe, driver, cfg, params, opt_state,
           say) -> None:
    from repro_torch.obs.metrics import get_registry

    registry = get_registry()
    staging = "on" if driver.stager is not None else "off"
    for epoch in range(args.epochs):
        t0 = time.time()
        rounds_before = pipe.counter.rounds
        for s in range(args.steps_per_epoch):
            params, opt_state, loss, metrics = driver.step(params, opt_state)
            if epoch == 0 and s == 0:
                say(f"scheme={args.scheme} executor={executor} "
                      f"prefetch={args.prefetch_depth} staging={staging} "
                      f"store={args.feature_store}: "
                      f"{pipe.counter.rounds} comm rounds/step "
                      f"({pipe.counter.sampling_rounds} sampling + "
                      f"{pipe.counter.feature_rounds} feature; "
                      f"vanilla=2L={2 * cfg.num_layers}, hybrid=2)")
        rounds = (pipe.counter.rounds - rounds_before) \
            / args.steps_per_epoch
        # the epoch's log line materializes the metrics anyway; absorbing
        # them also runs the warn-once sampler-overflow watch
        registry.observe_step(
            metrics, step=(epoch + 1) * args.steps_per_epoch - 1)
        msg = (f"epoch {epoch}: loss {float(loss):.4f} "
               f"rounds/step {rounds:g} utilized-KB/step "
               f"{float(metrics['sampling_utilized_bytes']) / 1024:.0f}s+"
               f"{float(metrics['feature_utilized_bytes']) / 1024:.0f}f "
               f"time {time.time() - t0:.2f}s")
        if args.cache_capacity:
            msg += f" cache-hit {float(metrics['cache_hit_rate']):.1%}"
        say(msg)


if __name__ == "__main__":
    main()
