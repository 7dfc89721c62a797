"""LM training launcher of the port (counterpart of ``repro.launch.train``,
its flags plus ``--device``): trains a config on synthetic Markov tokens.

  python -m repro_torch.launch.train --arch qwen2-7b --reduced   # on the GPU
  python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
      --device cpu --steps 50 --batch 8 --seq 128

``--devices N`` (``repro``'s count of host placeholder devices for its
mesh) runs N ranks of one job through ``repro_torch.launch.multihost``
(gloo), all on the caller's device, the card unless ``--device cpu``.
Every rank holds the parameters and the optimizer state as DTensors on
``make_host_mesh()``'s (N, 1) mesh, placed by
``repro_torch.sharding.param_shardings`` (MoE experts split over ``data``
where they divide N, all else replicated), and trains on the whole batch,
which is not sharded, as in ``repro``.  Rank 0 prints and writes the
losses; the parent prints rank 0's log.

``--checkpoint`` writes ``{"params", "opt"}`` in
``repro.train.checkpoint``'s format.  ``main(argv)`` returns the losses.
"""
import argparse
import json
import os
import sys
import tempfile
import time

# where a rank 0 of a --devices N run writes its losses (set by the parent)
ENV_LOSSES = "REPRO_TORCH_TRAIN_LOSSES"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the job (repro's host placeholder "
                         "devices), each on --device; the parameters are "
                         "DTensors on their (N, 1) mesh")
    ap.add_argument("--mh-timeout", type=float, default=600.0,
                    help="wall-clock bound of a --devices N > 1 run (s)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch import multihost

    if args.devices > 1 and not multihost.is_worker():
        return _launch_ranks(args, sys.argv[1:] if argv is None
                             else list(argv))

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.loop import make_lm_train_step

    rank, mesh = 0, None
    if multihost.is_worker():
        from repro_torch.launch.mesh import make_host_mesh
        rank, _, dev = multihost.init_from_env()
        mesh = make_host_mesh(device_type=dev.type)
    else:
        dev = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    if dev.type == "cuda":
        # products accumulate in float32, as repro's do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    say(f"arch={cfg.name} params={cfg.param_count():,} "
        f"family={cfg.family} device={dev}"
        + (f" ranks={mesh.size()}" if mesh is not None else ""))

    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0))
    opt_state = init_opt_state(params, kind="adamw")
    step_fn = make_lm_train_step(cfg, lr=args.lr, remat=False)
    run = step_fn
    if mesh is not None:
        # every rank drew the same parameters from the seed: each keeps its
        # own shards; tensors the step makes (the batch) are replicated
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.core.dist import TransportCollectives
        from repro_torch.sharding import P, distribute, param_specs
        specs = param_specs(params, mesh)
        params = distribute(params, specs, mesh)
        opt_state = distribute(opt_state, type(opt_state)(
            step=P(), mu=specs, nu=specs), mesh)

        def run(p, o, b):
            # DTensor's collectives through the fleet's transport (gloo's
            # all_gather / all_to_all_single, which take CUDA tensors)
            with implicit_replication(), TransportCollectives():
                return step_fn(p, o, b)

    src = MarkovTokenSource(cfg.vocab_size, seed=0)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        raw = src.train_batch(args.batch, args.seq, seed=step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        if cfg.family == "vlm":
            npatch = args.seq // 4
            batch["vision_embeds"] = torch.zeros(
                (args.batch, npatch, cfg.d_model), device=dev)
            batch["positions"] = torch.arange(args.seq, device=dev).expand(
                3, args.batch, args.seq)
        if cfg.is_encdec:
            batch["frames"] = torch.randn(
                (args.batch, cfg.encoder_seq, cfg.d_model), device=dev,
                generator=torch.Generator(dev).manual_seed(step))
        params, opt_state, metrics = run(params, opt_state, batch)
        losses.append(_host(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {_host(metrics['grad_norm']):.3f} "
                f"({(time.time()-t0)/(step+1):.2f}s/step)")

    if mesh is not None:
        from repro_torch.optim.optimizers import tree_map
        params, opt_state = tree_map(_full, (params, opt_state))
    if args.checkpoint and rank == 0:
        save_checkpoint(args.checkpoint,
                        {"params": params, "opt": opt_state},
                        step=args.steps)
        say("saved", args.checkpoint)
    if mesh is not None and rank == 0:
        with open(os.environ[ENV_LOSSES], "w") as f:
            json.dump(losses, f)
    return {"losses": losses, "finite": bool(np.isfinite(losses).all()),
            "params": params, "opt": opt_state}


def _full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    from repro_torch.core.dist import TransportCollectives
    with TransportCollectives():
        return t.full_tensor()


def _host(t) -> float:
    return float(_full(t))


def _launch_ranks(args, argv) -> dict:
    """The parent of a ``--devices N`` run: N ranks of this command line
    through the launcher, rank 0's log printed; returns rank 0's losses
    (no parameters: they stay with the ranks)."""
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.launch import multihost

    import repro_torch

    out = tempfile.NamedTemporaryFile(prefix="repro-torch-train-",
                                      suffix=".json", delete=False)
    out.close()
    # the ranks import the package this process runs
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    path = os.pathsep.join(filter(None, [root,
                                         os.environ.get("PYTHONPATH")]))
    try:
        log_dir = multihost.launch(
            [sys.executable, "-m", "repro_torch.launch.train"] + argv,
            num_procs=args.devices,
            device=resolve_device(args.device).type,
            timeout=args.mh_timeout,
            env=dict(os.environ, PYTHONPATH=path, **{ENV_LOSSES: out.name}))
        with open(os.path.join(log_dir, "rank0.out")) as f:
            sys.stdout.write(f.read())
        with open(out.name) as f:
            losses = json.load(f)
    finally:
        os.unlink(out.name)
    print(f"{args.devices} ranks; per-rank logs in {log_dir}")
    return {"losses": losses, "finite": bool(np.isfinite(losses).all()),
            "params": None, "opt": None}


if __name__ == "__main__":
    main()
