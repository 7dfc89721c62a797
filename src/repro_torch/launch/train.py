"""LM training launcher of the port (counterpart of ``repro.launch.train``,
its flags plus ``--device``): trains a config on synthetic Markov tokens.

  python -m repro_torch.launch.train --arch qwen2-7b --reduced   # on the GPU
  python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
      --device cpu --steps 50 --batch 8 --seq 128

One device, no data parallelism: ``--devices`` (``repro``'s count of host
placeholder devices for its mesh) takes 0 or 1 here; sharding waits for
the port's mesh.  ``--checkpoint`` writes ``{"params", "opt"}`` in
``repro.train.checkpoint``'s format.  ``main(argv)`` returns the losses.
"""
import argparse
import time


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
                    help="repro's host placeholder devices; 0 or 1 (one "
                         "device, no data parallelism)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.devices > 1:
        ap.error(f"--devices {args.devices}: the port's LM trainer runs on "
                 f"one device; data parallelism needs the mesh and sharding "
                 f"of the LM scaffold's part 2")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.loop import make_lm_train_step

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # products accumulate in float32, as repro's do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"family={cfg.family} device={dev}")

    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0))
    opt_state = init_opt_state(params, kind="adamw")
    step_fn = make_lm_train_step(cfg, lr=args.lr, remat=False)

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
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")

    if args.checkpoint:
        save_checkpoint(args.checkpoint,
                        {"params": params, "opt": opt_state},
                        step=args.steps)
        print("saved", args.checkpoint)
    return {"losses": losses, "finite": bool(np.isfinite(losses).all()),
            "params": params, "opt": opt_state}


if __name__ == "__main__":
    main()
