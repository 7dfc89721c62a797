"""Batched LM serving launcher of the port (counterpart of
``repro.launch.serve_lm``, its flags plus ``--device``): prefill a prompt
batch, then decode greedily.

  python -m repro_torch.launch.serve_lm --arch stablelm-1.6b   # on the GPU
  python -m repro_torch.launch.serve_lm --arch stablelm-1.6b --reduced \\
      --device cpu --batch 4 --prompt-len 32 --gen 16

Weights are random from seed 0 (``torch.Generator`` on the device), the
prompts come from ``MarkovTokenSource``.  ``main(argv)`` returns the
generated tokens and the timings.
"""
import argparse
import time


def prefill_cache(params, tokens, cfg):
    """Run the prompt through the model while filling the decode caches.

    A loop of decode steps (right for every family, ring-buffer SWA and
    SSM state included) over a cache of ``max(2 S, 64)`` positions.
    Returns (state, logits (B, S, V) float32).
    """
    import torch
    from repro_torch.models import lm

    B, S = tokens.shape
    state = lm.init_decode_state(cfg, B, max(S * 2, 64), params=params)
    logits = []
    for t in range(S):
        out, state = lm.decode_step(params, state,
                                    {"tokens": tokens[:, t:t + 1]}, cfg)
        logits.append(out[:, 0])
    return state, torch.stack(logits, 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted as repro's is; decoding is greedy")
    ap.add_argument("--device", default=None,
                    help="where to run: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # products accumulate in float32, as repro's do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit("use a decoder-only arch for the LM server demo")
    print(f"serving {cfg.name} ({cfg.param_count():,} params) on {dev}")

    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0))
    src = MarkovTokenSource(cfg.vocab_size, seed=0)
    prompts = torch.from_numpy(
        src.batch(args.batch, args.prompt_len - 1)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    state, logits = prefill_cache(params, prompts, cfg)
    sync()
    prefill_s = time.time() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_s:.2f}s")

    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    t0 = time.time()
    for _ in range(args.gen):
        logits, state = lm.decode_step(params, state, {"tokens": tok}, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    sync()
    dt = time.time() - t0
    gen = torch.cat(out, 1).cpu().numpy()
    print(f"decoded {args.gen} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.gen*args.batch/dt:.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {gen[b].tolist()}")
    return {"tokens": gen, "prefill_s": prefill_s, "decode_s": dt,
            "tok_per_s": args.gen * args.batch / dt,
            "finite": bool(np.isfinite(logits.cpu().numpy()).all())}


if __name__ == "__main__":
    main()
