"""Batched-serving example over the LM zoo (PyTorch port): prefill a prompt
batch and decode continuations with the KV/SSM caches, for one arch of each
cache family, at their reduced sizes.  Counterpart of
``examples/serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data.tokens import MarkovTokenSource
from repro_torch.device import resolve_device
from repro_torch.models import lm

ARCHS = ("stablelm_1p6b",      # dense GQA cache
         "mixtral_8x22b",      # MoE + SWA ring buffer
         "mamba2_130m",        # SSM O(1) state
         "zamba2_1p2b")        # hybrid: SSM + shared-attn KV


def serve(arch: str, dev, batch=4, prompt_len=16, gen=12) -> np.ndarray:
    cfg = get_reduced(arch)
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0))
    src = MarkovTokenSource(cfg.vocab_size, seed=1)
    prompts = torch.from_numpy(src.batch(batch, prompt_len - 1)).to(dev)

    state = lm.init_decode_state(cfg, batch, prompt_len + gen + 1,
                                 params=params)

    def step(state, tok):
        logits, state = lm.decode_step(params, state, {"tokens": tok}, cfg)
        return logits[:, -1].argmax(-1)[:, None], state

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # prefill = batched decode over the prompt (cache-populating)
    t0 = time.time()
    for t in range(prompts.shape[1]):
        tok, state = step(state, prompts[:, t:t + 1])
    sync()
    prefill_t = time.time() - t0

    t0 = time.time()
    outs = []
    for _ in range(gen):
        tok, state = step(state, tok)
        outs.append(tok)
    sync()
    dt = time.time() - t0
    gen_toks = torch.cat(outs, 1).cpu().numpy()
    print(f"{arch:16s} prefill {prefill_t:5.2f}s  "
          f"decode {gen * batch / dt:7.1f} tok/s  "
          f"sample: {gen_toks[0][:8].tolist()}")
    assert ((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()
    return gen_toks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {arch: serve(arch, dev) for arch in ARCHS}
    print("serving OK across cache families")
    return out


if __name__ == "__main__":
    main()
