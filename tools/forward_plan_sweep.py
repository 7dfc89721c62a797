#!/usr/bin/env python3
"""Launch-shape sweep of the forward ``sage_aggregate`` kernel on one CUDA
card, one process.

    python3 tools/forward_plan_sweep.py        # from the repository root

``repro_torch.kernels.sage_aggregate.forward_plan`` picks the rows per block
R and the threads per block from D and F.  This script launches the kernel
with each candidate (R, threads) in turn, then again in reverse order, on
the same seeded inputs, checks each result equals the f-ordered loop of
``chip_smoke.py`` bit for bit, and prints the kernel's device time per call
(``torch.profiler``, 20 calls) beside the byte bound.  The inputs are
synthetic, at the shapes of one 128-seed ``predict``'s layers and one
training step's (4 workers): ids uniform over the table, the last 70 % of
each serving worker's rows padding (-1) as the buckets leave them, 10 % of
the other slots -1.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.sage_aggregate import (_lib,  # noqa: E402
                                                forward_plan)

B = 4
# name: (S, F, N, D, share of each worker's rows that are real)
LAYERS = {"serving bottom": (22528, 5, 135168, 100, 0.3),
          "serving middle": (2048, 10, 22528, 256, 0.3),
          "serving top": (128, 15, 2048, 256, 0.3),
          "step top": (1000, 15, 16000, 256, 1.0),
          "step middle": (16000, 10, 176000, 256, 1.0),
          "step bottom": (176000, 5, 1056000, 100, 1.0)}
# (R, threads) candidates by D
CANDIDATES = {100: [(32, 800), (64, 800), (128, 800), (32, 416), (64, 416),
                    (64, 544), (96, 800)],
              256: [(4, 256), (8, 256), (4, 128), (8, 128), (16, 256),
                    (2, 128), (16, 512)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("forward_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    launch = _lib("sage_aggregate_launch")
    rng = np.random.default_rng(0)
    for name, (S, F, N, D, real) in LAYERS.items():
        e = rng.integers(0, N, (B, S, F)).astype(np.int32)
        e[:, int(S * real):] = -1
        e[rng.random(e.shape) < 0.1] = -1
        e = torch.from_numpy(e).cuda()
        h = torch.randn(B, N, D, device="cuda")
        out = torch.empty(B, S, D, device="cuda")
        ref = cs.f_ordered_mean(e, h)
        nbytes = (B * S * F * 4 + cs.unique_rows(e, N) * D * 4
                  + B * S * D * 4)
        bound = cs.add_bound({}, nbytes, 0.0)
        row = []
        for R, threads in CANDIDATES[D] + CANDIDATES[D][::-1]:
            def run(R=R, threads=threads):
                err = launch(e.data_ptr(), h.data_ptr(), B, S, F, N, D, 1, R,
                             threads, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            out.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name}: R {R}, {threads} threads "
                                     f"differs from the f-ordered loop")
            ms, _, _ = cs.time_ms(run)
            row.append(f"R {R} / {threads} thr {ms:.4f}")
        print(f"{name}: edges {(B, S, F)} D {D}, plan "
              f"{forward_plan(D, F, True)}, bound {bound:.5f} ms; device ms: "
              + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
