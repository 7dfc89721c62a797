#!/usr/bin/env python3
"""A/B of ``fused_sample``'s two scan tiles on one CUDA card, one process.

    python3 tools/scan_tile_ab.py        # from the repository root

``repro_torch.kernels.fused_sample`` picks 256 seeds per scan tile (one per
thread) for small levels and 1024 (four per thread) past ``LARGE_LEVEL``
seeds.  This script forces each tile size in turn (256, 1024, 1024, 256) on
the same seeded inputs, checks the result equals the plain version, and
prints the kernel's device time per call from a ``torch.profiler`` trace of
50 calls.  The graph is synthetic: 500 000 nodes with Pareto in-degrees
capped at 11 361 (the largest in-degree of ``chip_smoke.py``'s graph),
neighbours uniform; the shapes are those of one training step's and one
128-seed ``predict``'s levels (4 workers).
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.kernels.fused_sample as fsm  # noqa: E402

REPS = 50
# (B, S, fanout, share of padding seeds)
LEVELS = ((4, 176000, 5, 0.4), (4, 16000, 10, 0.1), (4, 2048, 10, 0.0),
          (4, 22528, 5, 0.3))


def kernel_ms(fn) -> float:
    """Device ms per call of ``fused_sample_kernel``; a trace that comes
    back without it is taken again, up to five times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ms = [e.device_time_total / REPS / 1e3 for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and "fused_sample_kernel" in e.key]
        if ms:
            return ms[0]
    raise RuntimeError("five traces without fused_sample_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_tile_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    n = 500_000
    deg = np.minimum((rng.pareto(0.8, n) * 6).astype(np.int64), 11361)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32)).cuda()
    indices = torch.from_numpy(rng.integers(0, n, int(deg.sum()),
                                            dtype=np.int32)).cuda()
    print(f"graph: {n} nodes, {int(deg.sum())} edges")
    chosen = fsm.seeds_per_tile
    try:
        for B, S, fanout, pad in LEVELS:
            s = rng.integers(0, n, (B, S)).astype(np.int32)
            s[rng.random((B, S)) < pad] = -1
            s = torch.from_numpy(s).cuda()
            ref = fsm.fused_sample_plain(indptr, indices, s, 3,
                                         fanout=fanout)
            for tile in (fsm.SMALL_TILE, fsm.LARGE_TILE, fsm.LARGE_TILE,
                         fsm.SMALL_TILE):
                fsm.seeds_per_tile = lambda num, t=tile: t
                got = fsm.fused_sample(indptr, indices, s, 3, fanout=fanout)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError("fused_sample differs from the "
                                         "plain version")
                ms = kernel_ms(lambda: fsm.fused_sample(indptr, indices, s,
                                                        3, fanout=fanout))
                print(f"seeds {(B, S)} fanout {fanout}: {tile}-seed tiles"
                      f"{' (chosen)' if chosen(B * S) == tile else ''}: "
                      f"fused_sample_kernel {ms:.4f} ms")
    finally:
        fsm.seeds_per_tile = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
