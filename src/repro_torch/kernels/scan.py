"""Scratch for the single-pass scan of ``csrc/scan.cuh``.

The scan's kernels take their tile ids from a counter and publish one
64-bit status word per tile; both must be zero when the launch starts, so
the wrapper allocates them with ``torch.zeros`` on the current stream on
every call (the kernels allocate nothing).  Extra int32 counters that the
same launch accumulates into (``fused_sample``'s overflow count, the
backward transpose's histogram) share the same buffer, so one fill clears
them all.
"""
from __future__ import annotations

import torch

THREADS = 256       # threads per block: scan::kThreads in csrc/scan.cuh


def scan_tiles(n: int, tile: int) -> int:
    """Tiles of ``tile`` items (a multiple of ``THREADS``) that cover
    ``n`` items; at least one, so a row of no items still gets its block
    (which writes ``R[b, 0] = 0``)."""
    return max(1, -(-int(n) // tile))


def scan_scratch(tiles: int, n_int32: int, device) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """One zeroed int64 buffer: ``tiles`` status words, the tile counter,
    then ``n_int32`` int32 zeros.  Returns ``(buffer, the int32 part)``."""
    words = tiles + 1 + (n_int32 + 1) // 2
    buf = torch.zeros(words, dtype=torch.int64, device=device)
    return buf, buf[tiles + 1:].view(torch.int32)[:n_int32]
