"""Message Flow Graphs (MFGs): the padded bipartite graphs of §3.1.

Counterpart of ``repro.core.mfg``.  Every field may carry a leading worker
dimension (the port writes the per-worker program over an explicit leading
P axis); the trailing dimensions are those of ``repro``:

  dst_nodes   (..., S)        global ids of the target nodes (the seeds)
  src_nodes   (..., S + S*F)  global ids of the sources, padded with -1;
                              the first S entries are ``dst_nodes``
  num_src     (...)           number of valid entries in src_nodes
  edges       (..., S, F)     local src index per sampled edge, -1 invalid
  edge_mask   (..., S, F)     validity mask
  indptr      (..., S + 1)    the fused-CSC row pointer R_l of Algorithm 1
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.sage_aggregate import sage_aggregate_plain


@dataclasses.dataclass(frozen=True)
class MFG:
    dst_nodes: torch.Tensor
    src_nodes: torch.Tensor
    num_src: torch.Tensor
    edges: torch.Tensor
    edge_mask: torch.Tensor
    indptr: torch.Tensor

    @property
    def num_dst(self) -> int:
        return self.dst_nodes.shape[-1]

    @property
    def src_capacity(self) -> int:
        return self.src_nodes.shape[-1]

    @property
    def fanout(self) -> int:
        return self.edges.shape[-1]


def mean_aggregate(mfg: MFG, h_src: torch.Tensor) -> torch.Tensor:
    """Masked mean of sampled-neighbour features per target node.

    h_src: (..., src_capacity, D) features aligned with ``mfg.src_nodes``.
    Returns (..., num_dst, D).  Plain PyTorch on any device; the CUDA
    kernel in ``repro_torch.kernels.sage_aggregate`` computes the same
    quantity.
    """
    return sage_aggregate_plain(mfg.edges, h_src)
