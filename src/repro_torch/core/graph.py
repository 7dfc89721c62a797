"""Graph containers: CSC and COO adjacency and their conversions, the
host-side CSR view, the host hash.

Counterpart of ``repro.core.graph``.  The paper (FastSample §3.2, Fig. 2)
works with a CSC matrix ``A = (R, C)``: ``R`` is the row-pointer vector
(length n+1) and ``C`` the column-index vector (length nnz);
``C[R[k]:R[k+1]]`` are the in-neighbours of node ``k``.  Here both are
int32 tensors on one device.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSCGraph:
    """Compressed-sparse-column adjacency (in-edges per node).

    indptr:  (num_nodes + 1,) int32 — the paper's R vector.
    indices: (nnz,)           int32 — the paper's C vector (source ids).
    """

    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def degrees(self) -> torch.Tensor:
        """In-degree per node: R[k+1] - R[k]."""
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device) -> "CSCGraph":
        return CSCGraph(indptr=self.indptr.to(device),
                        indices=self.indices.to(device))

    def numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Host (indptr, indices) arrays (no copy for CPU tensors)."""
        return self.indptr.cpu().numpy(), self.indices.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class COOGraph:
    """Coordinate-format adjacency: (dst[i], src[i]) per edge (paper Fig.
    2: X = rows, Y = cols), int32 tensors."""

    row: torch.Tensor           # dst node per edge
    col: torch.Tensor           # src node per edge
    num_nodes_hint: int = 0

    @property
    def num_edges(self) -> int:
        return self.row.shape[0]


def coo_to_csc(coo: COOGraph, num_nodes: int | None = None) -> CSCGraph:
    """Sort edges by destination (stable) and build the row-pointer
    vector, on the host; the result lies on the CPU."""
    n = num_nodes if num_nodes is not None else int(coo.num_nodes_hint)
    return csc_from_numpy_edges(coo.row.cpu().numpy().astype(np.int64),
                                coo.col.cpu().numpy().astype(np.int64), n)


def csc_to_coo(g: CSCGraph) -> COOGraph:
    """Expand the row pointers back to per-edge destinations."""
    row = torch.repeat_interleave(
        torch.arange(g.num_nodes, dtype=torch.int32, device=g.device),
        g.degrees().long(), output_size=g.num_edges)
    return COOGraph(row=row, col=g.indices, num_nodes_hint=g.num_nodes)


def csc_from_numpy_edges(dst: np.ndarray, src: np.ndarray,
                         num_nodes: int) -> CSCGraph:
    """Host-side CSC construction (used by the data pipeline /
    partitioner); the result lies on the CPU."""
    order = np.argsort(dst, kind="stable")
    dst_sorted = dst[order]
    src_sorted = src[order]
    counts = np.bincount(dst_sorted, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSCGraph(indptr=torch.from_numpy(indptr),
                    indices=torch.from_numpy(src_sorted.astype(np.int32)))


class CSRView:
    """Lazy host-side companion views of a CSC graph: the per-edge
    destination expansion (``dsts``) and the out-adjacency (``indptr`` /
    ``indices``, a stable transpose), each computed once on first access.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.csc_indptr = np.asarray(indptr)
        self.csc_indices = np.asarray(indices)

    @property
    def num_nodes(self) -> int:
        return self.csc_indptr.shape[0] - 1

    @cached_property
    def dsts(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_nodes),
                         np.diff(self.csc_indptr))

    @cached_property
    def indptr(self) -> np.ndarray:
        counts = np.bincount(self.csc_indices, minlength=self.num_nodes)
        out = np.zeros(self.num_nodes + 1, np.int64)
        np.cumsum(counts, out=out[1:])
        return out

    @cached_property
    def indices(self) -> np.ndarray:
        order = np.argsort(self.csc_indices, kind="stable")
        return self.dsts[order]


def csr_view(g: CSCGraph) -> CSRView:
    """``CSRView`` of ``g``, memoized on the graph object so partitioning
    and ``build_layout`` share one set of derived arrays."""
    view = getattr(g, "_csr_view_cache", None)
    if view is None:
        view = CSRView(*g.numpy())
        object.__setattr__(g, "_csr_view_cache", view)
    return view


def csr_view_release(g: CSCGraph) -> None:
    """Drop ``g``'s memoized ``CSRView`` so its O(nnz) arrays can be
    collected."""
    if getattr(g, "_csr_view_cache", None) is not None:
        object.__setattr__(g, "_csr_view_cache", None)


def mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, vectorized (uint64 in/out, wraps silently):
    the host-side deterministic hash of the split policies and seed
    draws."""
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def validate_csc(g: CSCGraph) -> None:
    """Structural invariants of a CSC graph; raises ``ValueError`` on the
    first one broken."""
    indptr, indices = (np.asarray(a) for a in g.numpy())
    if indptr[0] != 0:
        raise ValueError("R[0] must be 0")
    if indptr[-1] != indices.shape[0]:
        raise ValueError("R[-1] must equal nnz")
    if np.any(np.diff(indptr) < 0):
        raise ValueError("R must be non-decreasing")
    if indices.size and (indices.min() < 0
                         or indices.max() >= g.num_nodes):
        raise ValueError("column index out of range")
