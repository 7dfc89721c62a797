"""Chunked-edge ingest: CSC topology and partitions from edge streams
instead of one in-memory COO (counterpart of ``repro.data.ingest``).

An edge stream yields ``(dst, src)`` pairs of equal-length integer arrays.
A consumer that takes two passes is given a re-iterable (a list of chunks)
or a zero-argument factory returning a fresh iterator per pass.

  ``iter_edge_chunks(graph, chunk_edges)``  an in-memory ``CSCGraph``'s
      edges in CSC order, ``chunk_edges`` at a time.
  ``stream_edges(path, chunk_edges)``  an on-disk dataset's edges chunk by
      chunk; ``indices`` stays memory-mapped, so a chunk touches only its
      own pages.
  ``csc_from_edge_stream(stream, num_nodes)``  two-pass CSC construction
      (count, then scatter) with one chunk of COO resident at a time,
      bit-identical to ``csc_from_numpy_edges`` on the concatenated edges.

``partition_graph_streaming`` (``repro_torch.core.partition``) consumes
the same streams.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.graph import CSCGraph, csr_view


def _passes(stream) -> Callable[[], Iterable]:
    """A fresh-iterator factory for ``stream``.  A one-shot generator is
    refused: buffering it whole would hold every chunk at once."""
    if callable(stream):
        return stream
    if isinstance(stream, (list, tuple)):
        return lambda: iter(stream)
    raise TypeError(
        "stream must be a list/tuple of (dst, src) chunks or a "
        "zero-argument factory returning a fresh iterator (two passes "
        "are taken); wrap a generator in a lambda, e.g. "
        "csc_from_edge_stream(lambda: stream_edges(path), n)")


def iter_edge_chunks(graph: CSCGraph, chunk_edges: int = 1 << 20
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield int64 ``(dst, src)`` chunks of an in-memory CSC, in edge
    order."""
    if chunk_edges < 1:
        raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
    indices = graph.numpy()[1]
    dsts = csr_view(graph).dsts
    for lo in range(0, indices.size, chunk_edges):
        hi = min(lo + chunk_edges, indices.size)
        yield dsts[lo:hi].astype(np.int64), indices[lo:hi].astype(np.int64)


def stream_edges(source, chunk_edges: int = 1 << 20
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield int64 ``(dst, src)`` chunks of an on-disk dataset without
    loading the edge list: ``indices`` stays memory-mapped and each
    chunk's destinations are expanded from ``indptr``.  ``source`` is a
    dataset path or a loaded ``GraphDataset`` (pass the loaded one when
    streaming more than once, so the file is opened and checked once)."""
    from repro_torch.data.dataset_io import load_dataset

    if chunk_edges < 1:
        raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
    ds = source if hasattr(source, "graph") else \
        load_dataset(source, mmap=True)
    indptr_np, indices = ds.graph.numpy()        # indices: the mapped file
    indptr = indptr_np.astype(np.int64)
    nnz = int(indptr[-1])
    for lo in range(0, max(nnz, 1), chunk_edges):
        hi = min(lo + chunk_edges, nnz)
        if hi <= lo:
            return
        # destinations of edge range [lo, hi): expand the touched rows
        row_lo = int(np.searchsorted(indptr, lo, side="right") - 1)
        row_hi = int(np.searchsorted(indptr, hi, side="left"))
        local_ptr = np.clip(indptr[row_lo:row_hi + 1], lo, hi) - lo
        dst = np.repeat(np.arange(row_lo, row_hi, dtype=np.int64),
                        np.diff(local_ptr))
        yield dst, np.asarray(indices[lo:hi], np.int64)


def csc_from_edge_stream(stream, num_nodes: int) -> CSCGraph:
    """Two-pass streaming CSC construction: pass 1 counts in-degrees,
    pass 2 writes each chunk's sources into its destinations' slots in
    arrival order (the stable sort's order).  ``stream`` is a list of
    ``(dst, src)`` chunks or a factory of fresh iterators.  The result
    lies on the CPU."""
    make = _passes(stream)

    counts = np.zeros(num_nodes, np.int64)
    for dst, _ in make():
        counts += np.bincount(np.asarray(dst, np.int64),
                              minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    if nnz > np.iinfo(np.int32).max:
        raise ValueError(
            f"edge stream has {nnz:,} edges, beyond the int32 CSC limit "
            f"({np.iinfo(np.int32).max:,}); shard the graph first")

    indices = np.empty(nnz, np.int32)
    cursor = indptr[:-1].copy()                 # next free slot per row
    for dst, src in make():
        dst = np.asarray(dst, np.int64)
        src = np.asarray(src, np.int64)
        if dst.shape != src.shape:
            raise ValueError("edge chunk dst/src length mismatch")
        order = np.argsort(dst, kind="stable")
        dst_s, src_s = dst[order], src[order]
        uniq, starts = np.unique(dst_s, return_index=True)
        seg_counts = np.diff(np.append(starts, dst_s.size))
        # slot of each sorted edge: its row's cursor + rank within chunk
        base = np.repeat(cursor[uniq], seg_counts)
        rank = np.arange(dst_s.size) - np.repeat(starts, seg_counts)
        indices[base + rank] = src_s.astype(np.int32)
        cursor[uniq] += seg_counts

    if not np.array_equal(cursor, indptr[1:]):
        raise ValueError("edge stream changed between passes "
                         "(counts != filled slots)")
    return CSCGraph(indptr=torch.from_numpy(indptr.astype(np.int32)),
                    indices=torch.from_numpy(indices))
