"""Dataset shape and skew statistics (counterpart of
``repro.data.stats``).

``degree_skew`` is the coefficient of variation of the in-degree
distribution (std / mean).  ``top1pct_edge_share`` is the share of all
in-edges owned by the top 1 % in-degree nodes — what ``hybrid_partial``'s
replicated hot set, a top-degree slice, cashes in on.
"""
from __future__ import annotations

import numpy as np


def dataset_stats(ds) -> dict:
    """Shape and skew summary of a ``GraphDataset`` (plain-JSON
    values)."""
    indptr = ds.graph.numpy()[0].astype(np.int64)
    deg = np.diff(indptr)
    n = int(indptr.shape[0] - 1)
    nnz = int(indptr[-1])
    mean = nnz / max(n, 1)
    std = float(deg.std())
    k = max(n // 100, 1)
    top = np.sort(deg)[-k:]
    return {
        "dataset": ds.name,
        "num_nodes": n,
        "num_edges": nnz,
        "max_degree": int(deg.max()) if n else 0,
        "mean_degree": round(mean, 2),
        "degree_skew": round(std / max(mean, 1e-9), 3),
        "top1pct_edge_share": round(float(top.sum()) / max(nnz, 1), 4),
        "labeled_nodes": int((np.asarray(ds.labels) >= 0).sum()),
    }


def stats_label(stats: dict) -> str:
    """Compact one-line rendering of ``dataset_stats``."""
    return (f"{stats['dataset']} n={stats['num_nodes']} "
            f"nnz={stats['num_edges']} skew={stats['degree_skew']} "
            f"top1%={stats['top1pct_edge_share']:.0%}")
