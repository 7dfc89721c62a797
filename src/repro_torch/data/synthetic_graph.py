"""Synthetic power-law graphs standing in for ogbn-products /
papers100M, and the ``GraphDataset`` container (counterpart of
``repro.data.synthetic_graph``).

Chung-Lu-style power-law graphs with class-clustered edges and
class-conditioned Gaussian features, at the paper's feature widths
(products: 100 features / 47 classes, papers100M: 128 / 172).  The draws
are ``repro``'s, in its order, from one ``np.random.default_rng(seed)``,
so the datasets are bit-identical to ``repro``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CSCGraph, csc_from_numpy_edges


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    graph: CSCGraph             # on the CPU
    features: np.ndarray        # (n, D) float32
    labels: np.ndarray          # (n,) int32, -1 = unlabeled
    num_classes: int
    name: str = "synthetic"

    @property
    def labeled_mask(self) -> np.ndarray:
        return self.labels >= 0


def make_power_law_graph(num_nodes: int, avg_degree: int, *,
                         num_features: int = 100, num_classes: int = 47,
                         labeled_fraction: float = 0.3,
                         alpha: float = 1.8, seed: int = 0,
                         homophily: float = 0.6) -> GraphDataset:
    """Chung-Lu power-law graph with class-clustered edges: an edge
    connects same-class nodes with probability about ``homophily``, so a
    GNN has structure to learn."""
    rng = np.random.default_rng(seed)
    n = num_nodes
    m = num_nodes * avg_degree

    # power-law node weights -> hub-heavy degree profile
    w = rng.pareto(alpha, n) + 1.0
    p = w / w.sum()

    labels_all = rng.integers(0, num_classes, n).astype(np.int32)

    # endpoints proportional to weight; a homophilous share of the edges
    # draws its destination among the source's class
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    same = rng.random(m) < homophily
    order = np.argsort(labels_all, kind="stable")
    class_starts = np.searchsorted(labels_all[order],
                                   np.arange(num_classes + 1))
    cls = labels_all[src[same]]
    lo = class_starts[cls]
    hi = class_starts[cls + 1]
    pick = lo + (rng.random(cls.size) * np.maximum(hi - lo, 1)
                 ).astype(np.int64)
    dst[same] = order[np.minimum(pick, n - 1)]

    keep = src != dst
    src, dst = src[keep], dst[keep]
    graph = csc_from_numpy_edges(dst.astype(np.int64), src.astype(np.int64),
                                 n)

    centers = rng.normal(0, 1, (num_classes, num_features)).astype(np.float32)
    feats = (centers[labels_all]
             + rng.normal(0, 1.5, (n, num_features)).astype(np.float32))

    labels = labels_all.copy()
    labels[rng.random(n) >= labeled_fraction] = -1

    return GraphDataset(graph=graph, features=feats, labels=labels,
                        num_classes=num_classes, name=f"powerlaw-n{n}")


def products_like(scale: int = 1, seed: int = 0) -> GraphDataset:
    """ogbn-products shaped: 100 features, 47 classes, average degree
    24."""
    return make_power_law_graph(25_000 * scale, 24, num_features=100,
                                num_classes=47, seed=seed)


def papers_like(scale: int = 1, seed: int = 0) -> GraphDataset:
    """ogbn-papers100M shaped: 128 features, 172 classes, average degree
    14, 1 % labeled."""
    return make_power_law_graph(40_000 * scale, 14, num_features=128,
                                num_classes=172, labeled_fraction=0.01,
                                seed=seed)


# the paper's Table 1 (full-scale sizes), for the storage analytics beside
# the synthetic stand-ins' own statistics
PAPER_TABLE1 = {
    "ogbn-products": dict(nodes=2_500_000, edges=124_000_000,
                          features=100, classes=47),
    "ogbn-papers100M": dict(nodes=111_000_000, edges=3_200_000_000,
                            features=128, classes=172),
    "MAG240M": dict(nodes=244_160_499, edges=1_728_364_232, features=768,
                    classes=153),
    "IGBH-full": dict(nodes=269_364_174, edges=3_995_777_033, features=1024,
                      classes=2983),
}
