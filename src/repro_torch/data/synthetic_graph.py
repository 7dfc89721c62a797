"""The ``GraphDataset`` container (counterpart of
``repro.data.synthetic_graph.GraphDataset``)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CSCGraph


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
