"""Synthetic graph sources, split policies and the dataset spec (host-side
numpy; counterparts of ``repro.data``)."""
from repro_torch.data.sources import (available_sources, register_source,
                                      resolve_source)
from repro_torch.data.spec import DataSpec, resolve_dataset
from repro_torch.data.splits import apply_split, resolve_split
from repro_torch.data.synthetic_graph import GraphDataset

__all__ = ["DataSpec", "GraphDataset", "apply_split", "available_sources",
           "register_source", "resolve_dataset", "resolve_source",
           "resolve_split"]
