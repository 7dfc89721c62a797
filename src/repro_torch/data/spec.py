"""``DataSpec`` — declarative graph-source configuration — and the resolver
that turns (name-or-path, spec) into a ``GraphDataset`` (counterpart of
``repro.data.spec``).

``source`` is a registry name (optionally parameterized:
``"powerlaw(2.1)"``) or the path of a saved dataset; the other fields
parameterize synthetic generation and are ignored for files.
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What graph to serve or train on.

    source:       graph-source registry name (``repro_torch.data.sources``:
                  "uniform", "powerlaw(alpha)", "rmat(a,b,c,d)",
                  "sbm(k,p_in,p_out)") or the path of a dataset saved
                  with ``repro_torch.data.save_dataset`` (or ``repro``'s).
    num_nodes / avg_degree: synthetic size knobs (the edge draw targets
                  ``num_nodes * avg_degree`` before self-loop removal).
    num_features / num_classes: feature width / label arity.
    split:        split-policy registry name (``"random(frac)"`` or
                  ``"degree_stratified(frac)"``).
    seed:         generation seed; same (source, spec) => bit-identical
                  dataset.
    """
    source: str = "powerlaw(1.8)"
    num_nodes: int = 2000
    avg_degree: int = 8
    num_features: int = 16
    num_classes: int = 8
    split: str = "random(0.3)"
    seed: int = 0

    def __post_init__(self):
        from repro_torch.data.sources import available_sources, resolve_source
        from repro_torch.data.splits import resolve_split

        if self.num_nodes < 2:
            raise ValueError(f"num_nodes must be >= 2, got {self.num_nodes}")
        for field in ("avg_degree", "num_features", "num_classes"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"{field} must be >= 1, got {getattr(self, field)}")
        try:
            resolve_split(self.split)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if not _looks_like_path(self.source):
            try:
                resolve_source(self.source)
            except KeyError:
                raise ValueError(
                    f"unknown graph source {self.source!r} (and no such "
                    f"file); valid sources: {available_sources()}") \
                    from None


def _looks_like_path(source: str) -> bool:
    """An existing file, a ``*.npz`` name or anything with a separator."""
    return (os.path.exists(source) or source.endswith(".npz")
            or os.sep in source)


def resolve_dataset(source: str | None = None, data: DataSpec | None = None,
                    *, mmap: bool = True):
    """Materialize the dataset named by ``source`` (or ``data.source``):
    a path loads through ``load_dataset`` (memory-mapped unless
    ``mmap=False``); a name generates with the spec's parameters."""
    from repro_torch.data.dataset_io import load_dataset
    from repro_torch.data.sources import resolve_source

    if source is None and data is None:
        raise ValueError("no dataset named: pass a source name or path, or "
                         "a DataSpec")
    if data is None:
        data = DataSpec(source=str(source))
    source = data.source if source is None else str(source)
    if _looks_like_path(source):
        return load_dataset(source, mmap=mmap)
    return resolve_source(source).generate(
        data.num_nodes, data.avg_degree,
        num_features=data.num_features, num_classes=data.num_classes,
        split=data.split, seed=data.seed)
