"""The graph-source subsystem (counterpart of ``repro.data``): what to
train on, host-side numpy.

  Sources   ``register_source`` / ``resolve_source`` — "uniform",
            "powerlaw(alpha)", "rmat(a,b,c,d)", "sbm(k,p_in,p_out)".
  Storage   ``save_dataset`` / ``load_dataset`` (the ``repro.data`` v1
            npz, memory-mapped members) + the ``repro_torch.data.ogb``
            converter.
  Splits    ``register_split`` / ``resolve_split`` — "random(frac)",
            "degree_stratified(frac)".
  Ingest    ``iter_edge_chunks`` / ``stream_edges`` /
            ``csc_from_edge_stream`` (+
            ``repro_torch.core.partition.partition_graph_streaming``).
  Spec      ``DataSpec`` + ``resolve_dataset(source_or_path, data_spec)``.
  Stats     ``dataset_stats`` / ``stats_label``.
"""
from repro_torch.data.dataset_io import (FORMAT_VERSION, load_dataset,
                                         save_dataset)
from repro_torch.data.ingest import (csc_from_edge_stream, iter_edge_chunks,
                                     stream_edges)
from repro_torch.data.sources import (GraphSource, available_sources,
                                      parse_source_name, register_source,
                                      resolve_source)
from repro_torch.data.spec import DataSpec, resolve_dataset
from repro_torch.data.splits import (SplitPolicy, apply_split,
                                     available_splits, register_split,
                                     resolve_split)
from repro_torch.data.stats import dataset_stats, stats_label
from repro_torch.data.synthetic_graph import (GraphDataset,
                                              make_power_law_graph,
                                              papers_like, products_like)

__all__ = [
    "DataSpec", "resolve_dataset",
    "GraphSource", "register_source", "resolve_source",
    "available_sources", "parse_source_name",
    "save_dataset", "load_dataset", "FORMAT_VERSION",
    "SplitPolicy", "register_split", "resolve_split", "available_splits",
    "apply_split",
    "iter_edge_chunks", "stream_edges", "csc_from_edge_stream",
    "dataset_stats", "stats_label",
    "GraphDataset", "make_power_law_graph", "products_like", "papers_like",
]
