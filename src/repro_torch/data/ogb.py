"""OGB node-property dataset converter (optional dependency; counterpart
of ``repro.data.ogb``).

Converts an ``ogb.nodeproppred`` dataset (ogbn-products, ogbn-arxiv,
ogbn-papers100M, ...) into the ``repro.data`` on-disk format, so a real
graph rides the same ``Pipeline.build_from_source(path, spec)`` entry as
the synthetic families.  The ``ogb`` package is optional: a conversion
without it raises an ``ImportError`` saying so, and importing this module
never needs it.  ``NodePropPredDataset`` reads (and, when they are not
under ``--root``, downloads) OGB's files.

  python -m repro_torch.data.ogb ogbn-arxiv --root ogb-data \\
      --out datasets/ogbn-arxiv.npz
"""
from __future__ import annotations

import importlib.util

import numpy as np

from repro_torch.core.graph import csc_from_numpy_edges
from repro_torch.data.synthetic_graph import GraphDataset

# whether the optional package is installed (found, not imported)
HAVE_OGB = importlib.util.find_spec("ogb") is not None


def _node_prop_dataset():
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError:
        raise ImportError(
            "converting OGB datasets needs the optional 'ogb' package "
            "(pip install ogb), which this environment does not ship; "
            "generate a synthetic stand-in instead, e.g. "
            "Pipeline.build_from_source('powerlaw(1.8)', spec)") from None
    return NodePropPredDataset


def from_ogb(name: str, root: str = "ogb-data") -> GraphDataset:
    """OGB dataset ``name`` as a ``GraphDataset``: train-split nodes keep
    their labels, validation and test nodes are -1 (the labeled-mask
    convention)."""
    dataset = _node_prop_dataset()(name=name, root=root)
    graph_dict, node_labels = dataset[0]
    split = dataset.get_idx_split()

    n = int(graph_dict["num_nodes"])
    src, dst = graph_dict["edge_index"]          # OGB: row 0 = src
    graph = csc_from_numpy_edges(np.asarray(dst, np.int64),
                                 np.asarray(src, np.int64), n)

    feats = np.asarray(graph_dict["node_feat"], np.float32)
    labels = np.full(n, -1, np.int32)
    train = np.asarray(split["train"], np.int64)
    flat = np.asarray(node_labels).reshape(-1).astype(np.int32)
    labels[train] = flat[train]
    return GraphDataset(graph=graph, features=feats, labels=labels,
                        num_classes=int(flat.max()) + 1, name=name)


def convert(name: str, out_path: str, root: str = "ogb-data") -> str:
    """``from_ogb`` + ``save_dataset``; returns the path written."""
    from repro_torch.data.dataset_io import save_dataset
    return save_dataset(from_ogb(name, root=root), out_path)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("name", help="OGB dataset name, e.g. ogbn-arxiv")
    ap.add_argument("--root", default="ogb-data",
                    help="OGB's file directory")
    ap.add_argument("--out", required=True,
                    help="output .npz path (repro.data format)")
    args = ap.parse_args(argv)
    print(f"wrote {convert(args.name, args.out, root=args.root)}")


if __name__ == "__main__":
    main()
