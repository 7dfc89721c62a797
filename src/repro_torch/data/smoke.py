"""Every registered synthetic family at toy size: generate, round-trip the
on-disk format and re-check determinism (counterpart of ``python -m
repro.data.smoke``, ``make data-smoke``).

Per family: generate twice (bit-equality), validate the CSC, save -> load
(memory-mapped and eager) and compare exactly, run the chunked ingest
against the in-memory CSC, and hold the streaming partitioner to its
balance cap.  Exits non-zero on the first mismatch.

  PYTHONPATH=src python -m repro_torch.data.smoke [--nodes 400] [--degree 5]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.graph import validate_csc
from repro_torch.core.partition import resolve_partitioner
from repro_torch.data import (available_sources, csc_from_edge_stream,
                              dataset_stats, iter_edge_chunks, load_dataset,
                              resolve_source, save_dataset, stats_label,
                              stream_edges)

SMOKE_PARAMS = {
    "uniform": "uniform",
    "powerlaw": "powerlaw(1.8)",
    "rmat": "rmat(0.57,0.19,0.19,0.05)",
    "sbm": "sbm(4,0.9,0.1)",
}


def _eq(a, b, what: str) -> None:
    if not np.array_equal(np.asarray(a), np.asarray(b)):
        raise SystemExit(f"data-smoke FAILED: {what} mismatch")


def check_family(name: str, num_nodes: int, avg_degree: int,
                 tmpdir: str) -> None:
    def generate():
        return resolve_source(name).generate(
            num_nodes, avg_degree, num_features=6, num_classes=4, seed=7)

    ds, again = generate(), generate()
    validate_csc(ds.graph)
    _eq(ds.graph.indptr, again.graph.indptr, f"{name} determinism")
    _eq(ds.graph.indices, again.graph.indices, f"{name} determinism")
    _eq(ds.features, again.features, f"{name} determinism")
    _eq(ds.labels, again.labels, f"{name} determinism")

    path = save_dataset(ds, os.path.join(tmpdir, name.replace("(", "_")
                                         .replace(")", "").replace(",", "_")))
    for mmap in (True, False):
        back = load_dataset(path, mmap=mmap)
        _eq(back.graph.indptr, ds.graph.indptr, f"{name} roundtrip indptr")
        _eq(back.graph.indices, ds.graph.indices,
            f"{name} roundtrip indices")
        _eq(back.features, ds.features, f"{name} roundtrip features")
        _eq(back.labels, ds.labels, f"{name} roundtrip labels")
        if back.name != ds.name or back.num_classes != ds.num_classes:
            raise SystemExit(f"data-smoke FAILED: {name} roundtrip meta")

    # chunked ingest reproduces the CSC exactly, from memory and disk
    g_mem = csc_from_edge_stream(
        lambda: iter_edge_chunks(ds.graph, chunk_edges=257),
        ds.graph.num_nodes)
    _eq(g_mem.indptr, ds.graph.indptr, f"{name} stream ingest indptr")
    _eq(g_mem.indices, ds.graph.indices, f"{name} stream ingest indices")
    loaded = load_dataset(path)          # load once across both passes
    g_disk = csc_from_edge_stream(
        lambda: stream_edges(loaded, chunk_edges=311), ds.graph.num_nodes)
    _eq(g_disk.indices, ds.graph.indices, f"{name} disk stream indices")

    # the streaming partitioner holds the node balance cap on this family
    P = 4
    assign = resolve_partitioner("ldg").assign_stream(
        iter_edge_chunks(ds.graph, chunk_edges=509),
        ds.graph.num_nodes, P, np.asarray(ds.labels) >= 0)
    counts = np.bincount(assign, minlength=P)
    if (assign < 0).any() or counts.max() > 1.05 * num_nodes / P + 1:
        raise SystemExit(f"data-smoke FAILED: {name} streaming partition")

    print(f"data-smoke OK  {stats_label(dataset_stats(ds))}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--degree", type=int, default=5)
    args = ap.parse_args(argv)

    families = [SMOKE_PARAMS.get(base, base) for base in available_sources()]
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in families:
            check_family(name, args.nodes, args.degree, tmpdir)
    print(f"data-smoke PASSED ({len(families)} source families)")


if __name__ == "__main__":
    main()
