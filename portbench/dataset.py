"""The benchmark's datasets: generated from a configuration file, partitioned
offline, and kept on disk between runs.

A configuration's graph is its dataset, fixed as a public dataset is: it
does not change with ``--seed``.  The first run of a configuration in a
checkout generates it with ``power_law_graph`` (a frozen copy of
``repro_torch.data.synthetic_graph.make_power_law_graph``), partitions it
with ``ldg_assign`` (a frozen copy of ``repro_torch.core.partition``'s
BFS-ordered LDG, ``partition_graph``) and writes both under
``build/portbench/<config>-<hash of the config file>-ldg-p<parts>/``.
The directory is written under a temporary name and renamed into place,
so a run killed mid-write leaves nothing that a later run would load.
Later runs memory-map it, as a real job loads partitions made offline.

Plain NumPy; nothing here imports the port.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from collections import deque
from pathlib import Path

import numpy as np

FILES = ("indptr", "indices", "features", "labels", "assign")


def power_law_graph(num_nodes: int, avg_degree: int, *, num_features: int,
                    num_classes: int, labeled_fraction: float, alpha: float,
                    homophily: float, seed: int):
    """Chung-Lu power-law graph with class-clustered edges and
    class-conditioned Gaussian features.  Frozen copy of
    ``src/repro_torch/data/synthetic_graph.py:make_power_law_graph``: the
    same draws in the same order from one ``np.random.default_rng(seed)``.

    Returns (indptr (n+1,) int32, indices (nnz,) int32, features (n, D)
    float32, labels (n,) int32 with -1 for unlabelled nodes); in-edges of
    a node in generation order (a stable sort by destination)."""
    rng = np.random.default_rng(seed)
    n = num_nodes
    m = num_nodes * avg_degree
    w = rng.pareto(alpha, n) + 1.0
    p = w / w.sum()
    labels_all = rng.integers(0, num_classes, n).astype(np.int32)
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
    by_dst = np.argsort(dst, kind="stable")
    indices = src[by_dst].astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    del src, dst, by_dst
    centers = rng.normal(0, 1, (num_classes, num_features)).astype(np.float32)
    feats = (centers[labels_all]
             + rng.normal(0, 1.5, (n, num_features)).astype(np.float32))
    labels = labels_all.copy()
    labels[rng.random(n) >= labeled_fraction] = -1
    return indptr, indices, feats, labels


def _out_adjacency(indptr: np.ndarray, indices: np.ndarray):
    """The out-edges of a CSC graph: a stable transpose (CSR)."""
    n = indptr.shape[0] - 1
    dsts = np.repeat(np.arange(n), np.diff(indptr))
    out_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=out_indptr[1:])
    return out_indptr, dsts[np.argsort(indices, kind="stable")]


def _bfs_order(out_indptr, out_indices, n, rng):
    seen = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    k = 0
    starts = rng.permutation(n)
    si = 0
    q: deque[int] = deque()
    while k < n:
        while si < n and seen[starts[si]]:
            si += 1
        if si < n and not q:
            q.append(starts[si])
            seen[starts[si]] = True
        while q:
            v = q.popleft()
            order[k] = v
            k += 1
            for u in out_indices[out_indptr[v]:out_indptr[v + 1]]:
                if not seen[u]:
                    seen[u] = True
                    q.append(u)
    return order


def ldg_assign(indptr: np.ndarray, indices: np.ndarray, num_parts: int,
               labeled: np.ndarray, *, seed: int = 0,
               slack: float = 1.05) -> np.ndarray:
    """BFS-ordered linear deterministic greedy over in- and out-neighbours,
    balancing nodes and labelled nodes per partition.  Frozen copy of
    ``src/repro_torch/core/partition.py`` (``partition_graph``,
    ``_bfs_order``, ``_LDGState.place``) with ``labeled_slack = slack``.
    Returns (n,) int32 in [0, num_parts)."""
    n = indptr.shape[0] - 1
    labeled = np.asarray(labeled, bool)
    out_indptr, out_indices = _out_adjacency(indptr, indices)
    order = _bfs_order(out_indptr, out_indices, n, np.random.default_rng(seed))
    cap_nodes = slack * n / num_parts
    cap_labeled = max(1.0, slack * labeled.sum() / num_parts)
    assign = np.full(n, -1, np.int32)
    load_nodes = np.zeros(num_parts)
    load_labeled = np.zeros(num_parts)
    for v in order:
        nb = np.concatenate([indices[indptr[v]:indptr[v + 1]],
                             out_indices[out_indptr[v]:out_indptr[v + 1]]])
        score = np.zeros(num_parts)
        if nb.size:
            anb = assign[nb]
            anb = anb[anb >= 0]
            if anb.size:
                score = np.bincount(anb, minlength=num_parts).astype(float)
        penalty = 1.0 - load_nodes / cap_nodes
        full = load_nodes >= cap_nodes
        if labeled[v]:
            full = full | (load_labeled >= cap_labeled)
        gain = np.where(full, -np.inf,
                        (score + 1e-3) * np.maximum(penalty, 1e-6))
        if np.isfinite(gain).any():
            p = int(np.argmax(gain))
        else:
            ok = load_nodes < cap_nodes
            p = int(np.argmin(np.where(ok, load_labeled, np.inf)))
        assign[v] = p
        load_nodes[p] += 1
        if labeled[v]:
            load_labeled[p] += 1
    return assign


def config_key(config_path: Path) -> str:
    """``<config>-<first 16 hex digits of the file's sha256>``."""
    digest = hashlib.sha256(Path(config_path).read_bytes()).hexdigest()
    return f"{Path(config_path).stem}-{digest[:16]}"


def generate(cfg: dict, num_parts: int) -> dict:
    """The configuration's dataset and its LDG assignment, in memory."""
    indptr, indices, feats, labels = power_law_graph(
        cfg["num_nodes"], cfg["avg_degree"],
        num_features=cfg["num_features"], num_classes=cfg["num_classes"],
        labeled_fraction=cfg["labeled_fraction"], alpha=cfg["alpha"],
        homophily=cfg["homophily"], seed=cfg["graph_seed"])
    assign = ldg_assign(indptr, indices, num_parts, labels >= 0,
                        seed=cfg["partition_seed"])
    return {"indptr": indptr, "indices": indices, "features": feats,
            "labels": labels, "assign": assign}


def load_or_build(config_path: Path, cache_root: Path, num_parts: int,
                  partitioner: str = "ldg", log=print) -> tuple[dict, bool]:
    """The dataset of ``config_path`` partitioned into ``num_parts`` by
    ``partitioner`` (``ldg``, the one the benchmark has), memory-mapped
    from ``cache_root``; generated and written there first if it is
    missing.  Returns (arrays by name, whether this call built it)."""
    if partitioner != "ldg":
        raise ValueError(f"the benchmark partitions by 'ldg' only, not "
                         f"{partitioner!r}")
    config_path = Path(config_path)
    cfg = json.loads(config_path.read_text())
    final = Path(cache_root) / (f"{config_key(config_path)}-{partitioner}"
                                f"-p{num_parts}")
    built = False
    if not (final / "done.json").is_file():
        built = True
        log(f"portbench: generating {final.name} (first run of this "
            f"configuration in this checkout)")
        arrays = generate(cfg, num_parts)
        tmp = final.parent / f".{final.name}.partial"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for name in FILES:
            np.save(tmp / f"{name}.npy", arrays[name])
        (tmp / "done.json").write_text(json.dumps(
            {name: list(arrays[name].shape) for name in FILES}))
        del arrays
        if final.exists():           # an incomplete directory of another run
            shutil.rmtree(final)
        os.replace(tmp, final)
    return {name: np.load(final / f"{name}.npy", mmap_mode="r")
            for name in FILES}, built
