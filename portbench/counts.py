"""Operations and bytes a training step needs, worked out from its sampled
message-flow graphs (the reference's sampler, ``reference.sample_step``),
never read from the program.

Rooflines follow the rule that each input byte is read once and each output
byte written once, counted for what these inputs need.  The kernels' byte
counts are frozen copies of ``chip_smoke.py``'s (phase 4:
``check_fused_sample``, ``check_sage_aggregate``, ``check_feature_gather``,
``check_gather_rows``; phase 8: the backward); the backward's is of its
gather kernel alone, which reads the transpose ``sage_backward_index``
built, not the edge ids.  A model's GEMM operations are its model file's
(``models/<conv>.py``, ``gemm_flops``).
``bound_s`` turns a count into the least time on one H100 (``h100.py``).
"""
from __future__ import annotations

import torch

from portbench.h100 import FP32_FLOP_PER_S, HBM_BYTES_PER_S

# ~14 32-bit integer operations per drawn slot (hash + modulo), counted
# against the fp32 rate (chip_smoke.py, check_fused_sample)
SAMPLE_OPS = 14.0


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """Least time: the larger of bytes over HBM and operations over fp32."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def summarize(levels, cache=None) -> dict:
    """Counts of one step's levels (top first), per level and worker:
    ``S`` destinations and ``F`` fanout (capacities), ``dst`` valid
    destinations, ``edges`` valid edges, ``refs`` distinct sources the
    valid edges name, ``with_edges`` destinations with a valid edge; per
    worker, ``frontier`` valid ids of the bottom level's sources and
    ``hits`` those the worker's feature cache holds (``cache``: each
    worker's cached ids, the rows of the program's cache; none without
    one);
    and ``fetched``, the distinct nodes whose feature rows the owners
    serve over all workers, the hits left out."""
    out = {"levels": [], "P": int(levels[0].dst.shape[0])}
    for lvl in levels:
        P, S, F = lvl.edges.shape
        valid = lvl.edges >= 0
        rows = []
        for p in range(P):
            rows.append({
                "dst": int((lvl.dst[p] >= 0).sum()),
                "edges": int(valid[p].sum()),
                "refs": int(torch.unique(lvl.edges[p][valid[p]]).numel()),
                "with_edges": int(valid[p].any(-1).sum())})
        out["levels"].append({"S": S, "F": F, "workers": rows})
    src = levels[-1].src
    ok = src >= 0
    hit = torch.zeros_like(ok)
    if cache is not None:
        for p, ids in enumerate(cache):
            hit[p] = ok[p] & torch.isin(src[p], ids)
    out["frontier"] = ok.sum(-1).tolist()
    out["hits"] = hit.sum(-1).tolist()
    out["fetched"] = int(torch.unique(src[ok & ~hit]).numel())
    out["N"] = int(src.shape[1])
    return out


def fused_sample_bound(step: dict) -> float:
    """Least seconds of the step's ``fused_sample`` launches, one a level
    over all workers: seeds read, two row pointers a valid seed, a
    neighbour id a drawn slot, the samples and the row pointer written,
    one overflow count a worker."""
    total = 0.0
    P = step["P"]
    for lvl in step["levels"]:
        S, F = lvl["S"], lvl["F"]
        n_seeds = sum(w["dst"] for w in lvl["workers"])
        n_samples = sum(w["edges"] for w in lvl["workers"])
        nbytes = (P * S * 4 + n_seeds * 8 + n_samples * 4 + P * S * F * 4
                  + P * (S + 1) * 4 + P * 4)
        total += bound_s(nbytes, SAMPLE_OPS * n_samples)
    return total


def feature_gather_bound(step: dict, num_features: int) -> float:
    """Least seconds of the step's one ``feature_gather`` launch: each
    owner serves P request slots of the frontier's capacity N from every
    worker; the ids read, each distinct requested row read once, the
    whole (P, P * N, D) reply written (zero rows for padding)."""
    P, N, D = step["P"], step["N"], num_features
    Q = P * N
    nbytes = P * Q * 4 + step["fetched"] * D * 4 + P * Q * D * 4
    return bound_s(nbytes)


def gather_rows_bound(step: dict, num_features: int) -> float:
    """Least seconds of the step's one ``gather_rows`` launch, the cache
    hits of every worker from its pinned rows: the (P, N) slot ids read,
    each hit row read once (a worker's sources are distinct), the whole
    (P, N, D) output written (zero rows for the misses)."""
    P, N, D = step["P"], step["N"], num_features
    nbytes = P * N * 4 + sum(step["hits"]) * D * 4 + P * N * D * 4
    return bound_s(nbytes)


def sage_aggregate_bounds(model: dict, step: dict) -> tuple[float, float]:
    """(forward, backward) least seconds of the step's ``sage_aggregate``
    launches, one a worker and layer, and of its backward gather, one a
    worker and layer past the first.  Forward: the edge ids, each distinct
    source row the valid edges name, the (S, D) output.  Backward: the
    transpose's row pointer (N + 1) and one slot a valid edge, the
    gradient row and divisor of each destination that has an edge, the
    whole (N, D) gradient written."""
    L = model["num_layers"]
    dims = [model["in_dim"]] + [model["hidden_dim"]] * (L - 1)
    fwd = bwd = 0.0
    for layer in range(L):
        lvl = step["levels"][L - 1 - layer]
        S, F, D = lvl["S"], lvl["F"], dims[layer]
        N = S + S * F
        for w in lvl["workers"]:
            fwd += bound_s(S * F * 4 + w["refs"] * D * 4 + S * D * 4,
                           w["edges"] * D + S * D)
            if layer > 0:
                bwd += bound_s((N + 1) * 4 + w["edges"] * 4
                               + w["with_edges"] * (D * 4 + 4)
                               + N * D * 4, 2.0 * w["edges"] * D)
    return fwd, bwd
