"""Exact layer-wise GNN inference (no sampling): counterpart of
``repro.core.inference``.

Sampling-based training is evaluated with full-neighbourhood inference
(the DistDGL/DGL convention): propagate layer by layer over all nodes,
each layer in node batches whose MFG holds every in-edge (fanout = the
max in-degree, padded with -1).  This gives the exact h^L of every node,
the number reported as test accuracy, as opposed to the sampled estimate
of training and serving.

``full_neighborhood_level`` builds ``repro``'s MFG (relabelled, sources
padded to the capacity S + S * F).  ``layerwise_inference`` gives the same
logits without it: a batch's edges keep their global source ids and the
aggregate reads the layer's whole embedding table, so no batch gathers a
capacity-padded ``h_src`` (5.8 M rows per 512-node batch on a graph of max
in-degree 11 361) or sorts for the relabel.  Each destination row's mean
is the same f-ordered sum over the same rows, and the products run in
``rowwise_matmul``'s fixed row blocks, so neither the batch size nor the
last, shorter batch changes a node's bits.  On the card the aggregate is
the hand-written forward (its wide-row kernel past 8192 ids a row).
Every conv runs: gcn and gin aggregate like sage; gat and gatv1 project
the table once a layer (gat's through ``gat_project``, gatv1's through
``block_matmul``).  gat gathers each batch's attention sources from it,
(batch, width, d_out) floats a batch, so a graph with hubs runs it under a
``max_degree`` cap; gatv1's attention reads each slot's row, its
destinations' too, from the table by global id (its plain version, on the
CPU, gathers (batch, width + 1, H * C) floats).
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.mfg import MFG
from repro_torch.core.sampler import build_indptr, relabel
from repro_torch.models.gnn import (GNNConfig, apply_layer, block_matmul,
                                    gat_project)


def in_edges(graph: CSCGraph, seeds: torch.Tensor, max_degree: int):
    """The first ``max_degree`` in-edges of each seed in CSC order.

    seeds (S,) global ids, -1 padding.  Returns ``(samples (S, max_degree)
    int32 source ids padded with -1, valid (S, max_degree) bool)``.
    """
    seed_ok = seeds >= 0
    v = seeds.clamp(min=0).long()
    start = graph.indptr[v].long()
    deg = torch.where(seed_ok, graph.indptr[v + 1].long() - start, 0)
    col = torch.arange(max_degree, device=seeds.device)[None, :]
    valid = col < deg[:, None]
    if graph.num_edges == 0:
        samples = torch.full(valid.shape, -1, dtype=torch.int32,
                             device=seeds.device)
        return samples, valid
    pos = (start[:, None] + col).clamp(max=graph.num_edges - 1)
    samples = torch.where(valid, graph.indices[pos], -1).to(torch.int32)
    return samples, valid


def full_neighborhood_level(graph: CSCGraph, seeds: torch.Tensor,
                            max_degree: int) -> MFG:
    """Exact (unsampled) one-level MFG: every in-edge of every seed,
    padded to ``max_degree``."""
    samples, valid = in_edges(graph, seeds, max_degree)
    edges, src_nodes, num_src = relabel(seeds, samples, valid)
    return MFG(dst_nodes=seeds, src_nodes=src_nodes, num_src=num_src,
               edges=edges, edge_mask=valid, indptr=build_indptr(valid))


def inference_width(graph: CSCGraph, max_degree: int | None = None) -> int:
    """The fanout every batch is padded to: the max in-degree, capped at
    ``max_degree`` when one is given (>= 1)."""
    max_deg = int(graph.degrees().max()) if graph.num_nodes else 0
    if max_degree is not None:
        if max_degree < 1:
            raise ValueError(f"max_degree must be >= 1, got {max_degree}")
        max_deg = min(max_deg, int(max_degree))
    return max_deg


def layer_pass(layer_params, graph: CSCGraph, h: torch.Tensor,
               cfg: GNNConfig, *, is_last: bool, width: int,
               batch_size: int = 512) -> torch.Tensor:
    """One layer over every node: reads the layer-(l-1) table ``h`` (n,
    D_in) and returns the layer-l table (n, D_out), in node batches of
    ``batch_size`` whose edges name rows of ``h`` by global id, padded to
    ``width``."""
    n = graph.num_nodes
    all_nodes = torch.arange(n, dtype=torch.int32, device=h.device)
    num_src = torch.tensor(n, dtype=torch.int32, device=h.device)
    # gat and gatv1 project the whole table once a layer, not once a
    # batch: the rows of the row-blocked products do not depend on the row
    # count, so the bits are those of a per-batch projection (gatv1 scores,
    # its self slot included, inside its attention)
    projected = None
    if cfg.conv == "gat":
        projected = gat_project(layer_params, h)
    elif cfg.conv == "gatv1":
        projected = (block_matmul(h, layer_params["w_neigh"]),)
    outs = []
    for lo in range(0, n, batch_size):
        seeds = all_nodes[lo:lo + batch_size]
        samples, valid = in_edges(graph, seeds, width)
        # the sources are the whole table: src_nodes[i] == i
        mfg = MFG(dst_nodes=seeds, src_nodes=all_nodes,
                  num_src=num_src,
                  edges=samples, edge_mask=valid,
                  indptr=build_indptr(valid))
        outs.append(apply_layer(layer_params, mfg, h, cfg, is_last=is_last,
                                h_dst=h[lo:lo + batch_size],
                                projected=projected))
    return torch.cat(outs)


def layerwise_inference(params, graph: CSCGraph, features: torch.Tensor,
                        cfg: GNNConfig, *, batch_size: int = 512,
                        max_degree: int | None = None) -> torch.Tensor:
    """Exact logits for every node: L passes over the node set, on the
    device of ``features`` (the graph is moved there).

    Layer l reads the layer-(l-1) embedding table and writes the layer-l
    table; within a pass, nodes are processed in batches of
    ``batch_size`` with full-neighbourhood edges.  Memory: O(num_nodes *
    hidden) for the tables plus one batch's (batch_size, width) edges.

    max_degree: ``None`` pads every batch to the graph's true max
    in-degree (exact).  An int caps the width at ``min(true max degree,
    max_degree)``: a node of in-degree d > max_degree takes the mean over
    its first ``max_degree`` in-edges in CSC order (a deterministic
    truncation, not a subsample); nodes with d <= max_degree are
    unaffected, so any cap >= the true max degree gives the uncapped
    bits.  A cap below 1 raises.
    """
    width = inference_width(graph, max_degree)
    if graph.device != features.device:
        graph = graph.to(features.device)
    h = features.to(torch.float32)
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            h = layer_pass(params[layer], graph, h, cfg,
                           is_last=layer == cfg.num_layers - 1,
                           width=width, batch_size=batch_size)
    return h
