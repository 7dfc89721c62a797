"""GraphSAGE with the mean aggregator, the paper's sec. 4 model, as the
benchmark's plain reference runs it (``conv: "sage"``).

A layer maps the sources ``h`` (N, D_in) of its message-flow graph to its
S destinations: ``h[:S] @ w_self + mean(h[edges]) @ w_neigh + b``, then
relu and dropout on every layer but the last.  Plain PyTorch; imports
nothing of the port.
"""
from __future__ import annotations

import torch

from portbench import reference


def init_params(model: dict, seed: int, device) -> list[dict]:
    """He-scaled normal weights and zero biases, drawn on ``device`` from a
    generator seeded with ``seed``, in one call: per layer ``w_self`` then
    ``w_neigh`` (d_in, d_out) and ``b`` (d_out,)."""
    dims = reference.layer_dims(model)
    shapes = [(dims[i], dims[i + 1]) for i in range(model["num_layers"])]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(2 * a * b for a, b in shapes), generator=gen,
                       device=device)
    params, at = [], 0
    for d_in, d_out in shapes:
        layer = {}
        for name in ("w_self", "w_neigh"):
            layer[name] = (flat[at:at + d_in * d_out].view(d_in, d_out)
                           * (2.0 / d_in) ** 0.5).contiguous()
            at += d_in * d_out
        layer["b"] = torch.zeros(d_out, device=device)
        params.append(layer)
    return params


def forward(params, levels, p: int, h0: torch.Tensor, model: dict,
            gen: torch.Generator, mm) -> torch.Tensor:
    """Worker ``p``'s logits from its fetched rows ``h0``, layer 1 eating
    the bottom level; every product through ``mm``."""
    L = model["num_layers"]
    h = h0
    for layer in range(L):
        edges = levels[L - 1 - layer].edges[p]
        S = edges.shape[0]
        agg = reference.neighbour_mean(h, edges)
        w = params[layer]
        out = mm(h[:S], w["w_self"]) + mm(agg, w["w_neigh"]) + w["b"]
        if layer < L - 1:
            out = reference.dropout(torch.relu(out), model["dropout"], gen)
        h = out
    return h


def gemm_flops(model: dict, step: dict) -> dict:
    """The model's GEMM operations in one step (``counts.summarize``'s
    counts): the forward's two products a layer (self and neighbour) on
    the valid destination rows, the backward's weight gradients, and its
    input gradients for every layer but the first, whose input is the
    fetched features."""
    L = model["num_layers"]
    dims = reference.layer_dims(model)
    fwd = wgrad = igrad = 0.0
    for layer in range(L):
        lvl = step["levels"][L - 1 - layer]
        rows = sum(w["dst"] for w in lvl["workers"])
        per = 2 * 2.0 * rows * dims[layer] * dims[layer + 1]
        fwd += per
        wgrad += per
        if layer > 0:
            igrad += per
    return {"forward": fwd, "weight_grad": wgrad, "input_grad": igrad,
            "total": fwd + wgrad + igrad}
