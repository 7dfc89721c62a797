"""GAT, the original (static) attention of Velickovic et al.
(arXiv:1710.10903), as PyTorch Geometric's ``examples/ogbn_products_gat.py``
trains it on neighbour-sampled ogbn-products (``conv: "gatv1"``): the
benchmark's plain reference.  Written from the layer's equations, in plain
PyTorch; imports nothing of the port.

A layer maps the sources ``h`` (N, D_in) of its message-flow graph to its S
destinations (the first S sources) with H heads of width C:

* ``z = h @ w_neigh`` (one shared projection, PyG's ``lin_src`` =
  ``lin_dst``), every source row projected once;
* per head, ``s_j = z_j . attn_src`` and ``t_i = z_i . attn_dst``;
* N(i): i's valid sampled edges less any whose source is i itself, plus i
  itself (PyG's ``remove_self_loops`` then ``add_self_loops``);
* ``alpha_i = softmax over N(i) of LeakyReLU_0.2(s_j + t_i)``,
  ``o_i = sum_j alpha_ij z_j``;
* heads concatenated in a hidden layer (C = hidden / H), averaged in the
  last (C = classes, ``concat=False``);
* ``out_i = o_i + b_att + h_i @ w_self + b``: the conv's bias and the skip
  ``Linear``'s, two parameters;
* hidden layers: ELU, then dropout 0.5 (``reference.dropout``, the
  uniforms drawn in the program's order: one tensor a hidden layer).

Departures from PyG's example, besides what the configuration lists: the
sampled edges may name one source twice (the benchmark's sampler draws with
replacement, PyG's ``NeighborSampler`` without), and each counts as an
edge; padded destination rows (a worker with fewer seeds or frontier
nodes) are computed as any row and never reach the loss; the initial
weights below (PyG: Glorot for the projections and attention vectors);
no attention dropout, as the example sets none.
"""
from __future__ import annotations

import torch

from portbench import reference

SLOPE = 0.2


def _heads(model: dict, layer: int) -> tuple[int, int]:
    """(H, C) of ``layer``: C = hidden / H, the classes in the last."""
    H = model["gat_heads"]
    if layer == model["num_layers"] - 1:
        return H, model["num_classes"]
    return H, model["hidden_dim"] // H


def init_params(model: dict, seed: int, device) -> list[dict]:
    """Drawn on ``device`` from one generator seeded with ``seed``, in one
    call of standard normals, per layer in this order: ``w_self`` (d_in,
    d_out) and ``w_neigh`` (d_in, H * C), He-scaled (sqrt(2 / d_in));
    ``attn_src`` and ``attn_dst`` (H, C), scaled by sqrt(2 / (H + C)),
    Glorot's variance over the (H, C) vector PyG draws; then ``b_att`` (H
    * C, or C in the last layer) and ``b`` (d_out,) zero."""
    dims = reference.layer_dims(model)
    shapes = []
    for layer in range(model["num_layers"]):
        H, C = _heads(model, layer)
        d_in = dims[layer]
        shapes.append([("w_self", (d_in, dims[layer + 1]), 2.0 / d_in),
                       ("w_neigh", (d_in, H * C), 2.0 / d_in),
                       ("attn_src", (H, C), 2.0 / (H + C)),
                       ("attn_dst", (H, C), 2.0 / (H + C))])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(a * b for layer in shapes for _, (a, b), _ in
                           layer), generator=gen, device=device)
    params, at = [], 0
    for layer, drawn in enumerate(shapes):
        out = {}
        for name, (a, b), var in drawn:
            out[name] = (flat[at:at + a * b].view(a, b)
                         * var ** 0.5).contiguous()
            at += a * b
        H, C = _heads(model, layer)
        last = layer == model["num_layers"] - 1
        out["b_att"] = torch.zeros(C if last else H * C, device=device)
        out["b"] = torch.zeros(dims[layer + 1], device=device)
        params.append(out)
    return params


def forward(params, levels, p: int, h0: torch.Tensor, model: dict,
            gen: torch.Generator, mm) -> torch.Tensor:
    """Worker ``p``'s logits from its fetched rows ``h0``, layer 1 eating
    the bottom level; every product through ``mm``."""
    L = model["num_layers"]
    h = h0
    for layer in range(L):
        w = params[layer]
        H, C = _heads(model, layer)
        edges = levels[L - 1 - layer].edges[p]          # (S, F) positions
        S = edges.shape[0]
        me = torch.arange(S, device=edges.device)
        # slot 0 is the destination itself, then its edges but self loops
        src = torch.cat([me[:, None], edges.clamp(min=0)], 1)
        ok = torch.cat([torch.ones_like(me[:, None], dtype=torch.bool),
                        (edges >= 0) & (edges != me[:, None])], 1)
        z = mm(h, w["w_neigh"]).view(-1, H, C)           # (N, H, C)
        s = (z * w["attn_src"]).sum(-1)                  # (N, H)
        t = (z[:S] * w["attn_dst"]).sum(-1)              # (S, H)
        e = torch.nn.functional.leaky_relu(s[src] + t[:, None], SLOPE)
        e = e.masked_fill(~ok[..., None], float("-inf"))
        alpha = torch.softmax(e, dim=1)                  # (S, F + 1, H)
        o = (alpha[..., None] * z[src]).sum(1)           # (S, H, C)
        o = o.mean(1) if layer == L - 1 else o.reshape(S, H * C)
        out = o + w["b_att"] + mm(h[:S], w["w_self"]) + w["b"]
        if layer < L - 1:
            out = reference.dropout(torch.nn.functional.elu(out),
                                    model["dropout"], gen)
        h = out
    return h


def _sources(step: dict, level: int, p: int) -> int:
    """Valid sources of worker ``p`` at ``level`` (top first): its valid
    destinations and the sources its valid edges name, each once, which
    the sampler lists as the next level's destinations (below the bottom
    level: the frontier)."""
    levels = step["levels"]
    if level + 1 < len(levels):
        return levels[level + 1]["workers"][p]["dst"]
    return step["frontier"][p]


def gemm_flops(model: dict, step: dict) -> dict:
    """The published model's products in one step (``counts.summarize``'s
    counts), per layer and worker: the projection of each valid source
    row once (the valid destinations and the sources their edges name),
    the skip on the destinations, and the per-head scores (each projected
    row's ``s``, a destination's ``t``), 2 operations a multiply-add; the
    backward's weight gradients of all of them, and its input gradients
    for every layer but the first, whose input is the fetched features."""
    L = model["num_layers"]
    dims = reference.layer_dims(model)
    fwd = igrad = 0.0
    for layer in range(L):
        H, C = _heads(model, layer)
        d_in, d_out = dims[layer], dims[layer + 1]
        for p, w in enumerate(step["levels"][L - 1 - layer]["workers"]):
            rows = _sources(step, L - 1 - layer, p)
            per = (2.0 * rows * d_in * H * C + 2.0 * w["dst"] * d_in * d_out
                   + 2.0 * H * C * (rows + w["dst"]))
            fwd += per
            if layer > 0:
                igrad += per
    return {"forward": fwd, "weight_grad": fwd, "input_grad": igrad,
            "total": 2 * fwd + igrad}
