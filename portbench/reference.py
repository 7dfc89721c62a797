"""Plain reference of one cell's training steps: a GNN on sampled
message-flow graphs, trained by AdamW, in PyTorch and NumPy.

It imports nothing of the port and takes nothing the port made.  From the
configuration's dataset and its offline partition (``dataset.py``) and the
run's seed it works out again what the timed path computes:

* the layout: partition p owns new ids ``offsets[p] .. offsets[p+1]-1``,
  nodes ordered by partition, ties by old id; a node keeps its in-edges in
  the order the dataset stores them;
* each step's seeds: worker p takes its ``batch`` labelled nodes of least
  SplitMix64 key ``mix64(new id + salt * 0x9E3779B97F4A7C15)``, salt = the
  run's base salt + step;
* each level's draws: slot f of node v takes in-neighbour ``f`` when the
  node has at most ``fanout`` of them, else the one at
  ``SplitMix32(v * 2654435761 + f, level salt) % deg``, where ``deg`` is
  capped at the mix's ``sample_window`` (the fused sampler's rule) or not
  (``null``: the vanilla protocol's windowless draw);
* each level's message-flow graph: the destinations, then the new sources
  in ascending id order; an edge names its source's position;
* the feature rows, the forward with dropout drawn from a generator seeded
  as the run's, the per-worker masked cross entropy, its gradient averaged
  over the workers, the global-norm clip and AdamW.

The model is a file of its own, ``models/<conv>.py`` for the
configuration's ``model["conv"]`` (``load_model``), which gives
``init_params``, ``forward`` and ``gemm_flops``; everything else here
serves every model alike, the control and the faults included.

``precision="tf32"`` computes every product in TF32 (the control: the
nearest precision below the configuration's float32); ``fault`` plants one
of the faults the check must catch, in the reference put in the
program's place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

U32 = 0xFFFFFFFF
GOLDEN64 = 0x9E3779B97F4A7C15
FAULTS = ("half_batch", "no_exchange", "shifted_draw")


def mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer on uint64 (wrapping)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product in two
    16-bit halves of c, so no intermediate leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def hash_u32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """SplitMix32 of (x, salt), on int64 tensors holding uint32 values."""
    x = ((x & U32) + ((salt * 0x9E3779B9) & U32)) & U32
    x = _mul_u32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_u32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def level_salt(salt: int, depth: int) -> int:
    return ((salt & U32) * 1000003 + depth) & U32


@dataclasses.dataclass
class Layout:
    """The partition as the reference sees it, on ``device``."""
    perm: torch.Tensor          # new id -> old id (int64)
    old_to_new: torch.Tensor    # old id -> new id (int64)
    offsets: np.ndarray         # (P + 1,) int64
    indptr: torch.Tensor        # the dataset's CSC, old ids (int64)
    indices: torch.Tensor
    labels_new: np.ndarray      # (n,) labels by new id, -1 unlabelled
    features: torch.Tensor      # (n, D) by old id


def make_layout(data: dict, num_parts: int, device) -> Layout:
    assign = np.asarray(data["assign"])
    perm = np.argsort(assign, kind="stable")
    old_to_new = np.empty_like(perm)
    old_to_new[perm] = np.arange(perm.size)
    offsets = np.zeros(num_parts + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=num_parts), out=offsets[1:])
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
    return Layout(perm=t(perm), old_to_new=t(old_to_new), offsets=offsets,
                  indptr=t(data["indptr"]), indices=t(data["indices"]),
                  labels_new=np.asarray(data["labels"])[perm],
                  features=torch.from_numpy(np.array(
                      data["features"], np.float32)).to(device))


def draw_seeds(layout: Layout, batch: int, salt: int) -> np.ndarray:
    """(P, batch) new ids of each worker's minibatch, -1 padded."""
    P = layout.offsets.size - 1
    out = np.full((P, batch), -1, np.int64)
    salt64 = np.uint64((int(salt) * GOLDEN64) % 2 ** 64)
    for p in range(P):
        lo, hi = int(layout.offsets[p]), int(layout.offsets[p + 1])
        gids = lo + np.flatnonzero(layout.labels_new[lo:hi] >= 0)
        key = mix64(gids.astype(np.uint64) + salt64)
        take = gids[np.argsort(key, kind="stable")[:batch]]
        out[p, :take.size] = take
    return out


@dataclasses.dataclass
class Level:
    """One message-flow graph of all workers: (P, S) destinations, (P, S,
    F) edges as source positions (-1 invalid), (P, S + S * F) sources."""
    dst: torch.Tensor
    edges: torch.Tensor
    src: torch.Tensor


def sample_level(layout: Layout, frontier: torch.Tensor, fanout: int,
                 salt: int, window: int | None,
                 shifted: bool = False) -> Level:
    P, S = frontier.shape
    dev = frontier.device
    ok = frontier >= 0
    v = frontier.clamp(min=0)
    old = layout.perm[v]
    start = layout.indptr[old]
    deg = torch.where(ok, layout.indptr[old + 1] - start, 0)
    if window is not None:
        deg = deg.clamp(max=window)
    slots = torch.arange(fanout, device=dev)
    bits = hash_u32((_mul_u32(v[..., None], 2654435761) + slots) & U32, salt)
    col = torch.where((deg <= fanout)[..., None], slots,
                      torch.remainder(bits, deg.clamp(min=1)[..., None]))
    if shifted:
        col = torch.remainder(col + 1, deg.clamp(min=1)[..., None])
    valid = (slots < deg.clamp(max=fanout)[..., None]) & ok[..., None]
    pos = (start[..., None] + col).clamp(max=layout.indices.numel() - 1)
    samples = torch.where(valid, layout.old_to_new[layout.indices[pos]], -1)
    n = layout.perm.numel()
    edges = torch.full((P, S, fanout), -1, dtype=torch.int64, device=dev)
    src = torch.full((P, S + S * fanout), -1, dtype=torch.int64, device=dev)
    for p in range(P):
        where = torch.full((n,), -1, dtype=torch.int64, device=dev)
        where[frontier[p][ok[p]]] = torch.arange(S, device=dev)[ok[p]]
        cand = samples[p][valid[p]]
        new = torch.unique(cand[where[cand] < 0])
        where[new] = S + torch.arange(new.numel(), device=dev)
        edges[p] = torch.where(valid[p], where[samples[p].clamp(min=0)], -1)
        src[p, :S] = frontier[p]
        src[p, S:S + new.numel()] = new
    return Level(dst=frontier, edges=edges, src=src)


def sample_step(layout: Layout, seeds: np.ndarray, fanouts, salt: int,
                window: int | None, shifted: bool = False) -> list[Level]:
    """The step's levels, top first."""
    frontier = torch.from_numpy(seeds).to(layout.perm.device)
    levels = []
    for depth, fanout in enumerate(fanouts):
        lvl = sample_level(layout, frontier, int(fanout),
                           level_salt(salt, depth), window, shifted)
        levels.append(lvl)
        frontier = lvl.src
    return levels


def layer_dims(model: dict) -> list[int]:
    """Widths from the input to the logits: in, hidden per layer, classes."""
    return ([model["in_dim"]] + [model["hidden_dim"]]
            * (model["num_layers"] - 1) + [model["num_classes"]])


def load_model(models: Path, conv: str):
    """The model file ``models/<conv>.py``: ``init_params(model, seed,
    device)``, ``forward(params, levels, p, h0, model, gen, mm)`` and
    ``gemm_flops(model, step)``.  A conv without a file is an error that
    names the file; nothing stands in for it."""
    path = Path(models) / f"{conv}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model file {path} for the "
                                f"configuration's conv {conv!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_model_{conv.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leaves(params) -> dict:
    """{'l<i>.<name>': tensor} in layer order."""
    return {f"l{i}.{k}": v for i, layer in enumerate(params)
            for k, v in layer.items()}


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (nearest, ties away) in the
    forward; the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def _matmul_precision(tf32: bool, device):
    """float32 products with TF32 off, or on for the control."""
    if torch.device(device).type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mm(x, w, emulate_tf32: bool):
    if emulate_tf32:
        return _round_tf32(x) @ _round_tf32(w)
    return x @ w


def neighbour_mean(h: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(S, D) mean of each destination's valid edges' source rows of ``h``
    (N, D); 0 where a destination has none."""
    valid = (edges >= 0)[..., None].to(h.dtype)
    return (h[edges.clamp(min=0)] * valid).sum(1) / valid.sum(1).clamp(
        min=1.0)


def dropout(out: torch.Tensor, p: float,
            gen: torch.Generator) -> torch.Tensor:
    """``out`` with each element kept where its uniform from ``gen`` is >=
    ``p`` and scaled by 1 / (1 - p); the uniforms drawn as the program
    draws a worker's."""
    if p <= 0:
        return out
    keep = torch.rand((1, *out.shape), generator=gen,
                      device=out.device)[0] >= p
    return out * keep / (1 - p)


def worker_loss(net, params, levels: list[Level], p: int, layout: Layout,
                model: dict, gen: torch.Generator, mm,
                fault: str | None) -> torch.Tensor:
    """Worker p's masked cross entropy over its labelled seeds, the model
    file ``net``'s forward from the worker's fetched rows."""
    src = levels[-1].src[p]
    ok = src >= 0
    h = torch.where(ok[:, None], layout.features[layout.perm[src.clamp(
        min=0)]], 0.0)
    if fault == "no_exchange":
        lo, hi = layout.offsets[p], layout.offsets[p + 1]
        h = torch.where(((src >= lo) & (src < hi))[:, None], h, 0.0)
    h = net.forward(params, levels, p, h, model, gen, mm)
    seeds = levels[0].dst[p]
    labels = torch.from_numpy(layout.labels_new[seeds.clamp(
        min=0).cpu().numpy()]).to(h.device)
    use = (seeds >= 0) & (labels >= 0)
    if fault == "half_batch":
        use[seeds.numel() // 2:] = False
    nll = -torch.log_softmax(h, -1).gather(
        1, labels.clamp(min=0)[:, None])[:, 0]
    return torch.where(use, nll, 0.0).sum() / use.sum().clamp(min=1)


def train(data: dict, net, model: dict, optim: dict, mix: dict, seed: int,
          base_salt: int, dropout_seed: int, *, steps: int = 3,
          device="cpu", precision: str = "fp32",
          fault: str | None = None, layout: Layout | None = None,
          after_first: list | None = None) -> dict:
    """Run ``steps`` training steps of the model file ``net``
    (``load_model``) from the run's initial weights.
    Returns {"losses": [...], "grad_norms": {leaf: norm of the first
    clipped gradient}, "change1_norms" and "change<steps>_norms": {leaf:
    norm of the parameters' change after the first and the last step}};
    ``after_first`` receives the parameters after the first step."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if layout is None:
        layout = make_layout(data, mix["num_parts"], device)
    params = net.init_params(model, seed, device)
    start = {k: v.clone() for k, v in leaves(params).items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    mm = functools.partial(
        _mm, emulate_tf32=precision == "tf32"
        and torch.device(device).type != "cuda")
    b1, b2, eps = optim["b1"], optim["b2"], optim["eps"]
    out = {"losses": []}
    with _matmul_precision(precision == "tf32", device):
        for k in range(steps):
            salt = (base_salt + k) % 2 ** 32
            seeds = draw_seeds(layout, mix["batch"], salt)
            levels = sample_step(layout, seeds, model["fanouts"], salt,
                                 mix["sample_window"],
                                 shifted=fault == "shifted_draw")
            P = seeds.shape[0]
            named = leaves(params)
            grads = {k2: torch.zeros_like(t) for k2, t in named.items()}
            total = 0.0
            for p in range(P):
                live = {k2: t.detach().requires_grad_(True)
                        for k2, t in named.items()}
                shaped = [{n: live[f"l{i}.{n}"] for n in layer}
                          for i, layer in enumerate(params)]
                loss = worker_loss(net, shaped, levels, p, layout, model,
                                   gen, mm, fault)
                g = torch.autograd.grad(loss, list(live.values()))
                for k2, gi in zip(live, g):
                    grads[k2] += gi
                total += float(loss.detach())
            grads = {k2: g / P for k2, g in grads.items()}
            norm = math.sqrt(sum(float((g.double() ** 2).sum())
                                 for g in grads.values()))
            scale = min(1.0, optim["grad_clip"] / (norm + 1e-9))
            grads = {k2: g * scale for k2, g in grads.items()}
            if k == 0:
                out["grad_norms"] = {k2: float(g.norm())
                                     for k2, g in grads.items()}
            out["losses"].append(total / P)
            t = k + 1
            new = {}
            with torch.no_grad():
                for k2, p_ in named.items():
                    m[k2] = b1 * m[k2] + (1 - b1) * grads[k2]
                    v2[k2] = b2 * v2[k2] + (1 - b2) * grads[k2] ** 2
                    mhat = m[k2] / (1 - b1 ** t)
                    vhat = v2[k2] / (1 - b2 ** t)
                    new[k2] = p_ - optim["lr"] * (
                        mhat / (vhat.sqrt() + eps)
                        + optim["weight_decay"] * p_)
            params = [{n: new[f"l{i}.{n}"] for n in layer}
                      for i, layer in enumerate(params)]
            if k == 0:
                out["change1_norms"] = {k2: float((v - start[k2]).norm())
                                        for k2, v in new.items()}
                if after_first is not None:
                    after_first.append(new)
    out[f"change{steps}_norms"] = {k: float((v - start[k]).norm())
                                   for k, v in leaves(params).items()}
    return out
