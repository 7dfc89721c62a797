"""AdamW and SGD (+momentum) as plain functions on parameter trees.

Counterpart of ``repro.optim.optimizers``, with its formulas, defaults and
update order: AdamW with ``b2=0.95``, ``eps`` outside the square root and
bias correction computed on a float32 step count.  ``torch.optim.AdamW``
is not used: its defaults and its order of operations differ.

A parameter tree is nested lists, tuples and dicts of tensors (the GNN's
is a list of per-layer dicts); optimizer states mirror it.  Every function
returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: object           # first moment (or momentum); a tree like params
    nu: object           # second moment; a tree like params (0-d for sgd)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and of the trees in
    ``rest``, which share its structure); keeps lists, tuples, named
    tuples and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def _pick(like, out, i: int):
    """Element ``i`` of each tuple leaf of ``out``, a tree shaped like
    ``like`` whose leaves are the per-leaf update tuples."""
    return tree_map(lambda _, o: o[i], like, out)


def init_opt_state(params, *, kind: str = "adamw",
                   moment_dtype=torch.float32) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa: E731
                                  device=p.device)
    mu = tree_map(zeros, params)
    nu = tree_map(zeros, params) if kind == "adamw" else tree_map(
        lambda p: torch.zeros((), dtype=moment_dtype, device=p.device),
        params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def adamw(params, grads, state: OptState, *, lr, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.0, moment_dtype=torch.float32):
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(
            torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m32.to(moment_dtype), v32.to(moment_dtype))

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return (_pick(params, out, 0),
            OptState(step=step, mu=_pick(params, out, 1),
                     nu=_pick(params, out, 2)))


@torch.no_grad()
def sgd(params, grads, state: OptState, *, lr, momentum=0.9):
    step = state.step + 1

    def upd(p, g, m):
        m32 = m.to(torch.float32) * momentum + g.to(torch.float32)
        return ((p.to(torch.float32) - lr * m32).to(p.dtype),
                m32.to(m.dtype))

    out = tree_map(upd, params, grads, state.mu)
    return (_pick(params, out, 0),
            OptState(step=step, mu=_pick(params, out, 1), nu=state.nu))


def apply_updates(params, grads, state: OptState, *, kind="adamw", **kw):
    return (adamw if kind == "adamw" else sgd)(params, grads, state, **kw)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2)
                          for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
