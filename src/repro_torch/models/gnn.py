"""GraphSAGE over MFGs (the paper's §4 model): forward, loss and accuracy.

Counterpart of ``repro.models.gnn`` for the ``sage`` conv.  Parameters are
a plain list of per-layer dicts ``{"w_self": (d_in, d_out), "w_neigh":
(d_in, d_out), "b": (d_out,)}`` — ``repro``'s layout — so
``params_from_numpy`` carries ``repro``'s parameters across unchanged.
Layers consume MFGs bottom-up (layer 1 eats the bottom-most MFG) and every
activation may carry the leading worker axis.

The neighbour mean goes through the ``sage_aggregate`` kernels (forward
and backward) on CUDA tensors.  The two products stay ``torch.matmul``,
issued as fixed-shape (``ROW_CHUNK``, d_in) row blocks: cuBLAS picks its
kernel, and with it the reduction order, from the shape, so one product
over all rows would give a seed's logits bits that depend on how many
seeds share the batch.

Dropout masks come from an explicit ``torch.Generator`` (``repro`` draws
them with ``jax.random``, whose bits torch cannot reproduce); without a
generator, or with ``dropout == 0``, no dropout is applied.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.mfg import MFG
from repro_torch.kernels.sage_aggregate import sage_aggregate

ROW_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    in_dim: int
    hidden_dim: int = 256
    num_classes: int = 47
    num_layers: int = 3
    fanouts: tuple[int, ...] = (15, 10, 5)   # (N_L, ..., N_1), top first
    dropout: float = 0.5                      # training only
    conv: str = "sage"

    def __post_init__(self):
        if self.conv != "sage":
            raise ValueError(f"conv {self.conv!r} is not ported yet; "
                             f"available: ('sage',)")


def init_gnn_params(cfg: GNNConfig, generator: torch.Generator,
                    device) -> list[dict]:
    """He-scaled normal weights and zero biases, ``repro``'s shapes and
    scales, drawn on the CPU from ``generator`` and moved to ``device``."""
    dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])
    params = []
    for layer in range(cfg.num_layers):
        d_in, d_out = dims[layer], dims[layer + 1]
        scale = (2.0 / d_in) ** 0.5
        w_self = torch.randn((d_in, d_out), generator=generator) * scale
        w_neigh = torch.randn((d_in, d_out), generator=generator) * scale
        params.append({"w_self": w_self.to(device),
                       "w_neigh": w_neigh.to(device),
                       "b": torch.zeros((d_out,), device=device)})
    return params


def params_from_numpy(params_np, device) -> list[dict]:
    """``repro``'s parameter list (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, on ``device``."""
    return [{k: torch.from_numpy(np.array(v, np.float32)).to(device)
             for k, v in layer.items()} for layer in params_np]


def params_to_numpy(params) -> list[dict]:
    """The port's parameter list -> ``repro``'s layout as numpy arrays."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params]


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K), w (K, N), as ``torch.matmul`` over
    (ROW_CHUNK, K) row blocks, the last one zero-padded: every row goes
    through the same product shape whatever the row count, so its bits do
    not depend on the batch it shares.  The blocks are concatenated (no
    ``out=``), so autograd runs through it."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M == 0:
        return x2.new_zeros((*lead, w.shape[1]))
    full = M - M % ROW_CHUNK
    blocks = [torch.matmul(x2[i:i + ROW_CHUNK], w)
              for i in range(0, full, ROW_CHUNK)]
    if full < M:
        tail = torch.nn.functional.pad(x2[full:],
                                       (0, 0, 0, ROW_CHUNK - (M - full)))
        blocks.append(torch.matmul(tail, w)[:M - full])
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    return out.reshape(*lead, w.shape[1])


def apply_layer(layer, mfg: MFG, h_src: torch.Tensor, cfg: GNNConfig, *,
                is_last: bool, generator: torch.Generator | None = None,
                aggregate: Callable = sage_aggregate,
                h_dst: torch.Tensor | None = None) -> torch.Tensor:
    """One SAGE layer: (..., src_capacity, D_in) -> (..., num_dst, D_out).
    ``aggregate(edges, h_src)`` is the neighbour mean (the kernel wrapper
    by default; ``sage_aggregate_plain`` for a plain-version forward).
    ``h_dst`` holds the destination rows when they are not the prefix of
    ``h_src`` (exact inference reads its sources from the whole table).
    Hidden layers apply dropout with masks drawn from ``generator`` (on
    the activations' device) when it is given and ``cfg.dropout > 0``."""
    if h_dst is None:
        h_dst = h_src[..., : mfg.num_dst, :]      # prefix convention
    agg = aggregate(mfg.edges, h_src)
    out = (rowwise_matmul(h_dst, layer["w_self"])
           + rowwise_matmul(agg, layer["w_neigh"]) + layer["b"])
    if not is_last:
        out = torch.relu(out)
        if generator is not None and cfg.dropout > 0:
            keep = torch.rand(out.shape, generator=generator,
                              device=out.device) >= cfg.dropout
            out = out * keep / (1 - cfg.dropout)
    return out


def gnn_forward(params, mfgs: Sequence[MFG], h0: torch.Tensor,
                cfg: GNNConfig, *, generator: torch.Generator | None = None,
                aggregate: Callable = sage_aggregate) -> torch.Tensor:
    """mfgs top level first (sampler order); ``h0`` aligns with
    ``mfgs[-1].src_nodes``.  Returns logits for the top-level seeds."""
    if len(mfgs) != cfg.num_layers:
        raise ValueError(f"{len(mfgs)} MFGs for a {cfg.num_layers}-layer "
                         f"model")
    h = h0
    for layer in range(cfg.num_layers):
        mfg = mfgs[cfg.num_layers - 1 - layer]
        h = apply_layer(params[layer], mfg, h, cfg,
                        is_last=(layer == cfg.num_layers - 1),
                        generator=generator, aggregate=aggregate)
    return h


def gnn_loss(params, mfgs, h0, labels, valid, cfg: GNNConfig, *,
             generator: torch.Generator | None = None,
             aggregate: Callable = sage_aggregate) -> torch.Tensor:
    """Masked cross-entropy over the labeled seeds (eq. 3), per worker:
    ``labels``/``valid`` are (..., batch) and the result has the leading
    (worker) dims — the mean over each worker's labeled seeds."""
    logits = gnn_forward(params, mfgs, h0, cfg, generator=generator,
                         aggregate=aggregate)
    labels_ok = valid & (labels >= 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None]
                        )[..., 0]
    nll = torch.where(labels_ok, nll, torch.zeros((), dtype=nll.dtype,
                                                  device=nll.device))
    return nll.sum(dim=-1) / labels_ok.sum(dim=-1).clamp(min=1)


def gnn_accuracy(params, mfgs, h0, labels, valid,
                 cfg: GNNConfig) -> torch.Tensor:
    """Share of labeled seeds whose argmax logit is the label, per
    worker."""
    logits = gnn_forward(params, mfgs, h0, cfg)
    pred = torch.argmax(logits, dim=-1)
    ok = valid & (labels >= 0)
    correct = ok & (pred == labels)
    return correct.sum(dim=-1) / ok.sum(dim=-1).clamp(min=1)
