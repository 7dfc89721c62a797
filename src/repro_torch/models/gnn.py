"""GraphSAGE over MFGs (the paper's §4 model), inference forward.

Counterpart of ``repro.models.gnn`` for the ``sage`` conv.  Parameters are
a plain list of per-layer dicts ``{"w_self": (d_in, d_out), "w_neigh":
(d_in, d_out), "b": (d_out,)}`` — ``repro``'s layout — so
``params_from_numpy`` carries ``repro``'s parameters across unchanged.
Layers consume MFGs bottom-up (layer 1 eats the bottom-most MFG) and every
activation may carry the leading worker axis.

The neighbour mean goes through the ``sage_aggregate`` kernel on CUDA
tensors.  The two products stay ``torch.matmul``, issued as fixed-shape
(``ROW_CHUNK``, d_in) row blocks: cuBLAS picks its kernel, and with it the
reduction order, from the shape, so one product over all rows would give a
seed's logits bits that depend on how many seeds share the batch.
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
    dropout: float = 0.5                      # training only (not ported)
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
    not depend on the batch it shares."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    full = M - M % ROW_CHUNK
    out = x2.new_empty((M, w.shape[1]))
    for i in range(0, full, ROW_CHUNK):
        torch.matmul(x2[i:i + ROW_CHUNK], w, out=out[i:i + ROW_CHUNK])
    if full < M:
        tail = x2.new_zeros((ROW_CHUNK, K))
        tail[:M - full] = x2[full:]
        out[full:] = torch.matmul(tail, w)[:M - full]
    return out.reshape(*lead, w.shape[1])


def apply_layer(layer, mfg: MFG, h_src: torch.Tensor, cfg: GNNConfig, *,
                is_last: bool,
                aggregate: Callable = sage_aggregate) -> torch.Tensor:
    """One SAGE layer: (..., src_capacity, D_in) -> (..., num_dst, D_out).
    ``aggregate(edges, h_src)`` is the neighbour mean (the kernel wrapper
    by default; ``sage_aggregate_plain`` for a plain-version forward)."""
    h_dst = h_src[..., : mfg.num_dst, :]          # prefix convention
    agg = aggregate(mfg.edges, h_src)
    out = (rowwise_matmul(h_dst, layer["w_self"])
           + rowwise_matmul(agg, layer["w_neigh"]) + layer["b"])
    if not is_last:
        out = torch.relu(out)
    return out


def gnn_forward(params, mfgs: Sequence[MFG], h0: torch.Tensor,
                cfg: GNNConfig, *,
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
                        aggregate=aggregate)
    return h
