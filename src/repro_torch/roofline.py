"""Roofline terms of one device, counted while a step runs (counterpart of
``repro.roofline``).

Three terms per (arch x shape x mesh), all per-device quantities:

    compute    = FLOPs / peak_FLOP/s            (989e12, bf16, H100 SXM)
    memory     = bytes / HBM_bw                 (3.35e12 B/s)
    collective = collective_bytes / link_bw     (450e9 B/s, NVLink each way)

over ``repro_torch.launch.mesh``'s H100 data-sheet constants: these are
counts over constants, not timings.

``repro`` reads its counts from compiled HLO.  Here ``CostCounter`` records
them as the step runs, once, on the ops each rank really runs: a DTensor op
is left to DTensor, which runs it as local ops on the rank's shards and as
the functional collectives of its redistributions, and those are what the
counter sees and counts:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products and
    attention) on the local shapes;
  * bytes as the inputs plus the outputs of every local op (views and
    allocations move none): unfused, as XLA CPU's "bytes accessed" is,
    and eager PyTorch really makes those round trips;
  * ``fusable``: the result bytes of ops tagged ``torch.Tag.pointwise``, of
    views and of copies, where a result is at least 64 MB (``repro``'s
    rule: the large elementwise intermediates a fused kernel would keep
    on chip);
  * collective bytes and counts by ``repro``'s five kinds, at result-shape
    bytes.

Every layer and attention chunk runs unrolled in eager PyTorch, so the
depth probes (``extrapolate``) count each op once, as ``repro``'s unrolled
probes do.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.float16: 2, torch.bfloat16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
#: the collective kinds, under ``repro.roofline.collective_bytes``'s keys
COLLECTIVE_KINDS = _COLLECTIVES

_FUSABLE_MIN_BYTES = 64 * 1024 * 1024

# torch's collective ops (functional and in-place c10d) by repro's kinds
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COPIES = {"copy_", "_to_copy", "clone", "copy", "contiguous",
           "_unsafe_view", "expand_copy", "permute_copy", "view_copy"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "wait_tensor", "_local_scalar_dense",
             "detach", "lift_fresh", "alias"}


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out += _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            out += _tensors(x)
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


class CostCounter(TorchDispatchMode):
    """Records one device's work while the ``with`` body runs: ``flops``,
    ``hbm_bytes``, ``fusable``, and ``coll_bytes`` / ``coll_counts`` by
    collective kind.

    A DTensor op is handed back to DTensor (``NotImplemented``): it runs as
    local ops on this rank's shards and as functional collectives, which
    come back through this mode and are counted at their local shapes.
    DTensor's shape propagation, which runs ops in a fake mode of its own
    (or on the meta device), is not counted: an op is counted only under
    the fake mode that was active on entry (none, in eager code).
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.fusable = 0.0
        self.coll_bytes = {k: 0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self._entry_mode = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        if active_fake_mode() is not self._entry_mode \
                or any(t.device.type == "meta" for t in ins):
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = _tensors(out)
        if ns in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVE_OF.get(name)
            if kind is not None:
                # in-place c10d ops write their result into an input
                res = outs if ns == "_c10d_functional" else ins[:1]
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(tensor_bytes(t) for t in res)
            return out
        if ns == "prim" or name in _NO_BYTES or func.is_view:
            if func.is_view:
                self._fusable(outs)
            return out
        self.hbm_bytes += sum(tensor_bytes(t) for t in ins + outs)
        if torch.Tag.pointwise in func.tags or name in _COPIES:
            self._fusable(outs)
        f = self._flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        return out

    def _fusable(self, outs) -> None:
        for t in outs:
            b = tensor_bytes(t)
            if b >= _FUSABLE_MIN_BYTES:
                self.fusable += b

    @property
    def coll_total(self) -> int:
        return sum(self.coll_bytes.values())

    def metrics(self) -> dict:
        """The record ``extrapolate`` takes: ``flops``, ``hbm_bytes``,
        ``coll_bytes`` (all kinds) and ``fusable``."""
        return {"flops": float(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "coll_bytes": float(self.coll_total),
                "fusable": float(self.fusable)}


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops: float               # per-device
    hbm_bytes: float           # per-device
    coll_bytes: float          # per-device
    model_flops_global: float  # analytic 6*N*D
    chips: int
    fusable: float = 0.0       # per-device fusable-op result bytes

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_memory_adjusted(self) -> float:
        """Fusion-adjusted memory term (the raw one counts every eager
        round trip); the subtraction is capped at 80% of the raw bytes."""
        adj = max(self.hbm_bytes - self.fusable, 0.2 * self.hbm_bytes)
        return adj / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops summed over chips)."""
        hw = self.flops * self.chips
        return self.model_flops_global / hw if hw else float("nan")

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_adjusted_s": self.t_memory_adjusted,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def extrapolate(probe1: dict, probe2: dict, units: int) -> dict:
    """total(U) = p1 + (U-1) * (p2 - p1), per metric."""
    out = {}
    for k in probe1:
        d = probe2[k] - probe1[k]
        out[k] = probe1[k] + (units - 1) * d
    return out


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6 * N_active * tokens (+ attention term)."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch
        ctx = min(cfg.window, shape.seq_len) if cfg.window else shape.seq_len
        attn = (4 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim
                * ctx * tokens) if cfg.num_heads else 0
        return 2 * n * tokens + attn          # forward-only
    tokens = shape.global_batch * shape.seq_len
    ctx = min(cfg.window, shape.seq_len) if cfg.window else shape.seq_len
    attn = (6 * 2 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim
            * ctx * tokens / 2) if cfg.num_heads else 0
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens + (attn if shape.kind == "train"
                                else attn / 3)
