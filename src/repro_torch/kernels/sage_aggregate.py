"""GraphSAGE masked neighbour mean: CUDA kernels (forward and backward) +
plain versions.

Replaces ``repro.kernels.sage_aggregate.sage_aggregate`` (Pallas body
``_sage_aggregate_kernel``) and the gradient XLA derives for ``repro``'s
jnp mean.  Both kernels are in ``csrc/sage_aggregate.cu``; its header says
what bounds them and how they are laid out.  The forward's launch shape
(``forward_plan``) depends on D and F only, and its result on neither: each
output column is an f-ordered sum from +0.0 divided by the valid count.
The backward gathers over a transpose built on the card by
``sage_backward_index`` (``csrc/sage_backward_index.cu``);
``backward_index`` is its plain version and ``backward_prep_plain`` that
of its first pass.

The forward takes any fanout: rows wider than the ``MAX_STAGED_IDS`` ids
a block stages (exact inference pads to the max in-degree) go through the
wide-row kernel in the same launch, with the same bits: it compacts each
``WIDE_CHUNK_IDS`` ids of a row to the valid ones in f order and adds
only those, which gives the bits of adding +0.0 for the others.

``sage_aggregate`` runs the plain version (and trains through autograd)
for CPU tensors only; for CUDA tensors it is a ``torch.autograd.Function``
whose forward and backward each launch their kernel or raise.  The
backward runs only when ``h_src`` requires grad, so a layer whose input is
the fetched feature table launches none.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scan import THREADS, scan_scratch, scan_tiles

ROWPTR_TILE = 4 * THREADS   # kScanTile in csrc/sage_backward_index.cu
# the forward kernel's launch shape (csrc/sage_aggregate.cu)
MAX_STAGED_IDS = 8192       # kMaxStagedIds: edge ids a block stages
MIN_THREADS = 256           # a block takes rows up to this many threads
# the wide-row kernel (F > MAX_STAGED_IDS): one row a block of
# kWideThreads, which compacts its valid ids kWideChunk at a time
WIDE_THREADS = 512
WIDE_CHUNK_IDS = 12288


def forward_max_threads(F: int) -> int:
    """The most threads a forward block may have (``kForwardMaxThreads``:
    the F = 5 kernel fits 64 registers a thread, the others need more)."""
    return 1024 if F == 5 else 512


def forward_plan(D: int, F: int, vec: bool) -> tuple[int, int]:
    """(rows per block R, threads per block) of the forward kernel.

    A pure function of the row width D, the fanout F and the float4 path
    (``vec``), never of S, B or N; the kernel's bits do not depend on it
    either.  Thread work is the tile's (row, column) pairs, C = D / 4 float4
    columns a row (D on the scalar path), ``pairs_per_thread(F)`` of them a
    thread.  R makes the pairs an exact multiple of 32 threads (no idle
    lane), then doubles until the block has ``MIN_THREADS`` threads, and
    halves while the tile's R * F ids exceed ``MAX_STAGED_IDS``.  Past
    ``MAX_STAGED_IDS`` (wide rows) the wide-row kernel takes one row a
    block of ``WIDE_THREADS``, whatever D is.
    """
    if F > MAX_STAGED_IDS:
        return 1, WIDE_THREADS
    C = D // 4 if vec else D
    k = pairs_per_thread(F)
    R = 32 * k // math.gcd(C, 32 * k)
    while R * C < MIN_THREADS * k and R < MIN_THREADS * k:
        R *= 2
    while R > 1 and R * F > MAX_STAGED_IDS:
        R //= 2
    threads = -(-R * C // k)
    threads = min(max(32, -(-threads // 32) * 32), forward_max_threads(F))
    return R, threads


def pairs_per_thread(F: int) -> int:
    """(row, column) pairs a forward thread takes: two at F <= 5, whose
    single pair holds too few loads to pay for the block's id staging and
    barrier (64 rows on 800 threads beat 32 rows on 800 at serving shapes,
    ``tools/forward_plan_sweep.py``), else one."""
    return 2 if F <= 5 else 1


def sage_aggregate_plain(edges: torch.Tensor,
                         h_src: torch.Tensor) -> torch.Tensor:
    """Masked mean of ``h_src`` rows over each row of ``edges``.

    edges: (..., S, F) int local src ids, valid iff in [0, N).
    h_src: (..., N, D), the same leading dims.
    Returns (..., S, D); a row with no valid edge is 0 and a duplicate
    edge counts by multiplicity.
    """
    N, D = h_src.shape[-2:]
    mask = (edges >= 0) & (edges < N)
    idx = edges.clamp(0, max(N - 1, 0)).long()
    if h_src.dim() == 2:
        gathered = h_src[idx]                                  # (S, F, D)
    else:
        lead = h_src.shape[:-2]
        hb = h_src.reshape(-1, N, D)
        ib = idx.reshape(hb.shape[0], -1, 1).expand(-1, -1, D)
        gathered = hb.gather(1, ib).reshape(*lead, *idx.shape[-2:], D)
    m = mask[..., None].to(h_src.dtype)
    total = torch.sum(gathered * m, dim=-2)
    count = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    return total / count


def sage_aggregate_backward_plain(edges: torch.Tensor,
                                  grad_out: torch.Tensor,
                                  num_src: int) -> torch.Tensor:
    """Gradient of ``sage_aggregate_plain(edges, h_src)`` with respect to
    ``h_src`` (N = ``num_src`` rows), by autograd: ``grad_h[n]`` sums
    ``grad_out[i] / max(count_i, 1)`` over the valid edges (i, f) naming
    n.  It does not depend on ``h_src``'s values, so a zero table stands
    in for it."""
    lead = edges.shape[:-2]
    D = grad_out.shape[-1]
    with torch.enable_grad():
        h = torch.zeros((*lead, num_src, D), dtype=grad_out.dtype,
                        device=grad_out.device, requires_grad=True)
        out = sage_aggregate_plain(edges, h)
        (grad_h,) = torch.autograd.grad(out, h, grad_out)
    return grad_h


def backward_prep_plain(edges: torch.Tensor, num_src: int):
    """Plain version of the backward transpose's first pass.

    Returns ``(keys (B*S*F,) int32, denom (B*S,) float32, counts (B*N,)
    int32)``: each flattened (b, i, f) edge slot's key ``b * N +
    edges[b, i, f]`` when the id is in [0, N) and ``B * N`` otherwise,
    each destination row's ``max(count, 1)``, and the number of valid
    slots naming each source row ``b * N + n``.
    """
    S, F = edges.shape[-2:]
    B = math.prod(edges.shape[:-2])
    N = int(num_src)
    e = edges.reshape(B, S * F).long()
    valid = (e >= 0) & (e < N)
    base = (torch.arange(B, device=edges.device) * N).view(B, 1)
    keys = torch.where(valid, e + base, B * N).reshape(-1)
    counts = torch.bincount(keys, minlength=B * N + 1)[:B * N]
    denom = valid.reshape(B * S, F).sum(dim=-1).clamp(min=1)
    return (keys.to(torch.int32), denom.to(torch.float32),
            counts.to(torch.int32))


def backward_index(edges: torch.Tensor, num_src: int):
    """The transpose the backward kernel reads: plain version, int64.

    Returns ``(rowptr (B*N + 1,) int32, slots (B*S*F,) int32, denom
    (B*S,) float32)``: the flattened (b, i, f) edge slots stably sorted
    by source row ``b * N + edges[b, i, f]`` (invalid slots last), so
    source row r's slots are ``slots[rowptr[r]:rowptr[r + 1]]`` in
    ascending (i, f) order; ``denom`` is each destination row's
    ``max(count, 1)``.  Destination row of a slot: ``slot // F``.
    """
    B = math.prod(edges.shape[:-2])
    keys, denom, _ = backward_prep_plain(edges, num_src)
    sorted_key, order = torch.sort(keys.long(), stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(B * int(num_src) + 1, device=edges.device))
    return rowptr.to(torch.int32), order.to(torch.int32), denom


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point: (source under csrc/, argument types, result type)
_ENTRY_POINTS = {
    "sage_aggregate_launch": ("sage_aggregate",
                              [_P] * 2 + [_I] * 8 + [_P] * 2, _I),
    "sage_aggregate_backward_launch": ("sage_aggregate",
                                       [_P] * 4 + [_I] * 5 + [_P] * 2, _I),
    "sage_backward_index_temp_bytes": ("sage_backward_index", [_I] * 2,
                                       ctypes.c_size_t),
    "sage_backward_index_launch": (
        "sage_backward_index",
        [_P] + [_I] * 6 + [_P] * 9 + [ctypes.c_size_t, _P], _I),
}


def _lib(name: str):
    source, argtypes, restype = _ENTRY_POINTS[name]
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check_cuda(name: str, edges: torch.Tensor, x: torch.Tensor) -> None:
    if edges.device != x.device or x.device.type != "cuda":
        raise ValueError(f"{name}: edges on {edges.device}, the float input "
                         f"on {x.device}; both must be on one device")
    if edges.dtype != torch.int32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 edges and float32 rows, got "
                        f"{edges.dtype} and {x.dtype}")
    if edges.dim() != x.dim() or edges.shape[:-2] != x.shape[:-2]:
        raise ValueError(f"{name}: edges {tuple(edges.shape)} and "
                         f"{tuple(x.shape)} disagree on the leading (worker) "
                         f"dims")


def _check_sizes(name: str, edges: torch.Tensor, num_src: int) -> None:
    B = math.prod(edges.shape[:-2])
    if edges.numel() >= 2 ** 31 or B * int(num_src) + 1 >= 2 ** 31:
        raise ValueError(f"{name}: {edges.numel()} edge slots and "
                         f"{B * int(num_src)} source rows; the kernels' "
                         f"int32 ids take fewer than 2**31 of each")


def sage_backward_index(edges: torch.Tensor, num_src: int):
    """The transpose the backward kernel reads (same contract as
    ``backward_index``): the kernels of ``csrc/sage_backward_index.cu``
    for a CUDA tensor, the plain version for a CPU one.

    On the card: one pass over the edge slots (int32 keys, ``denom`` and
    the per-source-row histogram), a single-pass scan of the histogram
    into ``rowptr``, and a stable 32-bit radix sort of the keys with the
    slot ids as values.  No ``searchsorted``, no int64 sort.
    """
    if edges.device.type == "cpu":
        return backward_index(edges, num_src)
    _check_sizes("sage_backward_index", edges, num_src)
    if edges.device.type != "cuda":
        raise ValueError(f"sage_backward_index: edges on {edges.device}; "
                         f"the kernels take CUDA tensors")
    if edges.dtype != torch.int32 or edges.dim() < 2 or edges.shape[-1] < 1:
        raise TypeError(f"sage_backward_index takes int32 (..., S, F >= 1) "
                        f"edges, got {edges.dtype} {tuple(edges.shape)}")
    S, F = edges.shape[-2:]
    B = math.prod(edges.shape[:-2])
    N = int(num_src)
    dev = edges.device
    edges = edges.contiguous()
    nnz = B * S * F
    end_bit = max(1, (B * N).bit_length())
    tiles = scan_tiles(B * N + 1, ROWPTR_TILE)
    scratch, hist = scan_scratch(tiles, B * N + 1, dev)
    work = torch.empty(3 * nnz, dtype=torch.int32, device=dev)
    slots = torch.empty(nnz, dtype=torch.int32, device=dev)
    denom = torch.empty(B * S, dtype=torch.float32, device=dev)
    rowptr = torch.empty(B * N + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        temp_bytes = _lib("sage_backward_index_temp_bytes")(nnz, end_bit)
        temp = torch.empty(max(temp_bytes, 1), dtype=torch.uint8, device=dev)
        err = _lib("sage_backward_index_launch")(
            edges.data_ptr(), B, S, F, N, end_bit, tiles,
            work.data_ptr(), work[nnz:].data_ptr(), work[2 * nnz:].data_ptr(),
            slots.data_ptr(), denom.data_ptr(), rowptr.data_ptr(),
            hist.data_ptr(), scratch.data_ptr(), temp.data_ptr(), temp_bytes,
            torch.cuda.current_stream().cuda_stream)
    sage_backward_index.launches += 1
    _build.check_launch("sage_backward_index", err)
    return rowptr, slots, denom


sage_backward_index.launches = 0


def sage_aggregate_backward(edges: torch.Tensor, grad_out: torch.Tensor,
                            num_src: int) -> torch.Tensor:
    """Gradient of the masked neighbour mean with respect to ``h_src``
    (same contract as ``sage_aggregate_backward_plain``); the CUDA kernel
    for CUDA tensors, the plain version for CPU ones.

    The kernel gathers in a fixed order over the transpose
    ``sage_backward_index`` builds, so its result is the same bits on
    every call.
    """
    if grad_out.device.type == "cpu" and edges.device.type == "cpu":
        return sage_aggregate_backward_plain(edges, grad_out, num_src)
    _check_sizes("sage_aggregate_backward", edges, num_src)
    _check_cuda("sage_aggregate_backward", edges, grad_out)
    if grad_out.shape[:-1] != edges.shape[:-1]:
        raise ValueError(f"sage_aggregate_backward: grad_out "
                         f"{tuple(grad_out.shape)} does not match edges "
                         f"{tuple(edges.shape)}")
    S, F = edges.shape[-2:]
    D = grad_out.shape[-1]
    B = math.prod(edges.shape[:-2])
    N = int(num_src)
    dev = edges.device
    rowptr, slots, denom = sage_backward_index(edges, N)
    grad_out = grad_out.contiguous()
    grad_h = torch.empty((*edges.shape[:-2], N, D), dtype=torch.float32,
                         device=dev)
    vec = int(D % 4 == 0 and grad_out.data_ptr() % 16 == 0
              and grad_h.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = _lib("sage_aggregate_backward_launch")(
            rowptr.data_ptr(), slots.data_ptr(), grad_out.data_ptr(),
            denom.data_ptr(), B, N, F, D, vec, grad_h.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    sage_aggregate_backward.launches += 1
    _build.check_launch("sage_aggregate_backward", err)
    return grad_h


sage_aggregate_backward.launches = 0


class _SageAggregate(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, edges, h_src):
        ctx.save_for_backward(edges)
        ctx.num_src = h_src.shape[-2]
        return _forward(edges, h_src)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None
        (edges,) = ctx.saved_tensors
        return None, sage_aggregate_backward(edges, grad_out, ctx.num_src)


def sage_aggregate(edges: torch.Tensor, h_src: torch.Tensor) -> torch.Tensor:
    """Masked neighbour mean (same contract as ``sage_aggregate_plain``),
    differentiable in ``h_src``; the CUDA kernels for CUDA tensors, the
    plain version for CPU ones."""
    if h_src.device.type == "cpu" and edges.device.type == "cpu":
        return sage_aggregate_plain(edges, h_src)
    rows = math.prod(edges.shape[:-1])
    if max(rows, *edges.shape[-1:], *h_src.shape[-2:]) >= 2 ** 31:
        raise ValueError(f"sage_aggregate: {rows} destination rows, edges "
                         f"{tuple(edges.shape)}, h_src {tuple(h_src.shape)}; "
                         f"the forward's grid and int32 sizes take fewer "
                         f"than 2**31 of each")
    _check_cuda("sage_aggregate", edges, h_src)
    return _SageAggregate.apply(edges, h_src)


def _forward(edges: torch.Tensor, h_src: torch.Tensor) -> torch.Tensor:
    edges = edges.contiguous()
    h_src = h_src.contiguous()
    S, F = edges.shape[-2:]
    N, D = h_src.shape[-2:]
    B = math.prod(edges.shape[:-2])
    out = torch.empty((*edges.shape[:-1], D), dtype=h_src.dtype,
                      device=h_src.device)
    vec = D % 4 == 0 and h_src.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    R, threads = forward_plan(D, F, vec)
    with torch.cuda.device(h_src.device):
        err = _lib("sage_aggregate_launch")(
            edges.data_ptr(), h_src.data_ptr(), B, S, F, N, D, int(vec), R,
            threads, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    sage_aggregate.launches += 1
    _build.check_launch("sage_aggregate", err)
    return out


sage_aggregate.launches = 0
