#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, exact-inference, fleet,
dry-run, LM and seed-API paths on one CUDA card and check them.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. card and software: ``nvidia-smi`` name and power limit, torch/CUDA
     versions; TF32 is switched off for matmul and cuDNN, and bf16
     products reduce in fp32.
  2. build: every CUDA source under ``src/repro_torch/csrc`` with nvcc.
  3. main-path set-up: ``Pipeline.build_from_source`` on ``powerlaw(1.8)``
     (500 000 nodes, average degree 24, 100 features, 47 classes), P = 4,
     ``hybrid+fused``, ``ldg``; the paper's GraphSAGE (``PRODUCTS``) with
     seeded random weights; a ``Predictor`` with buckets (1, 8, 32, 128).
  4. kernels: each kernel against its plain PyTorch version on the card, on
     the inputs one 128-seed ``predict`` gives it (three sampling levels,
     three layers, one feature fetch): each one's device time per call
     (a ``torch.profiler`` trace of 20 calls) and call time (CUDA events,
     median of 20), the plain version's and, where one PyTorch call
     computes the same function, that call's device time, and the least
     time the card could take; ``fused_sample`` must run as one
     hand-written kernel per level.  The forward ``sage_aggregate`` must
     equal an f-ordered loop bit for bit and run as one hand-written
     kernel per layer, and be batch-invariant (the rows of a call on
     ``edges[:, :k]``, k = 1, 7, 32, equal the full call's at D = 100 and
     256).  Then ``fused_sample``, the forward and the ``sage_aggregate``
     backward on edge shapes (S = 1, S off the scan tile, B = 1, a row or
     tile of padding, S = 0, a window most seeds exceed; F = 1 and 33;
     D = 1, 33, 100, 130, 256 and an unaligned table; source rows with
     thousands of slots), the backward's transpose equal to
     ``backward_index`` bit for bit.  The sage hidden layer's tail
     (``check_sage_epilogue``): ``sage_hidden_tail`` at the benchmark's
     layer-1 shape (1, 176 000, 256), dropout 0.5, equal to the chain of
     PyTorch ops it replaces bit for bit, its gradients within tolerance;
     the ``sage_epilogue`` kernels there and on ragged shapes (H = 33, an
     unaligned input, H = 4096 and 16 384, p = 0.3, no dropout) equal to
     their plain versions (the backward's bias gradient within 1e-5 of
     its column sums), one launch a call, timed.  Last, the widths of
     ``examples/train_gnn_e2e_torch.py`` (its pipeline and initial
     weights, one step's MFGs): each layer's forward (D = 1024, 4096,
     4096) equal to the f-ordered loop bit for bit and within tolerance
     of the plain version, its backward on a seeded gradient against the
     plain version, both timed beside their plain versions.
  5. small-input parity: the same pipeline on an 800-node graph on the card
     and on the CPU (whose plain path the tests hold to ``repro``): MFGs
     equal, logits within tolerance.
  6. main path, with every launch count set to 0 first: ``predict`` on a
     128-seed batch (finite (128, 47) logits that match a plain-version
     forward on the same MFGs and features), then ``GNNServer.run`` over
     400 ``hotset`` arrivals whose outputs must equal direct ``predict``
     bit for bit.  Every kernel must have launched.
  7. where the time goes: wall time of one ``predict`` against the device
     time of the kernels it launches (``torch.profiler``).
  8. training: phase 3's layout through ``Pipeline.from_layout`` with a
     65 536-row ``degree`` cache per worker and the ``pinned_hot`` store,
     the paper's GraphSAGE with dropout 0, 1000 seeds per worker, AdamW
     (lr 0.006, clip 1.0).  At one step's shapes: ``gather_rows`` exact,
     the ``sage_aggregate`` backward within tolerance and the same bits on
     two calls (also timed with the L2 flushed before each call), its
     transpose equal to ``backward_index`` with ``torch.searchsorted``
     unavailable, ``fused_sample`` exact and the forward aggregate within
     tolerance, all against their plain versions (the forward also equal
     to the f-ordered loop bit for bit, one kernel per layer, with each
     layer's device time against its bound); the step with the
     kernels against the same step with plain versions (loss within 1e-5,
     each gradient leaf within tolerance); the ``pinned_hot`` step and an
     ``exchange``-with-cache step bit-identical in ``h_src``, loss and
     gradients.  Then, with every launch count set to 0 first, 10 steps
     through ``SyncDriver``: finite losses, 2 rounds per step, every one
     of the eight kernel wrappers launched; the step's wall time, device busy
     time and idle share, and peak device memory; and the sampling /
     feature / compute split of a step (``repro_torch.obs.profile.
     profile_stages``, arm ``hybrid+fused``).
  9. overlap, on phase 8's layout and model: 4 steps each of the sync
     driver without and with seed staging, ``double_buffer`` at depth 1
     and 2, depth 1 with staging, and a ``staged``-store pipeline at depth
     1 (same cache, device combine), each from phase 8's initial
     parameters.  Each run: losses and final parameters equal phase 8's
     synchronous run's after 4 steps bit for bit, 2 feature rounds per
     step (0 for
     ``staged``), the fused sampler's window overflow nonzero in some
     step (the stager's host replay applies the window), every kernel of
     the path launched, a restart at step 2 replays steps 2-3 (the
     ``staged`` store, whose steps take a second of host work each: 3
     steps, their losses and the parameters after them equal to phase
     8's after its first 3, a restart at step 1, no span timing); its step
     wall, the mean host ms of each driver, executor and stager span over
     3 traced steps (``repro_torch.obs``; unfenced, and fenced), device
     busy and idle share over 2 steps profiled one
     by one (taken again when their counts of device ops differ), the
     stager's ring-empty waits and pinned bytes, and peak
     device memory.  Then phase 6's predictor and arrivals through
     ``GNNServer`` with a ``RecyclingCache`` (``hot_set_admit`` over a
     ``blend(0.5)`` ranking), every served output equal to direct
     ``predict`` bit for bit, with its p50, p99, QPS and hit rate; a
     ``frequency`` cache pipeline's hit rate; and
     ``repro_torch.launch.serve_gnn`` with ``--recycle --hot-scorer
     blend(0.5)`` at its own small defaults, as a launcher smoke: served
     outputs equal direct ``predict`` bit for bit.
 10. placement schemes, on phase 8's layout, model, cache and store: the
     plans of ``vanilla``, ``hybrid``, ``hybrid_partial(0.0 / 0.25 /
     1.0)`` built (seconds, local topology bytes, replicated edge share),
     one step's MFGs equal across all five bit for bit; then 10
     ``SyncDriver`` steps each of ``vanilla``, ``hybrid`` (unfused
     backend) and ``hybrid_partial(0.25)`` from phase 8's initial
     parameters, with every launch count set to 0 first: losses and final
     parameters equal across the three bit for bit, 6 / 2 / 6 rounds per
     step, every kernel of the path launched and ``fused_sample`` never
     (these schemes draw windowless through their own samplers); then
     ``hybrid+fused`` the same way beside them, for time only (its window
     makes its draws differ on this graph).  Each run: step wall, the
     stage split (``profile_stages``, with the scheme as its arm), the
     prepare half's device busy ms, device busy and idle share over 2
     profiled steps, peak device memory, utilized sampling bytes, expected
     rounds.  Then one 128-seed ``predict`` under ``vanilla`` equal to
     ``hybrid``'s bit for bit, and the report's share table
     (``repro_torch.obs.report``) over every profiled arm.
     Traced run: 3 ``SyncDriver`` steps, 3 ``double_buffer`` depth-1
     steps with staging, one ``profile_stages`` step and 100 of phase 6's
     arrivals through ``GNNServer``, under ``start(path, fenced=True)``:
     the exported trace passes ``validate_trace`` and holds the driver,
     executor, stager, profile and serving spans; the report CLI prints
     its share and summary tables.
 11. exact inference: ``layerwise_inference``, uncapped, over the whole
     500 000-node graph at full width (100 -> 256 -> 256 -> 47) with phase
     8's trained parameters, with every launch count set to 0 first:
     finite (500 000, 47) logits, one forward launch per batch and layer
     (the wide-row kernel: every batch is padded to the max in-degree,
     11 361); per-layer wall and device busy, peak device memory and the
     share of edge slots that are padding.  On the batch holding the max
     in-degree node, each layer's aggregate equals the f-ordered loop bit
     for bit and its rows are within 1e-4 of a plain-version forward; the
     forward at that (512, 11 361, D) shape is timed beside its plain
     version and ``embedding_bag``.  Last, exact accuracy on the test
     split (the unlabelled nodes), and on its first 16 384 nodes beside
     the sampled ``predict``'s.
 12. the convs: gcn, gat (4 heads) and gin in turn at ``PRODUCTS`` widths,
     random weights from seed 0, on phase 8's layout, ``pinned_hot`` store
     and cache.  Each: one step with the kernels against the same step
     with plain versions (loss within 1e-5, each gradient leaf within
     tolerance); 3 ``SyncDriver`` steps (finite losses, 2 rounds a step,
     every kernel wrapper but ``sage_epilogue``'s two
     launched; step wall, device busy over 2
     more profiled steps, peak memory).  With the 3
     steps' weights: a ``Predictor`` at buckets (1, 8, 32, 128) over
     phase 3's pipeline, its 128-seed ``predict`` within 1e-4 of a
     plain-version forward (for gin an absolute 1e-4 of each row's
     largest |logit|: its sums grow with the in-degree) and 100 of phase
     6's ``hotset`` arrivals through ``GNNServer`` equal
     to direct ``predict`` bit for bit; exact inference, gcn and gin
     uncapped (one forward launch per batch and layer; the max in-degree
     batch's aggregate equal to the f-ordered loop bit for bit), gat
     under a cap of 2048 in-edges (the sampler's window; one launch per
     batch, its last layer), each layer's wall and device busy under the
     profiler, the max batch's rows against a plain-version forward (the
     same tolerance), exact accuracy on the test split beside the sampled
     ``predict``'s on its first 16 384 nodes.
 13. the data layer and the partitioners: ``rmat`` at phase 3's size
     (``dataset_stats``), saved and loaded back memory-mapped and eager
     equal bit for bit, ``Pipeline.build_from_source(path)`` under
     ``hash`` and 3 training steps; ``sbm(4,0.9,0.1)`` at 100 000 nodes
     under ``degree_stratified(0.3)`` through streaming LDG
     (``partition_chunk_edges``) and 3 steps; ``AdaptiveFanout`` forced
     down a rung and 2 steps at the new fanouts (``fused_sample`` and the
     aggregate launched); ``metis``'s refusal without ``pymetis``.
 14. the fleet executors: phase 3's dataset, its ldg assignment and
     phase 8's initial parameters written under ``build/fleet``; the
     parent's stacked runs of ``hybrid+fused`` and ``vanilla`` (3
     ``SyncDriver`` steps at 500 seeds a worker, ``exchange`` store, no
     cache) and a 128-seed stacked ``predict``; then one 4-rank
     ``torch.distributed`` launch (``repro_torch.launch.multihost``; this
     script re-run with ``--fleet-rank``) in which each rank loads those
     files (no second partitioning), builds its rank-local layout and
     trains the paper's GraphSAGE for ``FLEET_STEPS`` (2) ``SyncDriver``
     steps (500 seeds a worker) in three fleets: ``shard_map`` 4 ranks x 1 worker
     ``hybrid+fused``; ``multiprocess`` 2 x 2 ``hybrid+fused`` (on ranks 0
     and 1); ``shard_map`` 4 x 1 ``vanilla``.  Gates: every rank's tensors on the card, every kernel
     of the path launched in every rank (the wrappers' counts), 2 / 2 / 6
     rounds a step, finite losses equal on every rank, the losses and
     the parameters after step 1 and after the last equal to the stacked
     run's bit for bit (every executor takes ``repro``'s gradient rule),
     fleets 1 and 2 equal bit for bit, fleet 1's ``predict`` equal to the
     stacked one bit for bit.  Prints per fleet the step walls, each rank's peak
     memory and, from rank 0's ``comm/*`` spans, each round's bytes, ms
     and GB/s.  Then ``train_gnn --executor multiprocess --num-procs 2
     --dataset <saved 20 000-node rmat>.npz --partitioner labelprop(2)
     --trace`` at its other defaults but 1 step of 64 seeds a worker:
     exit 0, rank logs, rank
     0's edge cut equal to the parent's labelprop(2) of the file (the
     ranks refuse to train on partitions that differ), a merged trace
     that ``validate_trace`` accepts.
 15. the pod-scale dry-run and the e2e example:
     ``repro_torch.launch.dryrun_gnn`` on fake tensors at ``repro``'s
     defaults (2000 nodes a worker, 1000 seeds), 256 and 512 workers,
     vanilla and hybrid (6 rounds with 4 sampling, 2 with 0; as many
     all-to-alls; bytes a round, collective bytes and the ``MemTracker``
     peak a device); then one concrete rank 0 of a 256-rank fake-backend
     job on the card (hybrid, 500 nodes a worker, 128 seeds, seeded
     data, every launch count set to 0 first): its rounds, their bytes
     and every collective equal the fake record's at the same arguments,
     every kernel of the path launched, the loss a number (finite where
     this torch's fake backend writes the receive buffers), its
     ``max_memory_allocated`` beside the estimate.  Then
     ``examples/train_gnn_e2e_torch.py`` (in 1024 -> hidden 4096, 42.3 M
     parameters, P = 4, ``hybrid+fused``) for ``E2E_STEPS`` steps with
     its own asserts (the loss falls, the checkpoint restores) and every
     kernel of its path launched.
 16. the LM scaffold (``repro_torch.models.lm`` and its launchers; no
     hand-written kernel on its path, and none may launch): stablelm-1.6b
     at full width and depth in bf16 (seeded weights): ``serve_lm``'s
     ``prefill_cache`` over 4 x 32 Markov prompt tokens, its last logits
     within rel-L2 ``LM_REL_TOL`` of ``forward(last_only=True)``, then 16
     greedy decode tokens (prefill s, decode tok/s, peak memory); 3
     ``make_lm_train_step`` steps at batch 8 x seq 128 (AdamW lr 1e-3,
     f32 moments, finite losses, step ms, peak memory), then one step with
     ``remat=True`` whose loss equals the first step's bit for bit.  At
     full width in bf16, each a forward and the logits of every prompt
     position through decode steps within rel-L2 of the forward's
     (``LM_SSM_REL_TOL`` for the SSM families): mamba2-130m (1 x 256, two
     SSD chunks), zamba2-1.2b (all 38 layers, 1 x 128, a KV cache per
     shared-block application), whisper-small (2 x 32 over 1500 encoder
     frames, cross K/V precomputed), qwen2-vl-7b (text only, and a forward
     with a patch prefix on an M-RoPE grid), mixtral-8x22b cut to 2 layers
     (no-drop capacity for decode vs forward; at its own capacity a
     forward, 8 identical tokens through layer 0's MoE with tokens past
     the capacity dropped, a skewed dispatch equal to the CPU's).  The ten
     reduced configs in fp32, card against CPU from the same seeded
     weights: logits within ``LM_REDUCED_TOL``, 8 greedy tokens equal
     after a prompt past the SWA window.  Last, ``train`` (5 steps) and
     ``serve_lm`` at ``--reduced`` and ``examples/serve_lm_torch.py``,
     through their ``main``.
 17. the LM scaffold, part 2 (the production mesh, the sharding rules,
     DTensor; no hand-written kernel on its path): (a) the LM dry-run,
     ``repro_torch.launch.dryrun`` as rank 0 of a 256- or 512-rank
     fake-backend job on fake tensors on this card's torch, run in a
     process of its own from the script's start (it needs the CPU only):
     ``qwen2-7b`` x ``train_4k`` x ``pod``, ``mixtral-8x22b`` x
     ``decode_32k`` x ``multipod`` and ``mamba2-130m`` x ``long_500k`` x
     ``pod`` with their depth probes must end ``ok`` with finite roofline
     terms and a dominant term, ``qwen2-7b`` x ``long_500k`` ``skipped``;
     (b) one concrete rank 0 of a 256-rank fake-backend job on the card
     (``DeviceMesh("cuda")``, seeded bf16 shards of ``qwen2-7b`` at
     ``decode_32k`` on ``pod``, one serve step): every shard's shape and
     placements as the specs give them, its collectives by kind equal to
     the fake record's, ``max_memory_allocated`` within 10 % of the
     record's ``peak_estimate_bytes``; (c) ``train --arch mixtral-8x22b
     --reduced --devices 2 --steps 3`` (two gloo ranks on this card) with
     finite losses equal to ``--devices 1``'s within ``LM_RANKS_TOL``.
 18. ``repro``'s seed API, on phase 8's layout and initial parameters
     (GraphSAGE at ``PRODUCTS`` widths, 1000 seeds a worker), each route
     driven for ``SEED_API_STEPS`` (2) steps with every launch count set to
     0 first and read after: (a) ``dist.make_worker_step(scheme="hybrid",
     level_fn=resolve_backend("fused_cuda"))`` through ``run_stacked``,
     its losses and every gradient leaf equal to the ``Pipeline``'s
     ``hybrid+fused`` step (``exchange`` store, no cache) bit for bit;
     (b) ``build_degree_caches`` (65 536 rows a worker) with
     ``make_cached_worker_step`` and ``run_stacked_cached``, equal to (a)
     bit for bit, its hit rate above 0; (c) the shim under ``vanilla``
     (``plan_from_legacy``; shards from ``build_vanilla``'s
     ``VanillaPlan``) equal to the ``Pipeline``'s ``vanilla`` step bit for
     bit; rounds 2 / 2 / 6 a step; three ``DeprecationWarning``s; (d) the
     MFG-level ``kernels.ops`` (``fused_sample`` per level,
     ``sage_aggregate`` per MFG, ``feature_gather`` of the fetch) at the
     step's shapes against their plain versions; (e) ``fused_sample``
     (not under vanilla), ``feature_gather`` and the ``sage_aggregate``
     forward, backward and transpose launched on each route.  Paid for by
     depth cuts: phase 9's runs 4 steps restarted at 2 (were 6 at 3),
     phase 14's fleets 2 steps (were 3).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

NUM_NODES = 500_000
AVG_DEGREE = 24
NUM_PARTS = 4
SALT = 7
REPS = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
SAGE_TOL = 1e-5                  # kernel vs plain aggregate: fp32 sum order
LOGIT_TOL = 1e-4                 # logits after 3 layers of fp32 products
# the kernels each path runs (the backward and the pinned gather train only)
SERVING_KERNELS = ("fused_sample", "sage_aggregate", "feature_gather")
# the device kernels of csrc/ by name (sage_backward_index runs two of its
# own and CUB's radix sort)
HAND_WRITTEN = ("fused_sample_kernel", "sage_aggregate_kernel",
                "sage_aggregate_wide_kernel",
                "backward_prep_kernel", "rowptr_scan_kernel",
                "sage_aggregate_backward_kernel", "feature_gather_kernel",
                "gather_rows_kernel", "sage_epilogue_kernel",
                "sage_epilogue_backward_kernel", "gat_attention_kernel",
                "gat_attention_backward_kernel")
# the wrappers only a gatv1 layer launches: no phase here trains one
GAT_KERNELS = ("gat_attention", "gat_attention_backward")
TRAIN_BATCH = 1000               # seeds per worker (paper §4)
CACHE_K = 65_536                 # pinned cache rows per worker
TRAIN_STEPS = 10
TRAIN_LR = 0.006                 # paper §4
TRAIN_SALT = 11
LOSS_TOL = 1e-5                  # kernel step vs plain step, absolute
# backward kernel vs plain, and kernel step vs plain step per gradient
# leaf: max abs error over the leaf's max abs value (fp32 sums in another
# order, through three layers for the gradients)
BWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
FLUSH_KERNEL = "bitwise_not"     # the L2 flush's device kernel, by name
# the forward's fanouts at and past the ids a block stages (MAX_STAGED_IDS)
WIDE_FANOUTS = (8192, 8193, 11361, 16384)
INFER_BATCH = 512                # layerwise_inference's default batch
SAMPLED_TEST = 16_384            # test nodes the sampled predict reads
TRACE_MARGIN_S = 0.1             # host wait at each end of a timing trace


_START = time.perf_counter()


def log(*args) -> None:
    """Print a line; a section's header ("== " or "-- ") also gets the
    script's seconds so far, which time its sections."""
    if args and str(args[0]).startswith(("== ", "-- ")):
        args = (*args, f"[{time.perf_counter() - _START:.1f} s]")
    print(*args, flush=True)


@contextlib.contextmanager
def kernel_trace():
    """A ``torch.profiler`` trace of the device's kernels that waits
    TRACE_MARGIN_S on the host after it starts and again before it stops.
    Without the margins, traces on the card's machine came back short of
    launches up to three times in a row, or with no device op at all; the
    tracer keeps only the kernels whose device timestamps fall inside its
    window.  A wall time read inside the block leaves the margins out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def time_ms(fn, reps: int = REPS, flush=None, wrapper=None,
            kernel: str | None = None) -> tuple[float, float, dict]:
    """(device ms, call ms, device ms by name) of one ``fn()``, after 3
    warm-up runs.

    device: the summed time of the device kernels ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls; by name: the same split per
    device kernel name.
    call: the median over ``reps`` calls of CUDA events recorded around
    each call, which includes the host's launch overhead whenever the
    device waits for the host.
    flush: ``l2_flush()``'s function, run before every call, outside the
    events; its device kernel is left out of the sums.
    wrapper, kernel: the kernel wrapper ``fn`` calls and the hand-written
    device kernel it must launch.  Every traced call must add exactly one
    to the wrapper's own launch count, and ``kernel`` must be the only
    hand-written kernel in the traces (AssertionError otherwise).

    The profiler only times.  A trace that comes back with no device
    kernel at all, or with a kernel counted a number of times that is not
    a multiple of ``reps`` (the tracer drops records now and then on the
    card's machine), is taken again, up to five times, or until a partial
    trace repeats the previous one's counts (a drop that repeats).  Then
    the fullest trace is read: each kernel's time a call is the mean of
    its kept launches times its launches a call (one for ``kernel``, by
    the wrapper's count; the count over ``reps`` rounded, at least 1, for
    the others), which a dropped record does not bias.
    """
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if wrapper is not None:
        wrapper.launches = 0
    best, last, names = [], None, set()
    for attempt in range(5):
        with kernel_trace() as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not (flush is not None and FLUSH_KERNEL in e.key)]
        names |= {_short(e.key) for e in events}
        partial = {_short(e.key): e.count for e in events if e.count % reps}
        if events and not partial:
            break
        if sum(e.count for e in events) > sum(e.count for e in best):
            best = events
        log(f"  (trace {attempt + 1} recorded "
            + (f"partial counts {partial} of {reps} calls" if events
               else "no device kernel") + ")")
        if events and partial == last:
            break
        last = partial if events else None
    complete = bool(events) and not partial
    if not complete:
        if not best:
            raise RuntimeError("the profiler recorded no device kernel in "
                               "five traces")
        events = best
        log("  (reading the fullest partial trace: each kernel's time a "
            "call as the mean of its kept launches times its launches a "
            "call)")
    if wrapper is not None:
        # the tracer drops records but adds none: a complete trace holds
        # reps launches of the kernel, a partial one no more
        ours = sorted(names & set(HAND_WRITTEN))
        traced = sum(e.count for e in events if _short(e.key) == kernel)
        if (wrapper.launches != reps * (attempt + 1) or ours != [kernel]
                or traced > reps or (complete and traced != reps)):
            raise AssertionError(
                f"{wrapper.__name__}: {wrapper.launches} launches counted in "
                f"{reps * (attempt + 1)} calls, {traced} {kernel} in a trace "
                f"of {reps}, hand-written device kernels {ours}; expected "
                f"one {kernel} a call")
    by_name = {}
    for e in events:
        key = _short(e.key)
        per_call = 1 if key == kernel else max(1, round(e.count / reps))
        by_name[key] = (by_name.get(key, 0.0)
                        + _device_us(e) / e.count * per_call / 1e3)
    device_ms = sum(by_name.values())
    return device_ms, event_ms(fn, reps, flush, warmup=0), by_name


def one_kernel_ms(fn, wrapper, kernel: str,
                  reps: int = REPS) -> tuple[float, float, int]:
    """(device ms, call ms, launches the trace kept) of one ``fn()`` that
    calls the kernel wrapper ``wrapper`` once and launches one device
    kernel, named ``kernel``, after 3 warm-up runs.

    The wrapper's own count over ``reps`` calls must be ``reps``, and a
    ``torch.profiler`` trace of ``reps`` calls must record ``kernel`` and no
    other device kernel.  device: the mean duration of the launches the
    trace kept, which a dropped record (see ``kernel_trace``) does not
    bias, where a sum over ``reps`` calls would.  A trace that keeps none
    is taken again, up to five times.  call: as in ``time_ms``."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wrapper.launches = 0
    for attempt in range(5):
        with kernel_trace() as prof:
            for _ in range(reps):
                fn()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        names = {_short(e.key) for e in events}
        if names - {kernel}:
            raise AssertionError(f"{wrapper.__name__}: a call launched the "
                                 f"device kernels {sorted(names)}, expected "
                                 f"one {kernel}")
        if events:
            break
        log(f"  (trace {attempt + 1} recorded no device kernel; tracing "
            f"again)")
    else:
        raise RuntimeError("the profiler recorded no device kernel in five "
                           "traces")
    if wrapper.launches != reps * (attempt + 1):
        raise AssertionError(f"{wrapper.__name__}: {wrapper.launches} "
                             f"launches counted in {reps * (attempt + 1)} "
                             f"calls")
    (evt,) = events
    return (_device_us(evt) / evt.count / 1e3, event_ms(fn, reps, warmup=0),
            evt.count)


def event_ms(fn, reps: int = 5, flush=None, warmup: int = 2) -> float:
    """Median ms of one ``fn()`` by CUDA events around each call (``flush``
    before each, outside the events), after ``warmup`` untimed runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def l2_flush():
    """A function that evicts the 50 MB L2: it rewrites a 256 MB buffer
    with one ``bitwise_not`` kernel (FLUSH_KERNEL), which no kernel under
    test launches."""
    import torch
    buf = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    return buf.bitwise_not_


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None)
                 or getattr(evt, "cuda_time_total", 0.0))


def _short(kernel_name: str) -> str:
    """A device kernel's name without ``void``, the anonymous namespace,
    template arguments and parameters."""
    name = kernel_name.removeprefix("void ")
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def add_bound(tot: dict, nbytes: float, ops: float) -> float:
    """Least time for one call: the larger of its bytes over the memory
    rate and its operations over the fp32 rate.  Adds it to ``tot``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    tot["bound_ms"] = tot.get("bound_ms", 0.0) + max(t_bytes, t_ops)
    tot["t_bytes"] = tot.get("t_bytes", 0.0) + t_bytes
    tot["t_ops"] = tot.get("t_ops", 0.0) + t_ops
    tot["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                       else "operations")
    return max(t_bytes, t_ops)


def unique_rows(ids, n_rows: int) -> int:
    """Distinct valid rows ``ids`` names across the worker axis (each row
    of a (B, n_rows, D) table is a separate row)."""
    import torch
    b = torch.arange(ids.shape[0], device=ids.device).view(-1, 1)
    flat = (b * n_rows + ids.reshape(ids.shape[0], -1).long())
    ok = (ids.reshape(ids.shape[0], -1) >= 0) & (
        ids.reshape(ids.shape[0], -1) < n_rows)
    return int(torch.unique(flat[ok]).numel())


def check_fused_sample(graph, frontiers, fanouts, salt):
    import torch
    from repro_torch.core.sampler import level_salt
    from repro_torch.kernels.fused_sample import (fused_sample,
                                                  fused_sample_plain)
    tot = {"ms": 0.0, "plain_ms": 0.0, "overflow": 0, "err": 0.0,
           "split": {}}
    for depth, (seeds, fanout) in enumerate(zip(frontiers, fanouts)):
        ls = level_salt(salt, depth)
        args = (graph.indptr, graph.indices, seeds, ls)
        got = fused_sample(*args, fanout=fanout)
        ref = fused_sample_plain(*args, fanout=fanout)
        torch.cuda.synchronize()
        for name, a, b in zip(("samples", "R", "overflow"), got, ref):
            tot["err"] = max(tot["err"],
                             float((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"fused_sample {name} differs from the "
                                     f"plain version at level {depth}")
        ms, call, split = time_ms(lambda: fused_sample(*args, fanout=fanout),
                                  wrapper=fused_sample,
                                  kernel="fused_sample_kernel")
        plain, _, _ = time_ms(lambda: fused_sample_plain(*args,
                                                         fanout=fanout))
        B, S = seeds.shape
        n_seeds = int((seeds >= 0).sum())
        n_samples = int((got[0] >= 0).sum())
        nbytes = (B * S * 4 + n_seeds * 8 + n_samples * 4
                  + B * S * fanout * 4 + B * (S + 1) * 4 + B * 4)
        # ~14 32-bit integer operations per drawn slot (hash + modulo),
        # counted against the fp32 rate
        bnd = add_bound(tot, nbytes, 14.0 * n_samples)
        ovf = int(got[2].sum())
        log(f"  fused_sample level {depth}: seeds {tuple(seeds.shape)} "
            f"fanout {fanout}: exact match, one kernel launch, overflow {ovf} "
            f"(deg > window), device {ms:.4f} ms, call {call:.4f} ms "
            f"(plain {plain:.4f} ms, bound {bnd:.5f} ms for {nbytes} B)")
        log("    device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                              key=lambda kv: -kv[1])))
        for k, v in split.items():
            tot["split"][k] = tot["split"].get(k, 0.0) + v
        tot["ms"] += ms
        tot["call_ms"] = tot.get("call_ms", 0.0) + call
        tot["plain_ms"] += plain
        tot["overflow"] += ovf
    if tot["overflow"] == 0:
        raise AssertionError("no frontier node exceeded the sampling window; "
                             "the overflow path was not exercised")
    return tot


def f_ordered_mean(edges, h):
    """The masked mean as an f-ordered loop: acc = +0.0, then acc +
    where(valid_f, h[e_f], 0) for each f in order, divided by clamp(count,
    1).  The forward kernel must equal it bit for bit; it is a check, not
    the plain version."""
    import torch
    B, S, Fo = edges.shape
    N, D = h.shape[1:]
    idx = edges.long()
    ok = (idx >= 0) & (idx < N)
    # every slot's row gathered at once; only the sum runs f by f (one add
    # a slot, the same fp32 adds in the same order as a loop that gathers
    # inside it); the count is exact
    rows = torch.gather(h, 1, idx.clamp(0, max(N - 1, 0)).reshape(
        B, S * Fo, 1).expand(-1, -1, D)).reshape(B, S, Fo, D)
    rows.masked_fill_(~ok[..., None], 0.0)
    acc = torch.zeros((B, S, D), device=h.device)
    for f in range(Fo):
        acc = acc + rows[:, :, f]
    count = ok.sum(dim=-1).to(acc.dtype)
    return acc / count.clamp(min=1)[..., None]


def wide_sum_tol(F: int, h) -> float:
    """Absolute tolerance of the forward against its plain version at a
    fanout of F >= MAX_STAGED_IDS ids a row: the bound on the rounding of
    an F-term fp32 sum taken in f order, over the count (F * 2**-24 *
    max |h|), since the plain version sums in another order; SAGE_TOL
    at the narrower fanouts.  The bits are held to ``f_ordered_mean``
    exactly either way."""
    from repro_torch.kernels.sage_aggregate import MAX_STAGED_IDS
    if F < MAX_STAGED_IDS or h.numel() == 0:
        return SAGE_TOL
    return max(SAGE_TOL, F * 2.0 ** -24 * float(h.abs().max()))


def check_forward_once(edges, h, label: str):
    """The forward kernel equal to ``f_ordered_mean`` bit for bit and
    within SAGE_TOL (``wide_sum_tol`` for wide rows) of the plain version;
    rows with no valid id +0.0.  Returns (the kernel's result, its max abs
    error against the plain version)."""
    import torch
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_plain)
    got = sage_aggregate(edges, h)
    ref = sage_aggregate_plain(edges, h)
    loop = f_ordered_mean(edges, h)
    torch.cuda.synchronize()
    if not torch.equal(got, loop):
        diff = int((got != loop).any(dim=-1).sum())
        raise AssertionError(f"sage_aggregate, {label}: {diff} rows differ "
                             f"in bits from the f-ordered loop")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    atol = wide_sum_tol(edges.shape[-1], h)
    if not torch.allclose(got, ref, rtol=SAGE_TOL, atol=atol):
        raise AssertionError(f"sage_aggregate, {label}: max abs error {err} "
                             f"against the plain version (atol {atol:.3g})")
    empty = ~((edges >= 0) & (edges < h.shape[1])).any(dim=-1)
    if torch.signbit(got[empty]).any() or got[empty].any():
        raise AssertionError(f"sage_aggregate, {label}: a row with no valid "
                             f"id is not +0.0")
    return got, err


def check_sage_aggregate(layer_inputs, shapes: str):
    """Each layer's forward against the f-ordered loop (bits) and the plain
    version (SAGE_TOL), one hand-written kernel per call, timed beside its
    plain version and ``embedding_bag``.  Returns the totals over the
    layers with a ``layers`` list of each one's numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_plain)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
           "layers": []}
    for layer, (edges, h) in enumerate(layer_inputs):
        got, err = check_forward_once(edges, h, f"{shapes} layer {layer}")
        B, S, Fo = edges.shape
        N, D = h.shape[1:]
        # library yardstick: one embedding_bag(mean) over the flattened
        # table with a zero padding row for invalid edges (prepared once,
        # outside the timing)
        table = torch.cat([h.reshape(B * N, D), h.new_zeros((1, D))])
        off = (torch.arange(B, device=h.device) * N).view(B, 1, 1)
        bag = torch.where(edges >= 0, edges + off, B * N).reshape(-1, Fo)
        lib_out = F.embedding_bag(bag, table, mode="mean",
                                  padding_idx=B * N)
        if not torch.allclose(lib_out.view(B, S, D), got, rtol=SAGE_TOL,
                              atol=SAGE_TOL):
            raise AssertionError("embedding_bag yardstick disagrees")
        del got, lib_out
        ms, call, _ = time_ms(lambda: sage_aggregate(edges, h),
                              wrapper=sage_aggregate,
                              kernel="sage_aggregate_kernel")
        plain, _, _ = time_ms(lambda: sage_aggregate_plain(edges, h))
        lib, _, _ = time_ms(lambda: F.embedding_bag(bag, table, mode="mean",
                                                    padding_idx=B * N))
        n_valid = int(((edges >= 0) & (edges < N)).sum())
        nbytes = (B * S * Fo * 4 + unique_rows(edges, N) * D * 4
                  + B * S * D * 4)
        bnd = add_bound(tot, nbytes, n_valid * D + B * S * D)
        log(f"  sage_aggregate {shapes} layer {layer}: edges "
            f"{tuple(edges.shape)} h {tuple(h.shape)}: equal to the "
            f"f-ordered loop bit for bit, max abs err {err:.3g} against the "
            f"plain version (tol {SAGE_TOL}), one kernel launch, device "
            f"{ms:.4f} ms, call {call:.4f} ms (plain {plain:.4f} ms, "
            f"embedding_bag {lib:.4f} ms, bound {bnd:.5f} ms for {nbytes} B: "
            f"{bnd / ms:.1%} of it)")
        tot["layers"].append({
            "shapes": shapes, "layer": layer, "edges": list(edges.shape),
            "h": list(h.shape), "ms": ms, "call_ms": call,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
            "max_abs_err": err})
        tot["ms"] += ms
        tot["call_ms"] = tot.get("call_ms", 0.0) + call
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["err"] = max(tot["err"], err)
    return tot


def check_forward_invariance(layer_inputs) -> None:
    """Batch invariance of the forward: the rows of a call on
    ``edges[:, :k]`` equal the first k rows of the full call bit for bit,
    k = 1, 7 and 32, at each width D the layers have (100 and 256)."""
    import torch
    from repro_torch.kernels.sage_aggregate import sage_aggregate
    widths = {}
    for edges, h in layer_inputs:
        widths.setdefault(h.shape[-1], (edges, h))
    if sorted(widths) != [100, 256]:
        raise AssertionError(f"layer widths {sorted(widths)}, expected 100 "
                             f"and 256")
    for D, (edges, h) in sorted(widths.items()):
        full = sage_aggregate(edges, h)
        for k in (1, 7, 32):
            part = sage_aggregate(edges[:, :k], h)
            torch.cuda.synchronize()
            if not torch.equal(part, full[:, :k]):
                raise AssertionError(f"sage_aggregate at D = {D}: the rows "
                                     f"of edges[:, :{k}] differ in bits from "
                                     f"the full call's")
        log(f"  sage_aggregate, D = {D}, edges {tuple(edges.shape)}: the "
            f"rows of edges[:, :k] equal the full call's bit for bit for "
            f"k = 1, 7, 32")


def check_forward_edge_shapes(rng) -> None:
    """The forward against the f-ordered loop (bits) and the plain version
    on edge shapes: S = 1, B = 1, a tile of only -1 rows, S = 0, F = 1 and
    F = 33 (the generic path), D = 1, 33, 100, 130, 256, h off 16-byte
    alignment (the scalar path at D = 100), and wide rows (F = 8192, the
    most ids a block stages, and 8193, 11 361, 16 384 past it, at D = 100
    and 256: one hand-written kernel a call, the wide-row one past 8192);
    ids -1 and >= N, and duplicates, everywhere.  Then the wide rows that
    the wide kernel's compaction makes risky: a hub row of 11 361 valid
    ids, rows of only -1 and of only ids >= N, F = 8194 and 8195 (with
    8193, every row start mod 16 bytes), valid ids across the compacted
    chunks' boundaries and a row that fills every chunk (F = 3 *
    WIDE_CHUNK_IDS + 5), the scalar path at F = 11 361 (D = 33, and
    D = 100 with h off 16-byte alignment), and D = 257 and 1028 (two
    column passes over a row, scalar and float4)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sage_aggregate import (MAX_STAGED_IDS,
                                                    WIDE_CHUNK_IDS,
                                                    sage_aggregate)
    # (label, B, S, F, N, D, kind of wide rows)
    cases = [("S = 1, B = 1", 1, 1, 5, 60, 100, ""),
             ("B = 1", 1, 700, 10, 900, 256, ""),
             ("a tile of only -1 rows", 2, 300, 5, 400, 100, ""),
             ("S = 0", 2, 0, 5, 50, 100, ""),
             ("F = 1", 3, 500, 1, 200, 256, ""),
             ("F = 33 (generic path)", 2, 300, 33, 500, 100, ""),
             ("D = 1", 3, 500, 15, 100, 1, ""),
             ("D = 33", 2, 400, 10, 300, 33, ""),
             ("D = 130", 2, 400, 15, 300, 130, ""),
             ("D = 256", 4, 1000, 15, 3000, 256, ""),
             ("h off 16-byte alignment", 2, 600, 5, 800, 100, "")]
    # wide rows: F at and past the MAX_STAGED_IDS ids a block stages (exact
    # inference pads to the max in-degree, 11 361 on phase 3's graph)
    cases += [(f"F = {Fo} (wide rows)" if Fo > MAX_STAGED_IDS
               else f"F = {Fo}", 2, 48, Fo, 5000, D, "")
              for Fo in WIDE_FANOUTS for D in (100, 256)]
    chunks = 3 * WIDE_CHUNK_IDS + 5
    cases += [(f"a hub row of {WIDE_FANOUTS[2]} valid ids", 1, 8,
               WIDE_FANOUTS[2], 20000, D, "hub") for D in (100, 256)]
    cases += [("rows of only -1 and of only ids >= N", 2, 16,
               WIDE_FANOUTS[2], 5000, 100, "empty")]
    cases += [(f"F = {Fo} (rows start at "
               f"{len({r * Fo * 4 % 16 for r in range(4)})} offsets mod 16 B)",
               2, 48, Fo, 5000, 100, "") for Fo in (8194, 8195)]
    cases += [(f"F = {chunks}: ids across the boundaries of "
               f"{WIDE_CHUNK_IDS}-id chunks", 1, 6, chunks, 5000, D, "chunks")
              for D in (100, 256)]
    cases += [(f"D = 33 (scalar path), F = {WIDE_FANOUTS[2]}", 2, 24,
               WIDE_FANOUTS[2], 3000, 33, ""),
              (f"h off 16-byte alignment (scalar path), F = "
               f"{WIDE_FANOUTS[2]}", 2, 24, WIDE_FANOUTS[2], 3000, 100, ""),
              (f"D = 257 (scalar path, two column passes), F = "
               f"{WIDE_FANOUTS[1]}", 1, 12, WIDE_FANOUTS[1], 2000, 257, ""),
              (f"D = 1028 (two float4 column passes), F = "
               f"{WIDE_FANOUTS[1]}", 1, 12, WIDE_FANOUTS[1], 2000, 1028,
               "")]
    for label, B, S, Fo, N, D, kind in cases:
        e = rng.integers(-1, N + 3, (B, S, Fo)).astype(np.int32)
        if S:
            e[:, 0] = e[:, 0, :1]                 # a duplicate run
        if label.startswith("a tile"):
            e[1, :70] = -1                        # two whole 32-row tiles
        if Fo >= MAX_STAGED_IDS:
            e[:, 1:20, 300:] = -1                 # mostly padding, as in
            #                                       exact inference
        if kind == "hub":                         # every id valid
            e[0, 0] = rng.integers(0, N, Fo)
        elif kind == "empty":
            e[:, 1:5] = -1
            e[:, 5:9] = rng.integers(N, N + 1000, (B, 4, Fo))
        elif kind == "chunks":
            # row 0 fills every chunk's compacted list; rows 1-3 hold
            # valid ids only from 8 before to 5 after each chunk boundary
            # (the head offset moves a boundary by up to 3 ids), at the
            # row's ends, or two at each boundary among ids >= N
            e[0, 0] = rng.integers(0, N, Fo)
            e[0, 1:4] = -1
            e[0, 3] = rng.integers(N, N + 9, Fo)
            for b in range(WIDE_CHUNK_IDS, Fo, WIDE_CHUNK_IDS):
                e[0, 1, b - 8:b + 5] = rng.integers(0, N, 13)
                e[0, 3, b - 1:b + 1] = rng.integers(0, N, 2)
            e[0, 2, :3] = rng.integers(0, N, 3)
            e[0, 2, -3:] = rng.integers(0, N, 3)
        e = torch.from_numpy(e).cuda()
        buf = torch.from_numpy(rng.normal(0, 1, B * N * D + 1).astype(
            np.float32)).cuda()
        h = (buf[1:] if label.startswith("h off") else buf[:-1]).view(B, N, D)
        _, err = check_forward_once(e, h, label)
        note = ""
        if Fo >= MAX_STAGED_IDS:
            want = ("sage_aggregate_wide_kernel" if Fo > MAX_STAGED_IDS
                    else "sage_aggregate_kernel")
            one_kernel_ms(lambda: sage_aggregate(e, h), sage_aggregate, want,
                          reps=3)
            note = f", one {want} per call"
        log(f"  sage_aggregate, {label}: edges {(B, S, Fo)} h {(B, N, D)}: "
            f"equal to the f-ordered loop bit for bit, max abs err "
            f"{err:.3g} (atol {wide_sum_tol(Fo, h):.3g}){note}")


def check_feature_gather(ids, table):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.feature_gather import (feature_gather,
                                                    feature_gather_plain)
    got = feature_gather(ids, table)
    ref = feature_gather_plain(ids, table)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"feature_gather differs from the plain version "
                             f"(max abs error {err})")
    B, Q = ids.shape
    M, D = table.shape[1:]
    # library yardstick: one embedding lookup into the flattened table with
    # a zero row for ids outside the shard (prepared once, outside the
    # timing)
    flat = torch.cat([table.reshape(B * M, D), table.new_zeros((1, D))])
    off = (torch.arange(B, device=ids.device) * M).view(B, 1)
    idx = torch.where((ids >= 0) & (ids < M), ids + off, B * M)
    if not torch.equal(F.embedding(idx, flat), ref):
        raise AssertionError("F.embedding yardstick disagrees")
    ms, call, _ = time_ms(lambda: feature_gather(ids, table))
    plain, _, _ = time_ms(lambda: feature_gather_plain(ids, table))
    lib, _, _ = time_ms(lambda: F.embedding(idx, flat))
    nbytes = B * Q * 4 + unique_rows(ids, M) * D * 4 + B * Q * D * 4
    tot = {"ms": ms, "call_ms": call, "plain_ms": plain, "library_ms": lib,
           "err": err}
    bnd = add_bound(tot, nbytes, 0.0)
    log(f"  feature_gather: ids {tuple(ids.shape)} table "
        f"{tuple(table.shape)}: exact match, device {ms:.4f} ms, call "
        f"{call:.4f} ms (plain {plain:.4f} ms, F.embedding {lib:.4f} ms, "
        f"bound {bnd:.5f} ms for {nbytes} B)")
    return tot


def predict_breakdown(pred, seeds, label: str) -> None:
    """Wall time of one ``predict`` against the device time of the
    kernels it launches (profiled), and the largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict(seeds)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with kernel_trace() as prof:
        pred.predict(seeds)
    rows = sorted(((_device_us(e) / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  {label}: wall {wall:.3f} ms (median of 5), device busy "
        f"{busy:.3f} ms in {sum(r[1] for r in rows)} device ops, idle "
        f"share {1 - busy / wall:.3f}")
    for ms, count, name in rows[:8]:
        log(f"    {ms:8.4f} ms  x{count:<4d} {name[:90]}")


def small_parity(cfg_small) -> None:
    """The port on the card against the port on the CPU at 800 nodes."""
    import numpy as np
    import torch
    from repro_torch.models.gnn import init_gnn_params
    from repro_torch.pipeline import DataSpec, Pipeline, PipelineSpec
    from repro_torch.serve import Predictor, max_owner_count, route_by_owner

    data = DataSpec(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
                    num_features=cfg_small.in_dim,
                    num_classes=cfg_small.num_classes, seed=3)
    spec = PipelineSpec.from_scheme("hybrid+fused", num_parts=NUM_PARTS,
                                    fanouts=cfg_small.fanouts, data=data)
    out = {}
    mfgs = {}
    for dev in ("cuda", "cpu"):
        pipe = Pipeline.build_from_source(spec=spec, device=dev)
        params = init_gnn_params(cfg_small, torch.Generator().manual_seed(1),
                                 dev)
        pred = Predictor(pipe, params, cfg_small, base_salt=SALT,
                         device=dev)
        seeds = np.random.default_rng(0).integers(0, 800, 64)
        out[dev] = pred.predict(seeds)
        internal = pred._to_internal(seeds)
        routed, _ = route_by_owner(pred.offsets, internal,
                                   max_owner_count(pred.offsets, internal))
        prepare, _ = pipe.make_infer_prepare_consume(lambda *a: None,
                                                     device=dev)
        with torch.inference_mode():
            batch = prepare(pipe.shards, torch.from_numpy(routed).to(dev),
                            SALT)
        mfgs[dev] = batch.mfgs
    for level, (a, b) in enumerate(zip(mfgs["cuda"], mfgs["cpu"])):
        for field in ("dst_nodes", "src_nodes", "num_src", "edges",
                      "edge_mask", "indptr"):
            if not torch.equal(getattr(a, field).cpu(), getattr(b, field)):
                raise AssertionError(f"small parity: MFG level {level} "
                                     f"field {field} differs cuda vs cpu")
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    if not np.allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"small parity: logits differ by {err}")
    log(f"  800-node graph, P={NUM_PARTS}, fanouts {cfg_small.fanouts}: "
        f"MFGs equal cuda vs cpu, logits max abs err {err:.3g} (tol 1e-5)")


def matmul_row_probe() -> list:
    """Row counts M at which ``x[:M] @ w`` on the card differs in bits from
    the first M rows of one product over all rows (why the model issues
    its products in fixed row blocks)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((256, 47), device="cuda", generator=g)
    x = torch.randn((22528, 256), device="cuda", generator=g)
    full = x @ w
    return [m for m in (1, 4, 16, 64, 128, 512, 2048, 8192)
            if not torch.equal(x[:m] @ w, full[:m])]


def check_gather_rows(table, ids):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.gather import gather_rows, gather_rows_plain
    got = gather_rows(table, ids)
    ref = gather_rows_plain(table, ids)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"gather_rows differs from the plain version "
                             f"(max abs error {err})")
    B, N = ids.shape
    Kc, D = table.shape[1:]
    flat = torch.cat([table.reshape(B * Kc, D), table.new_zeros((1, D))])
    off = (torch.arange(B, device=ids.device) * Kc).view(B, 1)
    idx = torch.where((ids >= 0) & (ids < Kc), ids + off, B * Kc)
    if not torch.equal(F.embedding(idx, flat), ref):
        raise AssertionError("F.embedding yardstick disagrees")
    ms, call, _ = time_ms(lambda: gather_rows(table, ids))
    plain, _, _ = time_ms(lambda: gather_rows_plain(table, ids))
    lib, _, _ = time_ms(lambda: F.embedding(idx, flat))
    hits = int(((ids >= 0) & (ids < Kc)).sum())
    nbytes = B * N * 4 + unique_rows(ids, Kc) * D * 4 + B * N * D * 4
    tot = {"ms": ms, "call_ms": call, "plain_ms": plain, "library_ms": lib,
           "err": err}
    bnd = add_bound(tot, nbytes, 0.0)
    log(f"  gather_rows: ids {tuple(ids.shape)} ({hits} hits) table "
        f"{tuple(table.shape)}: exact match, device {ms:.4f} ms, call "
        f"{call:.4f} ms (plain {plain:.4f} ms, F.embedding {lib:.4f} ms, "
        f"bound {bnd:.5f} ms for {nbytes} B)")
    return tot


def backward_transpose_bound(edges, n: int, tot: dict) -> float:
    """Least time of ``sage_backward_index``: edge ids read once; row
    pointer, slots and ``denom`` written once."""
    B, S, Fo = edges.shape
    nbytes = B * S * Fo * 4 * 2 + (B * n + 1) * 4 + B * S * 4
    return add_bound(tot, nbytes, 0.0)


def check_transpose(edges, n: int) -> int:
    """The card's transpose equals ``backward_index`` bit for bit, with
    ``torch.searchsorted`` unavailable while the card builds it.  Returns
    the most slots any source row holds."""
    import torch
    from repro_torch.kernels.sage_aggregate import (backward_index,
                                                    sage_backward_index)

    def no_searchsorted(*args, **kwargs):
        raise AssertionError("the CUDA backward called torch.searchsorted")

    saved = torch.searchsorted
    torch.searchsorted = no_searchsorted
    try:
        got = sage_backward_index(edges, n)
        torch.cuda.synchronize()
    finally:
        torch.searchsorted = saved
    for name, a, b in zip(("rowptr", "slots", "denom"), got,
                          backward_index(edges, n)):
        if not torch.equal(a, b):
            raise AssertionError(f"the card's transpose: {name} differs "
                                 f"from backward_index")
    return int(torch.diff(got[0]).max()) if got[0].numel() > 1 else 0


def check_backward_once(edges, g, n: int) -> tuple[float, float, int]:
    """The backward kernel against its plain version: the transpose bit
    for bit, the same bits on two calls, max abs error within BWD_RTOL of
    the largest gradient.  Returns (the error, the largest gradient, the
    most slots a source row holds)."""
    import torch
    from repro_torch.kernels.sage_aggregate import (
        sage_aggregate_backward, sage_aggregate_backward_plain)
    most = check_transpose(edges, n)
    got = sage_aggregate_backward(edges, g, n)
    again = sage_aggregate_backward(edges, g, n)
    ref = sage_aggregate_backward_plain(edges, g, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("sage_aggregate backward: two calls on the "
                             "same inputs differ in bits")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if err > BWD_RTOL * scale:
        raise AssertionError(f"sage_aggregate backward: max abs error "
                             f"{err} against the plain version (max "
                             f"|grad| {scale}, rtol {BWD_RTOL})")
    return err, scale, most


def check_sage_backward(recorded):
    """``recorded``: (edges, grad_out, num_src) of each layer whose input
    requires grad, from one training step.  Returns the backward's result
    and that of the transpose it builds (``sage_backward_index``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.sage_aggregate import (
        backward_index, sage_aggregate_backward,
        sage_aggregate_backward_plain, sage_backward_index)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "err": 0.0,
           "split": {}, "cold_ms": 0.0, "cold_call_ms": 0.0}
    idx = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "err": 0.0,
           "library_ms": None}
    flush = l2_flush()
    for edges, g, n in recorded:
        err, scale, most = check_backward_once(edges, g, n)
        ref = sage_aggregate_backward_plain(edges, g, n)
        B, S, Fo = edges.shape
        D = g.shape[-1]
        # library yardstick: the backward of one embedding_bag(mean) over
        # the flattened table with a zero padding row (graph built once,
        # outside the timing)
        table = torch.zeros((B * n + 1, D), device=g.device,
                            requires_grad=True)
        off = (torch.arange(B, device=g.device) * n).view(B, 1, 1)
        bag = torch.where(edges >= 0, edges + off, B * n).reshape(-1, Fo)
        out = F.embedding_bag(bag, table, mode="mean", padding_idx=B * n)
        g2 = g.reshape(-1, D)

        def lib_fn():
            return torch.autograd.grad(out, table, g2, retain_graph=True)[0]

        lib_grad = lib_fn()[:B * n].view(B, n, D)
        if float((lib_grad - ref).abs().max()) > BWD_RTOL * scale:
            raise AssertionError("embedding_bag backward yardstick "
                                 "disagrees")
        del ref, lib_grad

        def kernel():
            return sage_aggregate_backward(edges, g, n)

        ms, call, split = time_ms(kernel)
        cold, cold_call, cold_split = time_ms(kernel, flush=flush)
        plain, _, _ = time_ms(lambda: sage_aggregate_backward_plain(edges,
                                                                    g, n))
        lib, _, _ = time_ms(lib_fn)
        out_buf = torch.empty((B, n, D), device=g.device)
        floor, _, _ = time_ms(out_buf.zero_)
        del out_buf
        i_ms, i_call, _ = time_ms(lambda: sage_backward_index(edges, n))
        i_plain, _, _ = time_ms(lambda: backward_index(edges, n))
        valid = (edges >= 0) & (edges < n)
        n_valid = int(valid.sum())
        n_dst = int(valid.any(dim=-1).sum())
        nbytes = B * S * Fo * 4 + n_dst * D * 4 + B * n * D * 4
        bnd = add_bound(tot, nbytes, 2.0 * n_valid * D)
        i_bnd = backward_transpose_bound(edges, n, idx)
        gather = split.get("sage_aggregate_backward_kernel", 0.0)
        cold_gather = cold_split.get("sage_aggregate_backward_kernel", 0.0)
        log(f"  sage_aggregate backward: edges {tuple(edges.shape)} "
            f"grad_out {tuple(g.shape)} -> ({B}, {n}, {D}), {n_valid} valid "
            f"slots, at most {most} per source row: transpose == "
            f"backward_index bit for bit (no searchsorted), max abs err "
            f"{err:.3g} (max |grad| {scale:.3g}, rtol {BWD_RTOL}), same "
            f"bits on two calls, device {ms:.4f} ms (gather kernel "
            f"{gather:.4f}), call {call:.4f} ms; L2 flushed before each "
            f"call: device {cold:.4f} ms (gather kernel {cold_gather:.4f}), "
            f"call {cold_call:.4f} ms (plain {plain:.4f} ms, embedding_bag "
            f"backward {lib:.4f} ms, bound {bnd:.5f} ms for {nbytes} B; "
            f"zero-filling the output alone {floor:.4f} ms)")
        log(f"    transpose alone: device {i_ms:.4f} ms, call {i_call:.4f} "
            f"ms (plain backward_index {i_plain:.4f} ms, bound "
            f"{i_bnd:.5f} ms)")
        log("    device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                              key=lambda kv: -kv[1])))
        for k, v in split.items():
            tot["split"][k] = tot["split"].get(k, 0.0) + v
        tot["ms"] += ms
        tot["call_ms"] = tot.get("call_ms", 0.0) + call
        tot["cold_ms"] += cold
        tot["cold_call_ms"] += cold_call
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["err"] = max(tot["err"], err)
        idx["ms"] += i_ms
        idx["call_ms"] += i_call
        idx["plain_ms"] += i_plain
    return tot, idx


def check_edge_shapes(graph) -> None:
    """The redesigned kernels against their plain versions on edge shapes:
    ``fused_sample`` with S = 1, S off either scan tile, B = 1, a row of
    only padding seeds, S = 0 and a window most seeds exceed; the forward
    aggregate (``check_forward_edge_shapes``); the backward with D off
    float4, a single slot, source rows holding thousands of slots (more
    than one warp's 32), and rows wider than the forward stages (F = 8193
    and 11 361: the backward gathers over its transpose, whatever F)."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_sample import (fused_sample,
                                                  fused_sample_plain)
    from repro_torch.kernels.fused_sample import LARGE_LEVEL, LARGE_TILE
    from repro_torch.kernels.fused_sample import SMALL_TILE
    rng = np.random.default_rng(5)
    n_nodes = graph.num_nodes

    def seeds(B, S):
        s = rng.integers(0, n_nodes, (B, S)).astype(np.int32)
        s[rng.random((B, S)) < 0.3] = -1
        return torch.from_numpy(s).cuda()

    padded = seeds(3, 700)
    padded[1] = -1
    cases = [("S = 1, B = 1", seeds(1, 1), 5, 2048),
             (f"S = tile + 1 = {SMALL_TILE + 1}", seeds(2, SMALL_TILE + 1),
              3, 2048),
             (f"{LARGE_TILE}-seed tiles, S = {LARGE_LEVEL // 2 + 1}",
              seeds(2, LARGE_LEVEL // 2 + 1), 5, 2048),
             (f"{LARGE_TILE}-seed tiles, B = 1, S = {LARGE_LEVEL + 3}",
              seeds(1, LARGE_LEVEL + 3), 2, 2048),
             ("S = 1000 (not a multiple of the tile)", seeds(4, 1000), 15,
              2048),
             ("a row of only -1 seeds", padded, 5, 2048),
             ("S = 0", seeds(2, 0), 4, 2048),
             ("window 4 (most seeds exceed it)", seeds(4, 5000), 6, 4),
             ("1-D seeds", seeds(1, 300)[0], 5, 2048)]
    for label, s, fanout, window in cases:
        args = (graph.indptr, graph.indices, s, 12345)
        got = fused_sample(*args, fanout=fanout, window=window)
        ref = fused_sample_plain(*args, fanout=fanout, window=window)
        torch.cuda.synchronize()
        for name, a, b in zip(("samples", "R", "overflow"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"fused_sample, {label}: {name} "
                                     f"differs from the plain version")
        if window == 4 and int(got[2].sum()) == 0:
            raise AssertionError("fused_sample: no seed exceeded window 4")
        log(f"  fused_sample, {label}: seeds {tuple(s.shape)}, fanout "
            f"{fanout}, window {window}: exact match, overflow "
            f"{int(got[2].sum())}")

    check_forward_edge_shapes(rng)

    for B, S, Fo, n, D, hub in ((1, 1, 1, 1, 1, False),
                                (1, 300, 5, 50, 33, False),
                                (2, 500, 3, 7, 256, False),
                                (4, 4000, 5, 2000, 256, True),
                                (1, 3000, 4, 100, 130, True),
                                (2, 40, WIDE_FANOUTS[1], 300, 256, True),
                                (2, 40, WIDE_FANOUTS[2], 300, 100, True)):
        e = rng.integers(-1, n + 1, (B, S, Fo)).astype(np.int32)
        if hub:
            e[0, :, 0] = 0
            e[-1, :S // 2, 1] = n - 1
        e = torch.from_numpy(e).cuda()
        g = torch.from_numpy(rng.normal(0, 1, (B, S, D)).astype(
            np.float32)).cuda()
        err, _, most = check_backward_once(e, g, n)
        if hub and most <= 32:
            raise AssertionError("no source row held more than 32 slots")
        log(f"  sage_aggregate backward: edges {(B, S, Fo)} -> ({B}, {n}, "
            f"{D}), at most {most} slots per source row: transpose == "
            f"backward_index, same bits on two calls, max abs err "
            f"{err:.3g} (rtol {BWD_RTOL} of max |grad|)")


EPILOGUE_ROWS = 176_000         # the benchmark's layer-1 destinations a
                                # worker (1000 -> 16 000 -> 176 000 rows)


def check_sage_epilogue() -> dict:
    """The ``sage_epilogue`` kernels against their plain versions (the
    chain of PyTorch ops they replace, run on the card) and the whole
    ``sage_hidden_tail`` op against the chain it replaces.

    At the benchmark's layer-1 shape (1, 176 000, 256) from 100 input
    features, dropout 0.5 from a CUDA generator: the op's forward equals
    ``rowwise_matmul(h_dst, w_self) + rowwise_matmul(agg, w_neigh) + b``,
    relu and ``out * (rand >= p) / (1 - p)`` bit for bit, its gradients
    within ``GRAD_RTOL`` of autograd through the chain.  Then the kernels
    alone on that shape and on ragged ones (rows off a block, H = 33 on the
    scalar path, an unaligned input, H = 4096, p = 0.3 and no dropout):
    the forward equal to the plain version (``torch.equal``), the backward's
    pre-activation gradient equal for a finite upstream gradient, its padded
    rows zero, the bias gradient within 1e-5 of the column sums of |dx|
    (float64 reference), and each wrapper's launch count one a call.  Both
    kernels timed at the big shape beside their plain versions and their
    least times (bytes: 4 (rows, H) arrays forward, 3 backward), each
    with its max abs error there (the backward's: the larger of dx's and
    the bias gradient's against its float64 column sums)."""
    import torch
    from repro_torch.kernels.sage_epilogue import (
        sage_epilogue, sage_epilogue_backward, sage_epilogue_backward_plain,
        sage_epilogue_plain)
    from repro_torch.models.gnn import rowwise_matmul, sage_hidden_tail

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # the whole op against the chain at the benchmark's layer-1 shape
    rows, K, H, p = EPILOGUE_ROWS, 100, 256, 0.5
    h_dst, agg = randn(1, rows, K), randn(1, rows, K)
    layer = {"w_self": randn(K, H) * 0.1, "w_neigh": randn(K, H) * 0.1,
             "b": randn(H) * 0.1}
    u = torch.rand((1, rows, H), generator=gen, device="cuda")
    leaves = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    got = sage_hidden_tail(h_dst, agg, leaves, u, p)
    chain = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    want = torch.relu(rowwise_matmul(h_dst, chain["w_self"])
                      + rowwise_matmul(agg, chain["w_neigh"]) + chain["b"])
    want = want * (u >= p) / (1 - p)
    if not torch.equal(got, want):
        raise AssertionError(f"sage_hidden_tail at (1, {rows}, {H}) differs "
                             f"from the chain in "
                             f"{int((got != want).sum())} elements")
    g = randn(1, rows, H)
    names = ("w_self", "w_neigh", "b")
    for name, a, b in zip(names, torch.autograd.grad(
            got, [leaves[k] for k in names], g), torch.autograd.grad(
            want, [chain[k] for k in names], g)):
        rel = float((a - b).abs().max() / b.abs().max())
        if rel > GRAD_RTOL:
            raise AssertionError(f"sage_hidden_tail's {name} gradient: "
                                 f"rel err {rel:.3g} > {GRAD_RTOL}")
    log(f"  sage_hidden_tail (1, {rows}, {K} -> {H}), dropout {p}: forward "
        f"== the chain bit for bit, gradients within {GRAD_RTOL}")

    def one(rows, H, p, offset=0, rows_pad=None):
        s = randn(rows * H + offset).view(-1)[offset:].view(rows, H)
        n, b = randn(rows, H), randn(H)
        u = None if p is None else torch.rand((rows, H), generator=gen,
                                              device="cuda")
        q = 0.0 if p is None else p
        out = sage_epilogue(s, n, b, u, q)
        want = sage_epilogue_plain(s, n, b, u, q)
        if not torch.equal(out, want):
            raise AssertionError(f"sage_epilogue ({rows}, {H}), p {p}, "
                                 f"offset {offset}: differs from the plain "
                                 f"version")
        g = randn(rows, H)
        dx, db = sage_epilogue_backward(g, out, q, rows_pad)
        px, _ = sage_epilogue_backward_plain(g, out, q, rows_pad)
        if not torch.equal(dx, px):
            raise AssertionError(f"sage_epilogue_backward ({rows}, {H}), p "
                                 f"{p}: dx differs from the plain version")
        ref = dx.double().sum(0)
        rel = float(((db.double() - ref).abs()
                     / dx.double().abs().sum(0).clamp(min=1e-30)).max())
        if rel > 1e-5:
            raise AssertionError(f"sage_epilogue_backward ({rows}, {H}): "
                                 f"bias gradient rel err {rel:.3g}")
        # max abs errors: the forward's and the backward's (dx's or the
        # bias gradient's, whichever is larger) against their references
        err = {"sage_epilogue": float((out - want).abs().max()),
               "sage_epilogue_backward": max(
                   float((dx - px).abs().max()),
                   float((db.double() - ref).abs().max()))}
        return s, n, b, u, q, out, g, rel, err

    for rows, H, p, offset, pad in ((EPILOGUE_ROWS, 256, 0.5, 0, 176_128),
                                    (777, 36, 0.5, 0, 4096),
                                    (1001, 33, 0.3, 0, None),
                                    (1000, 256, 0.3, 1, 1024),
                                    (5, 4096, None, 0, 9),
                                    (3, 16_384, 0.5, 0, None),
                                    (16_000, 256, None, 0, 16_384),
                                    (1, 4, 0.5, 0, None)):
        sage_epilogue.launches = sage_epilogue_backward.launches = 0
        *_, rel, _ = one(rows, H, p, offset, pad)
        launches = (sage_epilogue.launches, sage_epilogue_backward.launches)
        if launches != (1, 1):
            raise AssertionError(f"sage_epilogue launches {launches}, "
                                 f"expected 1 each")
        log(f"  sage_epilogue ({rows}, {H}), dropout {p}, offset {offset}, "
            f"rows_pad {pad}: forward and dx == plain, bias grad rel err "
            f"{rel:.3g}, 1 launch each")

    s, n, b, u, q, out, g, _, err = one(EPILOGUE_ROWS, 256, 0.5, 0,
                                        176_128)
    A = EPILOGUE_ROWS * 256 * 4
    res = {}
    for name, fn, plain, kernel, nbytes in (
            ("sage_epilogue", lambda: sage_epilogue(s, n, b, u, q),
             lambda: sage_epilogue_plain(s, n, b, u, q),
             "sage_epilogue_kernel", 4 * A + 256 * 4),
            ("sage_epilogue_backward",
             lambda: sage_epilogue_backward(g, out, q, 176_128),
             lambda: sage_epilogue_backward_plain(g, out, q, 176_128),
             "sage_epilogue_backward_kernel", 3 * A + 256 * 4)):
        wrapper = (sage_epilogue if name == "sage_epilogue"
                   else sage_epilogue_backward)
        ms, call_ms, by_name = time_ms(fn, wrapper=wrapper, kernel=kernel)
        plain_ms, _, _ = time_ms(plain)
        tot = {}
        add_bound(tot, nbytes, 0.0)
        res[name] = {"err": err[name], "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": tot["bound_ms"],
                     "bound_by": tot["bound_by"], "library_ms": None,
                     "kernel_ms": by_name.get(kernel)}
        log(f"  {name} (1, {EPILOGUE_ROWS}, 256), dropout 0.5: device "
            f"{ms:.4f} ms ({kernel} {by_name.get(kernel, 0.0):.4f}), call "
            f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}; "
            f"{100 * tot['bound_ms'] / by_name.get(kernel, ms):.1f} % of "
            f"the kernel)")
    return res


# the benchmark's gatv1 layer-1 shape a worker: 1000 seeds, fanouts 10, 10,
# 10 (S = 121 000 destinations, F = 10), 4 heads of 128
GAT_ROWS, GAT_F, GAT_H, GAT_C = 121_000, 10, 4, 128
GAT_CHUNK = 8192                # rows a float64 reference chunk
GAT_KINK = 1e-4                 # scores this near 0 take no gradient


def check_gat_attention() -> dict:
    """The ``gat_attention`` kernels against their plain versions computed
    in float64 (in row chunks), at the benchmark's layer-1 shape (121 000
    rows, 10 edges, 4 heads of 128) and on ragged ones (the last layer's
    C = 47 on the scalar path, an unaligned input, F = 1, one row, a head
    of 8).  ``keep`` drops a quarter of the edges at random and every edge
    of some rows (the self slot alone); rows with a score within
    ``GAT_KINK`` of LeakyReLU's kink take a zero upstream gradient (the
    card's float32 may put such a score on the other side of 0 than the
    float64 reference, and the slope's gradient jumps 5x there).
    Forward: the output within 1e-5
    of the largest |output| (float32 dots of C terms and a softmax), the
    weights within 1e-6; backward: dz_nb, dz_dst and the attention
    vectors' gradients (sums over every row) within ``GRAD_RTOL`` of their
    largest |value|; each wrapper one launch a call.  Both
    kernels timed at the big shape beside their float32 plain versions and
    their least times (bytes: their own inputs read once, outputs written
    once)."""
    import torch
    from repro_torch.kernels.gat_attention import (
        gat_attention, gat_attention_backward, gat_attention_backward_plain,
        gat_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(rows, F, H, C, offset=0):
        z_nb = randn(rows * F * H * C + offset)[offset:].view(rows, F,
                                                              H * C)
        keep = torch.rand((rows, F), generator=gen, device="cuda") >= 0.25
        keep[::7] = False                     # the self slot alone
        return (z_nb, randn(rows, H * C), keep, randn(H, C) * 0.1,
                randn(H, C) * 0.1)

    def at_the_kink(xs):
        """Rows with a kept slot whose score lies within ``GAT_KINK`` of
        LeakyReLU's kink (float64): float32 may put it on the other side,
        where the slope's gradient is 5x another."""
        z_nb, z_dst, keep, a_src, a_dst = xs
        rows, F, _ = z_nb.shape
        H, C = a_src.shape
        out = torch.zeros(rows, dtype=torch.bool, device="cuda")
        for lo in range(0, rows, GAT_CHUNK):
            sl = slice(lo, lo + GAT_CHUNK)
            zd = z_dst[sl].double().view(-1, 1, H, C)
            zs = torch.cat([zd, z_nb[sl].double().view(-1, F, H, C)], 1)
            pre = (zs * a_src.double()).sum(-1) \
                + (zd * a_dst.double()).sum(-1)
            ok = torch.cat([torch.ones_like(keep[sl, :1]), keep[sl]], 1)
            out[sl] = ((pre.abs() < GAT_KINK) & ok[..., None]).any(-1).any(-1)
        return out

    def one(rows, F, H, C, offset=0):
        xs = inputs(rows, F, H, C, offset)
        gat_attention.launches = gat_attention_backward.launches = 0
        out, alpha = gat_attention(*xs)
        # no upstream gradient at the kink: the gradient there is 0 in
        # any precision
        g = randn(rows, H, C) * ~at_the_kink(xs)[:, None, None]
        grads = gat_attention_backward(g, *xs, alpha)
        if (gat_attention.launches, gat_attention_backward.launches) \
                != (1, 1):
            raise AssertionError("gat_attention: one launch a call each")
        names = ("out", "alpha", "dz_nb", "dz_dst")
        err = dict.fromkeys(names + ("da",), 0.0)
        scale = dict.fromkeys(names + ("da",), 0.0)
        da_ref = [0.0, 0.0]
        for lo in range(0, rows, GAT_CHUNK):
            sl = slice(lo, lo + GAT_CHUNK)
            x64 = (xs[0][sl].double(), xs[1][sl].double(), xs[2][sl],
                   xs[3].double(), xs[4].double())
            o64, a64 = gat_attention_plain(*x64)
            d64 = gat_attention_backward_plain(g[sl].double(), *x64, a64)
            for k, got, want in (("out", out[sl], o64),
                                 ("alpha", alpha[sl], a64),
                                 ("dz_nb", grads[0][sl], d64[0]),
                                 ("dz_dst", grads[1][sl], d64[1])):
                err[k] = max(err[k], float((got - want).abs().max()))
                scale[k] = max(scale[k], float(want.abs().max()))
            da_ref = [da_ref[i] + d64[2 + i] for i in range(2)]
        for i in range(2):
            err["da"] = max(err["da"], float(
                (grads[2 + i].double() - da_ref[i]).abs().max()))
            scale["da"] = max(scale["da"], float(da_ref[i].abs().max()))
        lims = {"out": 1e-5, "alpha": 1e-6, "dz_nb": GRAD_RTOL,
                "dz_dst": GRAD_RTOL, "da": GRAD_RTOL}
        bad = [k for k, lim in lims.items()
               if err[k] > lim * (1.0 if k == "alpha" else scale[k])]
        if bad:
            raise AssertionError(f"gat_attention ({rows}, {F}, {H}, {C}), "
                                 f"offset {offset}: {bad} out of tolerance; "
                                 f"errors {err}, scales {scale}")
        return xs, out, alpha, g, err, scale

    for rows, F, H, C, offset in ((1000, 10, 4, 47, 0), (777, 10, 4, 128, 1),
                                  (513, 1, 4, 128, 0), (1, 10, 4, 128, 0),
                                  (3000, 5, 8, 64, 0), (257, 3, 1, 33, 0)):
        _, _, _, _, err, _ = one(rows, F, H, C, offset)
        log(f"  gat_attention ({rows}, {F}, {H} x {C}), offset {offset}: "
            f"within tolerance of float64 (max abs errors: " + ", ".join(
                f"{k} {v:.3g}" for k, v in err.items()) + "), 1 launch each")

    R, F, H, C = GAT_ROWS, GAT_F, GAT_H, GAT_C
    xs, out, alpha, g, err, scale = one(R, F, H, C)
    log(f"  gat_attention ({R}, {F}, {H} x {C}): within tolerance of "
        f"float64 (max abs errors: " + ", ".join(
            f"{k} {v:.3g}" for k, v in err.items()) + "; largest |values|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in scale.items()) + ")")
    HC, K = H * C, F + 1
    fwd_bytes = 4 * (R * F * HC + 2 * R * HC + 2 * HC + R * K * H) + R * F
    blocks = -(-R // 32)
    bwd_bytes = (4 * (2 * R * HC + R * F * HC + R * K * H + 2 * HC) + R * F
                 + 4 * (R * F * HC + R * HC + 2 * blocks * HC))
    res = {}
    for name, fn, plain, kernel, nbytes, e in (
            ("gat_attention", lambda: gat_attention(*xs),
             lambda: gat_attention_plain(*xs), "gat_attention_kernel",
             fwd_bytes, max(err["out"], err["alpha"])),
            ("gat_attention_backward",
             lambda: gat_attention_backward(g, *xs, alpha),
             lambda: gat_attention_backward_plain(g, *xs, alpha),
             "gat_attention_backward_kernel", bwd_bytes,
             max(err["dz_nb"], err["dz_dst"], err["da"]))):
        wrapper = (gat_attention if name == "gat_attention"
                   else gat_attention_backward)
        ms, call_ms, by_name = time_ms(fn, wrapper=wrapper, kernel=kernel)
        plain_ms, _, _ = time_ms(plain)
        tot = {}
        add_bound(tot, nbytes, 0.0)
        res[name] = {"err": e, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": tot["bound_ms"],
                     "bound_by": tot["bound_by"], "library_ms": None,
                     "kernel_ms": by_name.get(kernel)}
        log(f"  {name} ({R}, {F}, {H} x {C}): device {ms:.4f} ms ({kernel} "
            f"{by_name.get(kernel, 0.0):.4f}), call {call_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}; "
            f"{100 * tot['bound_ms'] / by_name.get(kernel, ms):.1f} % of the "
            f"kernel)")
    return res


def feature_rows(layout, src):
    """The rows ``src`` names, read straight from the owners' shards
    (+0.0 for padding): the fetch's expected output."""
    import torch
    from repro_torch.core.dist import owner_of
    own = owner_of(layout.offsets, src).long().clamp(min=0)
    local = (src.long() - layout.offsets.long()[own]).clamp(min=0)
    rows = layout.features[own, local]
    return torch.where((src >= 0)[..., None], rows,
                       torch.zeros((), device=rows.device))


def training_phase(layout, data, cfg):
    """Phase 8: returns ({kernel name: its result at the step's shapes},
    launch counts of the 10-step driver run, that run as phase 9's
    reference: {"params0", "losses", "params", "params_after": {steps:
    params}})."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    import repro_torch.kernels as K
    from repro_torch.core.dist import cache_lookup
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_plain)
    from repro_torch.models.gnn import gnn_loss, init_gnn_params
    from repro_torch.optim import init_opt_state, tree_leaves
    from repro_torch.pipeline import Pipeline, PipelineSpec

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = {store: PipelineSpec.from_scheme(
        "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
        cache_capacity=CACHE_K, cache_policy="degree", feature_store=store,
        data=data) for store in ("pinned_hot", "exchange")}
    pin = Pipeline.from_layout(layout, specs["pinned_hot"])
    exc = Pipeline.from_layout(layout, specs["exchange"])
    log(f"pinned_hot and exchange pipelines over phase 3's layout, "
        f"cache {tuple(pin.cache.rows.shape)} "
        f"({pin.cache.rows.numel() * 4 / 1e6:.1f} MB per store): "
        f"{time.perf_counter() - t0:.1f} s")

    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cuda")

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    def plain_loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg,
                        aggregate=sage_aggregate_plain)

    recorded = []
    forward_inputs = []

    def recording_aggregate(edges, h):
        forward_inputs.append((edges, h.detach()))
        out = sage_aggregate(edges, h)
        if h.requires_grad:
            out.register_hook(lambda g, e=edges, n=h.shape[-2]:
                              recorded.append((e, g, n)))
        return out

    def recording_loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg,
                        aggregate=recording_aggregate)

    seeds = pin.seeds(TRAIN_BATCH, TRAIN_SALT)
    prep_pin, consume = pin.make_prepare_consume(loss_fn, counted=False)
    prep_exc, _ = exc.make_prepare_consume(loss_fn, counted=False)
    _, consume_plain = pin.make_prepare_consume(plain_loss_fn,
                                                counted=False)
    _, consume_rec = pin.make_prepare_consume(recording_loss_fn,
                                              counted=False)
    with torch.no_grad():
        bp = prep_pin(pin.shards, seeds, TRAIN_SALT, pin.cache)
        be = prep_exc(exc.shards, seeds, TRAIN_SALT, exc.cache)
    src = bp.mfgs[-1].src_nodes
    log(f"one step's shapes: seeds {tuple(seeds.shape)}, frontier "
        f"{tuple(src.shape)} ({int((src >= 0).sum())} valid), MFG edges "
        + ", ".join(str(tuple(m.edges.shape)) for m in bp.mfgs))

    log("-- stores: pinned_hot against exchange with the same cache")
    if not torch.equal(bp.h_src, feature_rows(layout, src)):
        raise AssertionError("pinned_hot h_src differs from the owners' rows")
    if not (torch.equal(bp.h_src, be.h_src)
            and torch.equal(bp.hits, be.hits)):
        raise AssertionError("pinned_hot and exchange h_src or hits differ")
    lp, gp, mp = consume(params, bp)
    le, ge, _ = consume(params, be)
    same_grads = all(torch.equal(a, b) for a, b in zip(tree_leaves(gp),
                                                       tree_leaves(ge)))
    if not (torch.equal(lp, le) and same_grads):
        raise AssertionError(f"pinned_hot and exchange steps differ: loss "
                             f"{float(lp)} vs {float(le)}")
    log(f"h_src {tuple(bp.h_src.shape)} equal to the owners' rows and "
        f"between the stores bit for bit; hits {bp.hits.tolist()} (hit "
        f"rate {float(mp['cache_hit_rate']):.4f}); loss {float(lp):.6f} and "
        f"every gradient leaf bit-identical")

    log("-- the step with kernels against the same step with plain "
        "versions")
    lq, gq, _ = consume_plain(params, bp)
    loss_err = abs(float(lp) - float(lq))
    if loss_err > LOSS_TOL:
        raise AssertionError(f"loss {float(lp)} vs plain {float(lq)}")
    worst = 0.0
    for a, b in zip(tree_leaves(gp), tree_leaves(gq)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > GRAD_RTOL:
            raise AssertionError(f"gradient leaf {tuple(a.shape)} differs "
                                 f"from the plain step by {rel:.3g} of its "
                                 f"max (tol {GRAD_RTOL})")
    log(f"loss {float(lp):.6f} vs plain {float(lq):.6f} (abs err "
        f"{loss_err:.3g}, tol {LOSS_TOL}); gradients: worst leaf max abs "
        f"err {worst:.3g} of its max |g| (tol {GRAD_RTOL})")

    log("-- kernels against their plain versions at the step's shapes")
    is_hit, pos = cache_lookup(pin.cache, src)
    hit_pos = torch.where(is_hit, pos, -1).to(torch.int32)
    gr = check_gather_rows(pin.cache.rows, hit_pos)
    consume_rec(params, bp)
    # one forward and backward a worker: the kernels' calls at a step's
    # shapes are worker 0's (the other workers' have the same shapes)
    L = cfg.num_layers
    if (len(forward_inputs), len(recorded)) != (NUM_PARTS * L,
                                                NUM_PARTS * (L - 1)):
        raise AssertionError(f"{len(forward_inputs)} forward and "
                             f"{len(recorded)} backward aggregates recorded "
                             f"for {L} layers of {NUM_PARTS} workers")
    del forward_inputs[L:], recorded[L - 1:]
    bw, bidx = check_sage_backward(recorded)
    fs = check_fused_sample(layout.graph, [m.dst_nodes for m in bp.mfgs],
                            cfg.fanouts, TRAIN_SALT)
    log("  fused_sample, 3 levels at the step's shapes, device ms by "
        "kernel: " + ", ".join(f"{k} {v:.4f}"
                               for k, v in fs["split"].items()))
    sa = check_sage_aggregate(forward_inputs, "training step")
    del recorded[:], forward_inputs[:], bp, be, gp, ge, gq, hit_pos
    del is_hit, pos
    exc = None

    log(f"-- {TRAIN_STEPS} steps through SyncDriver (launch counts set to "
        f"0 first)")
    opt = init_opt_state(params)
    driver = pin.train_driver(loss_fn, batch=TRAIN_BATCH, lr=TRAIN_LR,
                              grad_clip=1.0)
    reference = {"params0": params}
    K.reset_launch_counts()
    rounds_before = pin.counter.rounds
    losses, walls, hit_rates, after = [], [], [], {}
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss, m = driver.step(params, opt)
        losses.append(float(loss))          # synchronizes
        walls.append((time.perf_counter() - t0) * 1e3)
        hit_rates.append(float(m["cache_hit_rate"]))
        after[k + 1] = params
    counts = K.launch_counts()
    reference.update(losses=losses, params=params, walls=walls,
                     params_after=after)
    rounds = (pin.counter.rounds - rounds_before) / TRAIN_STEPS
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if rounds != 2:
        raise AssertionError(f"{rounds} communication rounds per step, "
                             f"expected 2")
    missing = [k for k, v in counts.items()
               if v == 0 and k not in GAT_KERNELS]
    if missing:
        raise AssertionError(f"kernels never launched on the training "
                             f"path: {missing}")
    log("losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"cache hit rate {statistics.mean(hit_rates):.4f} (mean over the "
        f"steps), {rounds:g} rounds per step, step wall median "
        f"{statistics.median(walls):.3f} ms (min {min(walls):.3f}, max "
        f"{max(walls):.3f}; includes the host's seed draw)")
    log("launches per step: " + ", ".join(
        f"{k} {v / TRAIN_STEPS:g}" for k, v in counts.items()))

    split = stage_split(pin, loss_fn, params, "hybrid+fused")

    with kernel_trace() as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, opt, loss, _ = driver.step(params, opt)
            float(loss)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    rows = sorted(((_device_us(e) / 1e3 / 2, e.count // 2, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"one step (profiled, 2 steps): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms in {sum(r[1] for r in rows)} device ops, idle "
        f"share {1 - busy / wall:.3f}")
    for ms, count, name in rows[:12]:
        log(f"    {ms:8.4f} ms  x{count:<5d} {name[:90]}")
    ours = {}
    for ms, count, name in rows:
        short = _short(name)
        if short in HAND_WRITTEN:
            ours[short] = ours.get(short, 0.0) + ms
    log(f"hand-written kernels per step: {sum(ours.values()):.4f} ms device ("
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ours.items())) + ")")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB (torch.cuda.max_memory_allocated)")
    reference["stage_split"] = split
    reference["pipe"] = pin
    return {"gather_rows": gr, "sage_aggregate_backward": bw,
            "sage_backward_index": bidx, "fused_sample": fs,
            "sage_aggregate": sa}, counts, reference


def _union(spans) -> float:
    """Time covered by at least one of the (start, end) ``spans``."""
    spans = sorted(spans)
    union, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            union += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return union + cur_b - cur_a


def device_records(prof) -> list:
    """The device ops of a trace, from the profiler's raw records: an
    exact-inference layer holds 30-80 k of them, and ``prof.events()`` or
    ``prof.key_averages()`` take seconds to build their objects."""
    from torch.autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_streams(prof) -> tuple[float, list]:
    """(time at least one device op ran, [(ops, summed ms, busy ms) of
    each stream, the stream with the most ops first]) of a trace.  The
    step runs on one stream; the stager's copies ride a stream of their
    own and may overlap the step's kernels."""
    by_stream = {}
    for e in device_records(prof):
        start = e.start_ns()
        by_stream.setdefault(e.device_resource_id(), []).append(
            (start, start + e.duration_ns()))
    if not by_stream:
        raise AssertionError("the profiler recorded no device operation")
    streams = sorted(((len(v), sum(b - a for a, b in v) / 1e6,
                       _union(v) / 1e6) for v in by_stream.values()),
                     reverse=True)
    return _union([x for v in by_stream.values() for x in v]) / 1e6, \
        streams


def profiled_steps(driver, params, opt, steps: int = 2):
    """Profile ``steps`` driver steps, each in a trace of its own between
    two synchronizes.  Returns (params, opt, per-step means: wall ms,
    device busy ms, the step's own stream's ops and busy ms, the other
    streams' ops and summed ms).  When the steps' counts of device ops on
    their own stream differ, the tracer dropped records (as ``time_ms``
    notes) and the set is taken again, up to five times."""
    import torch
    for attempt in range(5):
        per = []
        for _ in range(steps):
            torch.cuda.synchronize()
            with kernel_trace() as prof:
                t0 = time.perf_counter()
                params, opt, loss, _ = driver.step(params, opt)
                float(loss)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            per.append((wall, *device_streams(prof)))
        own_ops = [streams[0][0] for _, _, streams in per]
        if len(set(own_ops)) == 1:
            break
        log(f"  (trace set {attempt + 1}: the step's stream recorded "
            f"{own_ops} device ops; tracing again)")
    else:
        raise RuntimeError("the profiler recorded no two steps alike in "
                           "five trace sets")
    mean = statistics.mean
    return params, opt, {
        "wall_ms": mean(w for w, _, _ in per),
        "device_busy_ms": mean(b for _, b, _ in per),
        "own_stream_ops": own_ops[0],
        "own_stream_busy_ms": mean(s[0][2] for _, _, s in per),
        "other_stream_ops": mean(sum(x[0] for x in s[1:])
                                 for _, _, s in per),
        "other_stream_ms": mean(sum(x[1] for x in s[1:])
                                for _, _, s in per)}


def h2d_ms(host, reps: int = 3) -> float:
    """Median time of one copy of the pinned ``host`` tensor to the card,
    by CUDA events around it."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = host.to("cuda", non_blocking=True)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        del dev
    return statistics.median(times)


# the fenced stage spans of every profile_stages call, for the report's
# share table at the end of phase 10
PROFILE_EVENTS: list = []


def stage_split(pipe, loss_fn, params, arm: str) -> dict:
    """The sampling / feature / compute split of one step of ``pipe``
    (``repro_torch.obs.profile.profile_stages``: three fenced calls a step,
    median of 3 steps after 1 warm-up, at phase 8's batch), printed with
    its arm; its spans are kept for the report's share table."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.profile import STAGES, profile_stages
    tracer = obs_trace.start(None)
    try:
        prof = profile_stages(pipe, loss_fn, params, batch=TRAIN_BATCH,
                              steps=3, warmup=1, base_salt=TRAIN_STEPS,
                              arm=arm)
    finally:
        obs_trace.stop(export=False)
    PROFILE_EVENTS.extend(e for e in tracer.events() if e["ph"] == "X")
    log(f"stage split [{arm}] (profile_stages, median of 3 fenced steps): "
        + ", ".join(f"{st} {prof[st + '_s'] * 1e3:.3f} ms "
                    f"({prof['share'][st]:.1%})" for st in STAGES)
        + f"; unoverlapped step {prof['step_s'] * 1e3:.3f} ms")
    return prof


def traced_parts(driver, params, opt, fenced: bool, steps: int = 3):
    """Mean host ms of each span (driver, executor and stager) over
    ``steps`` driver steps under a ``repro_torch.obs`` tracer; ``fenced``
    synchronizes inside each span (host + device ms)."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.report import span_summary
    tracer = obs_trace.start(None, fenced=fenced)
    try:
        for _ in range(steps):
            params, opt, loss, _ = driver.step(params, opt)
            float(loss)
    finally:
        obs_trace.stop(export=False)
    agg = span_summary({"traceEvents": tracer.events()})
    return params, opt, {name: a["mean_us"] / 1e3 for name, a in agg.items()}


def host_memory_gb() -> tuple[float, float]:
    """(MemTotal, MemAvailable) of the host, GB, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024 / 1e9
    return info["MemTotal"], info["MemAvailable"]


OVERLAP_RUNS = (       # (label, prefetch depth, staging, feature store)
    ("sync", 0, False, "pinned_hot"),
    ("sync + staging", 0, True, "pinned_hot"),
    ("double_buffer depth 1", 1, False, "pinned_hot"),
    ("double_buffer depth 2", 2, False, "pinned_hot"),
    ("double_buffer depth 1 + staging", 1, True, "pinned_hot"),
    ("staged store, depth 1", 1, False, "staged"),
)
# phase 9's runs: 4 steps held to phase 8's first 4 losses and its
# parameters after them, restarted at step 2 (depth cuts for the time
# bound: 10 steps restarted at 5, then 6 at 3, now 4 at 2 to pay for
# phase 18)
OVERLAP_STEPS = 4
RESTART = 2
# the staged store's run: its steps take about a second of host work each,
# so it runs 3 steps held to phase 8's first 3 losses and its parameters
# after them, restarts at step 1 and times no spans
STAGED_STEPS = 3
STAGED_RESTART = 1


def overlap_run(layout, data, cfg, ref, label, depth, staging, store):
    """One phase-9 run: ``OVERLAP_STEPS`` steps from phase 8's initial
    parameters, held to phase 8's synchronous run bit for bit, then a
    restart at ``RESTART``, 3 steps timed by part unfenced and 3 fenced,
    and 2 profiled steps (the
    staged store: ``STAGED_STEPS`` steps held to phase 8's first losses
    and its parameters after them, a restart at ``STAGED_RESTART``, no
    span timing).
    Returns (launch counts of the steps, numbers for PERF.md)."""
    import torch
    import repro_torch.kernels as K
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.optim import init_opt_state, tree_leaves
    from repro_torch.pipeline import Pipeline, PipelineSpec

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    def same_params(a, b) -> bool:
        return all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    staged = store == "staged"
    steps = STAGED_STEPS if staged else OVERLAP_STEPS
    restart = STAGED_RESTART if staged else RESTART
    spec = PipelineSpec.from_scheme(
        "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
        cache_capacity=CACHE_K, cache_policy="degree", feature_store=store,
        prefetch_depth=depth, staging=staging, data=data)
    pipe = Pipeline.from_layout(layout, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"-- {label}: {spec.prefetch.mode} driver, store {store}, staging "
        f"{'on' if staging or store == 'staged' else 'off'}")
    with pipe.train_driver(loss_fn, batch=TRAIN_BATCH, lr=TRAIN_LR,
                           grad_clip=1.0) as driver:
        params = ref["params0"]
        opt = init_opt_state(params)
        K.reset_launch_counts()
        rounds_before = pipe.counter.rounds
        losses, walls, overflow = [], [], []
        for k in range(steps):
            if k == restart:
                snapshot = (params, opt)
            t0 = time.perf_counter()
            params, opt, loss, m = driver.step(params, opt)
            losses.append(float(loss))          # synchronizes
            walls.append((time.perf_counter() - t0) * 1e3)
            overflow.append(int(m["sampler_window_overflow"]))
        counts = K.launch_counts()
        rounds = (pipe.counter.rounds - rounds_before) / steps
        final = params
        want_rounds = 0 if staged else 2
        if rounds != want_rounds:
            raise AssertionError(f"{label}: {rounds} rounds per step, "
                                 f"expected {want_rounds}")
        same = same_params(final, ref["params_after"][steps])
        if losses != ref["losses"][:steps] or not same:
            raise AssertionError(
                f"{label}: differs from phase 8's synchronous run: losses "
                f"{losses} vs {ref['losses'][:steps]}, parameters equal "
                f"{same}")
        if max(overflow) == 0:
            raise AssertionError(f"{label}: no window overflow in any step")
        path = [k for k in counts if k not in GAT_KERNELS
                and not (store == "staged" and k == "feature_gather")]
        missing = [k for k in path if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: "
                                 f"{missing}")
        params, opt = snapshot
        replay = []
        for k in range(restart, steps):
            params, opt, loss, _ = driver.step(params, opt, step_idx=k)
            replay.append(float(loss))
        if replay != losses[restart:] or not same_params(params, final):
            raise AssertionError(f"{label}: the restart at step {restart} "
                                 f"gave {replay}, not {losses[restart:]}")
        host, fenced = {}, {}
        if not staged:
            params, opt, host = traced_parts(driver, params, opt,
                                             fenced=False, steps=3)
            params, opt, fenced = traced_parts(driver, params, opt,
                                               fenced=True, steps=3)
        params, opt, prof = profiled_steps(driver, params, opt)
        stats = driver.stager.stats() if driver.stager is not None else None
        peak = torch.cuda.max_memory_allocated() / 1e9
        if store == "staged":       # after the peak: it needs a buffer
            buf = driver.stager._pool[0]
            prof["row_copy_bytes"] = buf.numel() * buf.element_size()
            prof["row_copy_ms"] = h2d_ms(buf)
            del buf
    median = statistics.median(walls)
    out = {"label": label, "losses_equal": True,
           "step_wall_median_ms": median,
           "step_wall_min_ms": min(walls), "step_wall_max_ms": max(walls),
           "step_walls_ms": walls, "profiled": prof,
           "idle_share": 1 - prof["device_busy_ms"] / prof["wall_ms"],
           "idle_share_of_median_wall": 1 - prof["device_busy_ms"] / median,
           "span_ms": host, "fenced_span_ms": fenced,
           "overflow_per_step": overflow, "rounds_per_step": rounds,
           "peak_device_gb": peak, "pinned_bytes": 0}
    log(f"losses and parameters equal phase 8's run bit for bit over "
        f"{steps} steps; restart at step {restart} "
        f"replays steps {restart}-{steps - 1}; {rounds:g} rounds per step; "
        f"window overflow per step {overflow}")
    log(f"step wall median {median:.3f} ms (min {min(walls):.3f}, max "
        f"{max(walls):.3f}); profiled steps: wall {prof['wall_ms']:.3f} "
        f"ms, device busy {prof['device_busy_ms']:.3f} ms (the step's "
        f"stream {prof['own_stream_busy_ms']:.3f} ms in "
        f"{prof['own_stream_ops']} ops; other streams "
        f"{prof['other_stream_ops']:g} ops, {prof['other_stream_ms']:.3f} "
        f"ms), idle share {out['idle_share']:.3f} (of the unprofiled "
        f"median wall {out['idle_share_of_median_wall']:.3f}); peak device "
        f"memory {peak:.2f} GB")
    if host:
        log("spans over 3 traced steps, mean host ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in host.items()) + "; fenced, host + "
            "device ms: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in fenced.items()))
    if "row_copy_ms" in prof:
        nbytes = prof["row_copy_bytes"]
        log(f"one staged row buffer ({nbytes} B) copied to the device "
            f"in {prof['row_copy_ms']:.3f} ms by CUDA events ("
            f"{nbytes / prof['row_copy_ms'] / 1e6:.1f} GB/s)")
    if stats is not None:
        out.update(empty_waits=stats["empty_waits"],
                   pinned_bytes=stats["pinned_bytes"])
        log(f"stager: ring found empty {stats['empty_waits']} times, pinned "
            f"host bytes {stats['pinned_bytes']} (its produce and stages "
            f"are the stager/ spans above)")
    log(f"launches in the {steps} steps: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    return counts, out


def recycled_serving(serving) -> tuple[dict, dict]:
    """Phase 6's full-width predictor and its ``hotset`` arrivals (twice
    the calibrated rate) through ``GNNServer`` with a ``RecyclingCache``
    that admits the top 1024 of a ``blend(0.5)`` scorer, its frequency
    term fed by another draw of the same traffic.  Every served output,
    recycled or not, must equal direct ``predict`` bit for bit (fixed
    salt, fixed parameters).  Returns (launch counts of the run, numbers
    for PERF.md)."""
    import numpy as np
    import repro_torch.kernels as K
    from repro_torch.core.cache import resolve_hot_scorer
    from repro_torch.serve import GNNServer, RecyclingCache, hot_set_admit
    from repro_torch.serve.traffic import hotset_arrivals

    pred, arrivals, graph = (serving[k] for k in ("pred", "arrivals",
                                                  "graph"))
    scorer = resolve_hot_scorer("blend(0.5)")
    scorer.scores(graph)                    # makes its frequency tracker
    seen = hotset_arrivals(len(arrivals), serving["rate"], NUM_NODES,
                           graph=graph, hot_k=64, seed=1)
    scorer.observe(np.asarray([v for _, v in seen]))
    recycler = RecyclingCache(capacity=1024, tau=64, rho=1.0,
                              admit=hot_set_admit(
                                  scorer.top_ids(graph, 1024)))
    server = GNNServer(pred, max_delay=2e-3, recycler=recycler)
    K.reset_launch_counts()
    stats, served = server.run(arrivals, warmup=False, collect_outputs=True)
    counts = K.launch_counts()
    direct = pred.predict([v for _, v in arrivals])
    if not np.array_equal(served, direct):
        raise AssertionError(
            f"served outputs (recycler on) differ from direct predict in "
            f"{int((served != direct).any(axis=1).sum())} of "
            f"{len(arrivals)} rows")
    missing = [k for k in SERVING_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the recycled "
                             f"serving path: {missing}")
    s = stats.summary()
    base = serving["summary"]
    log(f"served {s['num_requests']} hotset requests at "
        f"{serving['rate']:.0f} req/s: p50 {s['p50_ms']:.3f} ms, p99 "
        f"{s['p99_ms']:.3f} ms, QPS {s['qps']:.1f}, flushes "
        f"{s['num_flushes']}, recycled {s['num_recycled']} (hit rate "
        f"{s['recycler']['hit_rate']:.4f}, {s['recycler']['entries']} "
        f"entries); outputs == direct predict bit for bit.  Phase 6 "
        f"without the recycler: p50 {base['p50_ms']:.3f} ms, p99 "
        f"{base['p99_ms']:.3f} ms, QPS {base['qps']:.1f}")
    log(f"kernel launches on the recycled serving path: {counts}")
    return counts, {k: s[k] for k in ("p50_ms", "p99_ms", "qps",
                                      "num_recycled", "num_flushes",
                                      "recycler")}


def overlap_phase(layout, data, cfg, ref, serving):
    """Phase 9: the overlapped drivers and the staged store against phase
    8's synchronous run, the recycler on phase 6's full-width serving
    path, a ``frequency`` cache, and ``serve_gnn`` as a launcher smoke.
    Returns (summed launch counts of the runs' 10-step windows, launch
    counts of the recycled serving run, the numbers for PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve_gnn
    from repro_torch.pipeline import Pipeline, PipelineSpec

    total, avail = host_memory_gb()
    log(f"host memory {total:.1f} GB, {avail:.1f} GB available; one staged "
        f"row buffer {4 * 1_056_000 * cfg.in_dim * 4 / 1e9:.2f} GB")
    counts, runs = {}, []
    for label, depth, staging, store in OVERLAP_RUNS:
        c, out = overlap_run(layout, data, cfg, ref, label, depth, staging,
                             store)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        runs.append(out)

    log("-- the recycler on phase 6's predictor (full width)")
    recycled_counts, recycled = recycled_serving(serving)

    log("-- the frequency cache policy (65 536 rows per worker)")
    spec = PipelineSpec.from_scheme(
        "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
        cache_capacity=CACHE_K, cache_policy="frequency",
        feature_store="pinned_hot", data=data)
    t0 = time.perf_counter()
    pipe = Pipeline.from_layout(layout, spec)
    t_build = time.perf_counter() - t0
    prepare, _ = pipe.make_prepare_consume(None, counted=False)
    with torch.no_grad():
        b = prepare(pipe.shards, pipe.seeds(TRAIN_BATCH, 0), 0, pipe.cache)
    filled = int((pipe.cache.ids < 2 ** 31 - 1).sum())
    hit_rate = float((b.hits / (b.mfgs[-1].src_nodes >= 0).sum(-1)).mean())
    log(f"built in {t_build:.2f} s, {filled} of {4 * CACHE_K} slots filled; "
        f"hit rate at step 0's frontier {hit_rate:.4f}")
    del pipe, b

    log("-- serve_gnn --recycle --hot-scorer blend(0.5), a launcher smoke "
        "at its own small defaults (its times are not the port's)")
    res = serve_gnn.main(["--recycle", "--hot-scorer", "blend(0.5)"])
    direct = res["predictor"].predict(res["seeds"])
    if not np.array_equal(res["outputs"], direct):
        raise AssertionError("served outputs differ from direct predict")
    log("served outputs (recycled ones included) equal direct predict bit "
        "for bit")
    return counts, recycled_counts, {"runs": runs,
                                     "recycled_serving": recycled}

PLACEMENT_RUNS = ("vanilla", "hybrid", "hybrid_partial(0.25)")
PLACEMENT_PLANS = PLACEMENT_RUNS + ("hybrid_partial(0.0)",
                                    "hybrid_partial(1.0)")
PLACEMENT_ROUNDS = {"vanilla": 6, "hybrid": 2, "hybrid_partial(0.25)": 6,
                    "hybrid+fused": 2}


def same_mfgs(a, b) -> bool:
    """Every field of every level equal bit for bit."""
    import torch
    return len(a) == len(b) and all(
        torch.equal(getattr(x, f.name), getattr(y, f.name))
        for x, y in zip(a, b) for f in dataclasses.fields(x))


def prepare_profile(pipe, prep, seeds, salt, reps: int = 3) -> dict:
    """The prepare half alone on one step's seeds: median device busy ms
    (``torch.profiler``: time at least one device op ran)."""
    import torch
    busy = []
    with torch.no_grad():
        prep(pipe.shards, seeds, salt, pipe.cache)
        for _ in range(reps):
            with kernel_trace() as prof:
                prep(pipe.shards, seeds, salt, pipe.cache)
            busy.append(device_streams(prof)[0])
    return {"device_busy_ms": statistics.median(busy)}


def placement_plans(layout, cfg) -> tuple[dict, dict]:
    """Build the five plans alone and hold one step's MFGs of each to
    vanilla's bit for bit.  Returns (numbers by scheme, vanilla's MFGs)."""
    import torch
    from repro_torch.core.dist import RoundCounter, WorkerShard
    from repro_torch.core.partition import seeds_per_worker
    from repro_torch.core.placement import resolve_scheme
    from repro_torch.core.sampler import resolve_backend

    seeds = seeds_per_worker(layout, TRAIN_BATCH, TRAIN_SALT)
    out, ref = {}, None
    for name in PLACEMENT_PLANS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = resolve_scheme(name).build(layout)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        li, lx = plan.shard_topology()
        shard = WorkerShard(layout.features, layout.labels, li, lx)
        topo = sum(t.numel() * t.element_size() for t in (li, lx)
                   if t is not None)
        hot = getattr(plan, "hot_graph", None)
        if hot is not None:
            topo += sum(t.numel() * t.element_size()
                        for t in (hot.indptr, hot.indices))
        counter = RoundCounter()
        with torch.no_grad():
            mfgs, util = plan.sample(shard, seeds, cfg.fanouts, TRAIN_SALT,
                                     level_fn=resolve_backend("unfused"),
                                     counter=counter)
        if ref is None:
            ref = mfgs
        elif not same_mfgs(mfgs, ref):
            raise AssertionError(f"{name}: one step's MFGs differ from "
                                 f"vanilla's")
        out[name] = {"plan_build_s": t_build, "topology_bytes": topo,
                     "replicated_edge_fraction": getattr(
                         plan, "replicated_edge_fraction", None),
                     "sampling_rounds": counter.sampling_rounds,
                     "sampling_utilized_bytes": float(util.sum())}
        log(f"{name}: plan built in {t_build:.3f} s, local topology "
            f"{topo / 1e6:.1f} MB on the card (all workers stacked), "
            f"replicated edge share "
            f"{out[name]['replicated_edge_fraction']}, one step: "
            f"{counter.sampling_rounds} sampling rounds, "
            f"{out[name]['sampling_utilized_bytes']:.0f} utilized sampling "
            f"bytes")
        del plan, shard, mfgs
    log(f"one step's MFGs ({', '.join(str(tuple(m.edges.shape)) for m in ref)}"
        f") equal across {', '.join(PLACEMENT_PLANS)} bit for bit")
    return out, ref


def placement_run(layout, data, cfg, ref, name) -> tuple[dict, dict]:
    """One phase-10 run: ``name``'s pipeline (pinned_hot, phase 8's cache),
    10 ``SyncDriver`` steps from phase 8's initial parameters with the
    launch counts set to 0 first, then fenced stages, the prepare half,
    and 2 profiled steps.  Returns (launch counts of the 10 steps,
    numbers)."""
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spec = PipelineSpec.from_scheme(
        name, num_parts=NUM_PARTS, fanouts=cfg.fanouts,
        cache_capacity=CACHE_K, cache_policy="degree",
        feature_store="pinned_hot", data=data)
    t0 = time.perf_counter()
    pipe = Pipeline.from_layout(layout, spec)
    t_build = time.perf_counter() - t0
    log(f"-- {name}: scheme {spec.plan.scheme}, backend "
        f"{spec.sampler.backend}; pipeline (plan and cache) built in "
        f"{t_build:.2f} s")
    with pipe.train_driver(loss_fn, batch=TRAIN_BATCH, lr=TRAIN_LR,
                           grad_clip=1.0) as driver:
        params = ref["params0"]
        opt = init_opt_state(params)
        K.reset_launch_counts()
        rounds_before = pipe.counter.rounds
        sampling_before = pipe.counter.sampling_rounds
        losses, walls, util = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, loss, m = driver.step(params, opt)
            losses.append(float(loss))          # synchronizes
            walls.append((time.perf_counter() - t0) * 1e3)
            util.append(float(m["sampling_utilized_bytes"]))
        counts = K.launch_counts()
        rounds = (pipe.counter.rounds - rounds_before) / TRAIN_STEPS
        sampling = (pipe.counter.sampling_rounds - sampling_before) \
            / TRAIN_STEPS
        final = params
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if rounds != PLACEMENT_ROUNDS[name]:
            raise AssertionError(f"{name}: {rounds} rounds per step, "
                                 f"expected {PLACEMENT_ROUNDS[name]}")
        windowed = pipe.placement.scheme.uses_level_backend \
            and spec.sampler.backend == "fused_cuda"
        missing = [k for k, v in counts.items()
                   if v == 0 and k not in GAT_KERNELS
                   and (windowed or k != "fused_sample")]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: "
                                 f"{missing}")
        if not windowed and counts["fused_sample"]:
            raise AssertionError(f"{name}: fused_sample launched "
                                 f"{counts['fused_sample']} times")
        split = stage_split(pipe, loss_fn, params, name)
        prep, _ = pipe.make_prepare_consume(loss_fn, counted=False)
        prepare = prepare_profile(pipe, prep,
                                  pipe.seeds(TRAIN_BATCH, TRAIN_SALT),
                                  TRAIN_SALT)
        params, opt, prof = profiled_steps(driver, params, opt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    median = statistics.median(walls)
    out = {"scheme": name, "backend": spec.sampler.backend,
           "build_s": t_build, "losses": losses, "final_params": final,
           "step_wall_median_ms": median, "step_wall_min_ms": min(walls),
           "step_wall_max_ms": max(walls), "rounds_per_step": rounds,
           "sampling_utilized_bytes_per_step": statistics.mean(util),
           "expected_rounds_estimate": pipe.expected_rounds_estimate,
           "stage_split": split, "prepare": prepare, "profiled": prof,
           "idle_share": 1 - prof["device_busy_ms"] / prof["wall_ms"],
           "idle_share_of_median_wall": 1 - prof["device_busy_ms"] / median,
           "peak_device_gb": peak, "launches": counts}
    log(f"losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"{rounds:g} rounds per step ({sampling:g} sampling); utilized "
        f"sampling bytes per "
        f"step {out['sampling_utilized_bytes_per_step']:.0f}; expected "
        f"rounds estimate {out['expected_rounds_estimate']:.4f}")
    log(f"step wall median {median:.3f} ms (min {min(walls):.3f}, max "
        f"{max(walls):.3f})")
    log(f"prepare half: device busy "
        f"{prepare['device_busy_ms']:.3f} ms; profiled steps: wall "
        f"{prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_busy_ms']:.3f} ms in {prof['own_stream_ops']} ops "
        f"on the step's stream, idle share {out['idle_share']:.3f} (of the "
        f"unprofiled median wall {out['idle_share_of_median_wall']:.3f}); "
        f"peak device memory {peak:.2f} GB")
    log("launches in the 10 steps: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    return counts, out


def placement_phase(layout, data, cfg, ref, pred_seeds):
    """Phase 10: the placement schemes on phase 8's configuration.
    Returns ({path: launch counts}, numbers for PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.optim import tree_leaves
    from repro_torch.pipeline import Pipeline, PipelineSpec
    from repro_torch.serve import Predictor

    plans, _ = placement_plans(layout, cfg)
    counts, runs = {}, {}
    for name in PLACEMENT_RUNS + ("hybrid+fused",):
        c, runs[name] = placement_run(layout, data, cfg, ref, name)
        counts[f"placement {name}"] = c
    first = runs[PLACEMENT_RUNS[0]]
    for name in PLACEMENT_RUNS[1:]:
        r = runs[name]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(r["final_params"]),
            tree_leaves(first["final_params"])))
        if r["losses"] != first["losses"] or not same:
            raise AssertionError(
                f"{name} differs from {PLACEMENT_RUNS[0]}: losses "
                f"{r['losses']} vs {first['losses']}, final parameters "
                f"equal {same}")
    log(f"losses and final parameters of {', '.join(PLACEMENT_RUNS)} equal "
        f"bit for bit")
    if runs["hybrid+fused"]["losses"] != ref["losses"]:
        raise AssertionError("the hybrid+fused run differs from phase 8's")

    log("-- one 128-seed predict under vanilla against hybrid")
    logits = {}
    for name in ("vanilla", "hybrid"):
        pipe = Pipeline.from_layout(layout, PipelineSpec.from_scheme(
            name, num_parts=NUM_PARTS, fanouts=cfg.fanouts, data=data))
        pred = Predictor(pipe, first["final_params"], cfg, buckets=(128,),
                         base_salt=SALT)
        logits[name] = pred.predict(pred_seeds)
        del pred, pipe
    if logits["vanilla"].shape != (128, cfg.num_classes) \
            or not np.isfinite(logits["vanilla"]).all() \
            or not np.array_equal(logits["vanilla"], logits["hybrid"]):
        raise AssertionError("vanilla's predict differs from hybrid's")
    log("vanilla's logits (128, 47) equal hybrid's bit for bit")

    ref_walls = ref["walls"]
    log("schemes beside phase 8's hybrid+fused run (step wall median ms | "
        "prepare device ms | rounds per step | utilized sampling bytes per "
        "step | peak GB):")
    log(f"  phase 8 hybrid+fused: {statistics.median(ref_walls):.3f} | - | "
        f"2 | 0 | -")
    for name, r in runs.items():
        log(f"  {name}: {r['step_wall_median_ms']:.3f} | "
            f"{r['prepare']['device_busy_ms']:.3f} | "
            f"{r['rounds_per_step']:g} | "
            f"{r['sampling_utilized_bytes_per_step']:.0f} | "
            f"{r['peak_device_gb']:.2f}")
    for r in runs.values():
        del r["final_params"]
    return counts, {"plans": plans, "runs": runs,
                    "phase8_step_wall_median_ms": statistics.median(
                        ref_walls)}


TRACE_SPANS = ("driver/step", "driver/seeds", "driver/train_step",
               "driver/warmup", "driver/runner_step", "prefetch/prepare",
               "prefetch/consume", "stager/produce", "stager/get",
               "profile/sampling", "profile/feature", "profile/compute",
               "serve/predict", "serve/queue_wait", "serve/batch_delay",
               "serve/service")


def traced_run(layout, data, cfg, ref, serving) -> dict:
    """A short run under ``start(path, fenced=True)``: 3 ``SyncDriver``
    steps, 3 ``double_buffer`` depth-1 steps with seed staging (phase 8's
    layout, cache and store, from its initial parameters), one profiled
    step (``profile_stages``) and 100 of phase 6's arrivals through
    ``GNNServer``.  The exported trace must pass ``validate_trace`` and
    hold the driver, executor, stager, profile and serving spans; the
    report CLI prints its share and summary tables.  Returns the path's
    launch counts."""
    import repro_torch.kernels as K
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.profile import profile_stages
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec
    from repro_torch.serve import GNNServer

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    path = os.path.join(HERE, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    obs_trace.start(path, fenced=True, process_name="chip_smoke")
    try:
        for depth, staging in ((0, False), (1, True)):
            spec = PipelineSpec.from_scheme(
                "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
                cache_capacity=CACHE_K, cache_policy="degree",
                feature_store="pinned_hot", prefetch_depth=depth,
                staging=staging, data=data)
            pipe = Pipeline.from_layout(layout, spec)
            with pipe.train_driver(loss_fn, batch=TRAIN_BATCH, lr=TRAIN_LR,
                                   grad_clip=1.0) as driver:
                params, opt = ref["params0"], init_opt_state(ref["params0"])
                for _ in range(3):
                    params, opt, loss, _ = driver.step(params, opt)
                    float(loss)
            if depth == 0:
                profile_stages(pipe, loss_fn, params, batch=TRAIN_BATCH,
                               steps=1, warmup=0, arm="hybrid+fused")
            del pipe
        GNNServer(serving["pred"], max_delay=2e-3).run(
            serving["arrivals"][:100], warmup=False)
    finally:
        tracer = obs_trace.stop()
    counts = K.launch_counts()
    n = obs_trace.validate_trace(path)
    names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
    missing = [x for x in TRACE_SPANS if x not in names]
    if missing:
        raise AssertionError(f"the traced run recorded no {missing} spans")
    log(f"trace {os.path.relpath(path, HERE)}: {n} events pass "
        f"validate_trace, {tracer.num_recorded} spans ({tracer.dropped} "
        f"dropped), every expected span name present; "
        f"{time.perf_counter() - t0:.1f} s")
    if list(report.stage_shares(path)) != ["hybrid+fused"]:
        raise AssertionError("the traced run's stage spans lack their arm")
    log(f"python -m repro_torch.obs.report {os.path.relpath(path, HERE)} "
        f"--summary:")
    report.main([path, "--summary"])
    log(f"launches in the traced run: {counts}")
    return counts


def max_degree_batch(graph, width: int):
    """(lo, hi, samples, valid) of the exact-inference batch that holds the
    max in-degree node."""
    import torch
    from repro_torch.core.inference import in_edges
    v = int(torch.argmax(graph.degrees()))
    lo = v // INFER_BATCH * INFER_BATCH
    hi = min(lo + INFER_BATCH, graph.num_nodes)
    seeds = torch.arange(lo, hi, dtype=torch.int32, device=graph.device)
    samples, valid = in_edges(graph, seeds, width)
    return lo, hi, samples, valid


def check_wide_batch(params, graph, tables, cfg, width: int):
    """Each layer on the batch holding the max in-degree node: the kernel's
    aggregate equal to ``f_ordered_mean`` bit for bit, the layer's rows of
    the exact run within LOGIT_TOL of a plain-version forward of the
    batch; the forward at this shape timed beside its plain version and
    ``embedding_bag``.  Returns the kernel's numbers at the top layer's
    (512, 11 361, 256) shape and at the bottom's (512, 11 361, 100)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mfg import MFG
    from repro_torch.core.sampler import build_indptr
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_plain)
    from repro_torch.models.gnn import apply_layer
    lo, hi, samples, valid = max_degree_batch(graph, width)
    n = graph.num_nodes
    out = {}
    for layer in range(cfg.num_layers):
        h = tables[layer]
        got = sage_aggregate(samples, h)
        loop = f_ordered_mean(samples[None], h[None])[0]
        torch.cuda.synchronize()
        if not torch.equal(got, loop):
            raise AssertionError(f"exact inference layer {layer}: the "
                                 f"aggregate of the max in-degree batch "
                                 f"differs in bits from the f-ordered loop")
        ref = sage_aggregate_plain(samples, h)
        agg_err = float((got - ref).abs().max())
        del ref, loop
        # the sources are the whole table, as in layerwise_inference
        mfg = MFG(dst_nodes=torch.arange(lo, hi, device=h.device),
                  src_nodes=torch.arange(n, device=h.device),
                  num_src=torch.tensor(n), edges=samples, edge_mask=valid,
                  indptr=build_indptr(valid))
        is_last = layer == cfg.num_layers - 1
        plain = apply_layer(params[layer], mfg, h, cfg, is_last=is_last,
                            aggregate=sage_aggregate_plain, h_dst=h[lo:hi])
        rows = tables[layer + 1][lo:hi]
        err = float((rows - plain).abs().max())
        if not torch.allclose(rows, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f"exact inference layer {layer}: the "
                                 f"batch's rows differ from a plain-version "
                                 f"forward by {err}")
        del plain
        D = h.shape[-1]
        table = torch.cat([h, h.new_zeros((1, D))])
        bag = torch.where(samples >= 0, samples, n).long()
        ms, call, kept = one_kernel_ms(lambda: sage_aggregate(samples, h),
                                       sage_aggregate,
                                       "sage_aggregate_wide_kernel")
        # the plain version and embedding_bag by CUDA events: the profiler
        # drops records of these multi-GB calls in every retake
        plain_ms = event_ms(lambda: sage_aggregate_plain(samples, h))
        lib = F.embedding_bag(bag, table, mode="mean", padding_idx=n)
        atol = wide_sum_tol(width, h)
        if not torch.allclose(lib, got, rtol=SAGE_TOL, atol=atol) \
                or agg_err > atol + SAGE_TOL * float(got.abs().max()):
            raise AssertionError(f"exact inference layer {layer}: the "
                                 f"plain version or embedding_bag disagree "
                                 f"(max abs error {agg_err}, atol {atol:.3g})")
        lib_ms = event_ms(lambda: F.embedding_bag(
            bag, table, mode="mean", padding_idx=n))
        n_valid = int(valid.sum())
        nbytes = (samples.numel() * 4 + unique_rows(samples[None], n) * D * 4
                  + samples.shape[0] * D * 4)
        res = {"ms": ms, "call_ms": call, "plain_ms": plain_ms,
               "library_ms": lib_ms, "err": agg_err,
               "launches_traced": f"{kept} of {REPS}"}
        bnd = add_bound(res, nbytes, n_valid * D + samples.shape[0] * D)
        res.update(edges=list(samples.shape), h=list(h.shape),
                   valid_slots=n_valid, max_abs_err=agg_err)
        log(f"  layer {layer}: batch [{lo}, {hi}) edges "
            f"{tuple(samples.shape)} ({n_valid} valid) h {tuple(h.shape)}: "
            f"aggregate == f-ordered loop bit for bit (max abs err "
            f"{agg_err:.3g} against the plain version), rows within "
            f"{err:.3g} of a plain-version forward (tol {LOGIT_TOL}); one "
            f"sage_aggregate_wide_kernel a call, device {ms:.4f} ms (the "
            f"trace kept {kept} of {REPS} launches), call "
            f"{call:.4f} ms (by events: plain {plain_ms:.4f} ms, "
            f"embedding_bag {lib_ms:.4f} ms; bound {bnd:.5f} ms for {nbytes} "
            f"B: {bnd / ms:.1%} of it)")
        out.setdefault(D, res)
        del table, bag, lib
    return out


def exact_inference_phase(ds, data, cfg, params, pipe):
    """Phase 11: ``layerwise_inference``, uncapped, over the whole graph at
    full width with phase 8's trained parameters.  Returns (launch
    counts of the run, the forward's numbers at the wide shapes, numbers
    for PERF.md)."""
    import torch
    import repro_torch.kernels as K
    from repro_torch.core.inference import (inference_width, layer_pass,
                                            layerwise_inference)
    from repro_torch.serve import Predictor

    graph = ds.graph.to("cuda")
    x = torch.from_numpy(ds.features).cuda()
    n, width = graph.num_nodes, inference_width(graph)
    batches = -(-n // INFER_BATCH)
    padding = 1 - graph.num_edges / (n * width)
    log(f"graph {n} nodes, {graph.num_edges} edges, max in-degree {width}: "
        f"{batches} batches of {INFER_BATCH} a layer, each padded to "
        f"{width} slots a node; {padding:.4%} of the {n * width} edge slots "
        f"a layer are padding")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits = layerwise_inference(params, graph, x, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if logits.shape != (n, cfg.num_classes) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"exact logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    want = {k: 0 for k in counts}
    want["sage_aggregate"] = cfg.num_layers * batches
    want["sage_epilogue"] = (cfg.num_layers - 1) * batches
    if counts != want:
        raise AssertionError(f"exact inference launches {counts}, expected "
                             f"{want}")
    log(f"layerwise_inference (uncapped): logits {tuple(logits.shape)} "
        f"finite, {wall:.3f} s wall, peak device memory {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated); launches {counts}")

    # the distinct source rows of each batch's valid slots, summed over
    # the batches (every in-edge: the run is uncapped), for the layers'
    # byte bounds
    dst = torch.repeat_interleave(torch.arange(n, device="cuda"),
                                  graph.degrees().long())
    distinct = int(torch.unique(dst // INFER_BATCH * n
                                + graph.indices.long()).numel())
    del dst

    # per layer: wall, then device busy from a profiled pass of the layer
    tables, layers = [x], []
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            is_last = layer == cfg.num_layers - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = layer_pass(params[layer], graph, tables[-1], cfg,
                           is_last=is_last, width=width)
            torch.cuda.synchronize()
            layer_wall = (time.perf_counter() - t0) * 1e3
            with kernel_trace() as prof:
                layer_pass(params[layer], graph, tables[-1], cfg,
                           is_last=is_last, width=width)
            busy, streams = device_streams(prof)
            by_name = {}
            for e in device_records(prof):
                ms_n = by_name.setdefault(e.name(), [0.0, 0])
                ms_n[0] += e.duration_ns() / 1e6
                ms_n[1] += 1
            rows = sorted(((ms, count, _short(name))
                           for name, (ms, count) in by_name.items()),
                          reverse=True)
            if layer == 0:
                log("  layer 0's device ms by kernel (top 8): " + ", ".join(
                    f"{name} {ms:.1f} (x{count})"
                    for ms, count, name in rows[:8]))
            # the wide kernel over the pass: the trace's launches (it may
            # drop records) and their total, beside the layer's byte bound
            # (each batch's ids, its distinct valid source rows, the output)
            (wide_ms, wide_n), = [(ms, count) for ms, count, name in rows
                                  if name == "sage_aggregate_wide_kernel"]
            D = tables[-1].shape[1]
            bound = (n * width * 4 + distinct * D * 4 + n * D * 4) \
                / HBM_BYTES_PER_S * 1e3
            tables.append(h)
            layers.append({"wall_ms": layer_wall, "device_busy_ms": busy,
                           "device_ops": streams[0][0],
                           "idle_share": 1 - busy / layer_wall,
                           "wide_kernel": {
                               "launches_traced": wide_n,
                               "total_ms": wide_ms,
                               "mean_ms": wide_ms / wide_n,
                               "bound_ms": bound,
                               "mean_bound_ms": bound / batches}})
            log(f"  layer {layer}: {tuple(tables[-2].shape)} -> "
                f"{tuple(h.shape)}: wall {layer_wall:.1f} ms, device busy "
                f"{busy:.1f} ms in {streams[0][0]} device ops (idle share "
                f"{1 - busy / layer_wall:.3f}); sage_aggregate_wide_kernel "
                f"{wide_ms:.1f} ms over the {wide_n} launches the trace kept "
                f"of {batches}, {wide_ms / wide_n:.4f} ms a launch (bound "
                f"{bound:.3f} ms a layer, {bound / batches:.5f} a launch, "
                f"for {distinct} distinct source rows: "
                f"{bound / batches / (wide_ms / wide_n):.1%} of it)")
    if not torch.equal(tables[-1], logits):
        raise AssertionError("the layer-by-layer run differs in bits from "
                             "layerwise_inference")

    log("-- the batch holding the max in-degree node, each layer")
    wide = check_wide_batch(params, graph, tables, cfg, width)
    del tables

    test, labels_all = unlabelled_split(ds, data)
    pred_exact = torch.argmax(logits, dim=-1).cpu().numpy()
    exact_acc = float((pred_exact[test] == labels_all[test]).mean())
    sub = test[:SAMPLED_TEST]
    exact_sub = float((pred_exact[sub] == labels_all[sub]).mean())
    t0 = time.perf_counter()
    predictor = Predictor(pipe, params, cfg, buckets=(1024,),
                          base_salt=SALT)
    sampled = predictor.predict(sub)
    t_pred = time.perf_counter() - t0
    sampled_acc = float((sampled.argmax(-1) == labels_all[sub]).mean())
    log(f"test split ({test.size} unlabelled nodes): exact accuracy "
        f"{exact_acc:.4f}; on its first {sub.size}: exact {exact_sub:.4f}, "
        f"sampled predict (hybrid+fused, fanouts {cfg.fanouts}, salt "
        f"{SALT}) {sampled_acc:.4f} ({t_pred:.1f} s)")
    return counts, wide, {
        "wall_s": wall, "peak_device_gb": peak, "layers": layers,
        "width": width, "batches_per_layer": batches,
        "padding_share": padding, "test_nodes": int(test.size),
        "exact_accuracy": exact_acc, "subset_nodes": int(sub.size),
        "exact_accuracy_subset": exact_sub,
        "sampled_accuracy_subset": sampled_acc, "sampled_predict_s": t_pred}


# --------------------------------------------------------------------------
# phase 12: the gcn, gat and gin convs at full width
# --------------------------------------------------------------------------

CONVS = ("gcn", "gat", "gin")
CONV_STEPS = 3                   # a time-bound cut (it was 5)
CONV_ARRIVALS = 100
# gat's exact inference reads (batch, width, 256) floats of attention
# sources a batch: uncapped (width 11 361) 5.96 GB, 977 times a layer.
# The cap is the fused sampler's window: a node's first 2048 in-edges in
# CSC order, the ones training and serving draw from (1.07 GB a gather)
GAT_CAP = 2048


def conv_close(conv: str, got, ref) -> tuple[float, float]:
    """A conv's rows ``got`` against a plain-version forward ``ref`` (both
    (rows, width), numpy or torch): (max abs err, the largest share of
    its tolerance that any entry uses; the check passes at most 1).  An
    entry's tolerance is LOGIT_TOL times its |ref|, plus an absolute
    LOGIT_TOL; for gin, LOGIT_TOL times its row's largest |ref| where
    that passes 1.  gin sums its neighbours, so a row's values grow with
    its nodes' in-degrees (to 1e5 and more on the hub batch after 7
    steps), and an entry that cancels to near zero carries the fp32
    rounding of its row's scale; other rows keep theirs."""
    import torch
    got = torch.as_tensor(got)
    ref = torch.as_tensor(ref, device=got.device)
    atol = torch.full_like(ref[:, :1], LOGIT_TOL)
    if conv == "gin":
        atol = LOGIT_TOL * ref.abs().amax(-1, keepdim=True).clamp(min=1.0)
    diff = (got - ref).abs()
    share = (diff / (atol + LOGIT_TOL * ref.abs())).max()
    return float(diff.max()), float(share)


def unlabelled_split(ds, data):
    """(test node ids, every node's class): the nodes the split leaves
    unlabelled, with the class the source drew for them (its generator's
    first draw, checked against the labelled ones)."""
    import numpy as np
    n = ds.graph.num_nodes
    labels_all = np.random.default_rng(data.seed).integers(
        0, data.num_classes, n).astype(np.int32)
    labelled = ds.labels >= 0
    if not np.array_equal(labels_all[labelled], ds.labels[labelled]):
        raise AssertionError("the recomputed classes disagree with the "
                             "dataset's labels")
    return np.flatnonzero(~labelled), labels_all


def conv_exact(conv, params, cfg, graph, x, ds, data, serving_pipe):
    """Exact inference of one conv (gat under GAT_CAP), each layer a
    profiled ``layer_pass``: launch counts, layer walls and device busy,
    the max in-degree batch's aggregate against the f-ordered loop (gcn
    and gin: every layer's is the wide kernel's) and its rows against a
    plain-version forward, exact and sampled accuracy."""
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.core.inference import inference_width, layer_pass
    from repro_torch.core.mfg import MFG
    from repro_torch.core.sampler import build_indptr
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_plain)
    from repro_torch.models.gnn import apply_layer
    from repro_torch.serve import Predictor

    cap = GAT_CAP if conv == "gat" else None
    n, width = graph.num_nodes, inference_width(graph, cap)
    batches = -(-n // INFER_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tables, layers = [x], []
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            with kernel_trace() as prof:
                t0 = time.perf_counter()
                h = layer_pass(params[layer], graph, tables[-1], cfg,
                               is_last=layer == cfg.num_layers - 1,
                               width=width)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy, streams = device_streams(prof)
            ops = sum(n for n, _, _ in streams)
            tables.append(h)
            layers.append({"wall_ms": wall, "device_busy_ms": busy,
                           "device_ops": ops})
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    logits = tables[-1]
    if logits.shape != (n, cfg.num_classes) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{conv} exact logits: shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    want = {k: 0 for k in counts}
    # gat's attention layers launch no kernel; its last layer takes the
    # mean, one launch a batch like every layer of gcn and gin
    want["sage_aggregate"] = batches * (1 if conv == "gat"
                                        else cfg.num_layers)
    if counts != want:
        raise AssertionError(f"{conv} exact inference launches {counts}, "
                             f"expected {want}")
    log(f"  exact ({'cap ' + str(cap) if cap else 'uncapped'}, width "
        f"{width}): logits {tuple(logits.shape)} finite, launches {counts}, "
        f"peak device memory {peak:.2f} GB; layer wall (profiled) / device "
        f"busy ms: " + ", ".join(f"{lay['wall_ms']:.1f} / "
                                 f"{lay['device_busy_ms']:.1f} "
                                 f"({lay['device_ops']} ops)"
                                 for lay in layers))

    lo, hi, samples, valid = max_degree_batch(graph, width)
    errs, shares = [], []
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            h = tables[layer]
            if conv != "gat":
                got = sage_aggregate(samples, h)
                loop = f_ordered_mean(samples[None], h[None])[0]
                torch.cuda.synchronize()
                if not torch.equal(got, loop):
                    raise AssertionError(
                        f"{conv} exact layer {layer}: the max in-degree "
                        f"batch's aggregate differs in bits from the "
                        f"f-ordered loop")
                del got, loop
            mfg = MFG(dst_nodes=torch.arange(lo, hi, device=h.device),
                      src_nodes=torch.arange(n, device=h.device),
                      num_src=torch.tensor(n), edges=samples,
                      edge_mask=valid, indptr=build_indptr(valid))
            plain = apply_layer(params[layer], mfg, h, cfg,
                                is_last=layer == cfg.num_layers - 1,
                                aggregate=sage_aggregate_plain,
                                h_dst=h[lo:hi])
            err, share = conv_close(conv, tables[layer + 1][lo:hi], plain)
            errs.append(err)
            shares.append(share)
            if not share <= 1.0:
                raise AssertionError(f"{conv} exact layer {layer}: the max "
                                     f"batch's rows differ from a "
                                     f"plain-version forward by {err} "
                                     f"({share:.3g} of the tolerance)")
            del plain
    log(f"  max in-degree batch [{lo}, {hi}): "
        + ("aggregate == f-ordered loop bit for bit each layer; "
           if conv != "gat" else "")
        + "each layer's rows within " + ", ".join(
            f"{e:.3g} ({t:.3g} of the tolerance)"
            for e, t in zip(errs, shares))
        + " of a plain-version forward")
    del tables

    test, labels_all = unlabelled_split(ds, data)
    pred_exact = torch.argmax(logits, dim=-1).cpu().numpy()
    exact_acc = float((pred_exact[test] == labels_all[test]).mean())
    sub = test[:SAMPLED_TEST]
    predictor = Predictor(serving_pipe, params, cfg, buckets=(1024,),
                          base_salt=SALT)
    sampled = predictor.predict(sub)
    sampled_acc = float((sampled.argmax(-1) == labels_all[sub]).mean())
    exact_sub = float((pred_exact[sub] == labels_all[sub]).mean())
    log(f"  accuracy on the test split: exact {exact_acc:.4f} ({test.size} "
        f"nodes); on its first {sub.size}: exact {exact_sub:.4f}, sampled "
        f"predict {sampled_acc:.4f}")
    return counts, {"cap": cap, "width": width, "layers": layers,
                    "peak_device_gb": peak, "max_batch_row_err": errs,
                    "max_batch_row_tol_share": shares,
                    "exact_accuracy": exact_acc,
                    "exact_accuracy_subset": exact_sub,
                    "sampled_accuracy_subset": sampled_acc,
                    "subset_nodes": int(sub.size)}


def conv_phase(train_pipe, serving_pipe, ds, data, serving):
    """Phase 12: gcn, gat (4 heads) and gin at PRODUCTS widths, random
    weights from seed 0, on phase 8's layout, ``pinned_hot`` store and
    degree cache.  Returns ({path: launch counts}, {conv: numbers})."""
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.configs.graphsage_paper import PRODUCTS
    from repro_torch.kernels.sage_aggregate import sage_aggregate_plain
    from repro_torch.models.gnn import (gnn_forward, gnn_loss,
                                        init_gnn_params)
    from repro_torch.optim import init_opt_state, tree_leaves
    from repro_torch.serve import GNNServer, Predictor

    pin = train_pipe
    seeds = pin.seeds(TRAIN_BATCH, TRAIN_SALT)
    prepare, _ = pin.make_prepare_consume(None, counted=False)
    with torch.no_grad():
        bp = prepare(pin.shards, seeds, TRAIN_SALT, pin.cache)
    graph = ds.graph.to("cuda")
    x = torch.from_numpy(ds.features).cuda()
    arrivals = serving["arrivals"][:CONV_ARRIVALS]
    paths, out = {}, {}
    for conv in CONVS:
        t_conv = time.perf_counter()
        cfg = dataclasses.replace(PRODUCTS, dropout=0.0, conv=conv,
                                  gat_heads=4)
        log(f"-- {conv}: {cfg.in_dim} -> {cfg.hidden_dim} -> "
            f"{cfg.hidden_dim} -> {cfg.num_classes}, fanouts {cfg.fanouts}"
            + (f", {cfg.gat_heads} heads" if conv == "gat" else ""))
        params = init_gnn_params(cfg, torch.Generator().manual_seed(0),
                                 "cuda")

        def loss_fn(p, mfgs, h, lab, v, cfg=cfg):
            return gnn_loss(p, mfgs, h, lab, v, cfg)

        def plain_loss_fn(p, mfgs, h, lab, v, cfg=cfg):
            return gnn_loss(p, mfgs, h, lab, v, cfg,
                            aggregate=sage_aggregate_plain)

        _, consume = pin.make_prepare_consume(loss_fn, counted=False)
        _, consume_plain = pin.make_prepare_consume(plain_loss_fn,
                                                    counted=False)
        lk, gk, _ = consume(params, bp)
        lq, gq, _ = consume_plain(params, bp)
        loss_err = abs(float(lk) - float(lq))
        if not np.isfinite(float(lk)) or loss_err > LOSS_TOL:
            raise AssertionError(f"{conv}: loss {float(lk)} vs plain "
                                 f"{float(lq)}")
        worst = 0.0
        for a, b in zip(tree_leaves(gk), tree_leaves(gq)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, rel)
            if rel > GRAD_RTOL:
                raise AssertionError(f"{conv}: gradient leaf "
                                     f"{tuple(a.shape)} differs from the "
                                     f"plain step by {rel:.3g} of its max "
                                     f"(tol {GRAD_RTOL})")
        del gk, gq
        log(f"  kernel step vs plain step: loss {float(lk):.6f} vs "
            f"{float(lq):.6f} (abs err {loss_err:.3g}, tol {LOSS_TOL}); "
            f"gradients: worst leaf max abs err {worst:.3g} of its max |g| "
            f"(tol {GRAD_RTOL})")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        driver = pin.train_driver(loss_fn, batch=TRAIN_BATCH, lr=TRAIN_LR,
                                  grad_clip=1.0)
        params0, opt = params, init_opt_state(params)
        K.reset_launch_counts()
        rounds_before = pin.counter.rounds
        losses, walls = [], []
        for _ in range(CONV_STEPS):
            t0 = time.perf_counter()
            params, opt, loss, _ = driver.step(params, opt)
            losses.append(float(loss))
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        paths[f"{conv} steps"] = counts
        rounds = (pin.counter.rounds - rounds_before) / CONV_STEPS
        if not np.isfinite(losses).all() or rounds != 2:
            raise AssertionError(f"{conv}: losses {losses}, {rounds} rounds "
                                 f"per step (expected finite, 2)")
        # these convs keep their own tails: no sage_epilogue, and no
        # gat_attention (gatv1's)
        missing = [k for k, v in counts.items()
                   if v == 0 and not k.startswith("sage_epilogue")
                   and k not in GAT_KERNELS]
        if missing:
            raise AssertionError(f"{conv}: kernels never launched on the "
                                 f"training path: {missing}")
        # the profiled steps' parameters are dropped: serving and exact
        # inference read the trained steps' whatever the profiler retakes
        _, _, prof = profiled_steps(driver, params, opt)
        peak = torch.cuda.max_memory_allocated() / 1e9
        driver.close()
        log(f"  {CONV_STEPS} SyncDriver steps: losses "
            + ", ".join(f"{v:.6f}" for v in losses)
            + f"; {rounds:g} rounds a step; step wall median "
            f"{statistics.median(walls):.3f} ms (min {min(walls):.3f}, max "
            f"{max(walls):.3f}); profiled step wall {prof['wall_ms']:.3f} "
            f"ms, device busy {prof['device_busy_ms']:.3f} ms in "
            f"{prof['own_stream_ops']} ops (idle share against the median "
            f"{1 - prof['device_busy_ms'] / statistics.median(walls):.3f});"
            f" peak device memory {peak:.2f} GB; launches per step "
            + ", ".join(f"{k} {v / CONV_STEPS:g}" for k, v in counts.items()))

        t_train = time.perf_counter() - t_conv
        pred = Predictor(serving_pipe, params, cfg, buckets=(1, 8, 32, 128),
                         base_salt=SALT)
        pred.warmup()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        logits = pred.predict(serving["batch_seeds"])
        t_predict = (time.perf_counter() - t0) * 1e3
        batch, pos = serving["batch"], serving["pos"]
        with torch.inference_mode():
            plain = gnn_forward(params, list(batch.mfgs), batch.h_src, cfg,
                                aggregate=sage_aggregate_plain)
            plain = plain.cpu().numpy()[pos[:, 0], pos[:, 1]]
        if logits.shape != (128, cfg.num_classes) \
                or not np.isfinite(logits).all():
            raise AssertionError(f"{conv}: predict logits {logits.shape}, "
                                 f"finite {np.isfinite(logits).all()}")
        err, share = conv_close(conv, logits, plain)
        if not share <= 1.0:
            raise AssertionError(f"{conv}: predict logits differ from the "
                                 f"plain forward by {err} ({share:.3g} of "
                                 f"the tolerance)")
        stats, served = GNNServer(pred, max_delay=2e-3).run(
            arrivals, warmup=False, collect_outputs=True)
        direct = pred.predict([s for _, s in arrivals])
        if not np.array_equal(served, direct):
            raise AssertionError(
                f"{conv}: served outputs differ from direct predict in "
                f"{int((served != direct).any(axis=1).sum())} of "
                f"{len(arrivals)} rows")
        counts = K.launch_counts()
        paths[f"{conv} serving"] = counts
        missing = [k for k in SERVING_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"{conv}: kernels never launched on the "
                                 f"serving path: {missing}")
        s = stats.summary()
        log(f"  predict(128 seeds) {t_predict:.2f} ms, max abs err "
            f"{err:.3g} against a plain-version forward ({share:.3g} of the "
            f"tolerance); "
            f"{s['num_requests']} hotset requests through GNNServer: p50 "
            f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, buckets "
            f"{s['bucket_histogram']}; served == direct predict bit for "
            f"bit")
        del pred

        t_serve = time.perf_counter() - t_conv - t_train
        counts, exact = conv_exact(conv, params, cfg, graph, x, ds, data,
                                   serving_pipe)
        paths[f"{conv} exact"] = counts
        out[conv] = {"loss_vs_plain_abs_err": loss_err,
                     "grad_worst_rel_err": worst, "losses": losses,
                     "step_wall_ms": walls, "profiled_step": prof,
                     "peak_device_gb": peak, "predict_ms": t_predict,
                     "predict_max_abs_err": err,
                     "predict_tol_share": share,
                     "serve": {
                         k: s[k] for k in ("p50_ms", "p99_ms", "qps",
                                           "num_flushes")},
                     "exact": exact,
                     "phase_s": time.perf_counter() - t_conv}
        log(f"  {conv}: {out[conv]['phase_s']:.1f} s (training "
            f"{t_train:.1f}, serving {t_serve:.1f}, exact "
            f"{out[conv]['phase_s'] - t_train - t_serve:.1f})")
    return paths, out


# --------------------------------------------------------------------------
# phase 13: the data layer and the partitioners
# --------------------------------------------------------------------------

SBM_NODES = 100_000              # streaming LDG places nodes one by one
STREAM_CHUNK = 1 << 20           # edges a chunk of the stream
DATA_STEPS = 3
TRAIN_PATH_KERNELS = ("fused_sample", "feature_gather", "sage_aggregate",
                      "sage_backward_index", "sage_aggregate_backward")


def same_dataset(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.graph.numpy()[0], b.graph.numpy()[0])
            and np.array_equal(a.graph.numpy()[1], b.graph.numpy()[1])
            and np.array_equal(a.features, b.features)
            and np.array_equal(a.labels, b.labels)
            and a.name == b.name and a.num_classes == b.num_classes)


def data_steps(pipe, cfg, label: str, steps: int = DATA_STEPS):
    """``steps`` SyncDriver steps on ``pipe`` (launch counts set to 0
    first): finite losses, every kernel of the exchange store's training
    path launched.  Returns (launch counts, losses, step walls)."""
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.models.gnn import gnn_loss, init_gnn_params
    from repro_torch.optim import init_opt_state

    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cuda")
    driver = pipe.train_driver(
        lambda p, m, h, lab, v: gnn_loss(p, m, h, lab, v, cfg),
        batch=TRAIN_BATCH, lr=TRAIN_LR, grad_clip=1.0)
    opt = init_opt_state(params)
    K.reset_launch_counts()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, loss, _ = driver.step(params, opt)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    driver.close()
    missing = [k for k in TRAIN_PATH_KERNELS if counts[k] == 0]
    if not np.isfinite(losses).all() or missing:
        raise AssertionError(f"{label}: losses {losses}, kernels never "
                             f"launched: {missing}")
    log(f"  {steps} steps ({label}): losses "
        + ", ".join(f"{v:.6f}" for v in losses) + ", walls "
        + ", ".join(f"{w:.1f}" for w in walls) + f" ms; launches {counts}")
    return counts, losses, walls


def data_phase(cfg):
    """Phase 13: rmat through the on-disk format into a ``hash``
    pipeline, sbm under ``degree_stratified`` through streaming LDG,
    metis's refusal and a rung of ``AdaptiveFanout``, each training on the
    card at ``cfg``'s widths.  Returns ({path: launch counts}, numbers)."""
    import tempfile
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.core.adaptive import AdaptiveFanout
    from repro_torch.core.partition import resolve_partitioner
    from repro_torch.data import (DataSpec, dataset_stats, load_dataset,
                                  resolve_dataset, save_dataset, stats_label)
    from repro_torch.pipeline import Pipeline, PipelineSpec

    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        log("-- rmat through the on-disk format, partitioner hash")
        t0 = time.perf_counter()
        rmat = DataSpec(source="rmat(0.57,0.19,0.19,0.05)",
                        num_nodes=NUM_NODES, avg_degree=AVG_DEGREE,
                        num_features=cfg.in_dim,
                        num_classes=cfg.num_classes, seed=0)
        ds = resolve_dataset(data=rmat)
        t_gen = time.perf_counter() - t0
        stats = dataset_stats(ds)
        log(f"  {stats_label(stats)}: {json.dumps(stats)} (generated in "
            f"{t_gen:.1f} s)")
        t0 = time.perf_counter()
        path = save_dataset(ds, os.path.join(tmp, "rmat"))
        t_save = time.perf_counter() - t0
        for mmap in (True, False):
            t0 = time.perf_counter()
            back = load_dataset(path, mmap=mmap)
            if not same_dataset(back, ds):
                raise AssertionError(f"load_dataset(mmap={mmap}) differs "
                                     f"from the saved dataset")
            log(f"  load_dataset(mmap={mmap}) == the dataset bit for bit "
                f"({time.perf_counter() - t0:.2f} s with the comparison)")
        log(f"  saved {os.path.getsize(path) / 1e6:.1f} MB in {t_save:.2f} s")
        del back
        t0 = time.perf_counter()
        spec = PipelineSpec.from_scheme(
            "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
            partitioner="hash", data=rmat)
        pipe = Pipeline.build_from_source(path, spec)
        t_build = time.perf_counter() - t0
        log(f"  build_from_source(path), hash: {t_build:.1f} s, n_max "
            f"{pipe.layout.n_max}, edge cut {pipe.edge_cut_fraction:.4f}")
        paths["rmat file, hash"], losses, walls = data_steps(
            pipe, cfg, "rmat, hash")
        out["rmat"] = {"stats": stats, "generate_s": t_gen,
                       "save_s": t_save, "build_s": t_build,
                       "edge_cut": pipe.edge_cut_fraction,
                       "losses": losses, "step_wall_ms": walls}
        del pipe, ds

        log(f"-- sbm(4,0.9,0.1), {SBM_NODES} nodes, degree_stratified(0.3), "
            f"streaming LDG")
        t0 = time.perf_counter()
        sbm = DataSpec(source="sbm(4,0.9,0.1)", num_nodes=SBM_NODES,
                       avg_degree=AVG_DEGREE, num_features=cfg.in_dim,
                       num_classes=cfg.num_classes,
                       split="degree_stratified(0.3)", seed=0)
        spec = PipelineSpec.from_scheme(
            "hybrid+fused", num_parts=NUM_PARTS, fanouts=cfg.fanouts,
            partitioner="ldg", data=sbm)
        pipe = Pipeline.build_from_source(
            spec=spec, partition_chunk_edges=STREAM_CHUNK)
        t_build = time.perf_counter() - t0
        log(f"  {stats_label(dataset_stats(pipe.dataset))}; build with "
            f"chunks of {STREAM_CHUNK} edges: {t_build:.1f} s, edge cut "
            f"{pipe.edge_cut_fraction:.4f}, labelled "
            f"{int((pipe.dataset.labels >= 0).sum())}")
        paths["sbm, streaming ldg"], losses, walls = data_steps(
            pipe, cfg, "sbm, streaming ldg")
        out["sbm"] = {"stats": dataset_stats(pipe.dataset),
                      "build_s": t_build,
                      "edge_cut": pipe.edge_cut_fraction,
                      "losses": losses, "step_wall_ms": walls}

        log("-- AdaptiveFanout forced down a rung (patience 1, a flat loss)")
        af = AdaptiveFanout(ladder=(cfg.fanouts, (10, 7, 4), (5, 5, 3)),
                            patience=1)
        af.update(losses[-1])
        if not af.update(losses[-1]) or af.fanouts != (10, 7, 4):
            raise AssertionError(f"AdaptiveFanout did not step down: stage "
                                 f"{af.stage}")
        rung = dataclasses.replace(cfg, fanouts=af.fanouts)
        spec = PipelineSpec.from_scheme(
            "hybrid+fused", num_parts=NUM_PARTS, fanouts=af.fanouts,
            data=sbm)
        rebuilt = Pipeline.from_layout(pipe.layout, spec)
        prepare, _ = rebuilt.make_prepare_consume(None, counted=False)
        with torch.no_grad():
            b = prepare(rebuilt.shards, rebuilt.seeds(TRAIN_BATCH, 1), 1)
        if tuple(m.edges.shape[-1] for m in b.mfgs) != af.fanouts:
            raise AssertionError("the rebuilt step's MFGs are not at the "
                                 "new fanouts")
        paths["adaptive rung"], _, _ = data_steps(rebuilt, rung,
                                                  f"rung {af.fanouts}", 2)
        del pipe, rebuilt, b

        log("-- metis")
        try:
            import pymetis  # noqa: F401
            log("  pymetis is installed: the refusal cannot happen here")
        except ImportError:
            try:
                resolve_partitioner("metis")
            except ImportError as e:
                log(f"  metis refuses without pymetis: {e}")
            else:
                raise AssertionError("metis resolved without pymetis")

    return paths, out


# --------------------------------------------------------------------------
# phase 14: the fleet on the card
# --------------------------------------------------------------------------

# (label, executor, ranks, workers a rank, scheme, rounds a step)
FLEETS = (
    ("shard_map 4x1 hybrid+fused", "shard_map", 4, 1, "hybrid+fused", 2),
    ("multiprocess 2x2 hybrid+fused", "multiprocess", 2, 2, "hybrid+fused",
     2),
    ("shard_map 4x1 vanilla", "shard_map", 4, 1, "vanilla", 6),
)
FLEET_DIR = os.path.join(HERE, "build", "fleet")
# seeds a worker in the fleets and their stacked references: half of
# TRAIN_BATCH (a depth cut for the time bound: a 1000-seed step moves a
# 1.69 GB rows round a rank through gloo in 1.3-1.9 s)
FLEET_BATCH = 500
FLEET_TIMEOUT_S = 420.0
LAUNCHER_NODES = 20_000          # train_gnn's default --nodes
# seeds a worker in the launcher smoke (train_gnn's default is 256, whose
# rows round is 3.5 GB a rank through gloo; a time-bound cut)
LAUNCHER_BATCH = 64
# the pair of ranks 0 and 1 as an executor of its own (fleet 2 runs on it
# while ranks 2 and 3 wait)
PAIR_EXECUTOR = "multiprocess_ranks01"
LAUNCH_TIME_ENV = "CHIP_SMOKE_FLEET_LAUNCHED"   # the parent's time.time()
# steps of each fleet and of its stacked reference (depth cuts for the
# time bound: TRAIN_STEPS, 10, then 5, then 3 to pay for phase 17, now 2
# to pay for phase 18)
FLEET_STEPS = 2
# fleet vs the stacked executor: both take the rule of
# repro_torch.pipeline.prefetch (each worker's own backward, then the mean
# in worker order), so the losses of all FLEET_STEPS steps and the
# parameters after step 1 and after the last are held equal to the stacked
# run's bit for bit
ALL_KERNELS = ("fused_sample", "sage_aggregate", "sage_backward_index",
               "sage_aggregate_backward", "feature_gather", "gather_rows",
               "sage_epilogue", "sage_epilogue_backward")


def fleet_kernels(scheme: str) -> tuple:
    """The kernel wrappers a fleet step of ``scheme`` must launch (no
    cache: no ``gather_rows``; vanilla draws through its own sampler)."""
    return tuple(k for k in ALL_KERNELS if k != "gather_rows"
                 and (k != "fused_sample" or scheme == "hybrid+fused"))


def flat_params(params):
    import numpy as np
    return np.concatenate([v.detach().float().cpu().numpy().ravel()
                           for layer in params
                           for _, v in sorted(layer.items())])


def comm_stats(events, steps: int) -> dict:
    """Per round kind and payload, from a rank's ``comm/*`` spans: rounds a
    step, bytes this rank sent in one, and the mean ms."""
    out = {}
    for ev in events:
        if ev.get("ph") != "X" or not ev["name"].startswith("comm/"):
            continue
        a = ev.get("args", {})
        key = f"{ev['name']} {a.get('what')} {a.get('bytes')}"
        s = out.setdefault(key, {"op": ev["name"], "what": a.get("what"),
                                 "rank_bytes": a.get("bytes"), "n": 0,
                                 "ms": 0.0})
        s["n"] += 1
        s["ms"] += ev["dur"] / 1e3
    for s in out.values():
        s["per_step"] = s["n"] / steps
        s["mean_ms"] = s["ms"] / s["n"]
        if s["op"] != "comm/device_wait" and s["mean_ms"] > 0:
            s["gb_per_s"] = s["rank_bytes"] / s["mean_ms"] / 1e6
    return out


def fleet_rank(workdir: str) -> int:
    """One rank of phase 14's fleet: runs every fleet it belongs to and
    writes ``rank<r>.json`` (and rank 0 its parameters and logits) into
    ``workdir``."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    import repro_torch.kernels as K
    from repro_torch.configs.graphsage_paper import PRODUCTS
    from repro_torch.core.partition import build_layout
    from repro_torch.data import load_dataset
    from repro_torch.launch import multihost
    from repro_torch.models.gnn import gnn_loss, params_from_numpy
    from repro_torch.obs import trace as obs_trace
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec
    from repro_torch.pipeline.executor import (FleetExecutor,
                                               register_executor)
    from repro_torch.serve import Predictor

    t_rank = time.perf_counter()
    launched = time.time() - float(os.environ[LAUNCH_TIME_ENV])
    rank, num_procs, device = multihost.init_from_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pair = tdist.new_group([0, 1])
    register_executor(PAIR_EXECUTOR, lambda: FleetExecutor(pair))
    ds = load_dataset(os.path.join(workdir, "dataset.npz"))
    assign = np.load(os.path.join(workdir, "assign.npy"))
    blob = np.load(os.path.join(workdir, "params0.npz"))
    cfg = dataclasses.replace(PRODUCTS, dropout=0.0)
    params_np = [{k.split("/", 1)[1]: blob[k] for k in blob.files
                  if k.startswith(f"{i}/")} for i in range(cfg.num_layers)]
    batch_seeds = np.load(os.path.join(workdir, "batch_seeds.npy"))

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    results = {"rank": rank, "device": str(device),
               "process_start_s": launched,
               "startup_s": time.perf_counter() - t_rank, "fleets": {}}
    layouts = {}
    for i, (label, executor, ranks, per, scheme, rounds) in \
            enumerate(FLEETS):
        if rank < ranks:
            t0 = time.perf_counter()
            parts = (rank * per, (rank + 1) * per)
            if parts not in layouts:
                layouts[parts] = build_layout(
                    ds.graph, ds.features, ds.labels, assign, NUM_PARTS,
                    local_parts=parts)
            t_layout = time.perf_counter() - t0
            name = PAIR_EXECUTOR if ranks == 2 else executor
            spec = PipelineSpec.from_scheme(
                scheme, num_parts=NUM_PARTS, fanouts=cfg.fanouts,
                executor=name)
            pipe = Pipeline.from_layout(layouts[parts], spec)
            t_build = time.perf_counter() - t0
            params = params_from_numpy(params_np, device)
            opt = init_opt_state(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tracer = obs_trace.start(None, capacity=1 << 16, pid=rank)
            K.reset_launch_counts()
            losses, walls = [], []
            with pipe.train_driver(loss_fn, batch=FLEET_BATCH, lr=TRAIN_LR,
                                   grad_clip=1.0) as driver:
                for k in range(FLEET_STEPS):
                    t0 = time.perf_counter()
                    params, opt, loss, _ = driver.step(params, opt)
                    losses.append(float(loss))      # synchronizes
                    walls.append((time.perf_counter() - t0) * 1e3)
                    if k == 0:
                        params1 = flat_params(params)
            counts = K.launch_counts()
            obs_trace.stop(export=False)
            on_cuda = all(t.is_cuda for t in (
                pipe.shards.features, pipe.shards.labels,
                pipe.layout.graph.indices, pipe.layout.offsets, loss,
                pipe.seeds(FLEET_BATCH, 0),
                *(v for layer in params for v in layer.values())))
            kinds = pipe.counter.kinds
            res = {"losses": losses, "walls_ms": walls,
                   "launches": counts, "on_cuda": on_cuda,
                   "rounds_per_step": len(kinds) / FLEET_STEPS,
                   "round_kinds": kinds[:len(kinds) // FLEET_STEPS],
                   "worker_bytes_per_round":
                       pipe.counter.bytes_per_round[
                           :len(kinds) // FLEET_STEPS],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "layout_s": t_layout, "build_s": t_build,
                   "comm": comm_stats(tracer.events(), FLEET_STEPS),
                   "params_sha": hashlib.sha256(
                       flat_params(params).tobytes()).hexdigest()}
            if rank == 0:
                np.save(os.path.join(workdir, f"fleet{i}_params.npy"),
                        flat_params(params))
                np.save(os.path.join(workdir, f"fleet{i}_params1.npy"),
                        params1)
            if label == FLEETS[0][0]:
                pred = Predictor(pipe, params_from_numpy(params_np, device),
                                 cfg, buckets=(128,), base_salt=SALT)
                logits = pred.predict(batch_seeds)
                if rank == 0:
                    np.save(os.path.join(workdir, "fleet_logits.npy"),
                            logits)
                del pred
            results["fleets"][label] = res
            del pipe, driver, params, opt, loss
            torch.cuda.empty_cache()
        tdist.barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    tdist.destroy_process_group()
    return 0


def diff_to_stacked(fleet, stacked) -> dict:
    """Whether a fleet's parameters equal the stacked run's bit for bit,
    and by how much they differ where they do not."""
    import numpy as np
    d = np.abs(fleet.astype(np.float64) - stacked)
    return {"equal": bool(np.array_equal(fleet, stacked)),
            "max_abs": float(d.max()),
            "rel_l2": float(np.linalg.norm(d) / np.linalg.norm(stacked)),
            "entries_differing": int((d > 0).sum()), "entries": int(d.size)}


def stacked_fleet_reference(layout, cfg, params0, batch_seeds) -> dict:
    """The parent's stacked runs that phase 14's fleets are held to: 5
    ``SyncDriver`` steps of each fleet scheme over phase 3's layout,
    ``exchange`` store, no cache, from phase 8's initial parameters (and
    the 128-seed predict with those)."""
    import numpy as np
    import torch
    import repro_torch.kernels as K
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline, PipelineSpec
    from repro_torch.serve import Predictor

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    out = {}
    for scheme in ("hybrid+fused", "vanilla"):
        pipe = Pipeline.from_layout(layout, PipelineSpec.from_scheme(
            scheme, num_parts=NUM_PARTS, fanouts=cfg.fanouts))
        params = params0
        opt = init_opt_state(params)
        K.reset_launch_counts()
        losses, walls = [], []
        with pipe.train_driver(loss_fn, batch=FLEET_BATCH, lr=TRAIN_LR,
                               grad_clip=1.0) as driver:
            for k in range(FLEET_STEPS):
                t0 = time.perf_counter()
                params, opt, loss, _ = driver.step(params, opt)
                losses.append(float(loss))
                walls.append((time.perf_counter() - t0) * 1e3)
                if k == 0:
                    params1 = flat_params(params)
        out[scheme] = {"losses": losses, "walls_ms": walls,
                       "params": flat_params(params), "params1": params1,
                       "rounds_per_step": pipe.counter.rounds / FLEET_STEPS,
                       "launches": K.launch_counts()}
        if scheme == "hybrid+fused":
            pred = Predictor(pipe, params0, cfg, buckets=(128,),
                             base_salt=SALT)
            out["logits"] = pred.predict(batch_seeds)
            del pred
        log(f"  stacked {scheme}, exchange store: step wall median "
            f"{statistics.median(walls):.3f} ms; losses " + ", ".join(
                f"{x:.6f}" for x in losses))
        del pipe, driver, params, opt
        torch.cuda.empty_cache()
    return out


def fleet_launcher_smoke(cfg) -> dict:
    """``train_gnn --executor multiprocess --num-procs 2 --trace`` on a
    saved ``LAUNCHER_NODES``-node rmat, partitioned by ``labelprop(2)`` in
    every rank, at the launcher's other defaults but one step of
    ``LAUNCHER_BATCH`` seeds a worker: exit 0, rank logs, rank 0's edge
    cut equal to the parent's labelprop(2) of the file (the ranks check
    among themselves that they derived the same partition), a valid
    merged trace."""
    from repro_torch.core.partition import edge_cut, resolve_partitioner
    from repro_torch.data import DataSpec, resolve_dataset, save_dataset
    from repro_torch.obs.trace import validate_trace
    small = resolve_dataset(data=DataSpec(
        source="rmat(0.57,0.19,0.19,0.05)", num_nodes=LAUNCHER_NODES,
        avg_degree=10, num_features=cfg.in_dim, num_classes=cfg.num_classes,
        seed=0))
    path = save_dataset(small, os.path.join(FLEET_DIR, "rmat_small"))
    t0 = time.perf_counter()
    assign = resolve_partitioner("labelprop(2)").assign(
        small.graph, 8, small.labels >= 0)
    t_lp = time.perf_counter() - t0
    cut = edge_cut(small.graph, assign) / small.graph.num_edges
    trace = os.path.join(FLEET_DIR, "launcher_trace.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.train_gnn",
           "--executor", "multiprocess", "--num-procs", "2", "--dataset",
           path, "--partitioner", "labelprop(2)", "--epochs", "1",
           "--steps-per-epoch", "1", "--batch", str(LAUNCHER_BATCH),
           "--trace", trace]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=400,
                         cwd=HERE, env=dict(os.environ,
                                            PYTHONPATH=os.path.join(HERE,
                                                                    "src")))
    seconds = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        log(f"  | {line}")
    if run.returncode != 0:
        log(run.stderr[-4000:])
        raise AssertionError(f"train_gnn as a fleet exited {run.returncode}")
    want = f"partitioned into 8 by 'labelprop(2)': edge-cut {cut:.1%}"
    if want not in run.stdout:
        raise AssertionError(f"rank 0 did not print {want!r}")
    log_dir = run.stdout.strip().splitlines()[-1].rsplit(" ", 1)[-1]
    for r in range(2):
        if not os.path.exists(os.path.join(log_dir, f"rank{r}.out")):
            raise AssertionError(f"no rank{r}.out in {log_dir}")
    with open(trace) as f:
        merged = json.load(f)
    n = validate_trace(merged)
    names = {ev["args"]["name"] for ev in merged["traceEvents"]
             if ev.get("name") == "process_name"}
    if not {"rank0", "rank1"} <= names:
        raise AssertionError(f"merged trace processes {names}")
    log(f"  exit 0 in {seconds:.1f} s; labelprop(2) at P = 8 in the parent: "
        f"{t_lp:.2f} s on the host, edge cut {cut:.4f}, as rank 0 printed; "
        f"rank logs in {log_dir}; merged trace {n} events, processes "
        f"{sorted(names)}, valid")
    return {"seconds": seconds, "trace_events": n, "labelprop_s": t_lp,
            "edge_cut": cut}


def fleet_phase(ds, layout, cfg, params0, batch_seeds, placement):
    """Phase 14: the fleets on the card.  Returns ({path: launch counts
    summed over the ranks}, numbers for PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.data import save_dataset
    from repro_torch.launch import multihost
    from repro_torch.models.gnn import params_to_numpy

    os.makedirs(FLEET_DIR, exist_ok=True)
    t0 = time.perf_counter()
    save_dataset(ds, os.path.join(FLEET_DIR, "dataset.npz"))
    offsets = layout.host_offsets_labels()[0]
    assign = np.empty(layout.graph.num_nodes, np.int64)
    for p in range(NUM_PARTS):
        assign[layout.perm[offsets[p]:offsets[p + 1]]] = p
    np.save(os.path.join(FLEET_DIR, "assign.npy"), assign)
    np.savez(os.path.join(FLEET_DIR, "params0.npz"), **{
        f"{i}/{k}": v for i, layer in enumerate(params_to_numpy(params0))
        for k, v in layer.items()})
    np.save(os.path.join(FLEET_DIR, "batch_seeds.npy"), batch_seeds)
    log(f"dataset, ldg assignment and phase 8's initial parameters written "
        f"to {os.path.relpath(FLEET_DIR, HERE)} in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("-- the stacked runs the fleets are held to (launch counts set to "
        "0 first)")
    stacked = stacked_fleet_reference(layout, cfg, params0, batch_seeds)
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_allocated() / 1e9

    log(f"-- the fleets: {len(FLEETS)} runs of {FLEET_STEPS} SyncDriver "
        f"steps in one 4-rank launch (fleet 2 on ranks 0-1)")
    t0 = time.perf_counter()
    log_dir = multihost.launch(
        [sys.executable, os.path.abspath(__file__), "--fleet-rank",
         FLEET_DIR], num_procs=4, device="cuda", timeout=FLEET_TIMEOUT_S,
        log_dir=os.path.join(FLEET_DIR, "logs"),
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                 **{LAUNCH_TIME_ENV: repr(time.time())}))
    t_fleet = time.perf_counter() - t0
    ranks = []
    for r in range(4):
        with open(os.path.join(FLEET_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"fleet launch: {t_fleet:.1f} s wall; each rank's process start "
        f"(python, imports) " + ", ".join(f"{x['process_start_s']:.1f}"
                                          for x in ranks)
        + " s, then joining the group and loading the files "
        + ", ".join(f"{x['startup_s']:.1f}" for x in ranks) + " s")
    log("host copies: none in the transport (gloo takes CUDA tensors and "
        "copies them through pinned host memory inside the collective, so "
        "the all_to_all ms below include them)")

    counts, numbers = {}, {"fleets": {}, "parent_allocated_gb": parent_gb,
                           "launch_s": t_fleet}
    finals, failures = {}, []
    for i, (label, executor, nranks, per, scheme, rounds) in \
            enumerate(FLEETS):
        res = [x["fleets"][label] for x in ranks[:nranks]]
        ref = stacked[scheme]
        for r, x in enumerate(res):
            if not x["on_cuda"]:
                raise AssertionError(f"{label}: rank {r}'s tensors are not "
                                     f"all on cuda")
            missing = [k for k in fleet_kernels(scheme)
                       if x["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{label}: rank {r} never launched "
                                     f"{missing}")
            if x["rounds_per_step"] != rounds:
                raise AssertionError(f"{label}: rank {r} ran "
                                     f"{x['rounds_per_step']} rounds a step"
                                     f", expected {rounds}")
            if not np.isfinite(x["losses"]).all():
                raise AssertionError(f"{label}: rank {r} losses "
                                     f"{x['losses']}")
            if x["losses"] != res[0]["losses"] \
                    or x["params_sha"] != res[0]["params_sha"]:
                raise AssertionError(f"{label}: rank {r} differs from "
                                     f"rank 0")
        losses = np.asarray(res[0]["losses"])
        want = np.asarray(ref["losses"])
        params = np.load(os.path.join(FLEET_DIR, f"fleet{i}_params.npy"))
        params1 = np.load(os.path.join(FLEET_DIR, f"fleet{i}_params1.npy"))
        after1 = diff_to_stacked(params1, ref["params1"])
        final = diff_to_stacked(params, ref["params"])
        loss_rel = np.abs(losses - want) / np.abs(want)
        if not np.array_equal(losses, want):
            failures.append(f"{label}: losses {losses.tolist()} vs stacked "
                            f"{want.tolist()}")
        if not (after1["equal"] and final["equal"]):
            failures.append(f"{label}: parameters vs stacked: after step 1 "
                            f"{after1}, after {FLEET_STEPS} {final}")
        finals[label] = (losses, params)
        walls = res[0]["walls_ms"]
        comm = res[0]["comm"]
        log(f"-- fleet {i + 1}: {label} ({nranks} ranks x {per} workers)")
        log(f"  losses " + ", ".join(f"{x:.6f}" for x in losses)
            + f"; {'==' if np.array_equal(losses, want) else '!='} the "
            f"stacked run's bit for bit (|loss - stacked| / stacked by "
            f"step " + ", ".join(f"{x:.2g}" for x in loss_rel) + ")")
        for name, c in (("after step 1", after1),
                        (f"after {FLEET_STEPS}", final)):
            log(f"  parameters {name}: "
                f"{'==' if c['equal'] else '!='} the stacked run's bit for "
                f"bit (||diff|| / ||stacked|| {c['rel_l2']:.3g}, max |diff| "
                f"{c['max_abs']:.3g}, {c['entries_differing']} of "
                f"{c['entries']} entries differ)")
        log(f"  {res[0]['rounds_per_step']:g} rounds a step "
            f"({', '.join(res[0]['round_kinds'])}); per-worker capacity "
            f"bytes a round {res[0]['worker_bytes_per_round']}")
        log(f"  step wall median {statistics.median(walls):.3f} ms (min "
            f"{min(walls):.3f}, max {max(walls):.3f}); ranks' medians "
            + ", ".join(f"{statistics.median(x['walls_ms']):.3f}"
                        for x in res)
            + f"; stacked (same layout and store) "
            f"{statistics.median(ref['walls_ms']):.3f} ms")
        log("  peak device memory by rank (GB): " + ", ".join(
            f"{x['peak_gb']:.2f}" for x in res) + f"; parent holds "
            f"{parent_gb:.2f} GB allocated; layout + pipeline build "
            + ", ".join(f"{x['build_s']:.1f}" for x in res) + " s")
        for key, s in sorted(comm.items()):
            rate = f", {s['gb_per_s']:.3f} GB/s" if "gb_per_s" in s else ""
            log(f"  rank 0 {s['op']} {s['what']}: {s['per_step']:g} a step"
                f", {s['rank_bytes']} B sent, {s['mean_ms']:.3f} ms a "
                f"call{rate}")
        log("  launches per rank: " + "; ".join(
            ", ".join(f"{k} {v}" for k, v in x["launches"].items()
                      if v) for x in res))
        counts[f"fleet {label}"] = {
            k: sum(x["launches"][k] for x in res) for k in res[0]["launches"]}
        numbers["fleets"][label] = {
            "ranks": nranks, "workers_per_rank": per, "scheme": scheme,
            "losses": res[0]["losses"], "walls_ms": walls,
            "step_wall_median_ms": statistics.median(walls),
            "stacked_step_wall_median_ms": statistics.median(
                ref["walls_ms"]),
            "rounds_per_step": res[0]["rounds_per_step"],
            "worker_bytes_per_round": res[0]["worker_bytes_per_round"],
            "peak_gb_by_rank": [x["peak_gb"] for x in res],
            "comm_rank0": comm, "params_after_1": after1,
            "params_final": final,
            "launches_by_rank": [x["launches"] for x in res]}
    a, b = finals[FLEETS[0][0]], finals[FLEETS[1][0]]
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        failures.append(f"fleets 1 (4 x 1) and 2 (2 x 2) differ: losses "
                        f"{a[0].tolist()} vs {b[0].tolist()}, parameters "
                        f"max |diff| {float(np.abs(a[1] - b[1]).max())}")
    else:
        log("fleets 1 (4 ranks x 1 worker) and 2 (2 ranks x 2 workers): "
            "losses and final parameters equal bit for bit")
    logits = np.load(os.path.join(FLEET_DIR, "fleet_logits.npy"))
    if not np.array_equal(logits, stacked["logits"]):
        failures.append(
            f"fleet 1's predict differs from the stacked one by "
            f"{float(np.abs(logits - stacked['logits']).max())}")
    else:
        log(f"fleet 1's 128-seed predict {logits.shape} == the stacked "
            f"predict bit for bit")
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))
    runs = placement["runs"]
    log("beside phase 10's stacked walls (pinned_hot, cache): "
        f"vanilla {runs['vanilla']['step_wall_median_ms']:.3f} ms, "
        f"hybrid+fused {runs['hybrid+fused']['step_wall_median_ms']:.3f} "
        f"ms.  One card: the ranks share it, time-sliced, and gloo moves "
        f"their rounds through host memory; not a multi-card result")

    log(f"-- train_gnn --executor multiprocess --num-procs 2 --trace on a "
        f"saved {LAUNCHER_NODES}-node rmat, labelprop(2), one step")
    numbers["launcher"] = fleet_launcher_smoke(cfg)
    return counts, numbers


# --------------------------------------------------------------------------
# phase 15: the pod-scale dry-run and the end-to-end example
# --------------------------------------------------------------------------

DRYRUN_OUT = os.path.join(HERE, "build", "dryrun_gnn_torch")
# the concrete rank: repro's dry-run test shapes (500 nodes a worker, 128
# seeds), 256 workers, hybrid (an unfused sampler on the replicated graph)
CONCRETE = {"workers": 256, "nodes_per_worker": 500, "batch": 128,
            "features": 128}
CONCRETE_KERNELS = ("feature_gather", "sage_aggregate",
                    "sage_backward_index", "sage_aggregate_backward")
# the e2e example's loss climbs to ~130 by step 9 and falls below its
# first value at step 22 (read on an H100): 30 steps hold its own assert
E2E_STEPS = 30
E2E_WIDTHS = (1024, 4096)


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_e2e_widths() -> dict:
    """Phase 4's check at the e2e example's widths: its pipeline and
    initial weights on the card, worker 0's MFGs of one step, each
    layer's aggregate (D = 1024, 4096, 4096) equal to the f-ordered loop
    bit for bit and within tolerance of the plain version, its backward
    against the plain version (``check_backward_once``) on a seeded
    gradient; the forward and the backward timed beside their plain
    versions."""
    import torch
    from repro_torch.kernels.sage_aggregate import (
        sage_aggregate, sage_aggregate_backward,
        sage_aggregate_backward_plain, sage_aggregate_plain)
    from repro_torch.models.gnn import gnn_forward, init_gnn_params
    from repro_torch.pipeline.prefetch import worker_rows

    e2e = load_example("train_gnn_e2e_torch")
    args = e2e.parse_args([])
    pipe, cfg = e2e.build(args, "cuda")
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cuda")
    prepare, _ = pipe.make_prepare_consume(lambda *a: None, counted=False,
                                           device="cuda")
    batch = prepare(pipe.shards, pipe.seeds(args.batch, 0), 0)
    inputs = []

    def recording(edges, h):
        inputs.append((edges, h))
        return sage_aggregate_plain(edges, h)

    # a training step runs each worker's forward and backward on its own
    # rows: worker 0's calls are the shapes the kernels get
    one = slice(0, 1)
    with torch.no_grad():
        gnn_forward(params, [worker_rows(m, one) for m in batch.mfgs],
                    batch.h_src[one], cfg, aggregate=recording)
    widths = sorted({h.shape[-1] for _, h in inputs})
    if widths != list(E2E_WIDTHS):
        raise AssertionError(f"e2e widths {widths}, expected {E2E_WIDTHS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for layer, (edges, h) in enumerate(inputs):
        _, err = check_forward_once(edges, h, f"e2e layer {layer}")
        n = h.shape[1]
        g = torch.randn((*edges.shape[:2], h.shape[-1]), generator=gen,
                        device="cuda")
        b_err, scale, _ = check_backward_once(edges, g, n)
        ms, call, _ = time_ms(lambda: sage_aggregate(edges, h),
                              wrapper=sage_aggregate,
                              kernel="sage_aggregate_kernel")
        plain, _, _ = time_ms(lambda: sage_aggregate_plain(edges, h))
        b_ms, b_call, _ = time_ms(
            lambda: sage_aggregate_backward(edges, g, n))
        b_plain, _, _ = time_ms(
            lambda: sage_aggregate_backward_plain(edges, g, n))
        log(f"  e2e layer {layer}: edges {tuple(edges.shape)} h "
            f"{tuple(h.shape)}: forward == the f-ordered loop bit for bit, "
            f"max abs err {err:.3g} (tol {SAGE_TOL}), device {ms:.4f} ms "
            f"(plain {plain:.4f}); backward max abs err {b_err:.3g} (max "
            f"|grad| {scale:.3g}, rtol {BWD_RTOL}), device {b_ms:.4f} ms "
            f"(plain {b_plain:.4f})")
        out.append({"layer": layer, "edges": list(edges.shape),
                    "h": list(h.shape), "ms": ms, "call_ms": call,
                    "plain_ms": plain, "max_abs_err": err,
                    "backward_ms": b_ms, "backward_call_ms": b_call,
                    "backward_plain_ms": b_plain,
                    "backward_max_abs_err": b_err})
    del pipe, batch, inputs
    torch.cuda.empty_cache()
    return {"layers": out}


def fake_backend_writes() -> dict:
    """Whether this torch's fake backend writes the receive buffers of
    ``all_to_all_single`` and ``all_gather`` on CUDA tensors (it
    communicates nothing; some versions copy what this rank sends)."""
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.dryrun_gnn import fake_job
    with fake_job(2):
        send = torch.arange(4.0, device="cuda") + 1
        recv = torch.zeros_like(send)
        tdist.all_to_all_single(recv, send)
        parts = [torch.zeros(2, device="cuda") for _ in range(2)]
        tdist.all_gather(parts, send[:2])
        return {"all_to_all": bool(recv.any()),
                "all_gather": all(bool(p.any()) for p in parts)}


def concrete_rank(fake: dict) -> tuple[dict, dict]:
    """Rank 0 of a ``CONCRETE["workers"]``-rank fake-backend job on the
    card: seeded data (the replicated graph with ``AVG_DEGREE`` in-edges a
    node, features, labels, 128 of the worker's own seeds), the step run
    once with every launch count set to 0 first.  Gates: the rounds and
    the collective record equal ``fake``'s (the fake-tensor record at the
    same arguments), every kernel of the path launched, the loss a
    number (finite where the backend writes the receive buffers).
    Returns (launch counts, numbers)."""
    import math
    import torch
    import repro_torch.kernels as K
    from repro_torch.launch import dryrun_gnn as D
    from repro_torch.models.gnn import init_gnn_params

    W, npw, B, Fd = (CONCRETE[k] for k in ("workers", "nodes_per_worker",
                                            "batch", "features"))
    n_total = W * npw
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(shape, dtype, what):
        if what == "offsets":
            return torch.arange(W + 1, dtype=dtype, device="cuda") * npw
        if what == "features":
            return torch.randn(shape, generator=gen, device="cuda")
        if what == "labels":
            return torch.randint(0, 172, shape, generator=gen, dtype=dtype,
                                 device="cuda")
        if what == "seeds":       # worker 0 owns nodes 0 .. npw-1
            return torch.randperm(npw, generator=gen, device="cuda")[
                :B].to(dtype).view(shape)
        if what == "indptr":
            return torch.arange(n_total + 1, dtype=dtype,
                                device="cuda") * D.AVG_DEGREE
        if what == "indices":
            return torch.randint(0, n_total, shape, generator=gen,
                                 dtype=dtype, device="cuda")
        raise KeyError(what)

    writes = fake_backend_writes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with D.fake_job(W):
        spec, plan, shard, seeds = D.build_rank(
            "hybrid", workers=W, nodes_per_worker=npw, batch=B,
            features=Fd, make=make)
        params = init_gnn_params(D.model_config(Fd),
                                 torch.Generator().manual_seed(0), "cuda")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, counter, spans = D.run_step(spec, plan, shard, seeds, params,
                                          workers=W, features=Fd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        value = float(loss)
    peak = torch.cuda.max_memory_allocated() - base
    del shard, seeds, plan, params, loss
    torch.cuda.empty_cache()
    record = D.collective_record(spans, W)
    failures = []
    if (counter.rounds, counter.bytes_per_round) != (
            fake["rounds_traced"], fake["bytes_per_round"]):
        failures.append(f"rounds {counter.kinds} {counter.bytes_per_round}"
                        f" vs the fake record's {fake['bytes_per_round']}")
    for key, want in record.items():
        if fake[key] != want:
            failures.append(f"{key} {want} vs the fake record's "
                            f"{fake[key]}")
    missing = [k for k in CONCRETE_KERNELS if counts[k] == 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    if all(writes.values()) and not math.isfinite(value):
        failures.append(f"loss {value}")
    if failures:
        raise AssertionError("concrete rank: " + "; ".join(failures))
    est = fake["peak_estimate_bytes"]
    log(f"  concrete rank 0 of {W} (hybrid, {npw} nodes a worker, {B} "
        f"seeds, seeded data on the card): {counter.rounds} rounds, bytes "
        f"{counter.bytes_per_round} and every collective == the fake "
        f"record; loss {value!r} (the fake backend writes the receive "
        f"buffers: {writes}); step {wall * 1e3:.1f} ms; "
        f"max_memory_allocated {peak} B against the estimate {est} B "
        f"({peak / est - 1:+.2%}); launches {counts}")
    return counts, {"rounds": counter.rounds,
                    "bytes_per_round": counter.bytes_per_round,
                    "loss": value, "fake_backend_writes": writes,
                    "step_ms": wall * 1e3, "peak_bytes": peak,
                    "peak_estimate_bytes": est,
                    "collective_bytes_per_device":
                        record["collective_bytes_per_device"]}


def dryrun_phase() -> tuple[dict, dict]:
    """Phase 15: the fake-tensor dry-run at ``repro``'s defaults for 256
    and 512 workers, both schemes; one concrete rank on the card; the
    e2e example for ``E2E_STEPS`` steps.  Returns ({path: launch
    counts}, numbers for PERF.md)."""
    import torch
    import repro_torch.kernels as K
    from repro_torch.launch import dryrun_gnn as D

    numbers = {"fake": {}}
    for W in (256, 512):
        for scheme, rounds in (("vanilla", 6), ("hybrid", 2)):
            t0 = time.perf_counter()
            rec = D.dryrun(scheme, workers=W)
            secs = time.perf_counter() - t0
            sampling = rounds - 2
            if (rec["rounds_traced"], rec["sampling_rounds_traced"],
                    rec["expected_rounds"],
                    rec["collective_counts"]["all-to-all"]) != (
                        rounds, sampling, rounds, rounds):
                raise AssertionError(f"dry-run {scheme} at {W}: {rec}")
            gb = rec["collective_bytes_per_device"] / 1e9
            log(f"  fake dry-run {scheme}, {W} workers, repro's defaults: "
                f"{rec['rounds_traced']} rounds ({sampling} sampling), "
                f"bytes a round {rec['bytes_per_round']}, {gb:.3f} GB of "
                f"collectives a device (all-gather "
                f"{rec['collective_bytes_by_kind']['all-gather']} B), peak "
                f"estimate {rec['peak_estimate_bytes'] / 1e9:.3f} GB; "
                f"{secs:.1f} s")
            numbers["fake"][f"{scheme}@{W}"] = dict(rec, seconds=secs)
    fake = D.dryrun("hybrid", **CONCRETE)
    counts = {}
    counts["dry-run concrete rank"], numbers["concrete"] = \
        concrete_rank(fake)

    log(f"-- examples/train_gnn_e2e_torch.py, {E2E_STEPS} steps (launch "
        f"counts set to 0 first)")
    e2e = load_example("train_gnn_e2e_torch")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = e2e.main(["--steps", str(E2E_STEPS), "--device", "cuda",
                    "--ckpt", os.path.join(HERE, "build",
                                           "gnn_e2e_torch.npz")])
    wall = time.perf_counter() - t0
    counts["e2e example"] = K.launch_counts()
    missing = [k for k in TRAIN_PATH_KERNELS
               if counts["e2e example"][k] == 0]
    if missing:
        raise AssertionError(f"e2e example: kernels never launched: "
                             f"{missing}")
    log(f"  e2e: {out['params']} parameters, loss {out['first']:.4f} -> "
        f"{out['last']:.4f}, {out['s_per_step'] * 1e3:.1f} ms a step, "
        f"{wall:.1f} s with set-up; launches {counts['e2e example']}")
    numbers["e2e"] = dict(out, wall_s=wall)
    torch.cuda.empty_cache()
    return counts, numbers


# --------------------------------------------------------------------------
# phase 16: the LM scaffold
# --------------------------------------------------------------------------

# bf16 logits of decode against the full forward through the same weights:
# ||a - b|| / ||b|| over every compared position.  The SSM families'
# forward rounds its conv output to bf16 where decode keeps it in float32
# (repro's design), so they get more room: at the reduced widths in bf16 at
# full depth, the CPU gives 0.031 (mamba2, 24 layers) and 0.036 (zamba2,
# 38 layers) for the two paths (the attention families 0)
LM_REL_TOL = 0.05
LM_SSM_REL_TOL = 0.1
# the reduced configs in float32, the card against the CPU (the path the
# CPU tests hold to repro), as those tests' logit tolerance
LM_REDUCED_TOL = dict(rtol=1e-4, atol=2e-4)
LM_SERVE = {"batch": 4, "prompt": 32, "gen": 16}
LM_TRAIN = {"batch": 8, "seq": 128, "steps": 3, "lr": 1e-3}
# greedy tokens decoded after the prompt, card against CPU; the prompt
# passes the 64-slot window of the reduced SWA configs
LM_GREEDY = 8
LM_RING_PROMPT = 64


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def timed(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fresh_peak() -> int:
    """Reset the peak-memory counter; returns the bytes allocated now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gb(base: int = 0) -> float:
    import torch
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def lm_decode_logits(params, cfg, toks, enc_out=None):
    """Logits of every prompt position through decode steps, the caches
    filled as ``serve_lm.prefill_cache`` fills them (its context)."""
    import torch
    from repro_torch.models import lm
    B, S = toks.shape
    state = lm.init_decode_state(cfg, B, max(2 * S, 64), enc_out=enc_out,
                                 params=params)
    outs = []
    for t in range(S):
        lg, state = lm.decode_step(params, state,
                                   {"tokens": toks[:, t:t + 1]}, cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1), state


def lm_greedy(params, cfg, prompts, gen: int, enc_out=None):
    """Greedy tokens after ``prompts``: the prompt through decode steps,
    then ``gen`` tokens, each the argmax of the last."""
    import torch
    from repro_torch.models import lm
    logits, state = lm_decode_logits(params, cfg, prompts, enc_out)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    for _ in range(gen - 1):
        lg, state = lm.decode_step(params, state, {"tokens": tok}, cfg)
        tok = lg[:, -1].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, 1).cpu()


def lm_profile(fn) -> dict:
    """One call of ``fn`` under the profiler: its wall ms, device busy ms,
    device ops, idle share, and the kernels with the most device time."""
    import torch
    torch.cuda.synchronize()
    with kernel_trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, _ = device_streams(prof)
    by_name, ops = {}, 0
    for e in device_records(prof):
        name = _short(e.name())
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e6
        ops += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "busy_ms": busy, "ops": ops,
            "idle_share": 1 - busy / wall,
            "top_kernels_ms": {k: round(v, 3) for k, v in top}}


def lm_main_path(card: str) -> dict:
    """stablelm-1.6b at full width and depth in bf16: ``prefill_cache``
    over the prompts, its last logits against ``forward(last_only=True)``,
    greedy decode; ``make_lm_train_step`` steps (AdamW), then one step
    with ``remat=True`` whose loss equals the first ``remat=False``
    step's."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.launch.serve_lm import prefill_cache
    from repro_torch.models import lm
    from repro_torch.optim import init_opt_state, tree_leaves
    from repro_torch.train.loop import make_lm_train_step

    cfg = get_config("stablelm-1.6b")
    base = fresh_peak()
    params = lm.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    weights_gb = sum(x.numel() * x.element_size()
                     for x in tree_leaves(params)) / 1e9
    src = MarkovTokenSource(cfg.vocab_size, seed=0)
    B, S, G = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["gen"]
    prompts = torch.from_numpy(src.batch(B, S - 1)).cuda()
    prefill_cache(params, prompts[:, :2], cfg)            # warm-up
    (state, logits), prefill_s = timed(
        lambda: prefill_cache(params, prompts, cfg))
    with torch.no_grad():
        last, _ = lm.forward(params, {"tokens": prompts}, cfg, remat=False,
                             last_only=True)
    err = rel_l2(logits[:, -1], last[:, 0])
    max_abs = float((logits[:, -1] - last[:, 0]).abs().max())
    if not (torch.isfinite(logits).all() and err <= LM_REL_TOL):
        raise AssertionError(f"stablelm prefill: last logits differ from "
                             f"forward(last_only=True) by rel-L2 {err}")

    def decode():
        nonlocal state
        tok = logits[:, -1].argmax(-1)[:, None]
        out = []
        for _ in range(G):
            lg, state = lm.decode_step(params, state, {"tokens": tok}, cfg)
            tok = lg[:, -1].argmax(-1)[:, None]
            out.append(tok)
        return torch.cat(out, 1)

    toks, decode_s = timed(decode)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("stablelm decode: tokens out of range")
    serve_peak = peak_gb(base)
    decode_prof = lm_profile(lambda: lm.decode_step(
        params, state, {"tokens": toks[:, -1:]}, cfg))
    log(f"  stablelm-1.6b ({n_params:,} parameters, {weights_gb:.2f} GB of "
        f"bf16 weights; param_count() {cfg.param_count():,}): prefill "
        f"{B}x{S} {prefill_s:.3f} s; last logits vs forward(last_only) "
        f"rel-L2 {err:.4g} (tol {LM_REL_TOL}), max abs {max_abs:.4g}; "
        f"decode {G} x {B} greedy tokens in {decode_s:.3f} s "
        f"({G * B / decode_s:.1f} tok/s); peak {serve_peak:.2f} GB on "
        f"{card}; one profiled decode step: {decode_prof}")
    del state, logits, last

    Bt, St = LM_TRAIN["batch"], LM_TRAIN["seq"]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                src.train_batch(Bt, St, seed=s).items()}
               for s in range(LM_TRAIN["steps"])]
    base = fresh_peak()
    step = make_lm_train_step(cfg, lr=LM_TRAIN["lr"], remat=False)
    p, opt = params, init_opt_state(params)
    losses, step_ms = [], []
    for b in batches:
        (p, opt, m), secs = timed(lambda: step(p, opt, b))
        losses.append(float(m["loss"]))
        step_ms.append(secs * 1e3)
    train_peak = peak_gb(base)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stablelm training: losses {losses}")
    train_prof = lm_profile(lambda: step(p, opt, batches[0]))
    del p, opt, m
    remat = make_lm_train_step(cfg, lr=LM_TRAIN["lr"], remat=True)
    # the first checkpointed step sets up torch.utils.checkpoint (seconds
    # of host work): a one-sequence warm-up, timed apart
    _, remat_warm_s = timed(lambda: remat(params, init_opt_state(params), {
        k: v[:1] for k, v in batches[0].items()}))
    base = fresh_peak()
    (_, _, m), remat_s = timed(
        lambda: remat(params, init_opt_state(params), batches[0]))
    remat_peak = peak_gb(base)
    remat_loss = float(m["loss"])
    if remat_loss != losses[0]:
        raise AssertionError(f"stablelm: the remat step's loss {remat_loss!r}"
                             f" != the first step's {losses[0]!r}")
    log(f"  stablelm-1.6b training, batch {Bt} x seq {St}, AdamW lr "
        f"{LM_TRAIN['lr']}, f32 moments: losses {losses}, step ms "
        f"{[round(x, 3) for x in step_ms]}, peak {train_peak:.2f} GB; "
        f"remat=True step: loss == the first step's bit for bit, "
        f"{remat_s * 1e3:.3f} ms (after a one-sequence warm-up of "
        f"{remat_warm_s:.3f} s), peak {remat_peak:.2f} GB; one profiled "
        f"step: {train_prof}")
    del params, m, batches
    return {"params": n_params, "weights_gb": weights_gb,
            "param_count": cfg.param_count(), "prefill_s": prefill_s,
            "prefill_last_rel_l2": err, "prefill_last_max_abs": max_abs,
            "decode_s": decode_s, "decode_tok_per_s": G * B / decode_s,
            "serve_peak_gb": serve_peak, "train_losses": losses,
            "train_step_ms": step_ms, "train_peak_gb": train_peak,
            "remat_step_ms": remat_s * 1e3, "remat_warmup_s": remat_warm_s,
            "remat_peak_gb": remat_peak, "decode_profile": decode_prof,
            "train_profile": train_prof}


def lm_family(name: str, cfg, B: int, S: int, card: str, *,
              vision: bool = False) -> dict:
    """One family at full width in bf16: a forward, and the logits of
    every prompt position through decode steps against it.  ``vision``:
    qwen2-vl also runs a forward with its patch prefix and an M-RoPE
    grid (finite, and unlike the text-only forward's logits)."""
    import torch
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    base = fresh_peak()
    gen = torch.Generator("cuda").manual_seed(0)
    params = lm.init_model(cfg, gen)
    weights_gb = sum(x.numel() * x.element_size()
                     for x in tree_leaves(params)) / 1e9
    toks = torch.from_numpy(MarkovTokenSource(cfg.vocab_size, seed=0).batch(
        B, S - 1)).cuda()
    batch = {"tokens": toks}
    enc_out = None
    extra = ""
    if cfg.family == "vlm":
        # text only: no patches, t = h = w = the position (decode's rope)
        batch["vision_embeds"] = torch.zeros((B, 0, cfg.d_model),
                                             device="cuda")
        batch["positions"] = torch.arange(S, device="cuda").expand(3, B, S)
    if cfg.is_encdec:
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device="cuda")
    with torch.no_grad():
        (full, _), fwd_s = timed(lambda: lm.forward(params, batch, cfg,
                                                    remat=False))
        if cfg.is_encdec:
            enc_out = lm._encode(params, batch["frames"], cfg)
    (dec, state), dec_s = timed(
        lambda: lm_decode_logits(params, cfg, toks, enc_out))
    err = rel_l2(dec, full)
    last = rel_l2(dec[:, -1], full[:, -1])
    tol = LM_SSM_REL_TOL if cfg.family in ("ssm", "hybrid") else LM_REL_TOL
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()
            and err <= tol):
        raise AssertionError(f"{name}: decode logits differ from the "
                             f"forward's by rel-L2 {err} (tol {tol})")
    if cfg.family == "hybrid":
        apps = lm.num_shared_apps(cfg)
        if state.shared_kv.k.shape[0] != apps:
            raise AssertionError(f"{name}: {state.shared_kv.k.shape[0]} "
                                 f"shared caches, expected {apps}")
        extra = f"; {apps} shared-block applications, a KV cache each"
    if cfg.is_encdec:
        extra = (f"; cross K/V precomputed from {cfg.encoder_seq} encoder "
                 f"frames, {tuple(state.cross_kv[0].shape)}")
    if vision:
        n_patch = S // 4
        grid = torch.arange(S, device="cuda") - n_patch + 2
        pos = torch.stack([grid, grid, grid]).clamp(min=0)
        i = torch.arange(n_patch, device="cuda")
        pos[0, :n_patch] = 0                      # one frame of 2 x 4 patches
        pos[1, :n_patch] = i // 4
        pos[2, :n_patch] = i % 4
        vis = dict(batch, positions=pos[:, None].expand(3, B, S),
                   vision_embeds=torch.randn((B, n_patch, cfg.d_model),
                                             generator=gen, device="cuda"))
        with torch.no_grad():
            vl, _ = lm.forward(params, vis, cfg, remat=False)
        moved = rel_l2(vl, full)
        if not (torch.isfinite(vl).all() and moved > 0.0):
            raise AssertionError(f"{name}: patch-prefix forward: finite "
                                 f"{bool(torch.isfinite(vl).all())}, moved "
                                 f"{moved}")
        extra = (f"; with {n_patch} patch embeddings and an M-RoPE grid: "
                 f"finite, rel-L2 {moved:.3g} from the text-only logits")
    peak = peak_gb(base)
    log(f"  {name} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{weights_gb:.2f} GB of bf16 weights): forward {B}x{S} "
        f"{fwd_s:.3f} s, {S} decode steps {dec_s:.3f} s; decode vs forward "
        f"rel-L2 {err:.4g} (last position {last:.4g}, tol {tol}){extra}; "
        f"peak {peak:.2f} GB on {card}")
    del params, full, dec, state
    return {"layers": cfg.num_layers, "weights_gb": weights_gb,
            "batch": B, "seq": S, "forward_s": fwd_s, "decode_s": dec_s,
            "rel_l2": err, "last_rel_l2": last, "peak_gb": peak}


def lm_moe_drops(cfg, card: str) -> dict:
    """mixtral-8x22b, two layers at full width in bf16: the forward at its
    own capacity (finite); decode against the forward with no drops
    (``capacity_factor`` 8, as repro's own test); layer 0's MoE on 8
    identical tokens, which all pick the same two experts of 3 slots each
    (``moe_capacity`` at 8 tokens), so tokens 3-7 are dropped from both
    (their output exactly 0, the others' not); the dispatch of 2048 x 2
    skewed assignments on the card == on the CPU, with drops."""
    import dataclasses
    import torch
    from repro_torch.models import lm, moe

    out = lm_family("mixtral-8x22b (2 layers, capacity_factor 8: no drops)",
                    dataclasses.replace(cfg, capacity_factor=8.0), 2, 32,
                    card)
    gen = torch.Generator("cuda").manual_seed(1)
    params = lm.init_model(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device="cuda")
    with torch.no_grad():
        logits, aux = lm.forward(params, {"tokens": toks}, cfg, remat=False)
        if not torch.isfinite(logits).all():
            raise AssertionError("mixtral forward: logits not finite")
        blk = lm.layers(params["blocks"], cfg.num_layers)[0]["moe"]
        x = torch.randn((1, 1, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16).expand(1, 8, -1)
        y, _ = moe.apply_moe(blk, x.contiguous(), cfg)
    C = moe.moe_capacity(cfg, 8)
    y = y[0].float()
    if not (C < 8 and bool((y[C:] == 0).all())
            and bool((y[:C].abs().amax(-1) > 0).all())):
        raise AssertionError(f"mixtral drops: capacity {C}, row max "
                             f"{y.abs().amax(-1).tolist()}")
    # skewed assignments (expert e drawn with weight (e + 1)^2), so the
    # most loaded experts overflow their capacity
    weight = (torch.arange(cfg.num_experts, device="cuda") + 1.0) ** 2
    top_e = torch.multinomial(weight, 2048 * cfg.top_k, replacement=True,
                              generator=gen).view(2048, cfg.top_k)
    C2 = moe.moe_capacity(cfg, 2048)
    on_card = moe.dispatch(top_e, cfg.num_experts, C2)
    on_cpu = moe.dispatch(top_e.cpu(), cfg.num_experts, C2)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        raise AssertionError("mixtral: the card's dispatch differs from the "
                             "CPU's")
    dropped = int((~on_card[3]).sum())
    if not dropped:
        raise AssertionError("mixtral: the skewed dispatch dropped nothing")
    log(f"  mixtral-8x22b at its own capacity: forward 2x64 finite, aux "
        f"{float(aux):.4f}; 8 identical tokens through layer 0's MoE "
        f"(capacity {C}): tokens {C}-7 dropped (output 0), 0-{C - 1} kept; "
        f"the dispatch of 2048 x {cfg.top_k} skewed assignments (capacity "
        f"{C2}, {dropped} dropped) == the CPU's")
    del params, logits
    return dict(out, forward_aux=float(aux), capacity_8_tokens=C,
                random_dispatch_dropped=dropped)


def lm_reduced_batch(cfg, S: int) -> dict:
    """The CPU tests' batch of a reduced config (seeded numpy)."""
    import numpy as np
    import torch
    r = np.random.default_rng(0)
    B = 2
    b = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = r.normal(0, 1, (B, S // 4, cfg.d_model)
                                      ).astype(np.float32)
        grid = r.integers(0, S, (3, B, S)).astype(np.int32)
        grid[0] = np.arange(S)
        b["positions"] = grid
    if cfg.is_encdec:
        b["frames"] = r.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def lm_reduced_parity() -> dict:
    """The ten reduced configs in float32 (TF32 off), on the card against
    the CPU from the same seeded weights: the forward's logits within
    ``LM_REDUCED_TOL``, and ``LM_GREEDY`` greedy tokens equal after a
    prompt of ``LM_RING_PROMPT`` tokens (past the SWA configs' 64-slot
    window) or 16."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.models import lm
    from repro_torch.optim import tree_map

    out = {}
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        p_cpu = lm.init_model(cfg, torch.Generator().manual_seed(0))
        p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
        S = 128 if cfg.family in ("ssm", "hybrid") else 32
        b_cpu = lm_reduced_batch(cfg, S)
        b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
        with torch.no_grad():
            want, _ = lm.forward(p_cpu, b_cpu, cfg, remat=False)
            got, _ = lm.forward(p_gpu, b_gpu, cfg, remat=False)
            enc = ((lm._encode(p_cpu, b_cpu["frames"], cfg),
                    lm._encode(p_gpu, b_gpu["frames"], cfg))
                   if cfg.is_encdec else (None, None))
        err = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, **LM_REDUCED_TOL):
            raise AssertionError(f"{arch} reduced: card vs CPU logits max "
                                 f"abs err {err}")
        P = LM_RING_PROMPT if cfg.window else 16
        prompts = torch.from_numpy(MarkovTokenSource(
            cfg.vocab_size, seed=1).batch(2, P - 1))
        t_cpu = lm_greedy(p_cpu, cfg, prompts, LM_GREEDY, enc[0])
        t_gpu = lm_greedy(p_gpu, cfg, prompts.cuda(), LM_GREEDY, enc[1])
        if not torch.equal(t_cpu, t_gpu):
            raise AssertionError(f"{arch} reduced: greedy tokens differ: "
                                 f"card {t_gpu.tolist()} cpu "
                                 f"{t_cpu.tolist()}")
        out[arch] = {"max_abs_err": err, "prompt": P,
                     "tokens": t_gpu[0].tolist()}
        log(f"  {cfg.name}: logits card vs CPU max abs err {err:.3g} (tol "
            f"{LM_REDUCED_TOL}); {LM_GREEDY} greedy tokens after a "
            f"{P}-token prompt equal: {t_gpu[0].tolist()}")
    return out


def lm_launchers() -> dict:
    """``train`` (5 steps), ``serve_lm`` and ``examples/serve_lm_torch.py``
    at ``--reduced``, in-process through their ``main``, on the default
    device."""
    import math
    from repro_torch.launch import serve_lm, train
    tr = train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                     "5", "--log-every", "4"])
    if len(tr["losses"]) != 5 or not all(map(math.isfinite, tr["losses"])):
        raise AssertionError(f"train launcher: losses {tr['losses']}")
    sv = serve_lm.main(["--arch", "stablelm-1.6b", "--reduced"])
    if not sv["finite"] or sv["tokens"].shape != (4, 17):
        raise AssertionError(f"serve_lm launcher: {sv}")
    ex = load_example("serve_lm_torch").main([])
    log(f"  train --reduced: losses {tr['losses']}; serve_lm --reduced: "
        f"{sv['tok_per_s']:.1f} tok/s; examples/serve_lm_torch.py: "
        f"{list(ex)} served")
    return {"train_losses": tr["losses"], "serve_tok_per_s":
            sv["tok_per_s"]}


def lm_phase(card: str) -> dict:
    """Phase 16: the LM scaffold (no hand-written kernel on its path)."""
    import dataclasses
    import repro_torch.kernels as K
    from repro_torch.configs import get_config

    K.reset_launch_counts()
    out = {"card": card}
    log("-- stablelm-1.6b: serving and training at full width and depth")
    out["stablelm"] = lm_main_path(card)
    log("-- the other families at full width (bf16): decode vs forward")
    for name, B, S in (("mamba2-130m", 1, 256), ("zamba2-1.2b", 1, 128),
                       ("whisper-small", 2, 32), ("qwen2-vl-7b", 2, 32)):
        out[name] = lm_family(name, get_config(name), B, S, card,
                              vision=name == "qwen2-vl-7b")
    out["mixtral-8x22b"] = lm_moe_drops(
        dataclasses.replace(get_config("mixtral-8x22b"), num_layers=2), card)
    log("-- the ten reduced configs, card vs CPU (float32)")
    out["reduced"] = lm_reduced_parity()
    log("-- the LM launchers and the example at --reduced")
    out["launchers"] = lm_launchers()
    launched = {k: v for k, v in K.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"the LM path launched hand-written kernels: "
                             f"{launched}")
    return out


# --------------------------------------------------------------------------
# phase 17: the LM scaffold, part 2
# --------------------------------------------------------------------------

LM_DRYRUN_OUT = os.path.join(HERE, "build", "dryrun_torch")
# (arch, shape, mesh, the status it must end with), each with its probes
LM_DRYRUN_COMBOS = (("qwen2-7b", "train_4k", "pod", "ok"),
                    ("mixtral-8x22b", "decode_32k", "multipod", "ok"),
                    ("mamba2-130m", "long_500k", "pod", "ok"),
                    ("qwen2-7b", "long_500k", "pod", "skipped"))
# the concrete rank's combo (its fake record is traced without probes)
LM_CONCRETE = ("qwen2-7b", "decode_32k", "pod")
LM_PEAK_TOL = 0.10               # concrete peak vs the estimate, relative
# --devices 2 against --devices 1: tests/test_torch_lm_launch.py's bound
LM_RANKS_TOL = dict(rtol=1e-5, atol=1e-5)
LM_RANKS_ARGV = ("--arch", "mixtral-8x22b", "--reduced", "--steps", "3",
                 "--log-every", "1")
LM_DRYRUN_WAIT_S = 600


def lm_dryrun_worker(out_dir: str) -> int:
    """``--lm-dryrun OUT``: phase 17's dry-run records (``run_combo``,
    one JSON file a combo under ``out_dir``), on one CPU thread."""
    import torch
    from repro_torch.launch.dryrun import run_combo

    torch.set_num_threads(1)
    for arch, shape, mesh, _ in LM_DRYRUN_COMBOS:
        run_combo(arch, shape, mesh, out_dir=out_dir)
    run_combo(*LM_CONCRETE, skip_probes=True, out_dir=out_dir)
    return 0


def start_lm_dryrun():
    """Start phase 17's dry-run in a process of its own (fake tensors:
    host work only), stopped at exit if the script ends first."""
    import atexit
    import shutil
    shutil.rmtree(LM_DRYRUN_OUT, ignore_errors=True)
    os.makedirs(LM_DRYRUN_OUT)
    log_file = open(os.path.join(LM_DRYRUN_OUT, "worker.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lm-dryrun",
         LM_DRYRUN_OUT], stdout=log_file, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    log_file.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def lm_dryrun_records(proc) -> dict:
    """Wait for the dry-run process; its records by (arch, shape, mesh)."""
    t0 = time.perf_counter()
    code = proc.wait(timeout=LM_DRYRUN_WAIT_S)
    waited = time.perf_counter() - t0
    if code:
        with open(os.path.join(LM_DRYRUN_OUT, "worker.log")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"phase 17: the dry-run process exited "
                             f"{code}:\n{tail}")
    recs = {}
    for arch, shape, mesh in [c[:3] for c in LM_DRYRUN_COMBOS] \
            + [LM_CONCRETE]:
        with open(os.path.join(LM_DRYRUN_OUT,
                               f"{arch}__{shape}__{mesh}.json")) as f:
            recs[(arch, shape, mesh)] = json.load(f)
    log(f"  waited {waited:.1f} s for the dry-run process")
    return recs


def check_lm_dryrun(recs: dict) -> dict:
    """Phase 17 (a)'s gates; returns the records' numbers."""
    import math
    out, failures = {}, []
    for arch, shape, mesh, want in LM_DRYRUN_COMBOS:
        rec = recs[(arch, shape, mesh)]
        key = f"{arch}/{shape}/{mesh}"
        if rec["status"] != want:
            failures.append(f"{key}: {rec['status']} "
                            f"({rec.get('error', rec.get('reason'))})")
            continue
        if want == "skipped":
            log(f"  {key}: skipped ({rec['reason']})")
            out[key] = {"status": "skipped"}
            continue
        roof = rec["roofline"]
        terms = [roof[k] for k in ("flops_per_device",
                                   "hbm_bytes_per_device",
                                   "collective_bytes_per_device",
                                   "t_compute_s", "t_memory_s",
                                   "t_collective_s")]
        if not all(math.isfinite(t) for t in terms) or roof["dominant"] \
                not in ("compute", "memory", "collective"):
            failures.append(f"{key}: roofline {roof}")
        mem = rec["memory"]
        log(f"  {key} ({rec['chips']} ranks, fake tensors): trace "
            f"{rec['compile_s']} s, total {rec['total_s']} s; peak "
            f"estimate {mem['peak_estimate_bytes'] / 1e9:.3f} GB a device "
            f"(arguments {mem['argument_bytes'] / 1e9:.3f} GB); "
            f"collectives {rec['collective_schedule_counts']}; counts "
            f"over the H100 data sheet: compute {roof['t_compute_s']:.4g}"
            f" s, memory {roof['t_memory_s']:.4g} s, collective "
            f"{roof['t_collective_s']:.4g} s, dominant {roof['dominant']},"
            f" useful FLOP ratio {roof['useful_flops_ratio']:.3f}")
        out[key] = {"status": "ok", "memory": mem,
                    "collective_schedule_counts":
                        rec["collective_schedule_counts"],
                    "roofline": roof, "trace_s": rec["compile_s"],
                    "total_s": rec["total_s"]}
    if failures:
        raise AssertionError("phase 17 (a): " + "; ".join(failures))
    return out


def lm_concrete_rank(fake: dict) -> dict:
    """Phase 17 (b): rank 0 of a 256-rank fake-backend job on the card,
    seeded bf16 shards of ``LM_CONCRETE``'s combo, one serve step under a
    ``CostCounter``.  Gates: every shard's shape and placements as the
    specs give them, the collectives by kind equal to ``fake``'s (the
    fake-tensor record of the same combo), the peak within
    ``LM_PEAK_TOL`` of its estimate.  (The fake backend moves no data, so
    no value is gated.)"""
    import torch
    from repro_torch import roofline
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.dryrun_gnn import fake_job
    from repro_torch.sharding import (local_shape, placements,
                                      tree_map_with_path)

    arch, shape_name, mesh_name = LM_CONCRETE
    cfg, shape = get_config(arch), get_shape(shape_name)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(s, dtype):
        if dtype.is_floating_point:
            return torch.randn(s, generator=gen, dtype=dtype, device="cuda")
        return torch.zeros(s, dtype=dtype, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bad, n_shards = [], 0
    with fake_job(256):
        mesh = D.mesh_for(mesh_name, "cuda")
        inputs = D.rank_inputs(cfg, shape, mesh, make)
        for name, (_, specs) in D.rank_specs(cfg, shape, mesh).items():
            def check(path, t, spec, name=name):
                nonlocal n_shards
                n_shards += 1
                if tuple(t.to_local().shape) != local_shape(
                        t.shape, spec, mesh) or tuple(t.placements) != \
                        placements(spec, mesh) or not t.to_local().is_cuda:
                    bad.append(f"{name}/{path}")
            tree_map_with_path(check, inputs[name], specs)
        counter = roofline.CostCounter()
        t0 = time.perf_counter()
        with counter:
            tokens, state = D.run_step(cfg, shape, inputs, remat=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        next_shape = tuple(tokens.shape)
        del tokens, state, inputs
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    est = fake["memory"]["peak_estimate_bytes"]
    failures = []
    if bad:
        failures.append(f"shards off their specs: {bad[:5]}")
    if counter.coll_counts != fake["collective_schedule_counts"]:
        failures.append(f"collectives {counter.coll_counts} vs the fake "
                        f"record's {fake['collective_schedule_counts']}")
    if abs(peak / est - 1) > LM_PEAK_TOL:
        failures.append(f"peak {peak} B vs the estimate {est} B")
    if next_shape != (shape.global_batch,):
        failures.append(f"next tokens {next_shape}")
    if failures:
        raise AssertionError("phase 17 (b): " + "; ".join(failures))
    log(f"  concrete rank 0 of 256 ({arch} {shape_name} on {mesh_name}, "
        f"seeded bf16 shards on the card): {n_shards} shards as the specs "
        f"give them; collectives {counter.coll_counts} == the fake "
        f"record; step {wall * 1e3:.1f} ms; max_memory_allocated {peak} B "
        f"against the estimate {est} B ({peak / est - 1:+.2%})")
    return {"shards": n_shards, "collective_counts": counter.coll_counts,
            "collective_bytes": counter.coll_bytes, "step_ms": wall * 1e3,
            "peak_bytes": peak, "peak_estimate_bytes": est}


def lm_part2_phase(proc) -> dict:
    """Phase 17: (c)'s two ranks start first and train while (b) runs;
    (a)'s records come from the process started with the script."""
    import threading

    import numpy as np
    import repro_torch.kernels as K
    from repro_torch.launch import train

    K.reset_launch_counts()
    ranks: dict = {}

    def two_ranks():
        try:
            ranks["out"] = train.main(list(LM_RANKS_ARGV)
                                      + ["--devices", "2"])
        except BaseException as e:   # noqa: BLE001 — re-raised below
            ranks["error"] = e
    thread = threading.Thread(target=two_ranks)
    t_ranks = time.perf_counter()
    thread.start()
    out = {}
    try:
        log("-- (a) the LM dry-run on this card's torch (fake tensors)")
        recs = lm_dryrun_records(proc)
        out["dryrun"] = check_lm_dryrun(recs)
        log("-- (b) one concrete rank of the 256-rank job on the card")
        out["concrete"] = lm_concrete_rank(recs[LM_CONCRETE])
    finally:
        thread.join()
    ranks_s = time.perf_counter() - t_ranks
    if "error" in ranks:
        raise AssertionError(f"phase 17 (c): train --devices 2: "
                             f"{ranks['error']!r}")
    log("-- (c) train --devices 2 against --devices 1")
    one = train.main(list(LM_RANKS_ARGV))
    two = ranks["out"]["losses"]
    if not (np.isfinite(two).all() and np.isfinite(one["losses"]).all()
            and np.allclose(two, one["losses"], **LM_RANKS_TOL)):
        raise AssertionError(f"phase 17 (c): --devices 2 losses {two} vs "
                             f"--devices 1 {one['losses']}")
    log(f"  --devices 2 losses {two} == --devices 1 {one['losses']} within "
        f"{LM_RANKS_TOL} (2 ranks: {ranks_s:.1f} s with their start)")
    out["ranks"] = {"devices_2": two, "devices_1": one["losses"],
                    "ranks_s": ranks_s}
    launched = {k: v for k, v in K.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 17 launched hand-written kernels: "
                             f"{launched}")
    return out


# --------------------------------------------------------------------------
# phase 18: repro's seed API (the deprecated step shims) at phase 8's width
# --------------------------------------------------------------------------

SEED_API_STEPS = 2
SEED_API_CACHE_K = CACHE_K       # degree-cache rows a worker, as phase 8's


def same_step(a, b) -> bool:
    """Two (loss, grads) results equal bit for bit."""
    import torch
    from repro_torch.optim import tree_leaves
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                          tree_leaves(b[1])))


def check_seed_ops(layout, batch, salt: int, cfg) -> dict:
    """Phase 18 (d): the MFG-level ``kernels.ops`` wrappers on one step's
    shapes against their plain versions: ``fused_sample`` per level and
    ``feature_gather`` exactly, ``sage_aggregate`` per MFG equal to the
    f-ordered loop bit for bit and within SAGE_TOL of the plain version."""
    import torch
    from repro_torch.core.dist import (exchange, owner_local_ids, owner_of,
                                       pack_by_owner)
    from repro_torch.core.sampler import level_salt
    from repro_torch.kernels import ops
    from repro_torch.kernels.feature_gather import feature_gather_plain
    from repro_torch.kernels.fused_sample import fused_sample_plain
    from repro_torch.kernels.sage_aggregate import sage_aggregate_plain

    graph = layout.graph
    for depth, (m, fanout) in enumerate(zip(batch.mfgs, cfg.fanouts)):
        salt_d = level_salt(salt, depth)
        got = ops.fused_sample(graph, m.dst_nodes, fanout, salt_d)
        want = fused_sample_plain(graph.indptr, graph.indices, m.dst_nodes,
                                  salt_d, fanout=fanout)
        if not all(torch.equal(a, b) for a, b in zip(got, want)) \
                or not torch.equal(got[1], m.indptr):
            raise AssertionError(f"phase 18 (d): ops.fused_sample level "
                                 f"{depth} differs from its plain version "
                                 f"or from the step's MFG")
    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = []
    L = len(batch.mfgs)
    for i, m in enumerate(batch.mfgs):
        h = batch.h_src if i == L - 1 else torch.randn(
            m.src_nodes.shape[0], m.src_nodes.shape[1], cfg.hidden_dim,
            device="cuda", generator=gen)
        got = ops.sage_aggregate(m, h)
        plain = sage_aggregate_plain(m.edges, h)
        err = float((got - plain).abs().max())
        if not torch.equal(got, f_ordered_mean(m.edges, h)) \
                or not torch.allclose(got, plain, rtol=SAGE_TOL,
                                      atol=SAGE_TOL):
            raise AssertionError(f"phase 18 (d): ops.sage_aggregate on MFG "
                                 f"{i} {tuple(m.edges.shape)}: max abs err "
                                 f"{err} against the plain version, or not "
                                 f"the f-ordered loop's bits")
        errs.append(err)
    src = batch.mfgs[-1].src_nodes
    buf, _, _ = pack_by_owner(src, owner_of(layout.offsets, src), NUM_PARTS)
    ids = owner_local_ids(exchange(buf, None), layout.offsets, layout.n_max)
    if not torch.equal(ops.feature_gather(ids, layout.features),
                       feature_gather_plain(ids, layout.features)):
        raise AssertionError("phase 18 (d): ops.feature_gather differs from "
                             "its plain version")
    log(f"  (d) kernels.ops at the step's shapes: fused_sample, 3 levels, "
        f"== fused_sample_plain and the step's row pointers; sage_aggregate "
        f"on MFGs " + ", ".join(str(tuple(m.edges.shape))
                                for m in batch.mfgs)
        + f" == the f-ordered loop bit for bit, max abs err "
        + ", ".join(f"{e:.3g}" for e in errs)
        + f" against the plain version (tol {SAGE_TOL}); feature_gather "
        f"ids {tuple(ids.shape)} == feature_gather_plain")
    return {"sage_aggregate_max_abs_err": errs}


def seed_api_phase(layout, data, cfg, params0) -> tuple[dict, dict]:
    """Phase 18: ``repro``'s seed API on phase 8's layout and initial
    parameters, 1000 seeds a worker.  (a) ``dist.make_worker_step``
    (hybrid, the ``fused_cuda`` level backend) through ``run_stacked`` ==
    the ``Pipeline``'s ``hybrid+fused`` step bit for bit; (b)
    ``build_degree_caches`` + ``make_cached_worker_step`` +
    ``run_stacked_cached`` == (a) bit for bit, hit rate above 0; (c) the
    shim under ``vanilla`` (``plan_from_legacy``, ``build_vanilla``'s
    shards) == the ``Pipeline``'s ``vanilla`` step bit for bit; (d) the
    MFG-level ``kernels.ops``.  Returns ({path: launch counts}, numbers)."""
    import warnings

    import torch
    import repro_torch.kernels as K
    from repro_torch.core import cache as C
    from repro_torch.core import dist
    from repro_torch.core.partition import build_vanilla
    from repro_torch.core.sampler import resolve_backend
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.pipeline import Pipeline, PipelineSpec

    def loss_fn(p, mfgs, h, lab, v):
        return gnn_loss(p, mfgs, h, lab, v, cfg)

    t0 = time.perf_counter()
    pipes = {s: Pipeline.from_layout(layout, PipelineSpec.from_scheme(
        s, num_parts=NUM_PARTS, fanouts=cfg.fanouts, data=data))
        for s in ("hybrid+fused", "vanilla")}
    salts = [TRAIN_SALT + k for k in range(SEED_API_STEPS)]
    seeds = [pipes["hybrid+fused"].seeds(TRAIN_BATCH, s) for s in salts]
    vplan = build_vanilla(layout)
    shards = dist.WorkerShard(features=layout.features, labels=layout.labels)
    vshards = dist.WorkerShard(features=layout.features, labels=layout.labels,
                               local_indptr=vplan.local_indptr,
                               local_indices=vplan.local_indices)
    counters = {k: dist.RoundCounter() for k in ("a", "b", "c")}
    legacy = dict(offsets=layout.offsets, num_parts=NUM_PARTS,
                  fanouts=cfg.fanouts, loss_fn=loss_fn)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        shim = dist.make_worker_step(
            graph_replicated=layout.graph, scheme="hybrid",
            level_fn=resolve_backend("fused_cuda"), counter=counters["a"],
            **legacy)
        vshim = dist.make_worker_step(graph_replicated=None,
                                      scheme="vanilla",
                                      counter=counters["c"], **legacy)
        cache = C.build_degree_caches(layout, SEED_API_CACHE_K)
    warned = [w for w in caught if issubclass(w.category,
                                              DeprecationWarning)]
    if len(warned) != 3:
        raise AssertionError(f"phase 18: {len(warned)} DeprecationWarnings "
                             f"from the three deprecated builders")
    cstep = C.make_cached_worker_step(
        graph_replicated=layout.graph, level_fn=resolve_backend("fused_cuda"),
        counter=counters["b"], **legacy)
    log(f"  set-up: hybrid+fused and vanilla pipelines over phase 3's "
        f"layout, vanilla shards {tuple(vplan.local_indices.shape)}, degree "
        f"caches {tuple(cache.rows.shape)}, 3 DeprecationWarnings: "
        f"{time.perf_counter() - t0:.1f} s")

    def drive(label, fn):
        """The seed API's route for SEED_API_STEPS steps, with every launch
        count set to 0 just before and read just after."""
        torch.cuda.synchronize()
        K.reset_launch_counts()
        outs, walls = [], []
        for k in range(SEED_API_STEPS):
            t1 = time.perf_counter()
            outs.append(fn(seeds[k], salts[k]))
            float(outs[-1][0])                          # synchronizes
            walls.append((time.perf_counter() - t1) * 1e3)
        counts = K.launch_counts()
        log(f"  {label}: losses "
            + ", ".join(f"{float(o[0]):.6f}" for o in outs)
            + ", step walls " + ", ".join(f"{w:.3f}" for w in walls)
            + f" ms; launches {counts}")
        return outs, counts, walls

    def pipeline_steps(scheme):
        step = pipes[scheme].step_fn(loss_fn)
        return [step(params0, seeds[k], salts[k])[:2]
                for k in range(SEED_API_STEPS)]

    paths, numbers = {}, {}
    log("-- (a) dist.make_worker_step(scheme='hybrid', fused_cuda) + "
        "run_stacked against Pipeline(hybrid+fused).step_fn")
    a, paths["seed api hybrid+fused"], walls_a = drive(
        "shim", lambda s, salt: dist.run_stacked(shim, params0, shards, s,
                                                 salt))
    ref = pipeline_steps("hybrid+fused")
    if not all(same_step(x, y) for x, y in zip(a, ref)):
        raise AssertionError("phase 18 (a): the shim's loss or gradients "
                             "differ from the pipeline's hybrid+fused step")
    log(f"  (a) the shim's {SEED_API_STEPS} losses and every gradient leaf "
        f"== the pipeline's bit for bit; {counters['a'].rounds} rounds over "
        f"the steps")

    log(f"-- (b) build_degree_caches({SEED_API_CACHE_K}) + "
        f"make_cached_worker_step + run_stacked_cached against (a)")
    b, paths["seed api cached"], walls_b = drive(
        "cached step", lambda s, salt: C.run_stacked_cached(
            cstep, params0, shards, s, salt, cache))
    if not all(same_step(x, y) for x, y in zip(b, a)):
        raise AssertionError("phase 18 (b): the cached step's loss or "
                             "gradients differ from the shim's")
    hit_rates = [float(x[2]) for x in b]
    if not min(hit_rates) > 0.0:
        raise AssertionError(f"phase 18 (b): hit rates {hit_rates}")
    log(f"  (b) cached == (a) bit for bit (loss and every gradient leaf); "
        f"hit rate " + ", ".join(f"{h:.4f}" for h in hit_rates)
        + f" (mean over the workers, capacity {SEED_API_CACHE_K} a worker)")

    log("-- (c) the shim under vanilla (plan_from_legacy, build_vanilla's "
        "shards) against Pipeline(vanilla).step_fn")
    c, paths["seed api vanilla"], walls_c = drive(
        "vanilla shim", lambda s, salt: dist.run_stacked(
            vshim, params0, vshards, s, salt))
    if not all(same_step(x, y) for x, y in zip(c, pipeline_steps("vanilla"))):
        raise AssertionError("phase 18 (c): the vanilla shim's loss or "
                             "gradients differ from the pipeline's vanilla "
                             "step")
    log(f"  (c) == the pipeline's vanilla step bit for bit; "
        f"{counters['c'].rounds} rounds over the steps")
    rounds = {k: v.rounds / SEED_API_STEPS for k, v in counters.items()}
    if rounds != {"a": 2, "b": 2, "c": 6}:
        raise AssertionError(f"phase 18: rounds a step {rounds}, expected "
                             f"2 / 2 / 6")

    log("-- (e) launches of the seed API's runs")
    for path, counts in paths.items():
        want = [k for k in TRAIN_PATH_KERNELS
                if not (k == "fused_sample" and "vanilla" in path)]
        missing = [k for k in want if counts[k] == 0]
        if missing or counts["gather_rows"] or (
                "vanilla" in path and counts["fused_sample"]):
            raise AssertionError(f"phase 18 {path}: launches {counts}")
    log("  every kernel of each path launched (fused_sample, feature_gather, "
        "sage_aggregate forward, backward and transpose; vanilla draws "
        "windowless, no fused_sample); gather_rows none")

    log("-- (d) the MFG-level kernels.ops against their plain versions")
    with torch.no_grad():
        prep, _ = pipes["hybrid+fused"].make_prepare_consume(
            loss_fn, counted=False)
        batch = prep(pipes["hybrid+fused"].shards, seeds[0], salts[0])
    numbers["ops"] = check_seed_ops(layout, batch, salts[0], cfg)
    numbers.update(losses=[float(x[0]) for x in a], hit_rates=hit_rates,
                   rounds=rounds, step_walls_ms={
                       "shim": walls_a, "cached": walls_b,
                       "vanilla": walls_c})
    return paths, numbers


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    lm_dryrun = start_lm_dryrun()

    import repro_torch.kernels as K
    from repro_torch.configs.graphsage_paper import PRODUCTS, reduced
    from repro_torch.core.cache import resolve_hot_scorer
    from repro_torch.core.dist import exchange, owner_local_ids, owner_of
    from repro_torch.core.dist import pack_by_owner
    from repro_torch.kernels import _build
    from repro_torch.kernels.sage_aggregate import sage_aggregate_plain
    from repro_torch.models.gnn import gnn_forward, init_gnn_params
    from repro_torch.obs.report import render_share_table, stage_shares
    from repro_torch.pipeline import DataSpec, Pipeline, PipelineSpec
    from repro_torch.serve import GNNServer, Predictor, route_by_owner
    from repro_torch.serve.traffic import hotset_arrivals

    t_start = time.perf_counter()
    log("== phase 1: card and software")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log("TF32 off for matmul and cuDNN (full fp32 products); bf16 products "
        "reduce in fp32")

    log("== phase 2: build")
    t = _build.build_all()
    log(f"nvcc built {len(_build.SOURCES)} sources in parallel in {t:.2f} s "
        f"into {os.path.relpath(_build.build_dir(), HERE)}")

    log("== phase 3: main-path set-up")
    t0 = time.perf_counter()
    data = DataSpec(source="powerlaw(1.8)", num_nodes=NUM_NODES,
                    avg_degree=AVG_DEGREE, num_features=PRODUCTS.in_dim,
                    num_classes=PRODUCTS.num_classes, split="random(0.3)",
                    seed=0)
    spec = PipelineSpec.from_scheme("hybrid+fused", num_parts=NUM_PARTS,
                                    fanouts=PRODUCTS.fanouts, data=data)
    pipe = Pipeline.build_from_source(spec=spec)
    ds = pipe.dataset
    t_setup = time.perf_counter() - t0
    log(f"pipeline: {ds.name}, {ds.graph.num_edges} edges, P={NUM_PARTS}, "
        f"backend {spec.sampler.backend}, partitioner "
        f"{spec.plan.partitioner}, n_max {pipe.layout.n_max}, "
        f"max in-degree {int(ds.graph.degrees().max())}; set-up "
        f"{t_setup:.1f} s")
    params = init_gnn_params(PRODUCTS, torch.Generator().manual_seed(0),
                             "cuda")
    pred = Predictor(pipe, params, PRODUCTS, buckets=(1, 8, 32, 128),
                     base_salt=SALT)
    pred.warmup()

    rng = np.random.default_rng(0)
    batch_seeds = rng.choice(NUM_NODES, size=128, replace=False)
    internal = pred._to_internal(batch_seeds)
    routed, pos = route_by_owner(pred.offsets, internal, 128)
    prepare, _ = pipe.make_infer_prepare_consume(lambda *a: None)
    layer_inputs = []

    def recording_aggregate(edges, h):
        layer_inputs.append((edges, h))
        return sage_aggregate_plain(edges, h)

    with torch.inference_mode():
        seeds_dev = torch.from_numpy(routed).cuda()
        batch = prepare(pipe.shards, seeds_dev, SALT)
        plain_logits = gnn_forward(params, list(batch.mfgs), batch.h_src,
                                   PRODUCTS, aggregate=recording_aggregate)
        plain_logits = plain_logits.cpu().numpy()[pos[:, 0], pos[:, 1]]

        log("== phase 4: kernels against their plain versions (device time "
            f"per call over {REPS} profiled calls; call time = median of "
            f"{REPS} event-timed calls)")
        frontiers = [m.dst_nodes for m in batch.mfgs]
        fs = check_fused_sample(pipe.layout.graph, frontiers,
                                PRODUCTS.fanouts, SALT)
        log("  fused_sample, 3 levels, device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in fs["split"].items()))
        sa = check_sage_aggregate(layer_inputs, "serving")
        check_forward_invariance(layer_inputs)
        src = batch.mfgs[-1].src_nodes
        buf, _, _ = pack_by_owner(src, owner_of(pipe.layout.offsets, src),
                                  NUM_PARTS)
        ids = owner_local_ids(exchange(buf, None), pipe.layout.offsets,
                              pipe.layout.n_max)
        fg = check_feature_gather(ids, pipe.shards.features)
        bad_m = matmul_row_probe()
        log(f"  fp32 matmul (256 x 47 weights): x[:M] @ w differs in bits "
            f"from the same rows of one 22528-row product at M = {bad_m}")

    # outside inference mode: the backward's plain version runs autograd
    log("-- edge shapes of the redesigned kernels")
    check_edge_shapes(pipe.layout.graph)
    log("-- the sage hidden layer's tail (sage_epilogue, forward and "
        "backward)")
    epilogue = check_sage_epilogue()
    log("-- gatv1's attention (gat_attention, forward and backward)")
    epilogue.update(check_gat_attention())
    log("-- the e2e example's widths (D = 1024 and 4096)")
    e2e_widths = check_e2e_widths()

    log("== phase 5: small-input parity (cuda vs cpu port)")
    small_parity(reduced())

    log("== phase 6: main path")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits = pred.predict(batch_seeds)
    t_predict = time.perf_counter() - t0
    per_predict = K.launch_counts()
    if logits.shape != (128, PRODUCTS.num_classes) \
            or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite "
                             f"{np.isfinite(logits).all()}")
    err = float(np.abs(logits - plain_logits).max())
    if not np.allclose(logits, plain_logits, rtol=LOGIT_TOL,
                       atol=LOGIT_TOL):
        raise AssertionError(f"logits differ from the plain-version forward "
                             f"by {err}")
    log(f"predict(128 seeds): logits (128, {PRODUCTS.num_classes}) finite, "
        f"max abs err {err:.3g} against the plain forward on the same MFGs "
        f"(tol {LOGIT_TOL}); {t_predict * 1e3:.2f} ms; window overflow "
        f"{int(pred.last_metrics['sampler_window_overflow'])}; launches "
        f"{per_predict}")

    probe = resolve_hot_scorer("degree").top_ids(ds.graph, 8)
    t0 = time.perf_counter()
    for s in probe:
        pred.predict([int(s)])
    t1 = (time.perf_counter() - t0) / probe.size
    rate = 2.0 / t1
    log(f"calibrated: single-request service {t1 * 1e3:.2f} ms -> open-loop "
        f"rate {rate:.0f} req/s")
    arrivals = hotset_arrivals(400, rate, NUM_NODES, graph=ds.graph,
                               hot_k=64, seed=0)
    server = GNNServer(pred, max_delay=2e-3)
    stats, served = server.run(arrivals, warmup=False, collect_outputs=True)
    direct = pred.predict([s for _, s in arrivals])
    if not np.array_equal(served, direct):
        raise AssertionError(
            f"served outputs differ from direct predict in "
            f"{int((served != direct).any(axis=1).sum())} of {len(arrivals)}"
            f" rows")
    s = stats.summary()
    log(f"served {s['num_requests']} hotset requests: p50 "
        f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, QPS "
        f"{s['qps']:.1f}, flushes {s['num_flushes']}, buckets "
        f"{s['bucket_histogram']}; outputs == direct predict bit for bit")
    counts = K.launch_counts()
    log(f"kernel launches on the serving path: {counts}")
    missing = [k for k in SERVING_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")

    log("== phase 7: where the time of one predict goes")
    predict_breakdown(pred, batch_seeds, "predict(128 seeds), bucket 128")
    predict_breakdown(pred, batch_seeds[:1], "predict(1 seed), bucket 1")
    del server

    log("== phase 8: training (pinned_hot store, AdamW)")
    cfg_train = dataclasses.replace(PRODUCTS, dropout=0.0)
    train, train_counts, reference = training_phase(pipe.layout, data,
                                                    cfg_train)

    log("== phase 9: overlap (prefetch, staging, the staged store) and "
        "serve_gnn")
    overlap_counts, recycled_counts, overlap = overlap_phase(
        pipe.layout, data, cfg_train, reference,
        {"pred": pred, "arrivals": arrivals, "rate": rate, "graph": ds.graph,
         "summary": s})
    log(json.dumps({"overlap": overlap}))

    log("== phase 10: placement schemes (vanilla, hybrid, hybrid_partial) "
        "on phase 8's configuration")
    placement_counts, placement = placement_phase(
        pipe.layout, data, cfg_train, reference, batch_seeds)
    log(json.dumps({"placement": placement}))
    log("-- the report's share table over every profile_stages call "
        "(phases 8 and 10)")
    log(render_share_table(stage_shares({"traceEvents": PROFILE_EVENTS})))

    log("== traced run: SyncDriver, double_buffer with staging and "
        "GNNServer under start(path, fenced=True)")
    traced_counts = traced_run(pipe.layout, data, cfg_train, reference,
                               {"pred": pred, "arrivals": arrivals})

    log("== phase 11: exact layer-wise inference (uncapped, full width, "
        "phase 8's trained parameters)")
    infer_counts, wide, exact = exact_inference_phase(
        ds, data, cfg_train, reference["params"], pipe)
    log(json.dumps({"exact_inference": exact, "wide_rows": wide}))

    log("== phase 12: the gcn, gat and gin convs at full width (phase 8's "
        "layout, pinned_hot store and cache)")
    t0 = time.perf_counter()
    conv_counts, convs = conv_phase(
        reference.pop("pipe"), pipe, ds, data,
        {"batch_seeds": batch_seeds, "batch": batch, "pos": pos,
         "arrivals": arrivals})
    log(json.dumps({"convs": convs}))
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    log("== phase 13: the data layer and the partitioners")
    t0 = time.perf_counter()
    data_counts, data_layer = data_phase(cfg_train)
    log(json.dumps({"data_layer": data_layer}))
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    log("== phase 14: the fleet executors on the card (ranks of one "
        "torch.distributed job, gloo, all on this card)")
    t0 = time.perf_counter()
    fleet_counts, fleets = fleet_phase(ds, pipe.layout, cfg_train,
                                       reference["params0"], batch_seeds,
                                       placement)
    log(json.dumps({"fleets": fleets}))
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")

    log("== phase 15: the pod-scale dry-run (fake tensors; one concrete "
        "rank on the card) and the e2e example")
    t0 = time.perf_counter()
    dryrun_counts, dryrun = dryrun_phase()
    log(json.dumps({"dryrun": dryrun}))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")

    log("== phase 16: the LM scaffold (stablelm-1.6b serving and training "
        "at full width; the other families; the reduced configs; the "
        "launchers)")
    t0 = time.perf_counter()
    lm_numbers = lm_phase(card)
    log(json.dumps({"lm": lm_numbers}))
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    log("== phase 17: the LM scaffold, part 2 (the dry-run on DTensor over "
        "a fake 256/512-rank job; a concrete rank on the card; train "
        "--devices 2)")
    t0 = time.perf_counter()
    lm2 = lm_part2_phase(lm_dryrun)
    log(json.dumps({"lm_part2": lm2}))
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")

    log("== phase 18: repro's seed API (the deprecated step shims, the "
        "cached step, the legacy plans, kernels.ops) at phase 8's width")
    t0 = time.perf_counter()
    seed_counts, seed_api = seed_api_phase(pipe.layout, data, cfg_train,
                                           reference["params0"])
    log(json.dumps({"seed_api": seed_api}))
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    backward_of = ("src/repro/core/mfg.py:59 (gradient of the jnp mean; the "
                   "Pallas forward is src/repro/kernels/sage_aggregate.py:30)")
    kernels = []
    for name, serving, replaces, source in (
            ("fused_sample", fs, "src/repro/kernels/fused_sample.py:41",
             "fused_sample"),
            ("sage_aggregate", sa, "src/repro/kernels/sage_aggregate.py:30",
             "sage_aggregate"),
            ("sage_backward_index", None, backward_of,
             "sage_backward_index"),
            ("sage_aggregate_backward", None, backward_of, "sage_aggregate"),
            ("feature_gather", fg,
             "src/repro/kernels/feature_gather.py:26", "feature_gather"),
            ("gather_rows", None, "src/repro/kernels/gather.py:49",
             "gather_rows"),
            ("sage_epilogue", None, "none (port-only: the tail XLA fuses "
             "into src/repro/models/gnn.py's products)", "sage_epilogue"),
            ("sage_epilogue_backward", None, "none (port-only: its "
             "gradient)", "sage_epilogue"),
            ("gat_attention", None, "none (port-only: gatv1's attention; "
             "repro's gat attends in jnp, src/repro/models/gnn.py)",
             "gat_attention"),
            ("gat_attention_backward", None, "none (port-only: its "
             "gradients)", "gat_attention")):
        by_path = {"serving": counts.get(name, 0),
                   "training": train_counts[name],
                   "overlap": overlap_counts[name],
                   "recycled serving": recycled_counts.get(name, 0)}
        by_path.update({path: c[name]
                        for path, c in placement_counts.items()})
        by_path.update({"traced run": traced_counts[name],
                        "exact inference": infer_counts[name]})
        by_path.update({path: c[name] for path, c in conv_counts.items()})
        by_path.update({path: c[name] for path, c in data_counts.items()})
        by_path.update({path: c[name] for path, c in fleet_counts.items()})
        by_path.update({path: c[name]
                        for path, c in dryrun_counts.items()})
        by_path.update({path: c[name] for path, c in seed_counts.items()})
        at_step = train.get(name)
        res = serving or at_step or epilogue[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "call_ms": res["call_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms"),
            "shapes": "serving" if serving else "training step"}
        if "cold_ms" in res:
            entry["ms_l2_flushed"] = res["cold_ms"]
        if "layers" in res:
            entry["layers"] = res["layers"] + at_step["layers"]
        if name == "sage_aggregate":
            entry["wide_rows"] = {
                f"D={D}": {k: w[k] for k in (
                    "edges", "h", "valid_slots", "ms", "call_ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err", "launches_traced")}
                for D, w in sorted(wide.items())}
            entry["wide_rows"]["launches_per_pass"] = \
                infer_counts[name]
            entry["wide_rows"]["layers"] = [
                lay["wide_kernel"] for lay in exact["layers"]]
            entry["e2e_widths"] = e2e_widths["layers"]
        if serving and at_step:
            entry["training_step"] = {
                k: at_step.get(k) for k in ("ms", "call_ms", "plain_ms",
                                            "bound_ms", "library_ms",
                                            "max_abs_err")}
            entry["training_step"]["max_abs_err"] = at_step["err"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-rank"]:
        sys.exit(fleet_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--lm-dryrun"]:
        sys.exit(lm_dryrun_worker(sys.argv[2]))
    sys.exit(main())
