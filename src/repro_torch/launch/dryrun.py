"""Pod-scale dry-run of the LM scaffold: every (arch x shape x mesh) combo
traced once as one rank of a 256- or 512-rank job, on fake tensors
(counterpart of ``repro.launch.dryrun``).

``repro`` lowers and compiles each combo with GSPMD on 512 placeholder
host devices and reads memory, FLOPs, bytes and collectives from the
compiled module.  Here the process is rank 0 of a ``torch.distributed``
job on the ``"fake"`` backend (``repro_torch.launch.dryrun_gnn.fake_job``:
no peers, no network), the mesh is ``make_production_mesh``'s
``DeviceMesh`` over it, and parameters, optimizer state, batch and decode
state are DTensors placed by ``repro_torch.sharding`` /
``repro_torch.launch.specs``, whose local shards are ``FakeTensorMode``
tensors: nothing is allocated and no card is needed.  The step runs once,
under ``implicit_replication`` (tensors the model makes itself, masks and
index ranges, are replicated), and DTensor issues the reshards and
collectives that GSPMD inserts silently; the model's own DTensor hooks
(``repro_torch.models.spmd``) make the head reshapes, the MoE dispatch, the
decode cache writes and the SSD carry explicit.

For each combo the record holds (JSON lines, one file a combo under
``--out``):

  * the REAL step at full depth (``remat`` for ``train``) under
    ``PeakMemory`` (``MemTracker``'s reading of the rank's own ops), read
    as ``repro`` reads XLA's memory analysis:
    ``argument_bytes`` (this rank's shards of the inputs),
    ``output_bytes`` (of the outputs), ``alias_bytes`` (outputs that are
    inputs' buffers written in place: decode's caches),
    ``peak_estimate_bytes`` (the peak of every tensor the rank holds, its
    inputs included) and ``temp_bytes`` = peak - arguments - outputs +
    aliases; ``collective_schedule_counts`` (the step's collectives by
    kind); ``compile_s`` (the trace's seconds), ``total_s``;
  * two depth probes (1 and 2 depth units, no remat) counted by
    ``repro_torch.roofline.CostCounter`` and extrapolated to full depth:
    ``roofline``, counts over the H100's data-sheet constants, not
    timings;
  * ``status`` ``ok`` / ``skipped`` / ``fail`` (with ``error``): a failure
    is a result, and the exit code is 1 if any combo failed.

The step consumes its inputs as ``repro``'s donated jit does: the caller
keeps no reference to them.  Torch runs every layer and attention chunk
unrolled, so ``repro``'s ``PROBE_UNROLL`` has no counterpart.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_ALIASES, ModelConfig, SHAPES,
                                 ShapeConfig, get_config, get_shape)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 512k decode requires "
                       "sub-quadratic attention (DESIGN.md §5 skip)")
    return True, ""


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, *, remat: bool):
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.optim import apply_updates
    from repro_torch.optim.optimizers import (clip_by_global_norm,
                                              tree_leaves, tree_map)
    mdt = S.moment_dtype_for(cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        loss, _metrics = lm.lm_loss(params, batch, cfg, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        grads, _gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = apply_updates(params, grads, opt_state,
                                          kind="adamw", lr=1e-4,
                                          moment_dtype=mdt)
        return params, opt_state, loss.detach()
    return train_step


def build_prefill_step(cfg: ModelConfig, *, remat: bool):
    from repro_torch.models import lm

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = lm.forward(params, batch, cfg, remat=remat,
                               last_only=cfg.prefill_last_only)
        # score-only prefill output: next-token logits
        return logits[:, -1, :]
    return prefill_step


def build_serve_step(cfg: ModelConfig):
    from repro_torch.models import lm, spmd

    @torch.no_grad()
    def serve_step(params, state, batch):
        logits, new_state = lm.decode_step(params, state, batch, cfg)
        # DTensor's argmax over a sharded vocab syncs with the host: the
        # logits are gathered first, as GSPMD does
        last = spmd.replicate_dims(logits[:, -1, :], -1)
        return torch.argmax(last, dim=-1), new_state
    return serve_step


# ---------------------------------------------------------------------------
# one rank's inputs and one traced step
# ---------------------------------------------------------------------------

def rank_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The combo's meta stand-ins and their spec trees, by input:
    ``{name: (struct, specs)}`` for ``params`` (requiring grad for
    ``train``), ``opt`` (train), ``state`` (decode) and ``batch``."""
    from repro_torch.launch import specs as S

    pstruct = S.abstract_params(cfg)
    if shape.kind == "train":
        for t in _leaves(pstruct):
            t.requires_grad_(True)
    out = {"params": (pstruct, S.param_shardings_tree(pstruct, mesh))}
    if shape.kind == "train":
        ostruct = S.abstract_opt_state(cfg, pstruct)
        out["opt"] = (ostruct, S.opt_shardings_tree(ostruct, pstruct, mesh))
    if shape.kind == "decode":
        sstruct = S.abstract_decode_state(cfg, shape)
        out["state"] = (sstruct, S.decode_state_shardings(sstruct, mesh))
    bstruct = S.input_specs(cfg, shape)
    out["batch"] = (bstruct, S.batch_shardings(bstruct, mesh))
    return out


def rank_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, make) -> dict:
    """This rank's inputs for the combo as DTensors on ``mesh`` (the keys
    of ``rank_specs``), each shard built by ``make(local_shape, dtype)``."""
    from repro_torch.sharding import distribute
    return {name: distribute(struct, specs, mesh, make=make)
            for name, (struct, specs) in rank_specs(cfg, shape,
                                                    mesh).items()}


def _leaves(tree) -> list:
    from repro_torch.sharding import tree_map_with_path
    out = []
    tree_map_with_path(lambda _, t: out.append(t), tree)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def run_step(cfg: ModelConfig, shape: ShapeConfig, inputs: dict, *,
             remat: bool):
    """Run the combo's step once on ``inputs`` (consumed: ``inputs`` is
    emptied) under ``implicit_replication``.  Returns the outputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = [inputs.pop("params")]
    if shape.kind == "train":
        fn = build_train_step(cfg, remat=remat)
        args += [inputs.pop("opt")]
    elif shape.kind == "prefill":
        fn = build_prefill_step(cfg, remat=remat)
    else:
        fn = build_serve_step(cfg)
        args += [inputs.pop("state")]
    args.append(inputs.pop("batch"))
    with implicit_replication():
        return fn(*args)


def trace_combo(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                remat: bool = True, counter=None, memory: bool = False):
    """Trace one step of the combo as rank 0 on fake tensors.  With
    ``counter`` (a ``CostCounter``) the step runs under it; with
    ``memory`` the record of ``repro``'s memory keys is returned
    (``PeakMemory`` over the step, the inputs tracked from the start)."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    # the shards are fake and the step runs in their fake mode; DTensor's
    # shape propagation runs ops in the tracing context's fake mode, a
    # second one, so PeakMemory and CostCounter (which count only under
    # the mode active on entry) skip it
    from torch._guards import TracingContext, tracing
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        inputs = rank_inputs(
            cfg, shape, mesh,
            lambda s, dt: torch.empty(s, dtype=dt, device=mesh.device_type))
    local_in = [_local(t) for t in _leaves(inputs)]
    arg_bytes = sum(_nbytes(t) for t in local_in)
    in_storages = {_storage_key(t) for t in local_in}
    tracker = None
    ctx = contextlib.ExitStack()
    ctx.enter_context(mode)
    ctx.enter_context(tracing(TracingContext(FakeTensorMode())))
    if memory:
        tracker = PeakMemory()
        tracker.track(*local_in)
        ctx.enter_context(tracker)
    if counter is not None:
        ctx.enter_context(counter)
    del local_in
    with ctx:
        out = run_step(cfg, shape, inputs, remat=remat)
    if not memory:
        return None
    local_out = [_local(t) for t in _leaves(out)]
    out_bytes = sum(_nbytes(t) for t in local_out)
    alias = sum(_nbytes(t) for t in local_out
                if _storage_key(t) in in_storages)
    peak = tracker.peak
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes - out_bytes + alias,
            "alias_bytes": alias, "peak_estimate_bytes": peak}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_key(t):
    return t.untyped_storage()._cdata


class PeakMemory(TorchDispatchMode):
    """The peak bytes of the tensors one rank holds while the ``with`` body
    runs: the tensors given to ``track`` and every storage an op of the
    rank creates, each released with its storage (a CUDA storage rounded
    up to 512 B, as the caching allocator and ``MemTracker`` round).

    ``MemTracker``'s reading, kept to the rank's own ops: an op counts
    only under the fake mode that was active on entry, as in
    ``CostCounter``.  Torch 2.11's ``MemTracker`` also counts DTensor's
    shape propagation, which runs each op at global shapes, and on the
    card put a decode rank at 60 times the peak a concrete rank reached
    (``PERF.md``).  A collective's ``wait_tensor``
    gives back its input, as in eager code (the fake kernel makes a new
    tensor)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._entry_mode = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def track(self, *tensors) -> None:
        for t in tensors:
            self._add(t)
        self.peak = max(self.peak, self.live)

    def _add(self, t) -> None:
        import weakref
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // 512) * 512

        def release(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, release)
        self.live += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        from repro_torch.roofline import _tensors
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ours = active_fake_mode() is self._entry_mode
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and self._entry_mode is not None and ours:
            return args[0]
        out = func(*args, **(kwargs or {}))
        if ours:
            for t in _tensors(out):
                if t.device.type != "meta":
                    self._add(t)
            self.peak = max(self.peak, self.live)
        return out


def depth_units(cfg: ModelConfig) -> tuple[int, ModelConfig, ModelConfig]:
    """(units, cfg@1unit, cfg@2units) for the cost probes."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        every = cfg.shared_attn_every
        units = cfg.num_layers / every          # fractional remainder ok
        c1 = dataclasses.replace(cfg, num_layers=every)
        c2 = dataclasses.replace(cfg, num_layers=2 * every)
        return units, c1, c2
    if cfg.is_encdec:
        units = cfg.num_layers
        c1 = dataclasses.replace(cfg, num_layers=1, encoder_layers=1)
        c2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
        return units, c1, c2
    units = cfg.num_layers
    c1 = dataclasses.replace(cfg, num_layers=1)
    c2 = dataclasses.replace(cfg, num_layers=2)
    return units, c1, c2


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Count the 1- and 2-unit steps (no remat), extrapolate to full
    depth."""
    from repro_torch import roofline
    units, c1, c2 = depth_units(cfg)
    metrics = []
    for c in (c1, c2):
        counter = roofline.CostCounter()
        trace_combo(c, shape, mesh, remat=False, counter=counter)
        metrics.append(counter.metrics())
    return roofline.extrapolate(metrics[0], metrics[1], units)


def mesh_for(mesh_name: str, device_type: str = "cpu"):
    """The production ``DeviceMesh`` of ``pod`` / ``multipod`` /
    ``pod_tpN`` / ``multipod_tpN`` (the job must have its ranks), on
    ``device_type``.  The dry-run needs only the host: fake CPU tensors
    on a CPU mesh, on any machine (on a CPU mesh DTensor runs a
    shard-to-shard reshard as an all-gather, gloo having no all-to-all).
    On the card, torch 2.11's remat trace on fake CUDA tensors read a
    peak as if no activation were released (``PERF.md``)."""
    from repro_torch.launch.mesh import make_production_mesh
    tp = 16
    if "_tp" in mesh_name:
        tp = int(mesh_name.split("_tp")[1])
    return make_production_mesh(
        multi_pod=mesh_name.startswith("multipod"), model_parallel=tp,
        device_type=device_type)


def mesh_chips(mesh_name: str) -> int:
    return 512 if mesh_name.startswith("multipod") else 256


def run_combo(arch: str, shape_name: str, mesh_name: str,
              *, skip_probes: bool = False, out_dir: str | None = None,
              param_overrides: dict | None = None, cfg=None,
              mesh=None) -> dict:
    """One combo's record, as rank 0 of a fake job of the mesh's size
    (``fake_job``; a job of that size already running is used).  ``cfg``
    replaces the arch's config and ``mesh`` the production mesh (a
    ``DeviceMesh`` over the running job)."""
    from repro_torch import roofline
    from repro_torch.launch.dryrun_gnn import fake_job

    cfg = cfg or get_config(arch)
    if param_overrides:
        cfg = dataclasses.replace(cfg, **param_overrides)
    shape = get_shape(shape_name)
    chips = mesh.size() if mesh is not None else mesh_chips(mesh_name)

    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips}
    if not ok:
        rec.update(status="skipped", reason=why)
        _emit(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        with fake_job(chips):
            m = mesh if mesh is not None else mesh_for(mesh_name)
            # 1) the REAL step: remat, full depth
            sched = roofline.CostCounter()
            rec["memory"] = trace_combo(cfg, shape, m,
                                        remat=(shape.kind == "train"),
                                        counter=sched, memory=True)
            rec["compile_s"] = round(time.time() - t0, 1)
            rec["collective_schedule_counts"] = dict(sched.coll_counts)

            # 2) depth probes -> roofline terms
            if not skip_probes:
                costs = probe_costs(cfg, shape, m)
                terms = roofline.RooflineTerms(
                    flops=costs["flops"], hbm_bytes=costs["hbm_bytes"],
                    coll_bytes=costs["coll_bytes"],
                    fusable=costs.get("fusable", 0.0),
                    model_flops_global=roofline.model_flops(cfg, shape),
                    chips=chips)
                rec["roofline"] = terms.as_dict()
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failure IS the result here
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    _emit(rec, out_dir)
    return rec


def _emit(rec: dict, out_dir: str | None):
    line = {k: v for k, v in rec.items() if k != "traceback"}
    print(json.dumps(line), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)


def parse_opt(opt: str) -> dict:
    """``--opt``'s comma list -> config overrides, as ``repro`` parses it."""
    overrides = {}
    for o in filter(None, opt.split(",")):
        if o == "prefill_last":
            overrides["prefill_last_only"] = True
        elif o == "moe_shard":
            overrides["moe_shard_constraints"] = True
        elif o.startswith("moe_group"):
            overrides["moe_num_groups"] = int(o.split(":")[1]) \
                if ":" in o else 32
        elif o.startswith("attn_chunk"):
            overrides["attn_chunk"] = int(o.split(":")[1]) \
                if ":" in o else 1024
        elif o.startswith("ce_chunk"):
            overrides["ce_seq_chunk"] = int(o.split(":")[1]) \
                if ":" in o else 512
        elif o == "ssm_shard":
            overrides["ssm_state_constraints"] = True
    return overrides


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description="Trace rank 0 of a 256/512-rank LM job on fake tensors "
                    "(no card needed)")
    ap.add_argument("--arch", default=None,
                    help="arch id (e.g. qwen2-7b); omit with --all")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    help="pod | multipod | both | pod_tpN | multipod_tpN "
                         "(N-way model parallelism over the same ranks)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-probes", action="store_true",
                    help="the full-depth trace only (no roofline probes)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opt", default="",
                    help="comma list of beyond-paper optimizations: "
                         "prefill_last,moe_shard,attn_chunk[:N]")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("--arch is required without --all")

    overrides = parse_opt(args.opt)
    archs = list(ARCH_ALIASES) if args.all else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                records.append(run_combo(arch, shape, mesh,
                                         skip_probes=args.skip_probes,
                                         out_dir=args.out,
                                         param_overrides=overrides or None))
    n_fail = sum(r["status"] == "fail" for r in records)
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
