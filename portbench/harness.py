"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names a configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``); the configuration's ``model["conv"]`` names
the trained model (``models/<conv>.py``: its initial weights, the
reference's forward and its GEMM count); its limits are
``checks/<cell>.json``; each metric is read by ``metrics/<metric>.py``.
The traffic is a closed loop of training steps: the next step starts when
the previous one returns.

The program under test is ``repro_torch``: a ``Pipeline`` built by
``Pipeline.build`` from the configuration's dataset and its offline
partition (fed back through the public partitioner registry), driven by the
driver ``Pipeline.train_driver`` returns.  Set-up drives that driver
through its first steps, which the reference follows, then hands the same
driver and state to the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np

from portbench import compare, counts, dataset, devtrace, reference, stages

CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PARTITIONER = "portbench_offline"


def load_bench(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def bench_dir(root: Path, bench: dict) -> Path:
    return Path(root) / bench["paths"][0]


def config_path(root: Path, bench: dict, name: str) -> Path:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return Path(root) / cfg["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_mix(root: Path, bench: dict, traffic: str) -> dict:
    return json.loads((bench_dir(root, bench) / "mixes"
                       / f"{traffic}.json").read_text())


def load_limits(root: Path, bench: dict, workload: str) -> dict:
    return json.loads((bench_dir(root, bench) / "checks"
                       / f"{workload}.json").read_text())["limits"]


def load_metric(root: Path, bench: dict, name: str) -> types.ModuleType:
    """The reader ``metrics/<name>.py``: NAME, UNIT, LAYER, SOURCE, RUN
    ("untraced" or "traced"), MOVES and ``read(run) -> float | None``."""
    path = bench_dir(root, bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares NAME {mod.NAME!r}")
    return mod


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The entries this cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def _say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def seed_streams(seed: int) -> dict:
    """The run's streams, all from ``--seed``: the weights' generator, the
    driver's base salt (the seed draws and the sampling), the dropout
    generator."""
    return {"weights": int(seed) % 2 ** 63,
            "base_salt": int(seed) % 2 ** 32,
            "dropout": (int(seed) * 0x9E3779B97F4A7C15 + 1) % 2 ** 63}


def labelled_per_step(data: dict, num_parts: int, batch: int) -> int:
    """Labelled seeds in one step: each worker draws ``batch`` of its own
    labelled nodes, or all of them where it holds fewer."""
    owned = np.bincount(np.asarray(data["assign"])[
        np.asarray(data["labels"]) >= 0], minlength=num_parts)
    return int(np.minimum(owned, batch).sum())


def cache_capacity(mix: dict, assign) -> int:
    """The mix's cached rows a worker: a whole number, or ``"all_remote"``,
    the most nodes that other workers own, over the workers.  The latter
    is PaGraph's rule (Lin et al., SoCC 2020: fill the card's memory left
    free by training) where every remote row fits in it."""
    cap = mix["cache_capacity"]
    if cap == "all_remote":
        assign = np.asarray(assign)
        owned = np.bincount(assign, minlength=mix["num_parts"])
        return int(assign.size - owned.min())
    return int(cap)


def gnn_config(model: dict):
    """The program's ``GNNConfig`` from every key of the configuration's
    ``model`` (``fanouts`` as a tuple); a key it does not declare is an
    error that names it."""
    from repro_torch.models.gnn import GNNConfig

    known = {f.name for f in dataclasses.fields(GNNConfig)}
    unknown = sorted(set(model) - known)
    if unknown:
        raise ValueError(f"the configuration's model has keys that "
                         f"GNNConfig does not declare: {unknown}")
    return GNNConfig(**{k: tuple(v) if k == "fanouts" else v
                        for k, v in model.items()})


class Program:
    """The program under test, built and driven through its public API,
    with its initial weights from the model file ``net``
    (``models/<conv>.py``) and the program's ``GNNConfig`` ``gcfg``."""

    def __init__(self, data: dict, cfg: dict, mix: dict, streams: dict,
                 device, net, gcfg, log=_say):
        import torch

        from repro_torch.core.graph import CSCGraph
        from repro_torch.core.partition import (Partitioner,
                                                register_partitioner)
        from repro_torch.pipeline import Pipeline, PipelineSpec

        model, optim = cfg["model"], cfg["optimizer"]
        self.net, self.gcfg = net, gcfg
        assign = np.asarray(data["assign"])

        class Offline(Partitioner):
            name = PARTITIONER

            def _assign(self, graph, num_parts, labeled, *, seed, slack,
                        labeled_slack):
                if assign.shape != (graph.num_nodes,):
                    raise ValueError("the offline partition is of another "
                                     "graph")
                return assign

        register_partitioner(PARTITIONER, lambda: Offline(), overwrite=True)
        spec = PipelineSpec.from_scheme(
            mix["scheme"], num_parts=mix["num_parts"],
            fanouts=model["fanouts"], partitioner=PARTITIONER,
            feature_store=mix["feature_store"],
            cache_capacity=cache_capacity(mix, assign),
            prefetch_depth=mix["prefetch_depth"], staging=mix["staging"],
            executor=mix["executor"])
        graph = CSCGraph(
            indptr=torch.from_numpy(np.array(data["indptr"], np.int32)),
            indices=torch.from_numpy(np.array(data["indices"], np.int32)))
        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
            else (lambda: None)
        t0 = time.perf_counter()
        self.pipe = Pipeline.build(graph, data["features"],
                                   np.asarray(data["labels"]), spec,
                                   device=device)
        sync()
        self.layout_build_s = time.perf_counter() - t0
        log(f"portbench: Pipeline.build {self.layout_build_s:.3f} s")
        self.model, self.optim, self.mix = model, optim, mix
        self.device = device
        self.sync = sync
        self.driver = None
        self.start(streams)

    def start(self, streams: dict) -> None:
        """Fresh weights, optimizer state, dropout generator and driver
        from ``streams`` (``seed_streams``), over the same pipeline."""
        import torch

        from repro_torch.optim import init_opt_state

        if self.driver is not None:
            self.driver.close()
        self.generator = torch.Generator(device=self.device).manual_seed(
            streams["dropout"])
        self.params = self.net.init_params(
            self.model, streams["weights"], self.device)
        self.opt_state = init_opt_state(self.params, kind=self.optim["kind"])
        self.driver = self.pipe.train_driver(
            self.loss_fn, batch=self.mix["batch"], lr=self.optim["lr"],
            optimizer=self.optim["kind"], grad_clip=self.optim["grad_clip"],
            base_salt=streams["base_salt"], device=self.device)

    def loss_fn(self, params, mfgs, h_src, labels, valid):
        from repro_torch.models import gnn
        return gnn.gnn_loss(params, mfgs, h_src, labels, valid, self.gcfg,
                            generator=self.generator)

    def step(self):
        """One step; its loss, and its metrics (the driver's, on the
        device) in ``self.metrics``."""
        self.params, self.opt_state, loss, self.metrics = self.driver.step(
            self.params, self.opt_state)
        return loss

    def checked_steps(self, steps: int = CHECKED_STEPS,
                      after_first: list | None = None) -> dict:
        """Drive the first ``steps`` steps; read each loss, the first
        clipped gradient from AdamW's first moment after one step (m1 =
        (1 - b1) g), and the parameters' change after the first and the
        last step.  ``after_first`` receives the parameters after the
        first step."""
        def snapshot():
            return {k: v.clone()
                    for k, v in reference.leaves(self.params).items()}

        def change(start):
            return {k: float((v - start[k]).norm())
                    for k, v in reference.leaves(self.params).items()}

        start = snapshot()
        out = {"losses": []}
        for k in range(steps):
            out["losses"].append(float(self.step()))
            if k == 0:
                out["grad_norms"] = {
                    key: float((m / (1 - self.optim["b1"])).norm())
                    for key, m in reference.leaves(self.opt_state.mu).items()}
                out["change1_norms"] = change(start)
                if after_first is not None:
                    after_first.append(snapshot())
        out[f"change{steps}_norms"] = change(start)
        return out

    def close(self) -> None:
        self.driver.close()


def _loop_s(n: int = 200_000) -> float:
    t0 = time.perf_counter()
    total = 0
    for i in range(n):
        total += i
    return time.perf_counter() - t0


@contextlib.contextmanager
def on_fastest_cpu(log=_say):
    """Run the block with the calling thread on the CPU where a short
    pure-Python loop runs fastest now, then restore its CPUs.  The host
    paces the step, and on an H100 host of 8 virtual CPUs the CPUs a
    thread may land on differed in speed by up to 1.4x (a neighbour's load
    on a shared core); a thread left to the scheduler keeps one for the
    whole window, so runs fell into fast and slow ones.  Threads that other code starts
    meanwhile would share the one CPU, so nothing that starts threads (the
    profiler) runs inside."""
    tid = threading.get_native_id()
    cpus = sorted(os.sched_getaffinity(tid))
    speed = {}
    for cpu in cpus:
        os.sched_setaffinity(tid, {cpu})
        speed[cpu] = min(_loop_s() for _ in range(3))
    best = min(speed, key=speed.get)
    os.sched_setaffinity(tid, {best})
    log(f"portbench: window on CPU {best} (loop {speed[best] * 1e3:.2f} ms, "
        f"slowest {max(speed.values()) * 1e3:.2f} ms)")
    try:
        yield best
    finally:
        os.sched_setaffinity(tid, cpus)


def _window(prog: Program, seconds: float, device_trace: bool,
            cuda: bool) -> tuple:
    """(start, steps, wall seconds, rounds a step, device ops, seconds the
    profiler took to start) of a closed loop of steps for ``seconds``,
    closed by a synchronize: all the work over all the time.  With
    ``device_trace`` the window runs under a device-only profiler, started
    before the thread is pinned so that its threads keep every CPU, and
    the device ops are the window's; else None and 0."""
    rounds0 = prog.pipe.counter.rounds
    trace = (devtrace.traced(prog.sync, host=False, cuda=cuda)
             if device_trace else contextlib.nullcontext((None, None)))
    t_trace = time.perf_counter()
    with trace as (prof, bounds):
        trace_start_s = time.perf_counter() - t_trace if device_trace else 0.0
        with on_fastest_cpu():
            prog.sync()
            t0 = time.perf_counter()
            steps = 0
            while time.perf_counter() - t0 < seconds:
                prog.step()
                steps += 1
            prog.sync()
            wall = time.perf_counter() - t0
    dev = devtrace.records(prof, *bounds)[0] if device_trace else None
    if device_trace and cuda and not dev:
        raise RuntimeError("the device trace holds no operation inside "
                           "the measured window")
    return (t0, steps, wall, (prog.pipe.counter.rounds - rounds0) / steps,
            dev, trace_start_s)


def _traced_window(prog: Program, steps: int, label_steps: int,
                   cuda: bool) -> dict:
    """``steps`` steps under a device-only profiler (busy time, ops,
    kernels, the program's launch counts and rounds over them, and each
    step's cache hit share as the program's driver reports it), then
    ``label_steps`` more under a host and device profiler whose idle gaps
    get a label from what the host was doing (its own spans around the
    step and the seed draw, aten ops and runtime calls)."""
    from torch.profiler import record_function

    from repro_torch import kernels

    pipe = prog.pipe
    first = prog.driver._next
    kernels.reset_launch_counts()
    rounds0 = pipe.counter.rounds
    shares = []
    with devtrace.traced(prog.sync, host=False, cuda=cuda) as (prof, b):
        for _ in range(steps):
            prog.step()
            shares.append(prog.metrics["cache_hit_rate"])
    dev, _ = devtrace.records(prof, *b)
    out = {"steps": steps, "first": first, "t0": b[0], "t1": b[1],
           "dev": dev, "launches": kernels.launch_counts(),
           "rounds_per_step": (pipe.counter.rounds - rounds0) / steps,
           "hit_share": [float(x) for x in shares]}
    if not dev and cuda:
        raise RuntimeError("the device trace holds no operation inside "
                           "the traced window")

    draw = pipe.seeds_host

    def seeds_host(*args, **kwargs):
        with record_function("portbench.seeds_host"):
            return draw(*args, **kwargs)

    pipe.seeds_host = seeds_host
    try:
        with devtrace.traced(prog.sync, host=True, cuda=cuda) as (prof, b):
            for _ in range(label_steps):
                with record_function("portbench.step"):
                    prog.step()
    finally:
        del pipe.seeds_host
    ldev, host = devtrace.records(prof, *b)
    gaps = devtrace.idle_gaps(devtrace.busy_intervals(ldev), *b)
    out["idle_labels"] = devtrace.label_gaps(gaps, host)
    out["label_window_s"] = (b[1] - b[0]) / 1e9
    out["seed_draw_s"] = []
    for k in range(label_steps):
        t0 = time.perf_counter()
        pipe.seeds_host(prog.mix["batch"], 2 ** 31 + k)
        out["seed_draw_s"].append(time.perf_counter() - t0)
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: Path, device="cuda", t_start: float | None = None,
        log=_say) -> dict:
    """One run of ``workload``; returns the result line's object."""
    import torch

    import repro_torch  # noqa: F401  (the program: fail before any set-up)

    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    bench = load_bench(root)
    cell = find_cell(bench, workload)
    cfg_file = config_path(root, bench, cell["config"])
    cfg = json.loads(cfg_file.read_text())
    mix = load_mix(root, bench, cell["traffic"])
    limits = load_limits(root, bench, workload)
    streams = seed_streams(seed)
    model, P = cfg["model"], mix["num_parts"]
    # the model file and the program's config, before any set-up
    net = reference.load_model(bench_dir(root, bench) / "models",
                               model["conv"])
    gcfg = gnn_config(model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data, built = dataset.load_or_build(cfg_file, root / "build" / "portbench",
                                        P, mix["partitioner"], log=log)
    prog = Program(data, cfg, mix, streams, device, net, gcfg, log=log)
    checked = prog.checked_steps()
    for _ in range(mix["warmup_steps"] - CHECKED_STEPS):
        prog.step()
    cuda = torch.device(device).type == "cuda"
    # the untraced run takes the window's device ops for the card's rate;
    # the traced run keeps its window clean for the host's rate
    t0, steps, wall, rounds, window_dev, trace_start_s = _window(
        prog, seconds, not trace, cuda)
    # the profiler's start is the benchmark's, not the program's set-up
    setup_s = t0 - t_start - trace_start_s
    log(f"portbench: set-up {setup_s:.3f} s (dataset "
        f"{'built' if built else 'memory-mapped'}; the profiler's start, "
        f"{trace_start_s:.3f} s, left out)")
    per_step = labelled_per_step(data, P, mix["batch"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"portbench: window {steps} steps in {wall:.3f} s")
    if window_dev is not None:
        log(f"portbench: window's device trace: {len(window_dev)} device "
            f"ops, busy {devtrace.busy_seconds(window_dev):.6f} s")
    run_rec = types.SimpleNamespace(
        cell=cell, config=cfg, mix=mix, model=model, model_file=net,
        setup_s=setup_s,
        layout_build_s=prog.layout_build_s, window_steps=steps,
        window_s=wall, seeds_per_step=per_step, rounds_per_step=rounds,
        window_dev=window_dev,
        trace=None, stages=None, window_counts=None, trace_counts=None)
    if trace:
        run_rec.trace = _traced_window(prog, mix["trace_steps"],
                                       mix["label_steps"], cuda)
        salts = [(streams["base_salt"] + 10 ** 6 + i) % 2 ** 32
                 for i in range(mix["stage_steps"] + 1)]
        run_rec.stages = stages.stage_seconds(
            prog.pipe, prog.loss_fn, prog.params, batch=mix["batch"],
            salts=salts, sync=prog.sync)

    # the rows the program's cache holds, for the kernels' counts; then
    # free the program's state before the reference runs on the card
    cache = (prog.pipe.cache.ids.long().clone()
             if prog.pipe.cache is not None else None)
    window_first = mix["warmup_steps"]
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    layout = reference.make_layout(data, P, device)
    ref = reference.train(data, net, model, cfg["optimizer"], mix,
                          streams["weights"], streams["base_salt"],
                          streams["dropout"],
                          steps=CHECKED_STEPS, device=device, layout=layout)
    read = compare.readings(checked, ref)
    correct, table = compare.judge(read, limits)

    if trace:
        def structure(k):
            salt = (streams["base_salt"] + k) % 2 ** 32
            seeds = reference.draw_seeds(layout, mix["batch"], salt)
            return counts.summarize(reference.sample_step(
                layout, seeds, model["fanouts"], salt, mix["sample_window"]),
                cache)
        run_rec.window_counts = [structure(window_first + i)
                                 for i in range(steps)]
        tr = run_rec.trace
        run_rec.trace_counts = [structure(tr["first"] + i)
                                for i in range(tr["steps"])]
        check_hits(run_rec.trace_counts, tr["hit_share"])

    metrics = {}
    for entry in cell_metrics(bench, workload, trace):
        reader = load_metric(root, bench, entry["name"])
        value = reader.read(run_rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    out = {"correct": bool(correct), "attempted": steps, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        tr = run_rec.trace
        busy = devtrace.busy_seconds(tr["dev"])
        out["device"]["busy_s"] = busy
        out["device"]["window_s"] = (tr["t1"] - tr["t0"]) / 1e9
        out["breakdown"] = {
            "device_ops": devtrace.top(devtrace.device_by_name(tr["dev"])),
            "idle_gaps": devtrace.top(tr["idle_labels"])}
        log(f"portbench: traced {tr['steps']} steps in "
            f"{out['device']['window_s']:.3f} s (device busy {busy:.3f} s), "
            f"{mix['label_steps']} host-traced steps in "
            f"{tr['label_window_s']:.3f} s")
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in table.items()}
    return out


def check_hits(steps: list[dict], shares: list[float]) -> None:
    """Hold the kernels' counts of cache hits (``counts.summarize`` over the
    benchmark's sampling and the rows the program's cache holds) to the
    hit share the program's fetch reported in each traced step; a
    difference ends the run rather than miscount the rooflines."""
    for k, (s, got) in enumerate(zip(steps, shares)):
        want = float(np.mean([h / max(f, 1) for h, f in
                              zip(s["hits"], s["frontier"])]))
        if abs(want - got) > 1e-5:
            raise RuntimeError(
                f"traced step {k}: the program's fetch reported a cache hit "
                f"share of {got!r}, the benchmark counts {want!r}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def finish(out: dict) -> int:
    """Print the compared numbers beside their limits as the last lines of
    standard error and the result as the last line of standard output;
    refuse to print a result when a JAX module was loaded."""
    bad = forbidden_modules()
    if bad:
        _say(f"portbench: the process loaded {bad}; no result")
        return 3
    for k, c in out["checks"].items():
        _say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    _say(f"correct = {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0
