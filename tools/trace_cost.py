"""The cost of the port's tracing on a training step.

Builds one of the benchmark's configurations (``portbench/configs/``) under
one of its traffic mixes (``portbench/mixes/``) through the benchmark's own
set-up, then drives the ``SyncDriver`` of ``repro_torch`` under four
conditions, interleaved in chunks so that a drift of the host's speed falls
on all of them alike:

  * ``off``:      no tracer, no profiler: every span is the shared no-op;
  * ``tracer``:   a ``repro_torch.obs.trace`` tracer installed;
  * ``profiler``: ``torch.profiler`` recording the host and the device, so
                  every span opens a profiler range;
  * ``both``:     the tracer and the profiler.

A step's wall is the time between two consecutive returns of
``driver.step`` inside a chunk (no synchronize between steps, as the
benchmark's window runs them); each condition reports the median, the
quartiles and the number of steps.  The script also times one ``span()``
call, entered and left, under each condition, in ns.

    PYTHONPATH=src:. python tools/trace_cost.py \\
        --config portbench/configs/sage-products.json \\
        --mix portbench/mixes/fastsample.json --out trace_cost.json

Runs on CUDA when a card is there, else on the CPU (then give it a small
configuration).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONDITIONS = ("off", "tracer", "profiler", "both")


def span_call_ns(cuda: bool, number: int = 20_000) -> dict:
    """ns of one ``with span(...)``, entered and left, under each
    condition (the best of five repeats)."""
    from repro_torch.obs import trace as obs_trace

    def one():
        with obs_trace.span("step/update", cat="step"):
            pass

    out = {}
    for condition in CONDITIONS:
        with _condition(condition, cuda):
            out[condition] = min(timeit.repeat(one, number=number,
                                               repeat=5)) / number * 1e9
    return out


@contextlib.contextmanager
def _condition(condition: str, cuda: bool):
    """The tracer and the profiler as ``condition`` has them; yields the
    tracer or None."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    prof = (profile(activities=activities)
            if condition in ("profiler", "both") else contextlib.nullcontext())
    tracer = (obs_trace.start(None)
              if condition in ("tracer", "both") else None)
    try:
        with prof:
            yield tracer
    finally:
        if tracer is not None:
            obs_trace.stop(export=False)


def chunk(prog, steps: int, condition: str, cuda: bool) -> tuple:
    """Step walls (s) of ``steps`` steps under ``condition``, and the spans
    a tracer recorded."""
    with _condition(condition, cuda) as tracer:
        prog.sync()
        stamps = [time.perf_counter()]
        for _ in range(steps):
            prog.step()
            stamps.append(time.perf_counter())
        prog.sync()
    walls = [b - a for a, b in zip(stamps, stamps[1:])]
    return walls, (tracer.num_recorded if tracer is not None else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="portbench/configs/sage-products.json")
    ap.add_argument("--mix", default="portbench/mixes/fastsample.json")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=12,
                    help="steps a chunk; each round runs one chunk a "
                         "condition")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import dataset, harness

    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    cfg_path = ROOT / args.config
    cfg = json.loads(cfg_path.read_text())
    mix = json.loads((ROOT / args.mix).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, _ = dataset.load_or_build(cfg_path, ROOT / "build" / "portbench",
                                    mix["num_parts"], mix["partitioner"])
    prog = harness.Program(data, cfg, mix, harness.seed_streams(args.seed),
                           device)
    for _ in range(mix["warmup_steps"]):
        prog.step()
    for condition in CONDITIONS:      # the profiler's first start, untimed
        chunk(prog, 2, condition, cuda)

    walls = {c: [] for c in CONDITIONS}
    spans = 0
    for r in range(args.rounds):
        order = CONDITIONS[r % 4:] + CONDITIONS[:r % 4]
        for condition in order:
            w, n = chunk(prog, args.chunk, condition, cuda)
            walls[condition] += w
            spans = max(spans, n)
            harness._say(f"trace_cost: round {r} {condition}: median "
                         f"{statistics.median(w) * 1e3:.3f} ms")
    prog.close()

    result = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
              "torch": torch.__version__, "config": args.config,
              "mix": args.mix, "spans_per_chunk": spans,
              "chunk_steps": args.chunk, "span_call_ns": span_call_ns(cuda)}
    for condition, w in walls.items():
        q1, q2, q3 = statistics.quantiles(w, n=4)
        result[condition] = {"steps": len(w), "median_ms": q2 * 1e3,
                             "q1_ms": q1 * 1e3, "q3_ms": q3 * 1e3}
    base = result["off"]["median_ms"]
    for condition in CONDITIONS[1:]:
        result[condition]["vs_off"] = result[condition]["median_ms"] / base
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
