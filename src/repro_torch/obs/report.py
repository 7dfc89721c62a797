"""Render the paper's Figure-1-style step-time-share table from a trace
(counterpart of ``repro.obs.report``).

FastSample's motivating measurement is the share of a distributed
training step spent sampling vs fetching features vs computing.  This
CLI reproduces that table from a recorded trace file:

    PYTHONPATH=src python -m repro_torch.obs.report trace.json

It aggregates the fenced stage spans ``repro_torch.obs.profile`` emits (Chrome
cats ``sampling`` / ``feature`` / ``compute``), grouped by their ``arm``
tag — one row per placement scheme / feature store the profile covered;
``step (ms)`` is the stage total of one profiled step.  ``--summary``
additionally prints a per-span-name aggregation of every "X" event in the
trace (count / total / self / mean; self time is a span's duration less
what its child spans cover, found through their ``parent``), which is
useful on traces recorded by ``--trace`` training runs that carry driver,
step and stager spans but no fenced stage spans.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.obs.profile import STAGES
from repro_torch.obs.trace import validate_trace


def _load(trace):
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    validate_trace(trace)
    return trace


def stage_shares(trace) -> dict:
    """Aggregate a trace's fenced stage spans into per-arm shares.

    Parameters
    ----------
    trace : dict | str
        Parsed Chrome trace dict, or a path to one.

    Returns
    -------
    dict
        ``{arm: {"sampling_us", "feature_us", "compute_us", "step_us",
        "spans", "steps", "share": {stage: fraction}}}`` — the stage sums
        over all profiled steps, ``step_us`` their total over ``steps``
        (the arm's ``sampling`` spans, one a profiled step); spans with no
        ``arm`` tag land under ``"run"``.

    Examples
    --------
    >>> shares = stage_shares({"traceEvents": [
    ...     {"name": "profile/sampling", "ph": "X", "ts": 0, "dur": 30,
    ...      "pid": 0, "tid": 0, "cat": "sampling"},
    ...     {"name": "profile/compute", "ph": "X", "ts": 30, "dur": 70,
    ...      "pid": 0, "tid": 0, "cat": "compute"}]})
    >>> round(shares["run"]["share"]["sampling"], 2)
    0.3
    >>> shares["run"]["step_us"]
    100.0
    """
    trace = _load(trace)
    groups: dict = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") not in STAGES:
            continue
        arm = (ev.get("args") or {}).get("arm", "run")
        g = groups.setdefault(
            arm, {f"{s}_us": 0.0 for s in STAGES} | {"spans": 0, "steps": 0})
        g[f"{ev['cat']}_us"] += float(ev["dur"])
        g["spans"] += 1
        g["steps"] += ev["cat"] == "sampling"
    for g in groups.values():
        total = sum(g[f"{s}_us"] for s in STAGES)
        g["step_us"] = total / max(g["steps"], 1)
        g["share"] = {s: (g[f"{s}_us"] / total if total > 0 else 0.0)
                      for s in STAGES}
    return groups


def render_share_table(groups: dict) -> str:
    """Markdown table of per-arm stage shares (the Figure-1 layout)."""
    lines = [
        "| arm | sampling | feature | compute | step (ms) | spans |",
        "|---|---|---|---|---|---|",
    ]
    for arm in sorted(groups):
        g = groups[arm]
        cells = [str(arm)]
        cells += [f"{100.0 * g['share'][s]:.1f}%" for s in STAGES]
        cells += [f"{g['step_us'] / 1e3:.2f}", str(g["spans"])]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def span_summary(trace) -> dict:
    """Per-span-name aggregation of every "X" event:
    ``{name: {"count", "total_us", "self_us", "mean_us"}}``.  A span's
    self time is its duration less the durations of the spans whose
    ``args.parent`` is its ``args.id`` (in the same process); a span
    without an id has no known children.

    Examples
    --------
    >>> agg = span_summary({"traceEvents": [
    ...     {"name": "outer", "ph": "X", "ts": 0, "dur": 100, "pid": 0,
    ...      "tid": 0, "args": {"id": 1}},
    ...     {"name": "inner", "ph": "X", "ts": 20, "dur": 60, "pid": 0,
    ...      "tid": 0, "args": {"id": 2, "parent": 1}}]})
    >>> agg["outer"]["self_us"], agg["inner"]["self_us"]
    (40.0, 60.0)
    """
    trace = _load(trace)
    spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    children: dict = {}
    for ev in spans:
        parent = (ev.get("args") or {}).get("parent")
        if parent is not None:
            key = (ev.get("pid"), parent)
            children[key] = children.get(key, 0.0) + float(ev["dur"])
    agg: dict = {}
    for ev in spans:
        a = agg.setdefault(ev["name"], {"count": 0, "total_us": 0.0,
                                        "self_us": 0.0})
        dur = float(ev["dur"])
        span_id = (ev.get("args") or {}).get("id")
        kids = 0.0 if span_id is None \
            else children.get((ev.get("pid"), span_id), 0.0)
        a["count"] += 1
        a["total_us"] += dur
        a["self_us"] += max(0.0, dur - kids)
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["count"]
    return agg


def render_summary_table(agg: dict) -> str:
    """Markdown table of the span summary, heaviest spans first."""
    lines = ["| span | count | total (ms) | self (ms) | mean (us) |",
             "|---|---|---|---|---|"]
    for name in sorted(agg, key=lambda n: -agg[n]["total_us"]):
        a = agg[name]
        lines.append(f"| {name} | {a['count']} "
                     f"| {a['total_us'] / 1e3:.2f} "
                     f"| {a['self_us'] / 1e3:.2f} "
                     f"| {a['mean_us']:.1f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render the sampling/feature/compute step-time-share "
                    "table from a recorded trace")
    parser.add_argument("trace", help="Chrome trace-event JSON file "
                                      "(from --trace or profile_stages)")
    parser.add_argument("--summary", action="store_true",
                        help="also print a per-span-name aggregation of "
                             "every event in the trace")
    args = parser.parse_args(argv)

    trace = _load(args.trace)
    groups = stage_shares(trace)
    if groups:
        print("## Step-time share (sampling / feature / compute)\n")
        print(render_share_table(groups))
    else:
        print("no fenced stage spans (cats sampling/feature/compute) in "
              "this trace; record them with "
              "repro_torch.obs.profile.profile_stages")
    if args.summary or not groups:
        agg = span_summary(trace)
        if agg:
            print("\n## Span summary\n")
            print(render_summary_table(agg))
        step = agg.get("driver/step")
        if step:
            print(f"\n{step['count']} driver steps: step (ms) "
                  f"{step['mean_us'] / 1e3:.2f} a step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
