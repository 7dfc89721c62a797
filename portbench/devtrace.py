"""Reading a ``torch.profiler`` trace of the timed path: device operations,
busy time, idle gaps and what the host did in them.

The records come from the profiler's raw kineto results, as
``chip_smoke.py``'s ``device_records`` reads them (``prof.events()`` and
``key_averages()`` build slow objects).  The trace waits ``MARGIN_S`` on the
host after it starts and again before it stops, as ``chip_smoke.py``'s
``kernel_trace`` does: without the margins, traces on the card's machine
came back short of launches or empty.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

MARGIN_S = 0.1
GAP_LABELS = 200            # the longest gaps that get a host label


def short_name(name: str) -> str:
    """A device kernel's name without ``void``, namespaces' anonymous
    prefix, template arguments and parameters."""
    name = name.removeprefix("void ")
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


@contextlib.contextmanager
def traced(sync, *, host: bool, cuda: bool = True):
    """A profiler over device activity (with ``cuda``) and, with ``host``,
    the host's ops too; yields (profiler, bounds), ``bounds`` filled on
    exit with the window's (start, end) in the profiler's clock, the epoch
    in nanoseconds (``time.time_ns``), taken after a ``sync`` at each end.
    Host activity costs the traced steps time, so device-only traces give
    the busy share and host traces only label the idle gaps."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    bounds = []
    sync()
    with profile(activities=activities) as prof:
        time.sleep(MARGIN_S)
        sync()
        bounds.append(time.time_ns())
        yield prof, bounds
        sync()
        bounds.append(time.time_ns())
        time.sleep(MARGIN_S)


def _annotation(e) -> bool:
    """A user annotation (a ``record_function`` span) that the profiler
    also draws on the device's timeline: no device work of its own."""
    if e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)     # newer torch only
    return kind is not None and "annotation" in str(kind())


def records(prof, t0_ns: int, t1_ns: int) -> tuple[list, list]:
    """(device ops, host ops) of the trace that start inside [t0, t1], each
    as (name, start ns, end ns); user annotations count as host ops."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if not t0_ns <= start <= t1_ns:
            continue
        rec = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA and not _annotation(e):
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append(rec)
    return dev, host


def busy_intervals(dev: list) -> list:
    """The union of the device ops' intervals, merged and sorted."""
    spans = sorted((a, b) for _, a, b in dev)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(dev: list) -> float:
    """Seconds in which some device op ran: the union of their intervals."""
    return sum(b - a for a, b in busy_intervals(dev)) / 1e9


def idle_gaps(merged: list, t0_ns: int, t1_ns: int) -> list:
    """(start, end) of the stretches of [t0, t1] with no device op."""
    gaps, cur = [], t0_ns
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    return gaps


def label_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by what the host was doing, over the ``GAP_LABELS``
    longest gaps: the shortest host op (a span of the harness, an aten op
    or a runtime call) that covers the gap's middle, or ``python`` where
    none does."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:GAP_LABELS]
    if host:
        start = np.array([a for _, a, _ in host], np.int64)
        end = np.array([b for _, _, b in host], np.int64)
        dur = end - start
    out: dict[str, float] = {}
    for a, b in longest:
        mid = (a + b) // 2
        name = "python"
        if host:
            cover = np.flatnonzero((start <= mid) & (end >= mid))
            if cover.size:
                name = host[int(cover[np.argmin(dur[cover])])][0]
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def top(items: dict, k: int = 10) -> list:
    return [[name, v] for name, v in sorted(items.items(),
                                            key=lambda kv: -kv[1])[:k]]


def device_by_name(dev: list) -> dict:
    """Summed device seconds by short kernel name."""
    out: dict[str, float] = {}
    for name, a, b in dev:
        key = short_name(name)
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return out


def kernel_seconds(dev: list, names: tuple, launches: int) -> float | None:
    """Device seconds of the kernels ``names`` over ``launches`` launches.
    The tracer drops records now and then, never adds any: where it kept
    fewer than ``launches``, the kept ones' mean stands for each launch.
    None when it kept none."""
    kept = [(b - a) / 1e9 for name, a, b in dev if short_name(name) in names]
    if not kept or launches <= 0:
        return None
    if len(kept) >= launches:
        return sum(kept)
    return sum(kept) / len(kept) * launches
