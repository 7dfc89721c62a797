"""Low-overhead span tracing with Chrome trace-event JSON export
(counterpart of ``repro.obs.trace``; the same schema, and a superset of
its span names and cats).

Design constraints, in order:

1. **Cheap when off.**  Every instrumentation point in the pipeline
   (driver steps, the step's layer boundaries, stager produces, serve
   flushes) calls ``span(...)`` unconditionally; with no tracer installed
   and no ``torch.profiler`` recording that is one global load, one flag
   load and the shared no-op context manager: no allocation, no sync, no
   branching in callers.
2. **Cheap when on.**  A recording span is two ``perf_counter_ns`` reads
   and one tuple stored into a **preallocated ring** under a lock (spans
   are emitted a few dozen times per training step, never per edge).
   When the ring wraps, the oldest spans are dropped and counted: a trace
   never grows without bound and never reallocates on the hot path.
3. **Threads own their timelines.**  The span *stack* is thread-local,
   so the ``SeedStager``/``FeatureStager`` worker threads and the prefetch
   drivers nest spans independently; each thread becomes its own track
   (``tid``) in the exported trace, named after ``threading.Thread.name``.
4. **One clock with the device trace.**  While ``torch.profiler`` is
   recording, every span also opens a profiler range of the same name
   (``torch.profiler.record_function``), with or without a tracer, so the
   program's spans lie on the profiler's timeline beside the device's
   kernels: an idle stretch of the card can be put down to the span the
   host was in.  The range opens before the span's clock is read.  A
   tracer also reads the epoch clock (``time.time_ns``, the profiler's)
   beside its origin and exports it as ``clock_origin`` metadata, so its
   own trace can be laid over a profiler trace.  ``host_span`` is the
   one exception: a tracer's span alone, for detail inside a span whose
   range should keep naming the card's idle stretches.

Every recorded span gets an ``id``; its exported ``args`` hold ``parent``,
the id of the span enclosing it on its thread, and ``step``: its own, else
the one it inherits from its parent (``driver/step`` stamps the step
index, so every span of a driver step carries it).  ``obs.report``
computes self time from ``parent``.

Export is the Chrome trace-event format (the JSON flavour Perfetto and
``chrome://tracing`` load): complete events (``"ph": "X"``) with
microsecond timestamps relative to the tracer's start, plus
``process_name``/``thread_name``/``clock_origin`` metadata.
``merge_traces`` combines per-rank trace files into one fleet trace by
mapping rank -> ``pid``.

Fencing: spans around the step's halves measure the host's *dispatch* by
default, since CUDA kernels run asynchronously; this keeps the overlap the
drivers create.  ``start(..., fenced=True)`` opts into fencing (the
drivers call ``fence(x)`` inside their spans, which synchronizes the
streams of the CUDA tensors in ``x``): device time is then attributed to
the enclosing span, at the cost of the prepare/consume overlap (a
profiling mode, never a production default).  On CPU tensors a fence does
nothing.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_NS_PER_US = 1000.0


class _NullSpan:
    """Shared no-op context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_args(self, **args) -> None:
        """No-op: nothing records the span."""


_NULL_SPAN = _NullSpan()


class _RangeSpan:
    """A ``torch.profiler`` range alone: the span when the profiler
    records and no tracer is installed."""

    __slots__ = ("_range",)

    def __init__(self, name):
        self._range = _profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def add_args(self, **args) -> None:
        """No-op: a profiler range keeps its name only."""


class _Span:
    """One recording span: times itself between __enter__ and __exit__,
    inside a profiler range of its name while the profiler records (unless
    ``ranged`` is False)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_range",
                 "_id", "_parent", "_step", "_ranged")

    def __init__(self, tracer, name, cat, args, ranged=True):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._ranged = ranged

    def __enter__(self):
        self._range = None
        if self._ranged and _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self._name)
            self._range.__enter__()
        stack = self._tracer._stack()
        parent = stack[-1] if stack else None
        self._id = next(self._tracer._ids)
        self._parent = None if parent is None else parent._id
        args = self._args
        self._step = args["step"] if args and "step" in args else (
            None if parent is None else parent._step)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self._name, self._cat, self._t0, dur,
                             self._args, self._id, self._parent, self._step)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def add_args(self, **args) -> None:
        """Add host values known only inside the span to its ``args``."""
        self._args = dict(self._args or (), **args)


def _clock_origin(tries: int = 3) -> tuple[int, int]:
    """(monotonic ns, epoch ns) of one instant: spans are stamped on the
    monotonic clock, the profiler's events on the epoch one.  The epoch
    clock is read between two monotonic reads and the tightest of
    ``tries`` brackets kept, so that a preemption between the reads does
    not shift the pair."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix)
    return best[1], best[2]


class Tracer:
    """Preallocated-ring span recorder.

    Parameters
    ----------
    capacity : int, default 65536
        Ring slots.  When full, the oldest events are overwritten and
        counted in ``dropped`` (surfaced in the exported trace's
        metadata) — recording never reallocates or blocks.
    fenced : bool, default False
        Advertise fencing to instrumentation points (see module
        docstring).  The tracer itself never blocks;
        callers consult ``fenced`` via ``repro_torch.obs.trace.fenced()``.
    pid : int, default 0
        Process id stamped on events (ranks export with ``pid=rank``;
        ``merge_traces`` can also remap afterwards).
    process_name : str, optional
        ``process_name`` metadata for ``pid``.

    Examples
    --------
    >>> t = Tracer(capacity=16)
    >>> with t.span("step", cat="driver"):
    ...     pass
    >>> t.num_recorded
    1
    """

    def __init__(self, capacity: int = 65536, *, fenced: bool = False,
                 pid: int = 0, process_name: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.fenced = bool(fenced)
        self.pid = int(pid)
        self.process_name = process_name
        self.t_origin_ns, self.t_origin_unix_ns = _clock_origin()
        self._ids = itertools.count(1)
        self._ring: list = [None] * self.capacity
        self._count = 0                      # total ever recorded
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._thread_names: dict[int, str] = {}
        self._extra_events: list[dict] = []  # explicit-timestamp events
        self._extra_procs: dict[int, str] = {}

    # ------------------------------------------------------------ recording

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            t = threading.current_thread()
            with self._lock:
                self._thread_names[t.ident] = t.name
        return stack

    def span(self, name: str, cat: str | None = None, **args) -> _Span:
        """A context manager recording ``name`` over its ``with`` body.

        ``cat`` is the Chrome trace category (the report CLI's share
        table adds up the fenced stage cats ``sampling`` / ``feature`` /
        ``compute``; the live spans use others: ``driver``, ``step``,
        ``stager``, ``serve``, ``comm``); ``args`` become the event's
        ``args`` dict, with its ``id``, ``parent`` and ``step``.
        """
        return _Span(self, name, cat, args or None)

    def _record(self, name, cat, t0_ns, dur_ns, args, span_id, parent,
                step) -> None:
        tid = threading.current_thread().ident
        with self._lock:
            self._ring[self._count % self.capacity] = (
                name, cat, tid, t0_ns, dur_ns, args, span_id, parent, step)
            self._count += 1

    def event(self, name: str, ts_s: float, dur_s: float, *,
              tid: int = 0, pid: int | None = None,
              cat: str | None = None, args: dict | None = None) -> None:
        """Record a complete event with an explicit timeline.

        For producers whose clock is not this process's monotonic clock —
        the serving loop's virtual-clock request lanes use it (``pid``
        set to a dedicated virtual process, named via
        ``name_process``).  ``ts_s``/``dur_s`` are seconds on the
        caller's own timeline, exported as-is (microseconds)."""
        ev = {"name": name, "ph": "X", "ts": ts_s * 1e6,
              "dur": dur_s * 1e6,
              "pid": self.pid if pid is None else int(pid), "tid": int(tid)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        with self._lock:
            self._extra_events.append(ev)

    def name_process(self, pid: int, name: str) -> None:
        """Attach ``process_name`` metadata for an extra (virtual) pid."""
        with self._lock:
            self._extra_procs[int(pid)] = name

    # -------------------------------------------------------------- export

    @property
    def num_recorded(self) -> int:
        """Spans currently held in the ring (<= capacity)."""
        with self._lock:
            return min(self._count, self.capacity)

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        with self._lock:
            return max(0, self._count - self.capacity)

    def events(self) -> list[dict]:
        """The recorded events as Chrome trace-event dicts (oldest
        first), including metadata events."""
        with self._lock:
            n = min(self._count, self.capacity)
            start = self._count - n
            recs = [self._ring[(start + i) % self.capacity]
                    for i in range(n)]
            tnames = dict(self._thread_names)
            extra = list(self._extra_events)
            procs = dict(self._extra_procs)
            dropped = max(0, self._count - self.capacity)
        out = []
        pname = self.process_name or f"pid{self.pid}"
        out.append({"name": "process_name", "ph": "M", "pid": self.pid,
                    "tid": 0, "args": {"name": pname}})
        out.append({"name": "clock_origin", "ph": "M", "pid": self.pid,
                    "tid": 0, "args": {"unix_ns": self.t_origin_unix_ns}})
        for pid, name in sorted(procs.items()):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": name}})
        for tid, name in sorted(tnames.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": tid, "args": {"name": name}})
        if dropped:
            out.append({"name": "trace_ring_dropped", "ph": "M",
                        "pid": self.pid, "tid": 0,
                        "args": {"dropped": dropped}})
        for name, cat, tid, t0_ns, dur_ns, args, span_id, parent, step \
                in recs:
            ev = {"name": name, "ph": "X",
                  "ts": (t0_ns - self.t_origin_ns) / _NS_PER_US,
                  "dur": dur_ns / _NS_PER_US,
                  "pid": self.pid, "tid": tid}
            if cat:
                ev["cat"] = cat
            ev["args"] = dict(args or (), id=span_id)
            if parent is not None:
                ev["args"]["parent"] = parent
            if step is not None:
                ev["args"]["step"] = step
            out.append(ev)
        out.extend(extra)
        return out

    def export(self, path: str) -> int:
        """Write the trace as Chrome trace-event JSON; returns the event
        count (metadata included).  The file loads directly in Perfetto
        (https://ui.perfetto.dev) or ``chrome://tracing``."""
        events = self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
        return len(events)


# --------------------------------------------------------------------------
# the installed tracer (module-global; instrumentation points consult it)
# --------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def start(path: str | None = None, *, capacity: int = 65536,
          fenced: bool = False, pid: int = 0,
          process_name: str | None = None) -> Tracer:
    """Install (and return) a fresh global tracer.

    ``path`` is remembered so ``stop()`` exports there; pass ``None`` to
    manage export yourself.  Installing over an active tracer replaces
    it (the old one keeps its recorded spans but receives no new ones).
    """
    global _ACTIVE
    tracer = Tracer(capacity, fenced=fenced, pid=pid,
                    process_name=process_name)
    tracer._export_path = path
    _ACTIVE = tracer
    return tracer


def stop(export: bool = True) -> Tracer | None:
    """Uninstall the global tracer; export to its ``start(path=...)``
    destination when ``export`` and a path was given.  Returns the
    tracer (or ``None`` if none was active)."""
    global _ACTIVE
    tracer, _ACTIVE = _ACTIVE, None
    if tracer is not None and export \
            and getattr(tracer, "_export_path", None):
        tracer.export(tracer._export_path)
    return tracer


def active_tracer() -> Tracer | None:
    """The installed tracer, or ``None`` when tracing is off."""
    return _ACTIVE


def span(name: str, cat: str | None = None, **args):
    """Span on the installed tracer, inside a profiler range of the same
    name while ``torch.profiler`` records; a profiler range alone when no
    tracer is installed; the shared no-op when neither is on.  This is
    the form instrumentation points use:

    >>> with span("driver/step", cat="driver", step=3):
    ...     pass

    ``args`` hold host values only: reading a device tensor here would
    synchronize the step.  ``add_args`` on the span adds values known
    only at its end.
    """
    t = _ACTIVE
    if t is None:
        if not _profiler._is_profiler_enabled:
            return _NULL_SPAN
        return _RangeSpan(name)
    return t.span(name, cat, **args)


def host_span(name: str, cat: str | None = None, **args):
    """Span on the installed tracer that opens no profiler range; the
    shared no-op when no tracer is installed.  For detail inside another
    span whose profiler range should go on naming what the host does
    there: the card's idle stretches inside it keep the outer name."""
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, args or None, ranged=False)


def fenced() -> bool:
    """True when an installed tracer asked for fencing (honest
    device-time attribution; overlap-destroying)."""
    t = _ACTIVE
    return t is not None and t.fenced


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (tensors, dicts, lists,
    tuples and dataclasses, walked recursively)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def synchronize(x):
    """Wait until the work queued on the current stream of every CUDA
    device holding a tensor of ``x`` is done; returns ``x``.  No-op for
    CPU tensors."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.current_stream(dev).synchronize()
    return x


def fence(x):
    """``synchronize(x)`` when fencing is on; ``x`` otherwise.

    Called *inside* a span so the device time it exposes lands on that
    span.  Off (the default) the call is a no-op and spans measure
    dispatch, preserving overlap."""
    if fenced():
        synchronize(x)
    return x


# --------------------------------------------------------------------------
# schema validation + multi-rank merging
# --------------------------------------------------------------------------

def validate_trace(obj) -> int:
    """Validate Chrome trace-event JSON structure; returns the event
    count or raises ``ValueError``.

    Checks the invariants Perfetto's JSON importer relies on: a
    ``traceEvents`` list; every event a dict with a string ``name`` and
    one-char ``ph``; ``"X"`` events carry numeric ``ts`` and
    non-negative ``dur`` plus integer ``pid``/``tid``; ``"M"`` metadata
    events carry an ``args`` dict.  ``obj`` may be a parsed dict or a
    path to a JSON file.
    """
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        name, ph = ev.get("name"), ev.get("ph")
        if not isinstance(name, str) or not name:
            raise ValueError(f"event {i} missing string 'name'")
        if not isinstance(ph, str) or len(ph) != 1:
            raise ValueError(f"event {i} ({name!r}) missing 1-char 'ph'")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i} ({name!r}) missing numeric "
                                 f"'ts'")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} ({name!r}) needs 'dur' >= 0")
            for key in ("pid", "tid"):
                if not isinstance(ev.get(key), int):
                    raise ValueError(f"event {i} ({name!r}) missing int "
                                     f"{key!r}")
        elif ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"metadata event {i} ({name!r}) missing "
                                 f"'args'")
    return len(events)


def merge_traces(paths, out: str | None = None, *, pids=None,
                 names=None) -> dict:
    """Merge per-rank trace files into one fleet trace.

    Every event from ``paths[r]`` is re-stamped with ``pid = pids[r]``
    (default: ``r``) and the process is named ``names[r]`` (default
    ``"rank{r}"``), so Perfetto shows one process track group per rank
    (rank as pid).  Virtual
    pids inside a rank's trace (e.g. the serving loop's request lanes)
    are offset into a disjoint range so ranks cannot collide.

    Returns the merged trace dict; also written to ``out`` when given.
    Each input is schema-validated first, so one corrupt rank file fails
    loudly instead of producing an unloadable fleet trace.
    """
    paths = list(paths)
    pids = list(pids) if pids is not None else list(range(len(paths)))
    names = list(names) if names is not None \
        else [f"rank{r}" for r in range(len(paths))]
    if not (len(paths) == len(pids) == len(names)):
        raise ValueError("paths, pids, and names must align")
    # virtual pids (any pid != the rank trace's own primary pid) are
    # offset per rank into ranges beyond every real rank pid
    base_virtual = (max(pids) + 1) if pids else 1
    merged: list[dict] = []
    for r, (path, pid, name) in enumerate(zip(paths, pids, names)):
        with open(path) as f:
            trace = json.load(f)
        validate_trace(trace)
        events = trace["traceEvents"]
        # the rank's own pid: its first process_name metadata (the
        # exporter emits it first), falling back to the first X event
        primary = next((ev["pid"] for ev in events
                        if ev.get("ph") == "M"
                        and ev.get("name") == "process_name"
                        and "pid" in ev), None)
        if primary is None:
            primary = next((ev["pid"] for ev in events
                            if ev.get("ph") == "X" and "pid" in ev), None)
        seen_primary_meta = False
        for ev in events:
            ev = dict(ev)
            src_pid = ev.get("pid", primary)
            if primary is None or src_pid == primary:
                ev["pid"] = pid
                if ev.get("ph") == "M" \
                        and ev.get("name") == "process_name":
                    if seen_primary_meta:
                        continue
                    seen_primary_meta = True
                    ev["args"] = {"name": name}
            else:
                # keep virtual processes, shifted into a rank-unique range
                ev["pid"] = base_virtual + 1000 * r + int(src_pid)
            merged.append(ev)
        if not seen_primary_meta:
            merged.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": name}})
    trace = {"traceEvents": merged, "displayTimeUnit": "ms"}
    validate_trace(trace)
    if out is not None:
        with open(out, "w") as f:
            json.dump(trace, f)
    return trace
