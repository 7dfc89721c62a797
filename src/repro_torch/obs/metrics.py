"""Counter/gauge/histogram registry with snapshot/delta semantics
(counterpart of ``repro.obs.metrics``).

The registry absorbs the step-metric dicts the pipeline emits behind
three primitive types:

  * ``Counter``   — monotonically accumulating totals (utilized bytes,
    overflow counts, steps).  ``snapshot``/``delta`` give per-window
    readings without resetting anything.
  * ``Gauge``     — last-written values (cache hit rate, loss).
  * ``Histogram`` — bounded-reservoir distributions (step wall times)
    with count/mean/percentile summaries.

``MetricsRegistry.observe_step`` is the one call the training loop makes
per materialized step: it feeds the known metric keys into the registry
and runs the **overflow watch**: the first time
``sampler_window_overflow`` goes non-zero in a run it emits a single
``warnings.warn`` naming the offending sampler level and count.

``median_wall`` is the shared wall timer: median-of-repeats wall time of
a callable with an explicit synchronization hook, so an asynchronous
CUDA launch is not mistaken for execution (pass
``repro_torch.obs.trace.synchronize``, which waits for the streams of the
result's CUDA tensors).
"""
from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch


class Counter:
    """Monotonic accumulator (float; ``add`` negative values rejected)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, v: float = 1.0) -> None:
        v = float(v)
        if v < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (add({v}))")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value (``nan`` until first ``set``)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = float("nan")

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir distribution.

    Keeps the first ``capacity`` observations verbatim (enough for the
    step-time distributions the benches record) plus exact count/sum;
    past capacity, new observations update count/sum/min/max but are not
    stored — percentiles then describe the stored prefix, flagged by
    ``saturated`` in the summary.
    """

    __slots__ = ("name", "capacity", "_values", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self.capacity = int(capacity)
        self._values: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._values) < self.capacity:
                self._values.append(v)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._values:
                return float("nan")
            return float(np.percentile(np.asarray(self._values), q))

    def summary(self) -> dict:
        with self._lock:
            if not self._count:
                return {"count": 0}
            vals = np.asarray(self._values)
            return {"count": self._count,
                    "mean": self._sum / self._count,
                    "min": self._min, "max": self._max,
                    "p50": float(np.percentile(vals, 50)),
                    "p99": float(np.percentile(vals, 99)),
                    "saturated": self._count > len(self._values)}


def _np(x) -> np.ndarray:
    """A metric value as a host array (a tensor is copied off its
    device; the caller has already waited for it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricsRegistry:
    """Named metric instruments + snapshot/delta + the warn-once watch.

    Examples
    --------
    >>> reg = MetricsRegistry()
    >>> reg.counter("steps").add(3)
    >>> before = reg.snapshot()
    >>> reg.counter("steps").add(2)
    >>> reg.delta(before)["steps"]
    2.0
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._warned: set[str] = set()
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, not a "
                    f"{cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """Get-or-create the counter ``name``."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the gauge ``name``."""
        return self._get(name, Gauge)

    def histogram(self, name: str, capacity: int = 4096) -> Histogram:
        """Get-or-create the histogram ``name``."""
        return self._get(name, Histogram, capacity=capacity)

    # ------------------------------------------------------ snapshot/delta

    def snapshot(self) -> dict:
        """Point-in-time reading: ``{name: value}`` for counters/gauges,
        ``{name: summary-dict}`` for histograms.  Reading never resets —
        windows come from ``delta``."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            out[name] = m.summary() if isinstance(m, Histogram) \
                else m.value
        return out

    def delta(self, since: dict) -> dict:
        """What accumulated since a previous ``snapshot()``: counter
        differences, gauges' current values, and histogram count deltas
        (``{name: {"count": n}}``).  Metrics created after ``since`` are
        reported in full."""
        now = self.snapshot()
        out = {}
        for name, val in now.items():
            prev = since.get(name)
            if isinstance(val, dict):
                out[name] = {"count": val.get("count", 0)
                             - (prev or {}).get("count", 0)}
            elif isinstance(self._metrics.get(name), Counter):
                out[name] = val - (prev if prev is not None else 0.0)
            else:
                out[name] = val
        return out

    # -------------------------------------------------------- warn-once

    def warn_once(self, key: str, message: str) -> bool:
        """Emit ``warnings.warn(message)`` the first time ``key`` is
        seen by this registry; returns True when the warning fired."""
        with self._lock:
            if key in self._warned:
                return False
            self._warned.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=3)
        return True

    # ----------------------------------------------------- step absorption

    #: step-metric keys absorbed as counters (fabric-wide totals)
    STEP_COUNTERS = ("sampling_utilized_bytes", "feature_utilized_bytes",
                     "sampler_window_overflow")
    #: step-metric keys absorbed as gauges (latest value wins)
    STEP_GAUGES = ("cache_hit_rate", "grad_norm")

    def observe_step(self, metrics: dict, *, step: int | None = None
                     ) -> None:
        """Absorb one training/inference step's metrics dict.

        Converts values to host arrays; callers invoke this where they
        already materialize step outputs (loop logging points), so no
        extra device sync is introduced.  Unknown keys are ignored;
        the overflow watch (see class docstring) runs here.
        """
        for key in self.STEP_COUNTERS:
            if key in metrics:
                self.counter(key).add(float(_np(metrics[key])))
        for key in self.STEP_GAUGES:
            if key in metrics:
                self.gauge(key).set(float(_np(metrics[key])))
        self.counter("steps_observed").add(1)
        overflow = metrics.get("sampler_window_overflow")
        if overflow is not None:
            total = float(_np(overflow))
            if total > 0:
                per_level = metrics.get("sampler_window_overflow_per_level")
                detail = ""
                if per_level is not None:
                    pl = _np(per_level).astype(np.float64)
                    lvl = int(np.argmax(pl))
                    detail = (f"; worst level {lvl} truncated "
                              f"{pl[lvl]:.0f} frontier slots "
                              f"(per-level {pl.astype(np.int64).tolist()})")
                at = "" if step is None else f" at step {step}"
                self.warn_once(
                    "sampler_window_overflow",
                    f"sampler neighbor-window overflow went non-zero"
                    f"{at}: {total:.0f} frontier slots truncated this "
                    f"step{detail}.  High-degree hubs exceed the fused "
                    f"kernel's neighbor window; raise the window or use "
                    f"an unwindowed backend if truncation bias matters "
                    f"(further overflow this run will not re-warn).")


# --------------------------------------------------------------------------
# the default registry (training loops and launchers share it)
# --------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Replace the process-wide default registry (tests isolate state
    with a fresh one); returns the previous registry."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, registry
    return prev


# --------------------------------------------------------------------------
# shared wall timers
# --------------------------------------------------------------------------

def median_wall(fn, *, warmup: int = 2, iters: int = 5, sync=None,
                histogram: Histogram | None = None) -> float:
    """Median wall-clock seconds of ``fn()`` over ``iters`` repeats.

    ``sync(result)`` runs inside the timed region (pass
    ``repro_torch.obs.trace.synchronize`` for callables that launch CUDA
    work, so dispatch is not mistaken for execution); each repeat is also
    fed to ``histogram`` when given.  The warmup repeats (kernel builds,
    ring fills) are synced but untimed.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        out = fn()
        if sync is not None:
            sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        if sync is not None:
            sync(out)
        dt = time.perf_counter() - t0
        times.append(dt)
        if histogram is not None:
            histogram.observe(dt)
    times.sort()
    return times[len(times) // 2]


def time_driver(driver, params, opt_state, *, steps: int,
                repeats: int = 4, registry: MetricsRegistry | None = None
                ) -> tuple[float, dict]:
    """Median seconds/step of a prefetch driver's training loop.

    Two warmup steps build every kernel and fill the prepared-batch queue
    and staging ring, then each repeat times ``steps`` driver steps,
    materializing the loss each step exactly like a real training loop
    does for logging; that per-step host block is what exposes any host
    segment the staging/prefetch machinery fails to hide.

    Returns ``(median_sec_per_step, last_metrics)``; observes each
    repeat into ``registry``'s ``driver_step_s`` histogram when given.
    """
    state = {"params": params, "opt": opt_state, "metrics": {}}

    def once():
        for _ in range(steps):
            state["params"], state["opt"], loss, state["metrics"] = \
                driver.step(state["params"], state["opt"])
            float(loss)

    hist = registry.histogram("driver_step_s") if registry is not None \
        else None
    # warmup by hand (two steps, not two full repeats)
    p, o, loss, m = driver.step(state["params"], state["opt"])
    p, o, loss, m = driver.step(p, o)
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    state.update(params=p, opt=o, metrics=m)
    dt = median_wall(once, warmup=0, iters=repeats)
    per_step = dt / steps
    if hist is not None:
        hist.observe(per_step)
    return per_step, state["metrics"]
