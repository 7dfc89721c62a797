"""``repro_torch.obs``: structured tracing and metrics (counterpart of
``repro.obs``).

FastSample's opening argument is a *measurement*: sampling is a large
share of a distributed step.  This package is the instrument that gives
that breakdown:

  * ``repro_torch.obs.trace``   — a low-overhead span tracer (monotonic
    clock spans in a preallocated ring, thread-local span stacks so the
    stager threads annotate their own timelines, each span's parent and
    step) exporting Chrome trace-event JSON viewable in Perfetto; while
    ``torch.profiler`` records, every span is also a profiler range of
    the same name, so the step's layers are named on the device trace's
    timeline.  Its span names and cats are a superset of ``repro``'s:
    the step's layer boundaries (``seeds/*``, ``step/*``, ``model/*``)
    are the port's own.
  * ``repro_torch.obs.metrics`` — a counter/gauge/histogram registry with
    snapshot/delta semantics absorbing the step-metric dicts the pipeline
    emits, including the warn-once sampler-overflow watch, plus the
    median-of-repeats wall timers.
  * ``repro_torch.obs.profile`` — fenced per-stage step profiling: the
    sampling / feature-fetch / model-compute split behind the paper's
    Figure 1.
  * ``repro_torch.obs.report``  — the CLI rendering that table from a
    recorded trace: ``python -m repro_torch.obs.report trace.json``.

Instrumented producers: the prefetch drivers, the executor's runner and
the step's layer boundaries (``repro_torch.pipeline``: the seed draw and
its copy, sampling, the fetch, each worker's forward and backward, the
gradient mean, the update), the staging threads and the serving loop
(``repro_torch.serve.server``).  Everything is a no-op until a tracer is
installed (``repro_torch.obs.trace.start``) or ``torch.profiler``
records: the cost of an instrumentation point with both off is one
global check and one flag check.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, get_registry,
                                     median_wall, set_registry)
from repro_torch.obs.trace import (Tracer, active_tracer,  # noqa: F401
                                   fence, fenced, merge_traces, span, start,
                                   stop, synchronize, validate_trace)

__all__ = [
    "Tracer", "active_tracer", "span", "start", "stop", "fence", "fenced",
    "synchronize", "merge_traces", "validate_trace",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "set_registry", "median_wall",
]
