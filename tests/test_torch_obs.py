"""The port's observability package (``repro_torch.obs``) on the CPU: the
single-process cases of ``tests/test_obs.py`` on the port (tracer ring and
export schema, no-op spans, thread tracks, stager span order, the metrics
registry and its warn-once overflow watch, driver spans at depth 0 and 1,
fenced losses equal to unfenced ones, the stage profile and the report
round trip, the serving loop's virtual-clock lanes, rank-trace merging),
the port's own layer spans (every layer boundary of a ``SyncDriver`` step,
their parents and steps, the same names as ``torch.profiler`` ranges with
no tracer, one clock with the profiler, nothing opened with both off) and
its report's per-step ``step (ms)`` and self time, plus cross-checks
against ``repro``:

  * a trace the port exports passes ``repro.obs.trace.validate_trace``;
  * ``repro.obs.report`` and ``repro_torch.obs.report`` give the same
    shares and span totals for the same trace file, and the port's
    ``step (ms)`` is ``repro``'s over the profiled steps;
  * the port's driver, executor and serving spans carry ``repro``'s names
    and cats for the same runs, besides the port's own layer spans
    (cat ``step``).

The two-rank fleet trace waits for the multi-rank executor.
"""
import json
import threading

import numpy as np
import jax
import pytest
import torch

from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.obs import report as j_report
from repro.obs import trace as j_trace
from repro.optim import init_opt_state as j_opt
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.models.gnn import (GNNConfig, gnn_loss, init_gnn_params,
                                    params_from_numpy)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as t_report
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import STAGES, profile_stages
from repro_torch.obs.report import (render_share_table, span_summary,
                                    stage_shares)
from repro_torch.obs.trace import Tracer, merge_traces, validate_trace
from repro_torch.optim import init_opt_state
from repro_torch.pipeline import Pipeline, PipelineSpec, PlanSpec
from repro_torch.pipeline.specs import PrefetchSpec, SamplerSpec

P_ = 4
DATA = dict(source="powerlaw(1.8)", num_nodes=1200, avg_degree=6,
            num_features=8, num_classes=4, seed=0)
FANOUTS = (3, 3)


def _cfg(pkg=GNNConfig):
    return pkg(in_dim=8, hidden_dim=8, num_classes=4, num_layers=2,
               fanouts=FANOUTS, dropout=0.0)


@pytest.fixture(scope="module")
def world():
    """(a P = 4 port pipeline on the CPU, config, params carried over from
    ``repro``'s init, repro params)."""
    base = Pipeline.build_from_source(spec=PipelineSpec.from_scheme(
        "hybrid", num_parts=P_, fanouts=FANOUTS, data=TDataSpec(**DATA)),
        device="cpu")
    jparams = j_init(jax.random.key(1), _cfg(JConfig))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return base, _cfg(), params, jparams


def _spec(scheme="hybrid", depth=0, store="exchange", **prefetch_kw):
    return PipelineSpec(
        plan=PlanSpec(num_parts=P_, scheme=scheme, feature_store=store),
        sampler=SamplerSpec(fanouts=FANOUTS, backend="reference"),
        prefetch=PrefetchSpec(depth=depth, **prefetch_kw))


def _loss_fn(cfg):
    def loss_fn(p, mfgs, h_src, labels, valid):
        return gnn_loss(p, mfgs, h_src, labels, valid, cfg)
    return loss_fn


def _pipe(world, **kw):
    return Pipeline.from_layout(world[0].layout, _spec(**kw), device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test leaves both packages' global tracers uninstalled."""
    yield
    obs_trace.stop(export=False)
    j_trace.stop(export=False)


def _xs(tracer):
    return [e for e in tracer.events() if e["ph"] == "X"]


# --------------------------------------------------------------------------
# tracer core
# --------------------------------------------------------------------------

def test_tracer_records_spans_with_cat_and_args():
    t = Tracer(capacity=16)
    with t.span("outer", cat="driver", step=3):
        with t.span("inner", cat="driver"):
            pass
    assert t.num_recorded == 2 and t.dropped == 0
    evs = _xs(t)
    # inner closes first: ring order is completion order
    assert [e["name"] for e in evs] == ["inner", "outer"]
    inner, outer = evs
    assert outer["cat"] == "driver" and outer["args"] == {"step": 3, "id": 1}
    # the inner span names its parent and inherits its step
    assert inner["args"] == {"id": 2, "parent": 1, "step": 3}
    assert outer["dur"] >= inner["dur"]


def test_tracer_ring_wraps_and_counts_drops(tmp_path):
    t = Tracer(capacity=4)
    for i in range(7):
        with t.span(f"s{i}"):
            pass
    assert t.num_recorded == 4 and t.dropped == 3
    assert [e["name"] for e in _xs(t)] == ["s3", "s4", "s5", "s6"]
    meta = [e for e in t.events() if e["name"] == "trace_ring_dropped"]
    assert meta and meta[0]["args"]["dropped"] == 3
    path = tmp_path / "wrap.json"
    n = t.export(str(path))
    assert validate_trace(str(path)) == n
    assert j_trace.validate_trace(str(path)) == n


class _RangeCount:
    """Stands in for ``torch.profiler.record_function``: counts the ranges
    opened."""

    opened: list = []

    def __init__(self, name):
        self.opened.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def range_count(monkeypatch):
    _RangeCount.opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _RangeCount)
    return _RangeCount.opened


def test_module_level_span_is_noop_when_off(range_count):
    assert obs_trace.active_tracer() is None
    assert not torch.autograd.profiler._is_profiler_enabled
    assert obs_trace.span("ignored", cat="driver", step=1) \
        is obs_trace._NULL_SPAN
    with obs_trace.span("ignored", cat="driver") as sp:
        sp.add_args(rounds=2)                    # must not raise
    assert range_count == []                     # no profiler range
    x = torch.ones(3)
    assert obs_trace.fence(42) == 42             # unfenced: identity
    assert obs_trace.fence(x) is x
    t = obs_trace.start(None, fenced=True)
    assert obs_trace.fenced()
    # fenced, CPU tensors (and anything else) pass through untouched
    assert obs_trace.fence({"a": [x, (x, 1)]})["a"][0] is x
    with obs_trace.span("seen"):
        pass
    assert obs_trace.stop(export=False) is t
    assert t.num_recorded == 1
    assert not obs_trace.fenced()
    assert range_count == []
    # the control: while the profiler records, the same call opens one
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs_trace.span("ranged", cat="driver"):
            pass
    assert range_count == ["ranged"]


def test_threads_get_their_own_tracks():
    t = Tracer()
    done = threading.Event()

    def worker():
        with t.span("worker-span"):
            done.wait(1.0)

    th = threading.Thread(target=worker, name="stager-test")
    th.start()
    with t.span("main-span"):
        pass
    done.set()
    th.join()
    evs = {e["name"]: e for e in _xs(t)}
    assert evs["worker-span"]["tid"] != evs["main-span"]["tid"]
    tnames = {e["args"]["name"] for e in t.events()
              if e["name"] == "thread_name"}
    assert "stager-test" in tnames


# --------------------------------------------------------------------------
# the step's layer spans, the profiler's ranges and its clock
# --------------------------------------------------------------------------

#: a SyncDriver step's spans at P = 4, with their counts
SYNC_STEP_SPANS = {"driver/step": 1, "driver/seeds": 1, "seeds/draw": 1,
                   "seeds/h2d": 1, "driver/train_step": 1, "step/sample": 1,
                   "step/fetch": 1, "model/forward": P_,
                   "model/backward": P_, "step/grad_mean": 1,
                   "step/update": 1}


def _sync_steps(world, steps=2):
    _, cfg, params, _ = world
    with _pipe(world).train_driver(_loss_fn(cfg), batch=8, lr=0.01,
                                   device="cpu") as d:
        p, opt = params, init_opt_state(params)
        for k in range(steps):
            p, opt, _, _ = d.step(p, opt, k)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns())
            for e in prof.profiler.kineto_results.events()]


def test_sync_driver_spans_every_layer_boundary(world):
    tracer = obs_trace.start(None)
    _sync_steps(world)
    obs_trace.stop(export=False)
    evs = _xs(tracer)
    assert len(evs) == 2 * sum(SYNC_STEP_SPANS.values())
    by_id = {e["args"]["id"]: e for e in evs}
    for k in (0, 1):
        mine = [e for e in evs if e["args"]["step"] == k]
        names = [e["name"] for e in mine]
        assert {n: names.count(n) for n in set(names)} == SYNC_STEP_SPANS
        (root,) = [e for e in mine if e["name"] == "driver/step"]
        assert "parent" not in root["args"]
        for e in mine:
            # every span nests under its step's driver/step, on one thread
            chain = e
            while "parent" in chain["args"]:
                up = by_id[chain["args"]["parent"]]
                assert up["tid"] == chain["tid"]
                assert up["ts"] <= chain["ts"] and \
                    chain["ts"] + chain["dur"] <= up["ts"] + up["dur"] + 1e-3
                chain = up
            assert chain is root
        cats = {e["name"]: e["cat"] for e in mine}
        assert {n for n, c in cats.items() if c == "step"} == \
            set(SYNC_STEP_SPANS) - {"driver/step", "driver/seeds",
                                    "driver/train_step"}
        # the layer spans' parents: the driver spans that run them
        parent = {e["name"]: by_id[e["args"]["parent"]]["name"]
                  for e in mine if "parent" in e["args"]}
        assert parent["seeds/draw"] == parent["seeds/h2d"] == "driver/seeds"
        for name in ("step/sample", "step/fetch", "model/forward",
                     "model/backward", "step/grad_mean", "step/update"):
            assert parent[name] == "driver/train_step"
        workers = [e["args"]["worker"] for e in mine
                   if e["name"] == "model/forward"]
        assert workers == list(range(P_))
        sample = next(e for e in mine if e["name"] == "step/sample")
        fetch = next(e for e in mine if e["name"] == "step/fetch")
        # hybrid: no sampling round, the two feature rounds
        assert (sample["args"]["rounds"], fetch["args"]["rounds"]) == (0, 2)
        assert sample["ts"] + sample["dur"] <= fetch["ts"]
        draw = next(e for e in mine if e["name"] == "seeds/draw")
        assert draw["args"]["seeds"] == P_ * 8
        assert draw["args"]["keys"] == P_ * world[0].layout.n_max


def test_gatv1_step_spans_its_attention_per_layer_and_worker(world):
    """A gatv1 step opens ``model/gat_attention`` once a layer and worker,
    inside that worker's ``model/forward``, with the layer, its edge slots,
    its heads and the rows of the table it reads; it is the tracer's alone,
    no profiler range, so the card's idle gaps inside it keep the name
    ``model/forward``."""
    base, _, _, _ = world
    cfg = GNNConfig(in_dim=8, hidden_dim=8, num_classes=4, num_layers=2,
                    fanouts=FANOUTS, dropout=0.5, conv="gatv1", gat_heads=4)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)

    def loss_fn(p, mfgs, h_src, labels, valid):
        return gnn_loss(p, mfgs, h_src, labels, valid, cfg, generator=gen)

    def step():
        with _pipe(world).train_driver(loss_fn, batch=8, lr=0.01,
                                       device="cpu") as d:
            d.step(params, init_opt_state(params), 0)

    tracer = obs_trace.start(None)
    ranges = {n for n, _ in _profiled(step)}
    obs_trace.stop(export=False)
    assert "model/forward" in ranges and "model/gat_attention" not in ranges
    evs = _xs(tracer)
    by_id = {e["args"]["id"]: e for e in evs}
    att = [e for e in evs if e["name"] == "model/gat_attention"]
    assert len(att) == cfg.num_layers * P_
    forwards = [by_id[e["args"]["parent"]] for e in att]
    assert {f["name"] for f in forwards} == {"model/forward"}
    # per worker, its layers in order; edge slots: the level's S * F
    assert [(f["args"]["worker"], e["args"]["layer"])
            for f, e in zip(forwards, att)] == [
        (w, layer) for w in range(P_) for layer in range(cfg.num_layers)]
    S = [8 * (1 + FANOUTS[0]), 8]           # bottom level first
    assert [e["args"]["edges"] for e in att] == \
        [s * f for s, f in zip(S, FANOUTS[::-1])] * P_
    # the table the attention reads: the level's S + S * F sources
    assert [e["args"]["table_rows"] for e in att] == \
        [s * (1 + f) for s, f in zip(S, FANOUTS[::-1])] * P_
    assert {e["args"]["heads"] for e in att} == {4}
    assert {e["cat"] for e in att} == {"step"}


def test_sync_driver_spans_are_profiler_ranges_without_a_tracer(world):
    assert obs_trace.active_tracer() is None
    names = [n for n, _ in _profiled(lambda: _sync_steps(world))]
    assert obs_trace.active_tracer() is None
    for name, count in SYNC_STEP_SPANS.items():
        assert names.count(name) == 2 * count, name


def test_tracer_and_profiler_share_one_clock():
    tracer = Tracer()

    def spans():
        with tracer.span("warmup"):
            pass
        for i in range(3):
            with tracer.span(f"probe{i}"):
                sum(range(1000))
    host = dict(_profiled(spans))
    evs = tracer.events()
    (origin,) = [e["args"]["unix_ns"] for e in evs
                 if e["name"] == "clock_origin"]
    probes = [e for e in evs if e["ph"] == "X"
              and e["name"].startswith("probe")]
    assert len(probes) == 3
    for e in probes:
        assert abs(origin + e["ts"] * 1e3 - host[e["name"]]) < 1e5


def test_sync_driver_step_with_both_off_opens_and_records_nothing(
        world, range_count):
    assert obs_trace.active_tracer() is None
    _sync_steps(world, steps=1)
    assert range_count == []


# --------------------------------------------------------------------------
# stager integration: worker-thread spans, in order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["exchange", "staged"])
def test_stager_thread_spans_land_in_order(world, store):
    from repro_torch.pipeline.prefetch import SeedStream
    from repro_torch.pipeline.staging import FeatureStager, SeedStager

    pipe = _pipe(world, depth=1, store=store)
    tracer = obs_trace.start(None)
    stream = SeedStream(pipe, batch=8)
    stager = (FeatureStager(stream, pipeline=pipe, depth=1, lead=2)
              if store == "staged" else
              SeedStager(stream, depth=1, lead=2))
    with stager:
        for k in range(4):
            stager.get(k)
    obs_trace.stop(export=False)
    evs = _xs(tracer)
    produces = [e for e in evs if e["name"] == "stager/produce"]
    assert len(produces) >= 4
    # all on the stager thread's track, one track only
    assert len({e["tid"] for e in produces}) == 1
    main_gets = [e for e in evs if e["name"] == "stager/get"]
    assert main_gets and all(e["tid"] != produces[0]["tid"]
                             for e in main_gets)
    # the thread annotates its own timeline in step order
    steps = [e["args"]["step"] for e in produces]
    assert steps == sorted(steps)
    ts = [e["ts"] for e in produces]
    assert ts == sorted(ts)
    kids = {e["name"] for e in evs if e["tid"] == produces[0]["tid"]}
    want = {"stager/seeds_host", "stager/h2d"}
    if store == "staged":
        want |= {"stager/frontier_replay", "stager/gather_rows"}
    assert want <= kids
    # the stager's draw is the program's own seed draw, traced as such
    # under the stager's span, on its track
    by_id = {e["args"]["id"]: e for e in evs}
    draws = [e for e in evs if e["name"] == "seeds/draw"]
    assert len(draws) == len(produces)
    for e in draws:
        assert e["cat"] == "step" and e["tid"] == produces[0]["tid"]
        assert by_id[e["args"]["parent"]]["name"] == "stager/seeds_host"
    assert all(e["cat"] == "stager" for e in evs if e not in draws)


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("bytes").add(10)
    reg.counter("bytes").add(5)
    reg.gauge("hit_rate").set(0.25)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.histogram("lat").observe(v)
    snap = reg.snapshot()
    assert snap["bytes"] == 15
    assert snap["hit_rate"] == 0.25
    assert snap["lat"]["count"] == 4 and snap["lat"]["mean"] == 2.5
    with pytest.raises(ValueError):
        reg.counter("bytes").add(-1)             # counters are monotonic
    with pytest.raises(TypeError):
        reg.gauge("bytes")                       # name/type conflict


def test_registry_delta_semantics():
    reg = MetricsRegistry()
    reg.counter("c").add(3)
    since = reg.snapshot()
    reg.counter("c").add(4)
    reg.gauge("g").set(7.0)
    d = reg.delta(since)
    assert d["c"] == 4                           # counter: difference
    assert d["g"] == 7.0                         # gauge: current value


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_observe_step_absorbs_and_warns_once(kind):
    """Step metrics as numpy scalars or as the tensors the port's steps
    return."""
    wrap = np.float32 if kind == "numpy" else torch.tensor
    reg = MetricsRegistry()
    clean = {"sampling_utilized_bytes": wrap(100.0),
             "feature_utilized_bytes": wrap(200.0),
             "cache_hit_rate": wrap(0.5),
             "sampler_window_overflow": wrap(0.0)}
    reg.observe_step(clean, step=0)
    snap = reg.snapshot()
    assert snap["feature_utilized_bytes"] == 200.0
    assert snap["steps_observed"] == 1

    bad = dict(clean, sampler_window_overflow=wrap(9.0))
    bad["sampler_window_overflow_per_level"] = (
        np.asarray([2.0, 7.0]) if kind == "numpy"
        else torch.tensor([2.0, 7.0]))
    with pytest.warns(RuntimeWarning) as rec:
        reg.observe_step(bad, step=3)
    msg = str(rec[0].message)
    assert "worst level 1" in msg and "7" in msg and "step 3" in msg
    # ...and only once per registry, however often overflow recurs
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("error")
        reg.observe_step(bad, step=4)
    assert reg.snapshot()["sampler_window_overflow"] == 18.0


def test_median_wall_syncs_and_feeds_histogram():
    reg = MetricsRegistry()
    calls = []
    dt = obs_metrics.median_wall(lambda: calls.append(1), warmup=1,
                                 iters=3, histogram=reg.histogram("t"),
                                 sync=obs_trace.synchronize)
    assert dt >= 0 and len(calls) == 4
    assert reg.snapshot()["t"]["count"] == 3


def test_time_driver_times_the_driver(world):
    _, cfg, params, _ = world
    pipe = _pipe(world, depth=1)
    reg = MetricsRegistry()
    with pipe.train_driver(_loss_fn(cfg), batch=8, lr=0.01,
                          device="cpu") as driver:
        per_step, metrics = obs_metrics.time_driver(
            driver, params, init_opt_state(params), steps=2, repeats=2,
            registry=reg)
    assert per_step > 0 and "cache_hit_rate" in metrics
    assert reg.snapshot()["driver_step_s"]["count"] == 1


# --------------------------------------------------------------------------
# driver + profiler + report integration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_driver_steps_are_traced(world, depth):
    _, cfg, params, _ = world
    pipe = _pipe(world, depth=depth)
    tracer = obs_trace.start(None)
    with pipe.train_driver(_loss_fn(cfg), batch=8, lr=0.01,
                          device="cpu") as driver:
        opt = init_opt_state(params)
        p = params
        for k in range(3):
            p, opt, loss, _ = driver.step(p, opt, k)
    obs_trace.stop(export=False)
    evs = _xs(tracer)
    steps = [e for e in evs if e["name"] == "driver/step"]
    assert len(steps) == 3
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    assert all(e["cat"] == "driver" for e in steps)
    names = {e["name"] for e in evs}
    if depth == 0:
        assert "driver/train_step" in names
    else:
        assert {"prefetch/prepare", "prefetch/consume",
                "driver/warmup", "driver/runner_step"} <= names
    # live spans never use the report's fenced stage cats
    assert not any(e.get("cat") in STAGES for e in evs)


def test_fenced_driver_matches_unfenced_losses(world):
    _, cfg, params, _ = world
    pipe = _pipe(world, depth=1)

    def run():
        with pipe.train_driver(_loss_fn(cfg), batch=8, lr=0.01,
                          device="cpu") as d:
            p, opt = params, init_opt_state(params)
            out = []
            for k in range(3):
                p, opt, loss, _ = d.step(p, opt, k)
                out.append(float(loss))
            return out

    base = run()
    obs_trace.start(None, fenced=True)
    fenced = run()
    obs_trace.stop(export=False)
    assert fenced == base          # fencing changes timing, not results


def test_profile_stages_share_and_report_round_trip(world, tmp_path):
    _, cfg, params, _ = world
    pipe = _pipe(world)
    path = tmp_path / "stages.json"
    obs_trace.start(str(path), fenced=True)
    prof = profile_stages(pipe, _loss_fn(cfg), params, batch=8, steps=2,
                          warmup=1, arm="hybrid")
    obs_trace.stop()
    assert set(prof["share"]) == set(STAGES)
    assert all(v > 0 for v in prof["share"].values())
    assert abs(sum(prof["share"].values()) - 1.0) < 1e-9
    assert prof["step_s"] == pytest.approx(
        prof["sampling_s"] + prof["feature_s"] + prof["compute_s"])

    validate_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    groups = stage_shares(trace)
    assert list(groups) == ["hybrid"]
    g = groups["hybrid"]
    assert g["spans"] == 2 * len(STAGES)
    for st in STAGES:
        assert g["share"][st] == pytest.approx(prof["share"][st],
                                               abs=0.25)
    table = render_share_table(groups)
    assert "| hybrid |" in table and "sampling" in table
    summary = span_summary(trace)
    assert summary["profile/sampling"]["count"] == 2


def test_profile_stages_leaves_the_round_counter_alone(world):
    _, cfg, params, _ = world
    pipe = _pipe(world, scheme="vanilla")
    before = pipe.counter.rounds
    profile_stages(pipe, _loss_fn(cfg), params, batch=8, steps=1,
                   warmup=0)
    assert pipe.counter.rounds == before


def test_profile_stages_rejects_external_row_stores(world):
    _, cfg, params, _ = world
    pipe = _pipe(world, depth=1, store="staged")
    with pytest.raises(ValueError, match="staged"):
        profile_stages(pipe, _loss_fn(cfg), params, batch=8)


def _x(name, ts, dur, cat=None, **args):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 0,
          "tid": 0, "args": args}
    if cat:
        ev["cat"] = cat
    return ev


def test_report_step_ms_is_one_profiled_step():
    trace = {"traceEvents": [
        _x("profile/sampling", 100 * k, 30, "sampling", arm="a")
        for k in range(2)] + [
        _x("profile/compute", 100 * k + 30, 70, "compute", arm="a")
        for k in range(2)]}
    g = stage_shares(trace)["a"]
    assert (g["steps"], g["spans"]) == (2, 4)
    assert g["step_us"] == pytest.approx(100.0)
    assert g["share"]["sampling"] == pytest.approx(0.3)
    row = render_share_table(stage_shares(trace)).splitlines()[-1]
    assert row == "| a | 30.0% | 0.0% | 70.0% | 0.10 | 4 |"


def test_report_self_time_leaves_out_the_children():
    trace = {"traceEvents": [
        _x("parent", 0, 100, id=1), _x("child", 20, 60, id=2, parent=1),
        _x("parent", 0, 100, pid_other=True, id=1),
        _x("plain", 0, 50)]}
    trace["traceEvents"][2]["pid"] = 1        # another process's id 1
    agg = span_summary(trace)
    assert agg["parent"]["self_us"] == pytest.approx(40.0 + 100.0)
    assert agg["child"]["self_us"] == pytest.approx(60.0)
    assert agg["plain"]["self_us"] == pytest.approx(50.0)
    table = t_report.render_summary_table(agg)
    assert "| span | count | total (ms) | self (ms) | mean (us) |" in table
    assert "| parent | 2 | 0.20 | 0.14 | 100.0 |" in table


def test_trainer_context_manager_feeds_the_registry(world):
    from repro_torch.train.loop import GNNTrainer
    base, cfg, _, _ = world
    reg = MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    try:
        with GNNTrainer(base.layout, cfg, scheme="hybrid",
                        batch_per_worker=8, prefetch_depth=1,
                        device="cpu") as tr:
            out = tr.run_epoch(0, steps_per_epoch=2)
            assert np.isfinite(out["loss"])
    finally:
        obs_metrics.set_registry(prev)
    snap = reg.snapshot()
    assert snap["steps_observed"] == 2
    assert snap["feature_utilized_bytes"] > 0


# --------------------------------------------------------------------------
# serve: virtual-clock request lanes
# --------------------------------------------------------------------------

def test_serve_emits_virtual_clock_lanes(world):
    from repro_torch.serve import GNNServer, Predictor
    from repro_torch.serve.server import SERVE_VPID

    _, cfg, params, _ = world
    predictor = Predictor(_pipe(world), params, cfg, buckets=(1, 4),
                          device="cpu")
    tracer = obs_trace.start(None)
    server = GNNServer(predictor, buckets=(1, 4), max_delay=1e-3,
                       device="cpu")
    arrivals = [(0.000, 3), (0.0005, 9), (0.002, 11)]
    stats = server.run(arrivals, warmup=True)
    obs_trace.stop(export=False)
    assert stats.num_requests == 3
    evs = tracer.events()
    lanes = [e for e in evs if e["ph"] == "X" and e["pid"] == SERVE_VPID]
    assert {"serve/queue_wait", "serve/batch_delay",
            "serve/service"} <= {e["name"] for e in lanes}
    # one lane (tid) per request, in arrival order
    waits = sorted((e for e in lanes if e["name"] == "serve/queue_wait"),
                   key=lambda e: e["tid"])
    assert [e["tid"] for e in waits] == [0, 1, 2]
    assert all(e["dur"] >= 0 for e in lanes)
    # real-clock predict spans live on the real process, not the lanes
    predicts = [e for e in evs if e["ph"] == "X"
                and e["name"] == "serve/predict"]
    assert predicts and all(e["pid"] != SERVE_VPID for e in predicts)
    procs = {e["pid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert "virtual clock" in procs[SERVE_VPID]


def test_serve_lanes_mark_recycled_hits(world):
    from repro_torch.serve import GNNServer, Predictor, RecyclingCache
    from repro_torch.serve.server import SERVE_VPID

    _, cfg, params, _ = world
    predictor = Predictor(_pipe(world), params, cfg, buckets=(1, 4),
                          device="cpu")
    tracer = obs_trace.start(None)
    server = GNNServer(predictor, max_delay=0.0, device="cpu",
                       recycler=RecyclingCache(capacity=16, tau=8, rho=1.0))
    stats = server.run([(0.0, 5), (0.01, 5), (0.02, 5)], warmup=False)
    obs_trace.stop(export=False)
    hits = [e for e in _xs(tracer) if e["name"] == "serve/recycled_hit"]
    assert stats.num_recycled == len(hits) > 0
    assert all(e["pid"] == SERVE_VPID for e in hits)


# --------------------------------------------------------------------------
# merging rank traces
# --------------------------------------------------------------------------

def _rank_trace(path, pid, spans, virtual_pid=None):
    t = Tracer(pid=pid, process_name=f"worker{pid}")
    for name in spans:
        with t.span(name, cat="driver"):
            pass
    if virtual_pid is not None:
        t.name_process(virtual_pid, "lanes")
        t.event("lane", 0.0, 1e-3, tid=0, pid=virtual_pid, cat="serve")
    t.export(str(path))


def test_merge_traces_rank_as_pid(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    _rank_trace(a, pid=0, spans=["driver/step"], virtual_pid=100)
    _rank_trace(b, pid=0, spans=["driver/step", "driver/seeds"])
    out = tmp_path / "fleet.json"
    merged = merge_traces([str(a), str(b)], str(out))
    validate_trace(str(out))
    xs = [e for e in merged["traceEvents"] if e["ph"] == "X"]
    by_pid = {}
    for e in xs:
        by_pid.setdefault(e["pid"], []).append(e["name"])
    # rank files' primary pids remapped to 0 and 1
    assert by_pid[0] == ["driver/step"]
    assert sorted(by_pid[1][:2]) == ["driver/seeds", "driver/step"]
    # rank 0's virtual pid 100 shifted into a rank-unique range >= 2
    (vpid,) = [p for p in by_pid if p not in (0, 1)]
    assert vpid >= 2 and by_pid[vpid] == ["lane"]
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"rank0", "rank1", "lanes"} <= names
    # the same merge by repro's function gives the same events
    ref = j_trace.merge_traces([str(a), str(b)], None)
    assert ref["traceEvents"] == merged["traceEvents"]


def test_merge_traces_rejects_corrupt_rank_file(tmp_path):
    good, bad = tmp_path / "g.json", tmp_path / "b.json"
    _rank_trace(good, pid=0, spans=["driver/step"])
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    with pytest.raises(ValueError, match="name"):
        merge_traces([str(good), str(bad)], None)


# --------------------------------------------------------------------------
# against repro
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_profile(world, tmp_path_factory):
    """A trace file the port exported: profile spans under two arms plus a
    traced depth-1 driver run."""
    _, cfg, params, _ = world
    path = tmp_path_factory.mktemp("obs") / "port.json"
    obs_trace.start(str(path), fenced=True)
    try:
        for arm, scheme in (("hybrid", "hybrid"), ("vanilla", "vanilla")):
            profile_stages(_pipe(world, scheme=scheme), _loss_fn(cfg),
                           params, batch=8, steps=2, warmup=1, arm=arm)
        with _pipe(world, depth=1).train_driver(
                _loss_fn(cfg), batch=8, lr=0.01, device="cpu") as d:
            p, opt = params, init_opt_state(params)
            for k in range(2):
                p, opt, _, _ = d.step(p, opt, k)
    finally:
        obs_trace.stop()
    return str(path)


def test_port_trace_passes_repro_validate_trace(traced_profile):
    n = validate_trace(traced_profile)
    assert n > 0 and j_trace.validate_trace(traced_profile) == n


def test_reports_agree_with_repro_on_one_trace(traced_profile, capsys):
    """The same shares and span totals; the port's ``step (ms)`` is one
    profiled step, ``repro``'s the sum over them, and the port's summary
    adds self time."""
    ours, theirs = (t_report.stage_shares(traced_profile),
                    j_report.stage_shares(traced_profile))
    assert sorted(ours) == sorted(theirs) == ["hybrid", "vanilla"]
    for arm, g in ours.items():
        assert g["steps"] == 2
        for key, value in theirs[arm].items():
            if key == "step_us":
                assert g[key] == pytest.approx(value / g["steps"])
            else:
                assert g[key] == value, key
    agg, jagg = (t_report.span_summary(traced_profile),
                 j_report.span_summary(traced_profile))
    assert sorted(agg) == sorted(jagg)
    for name, a in jagg.items():
        assert {k: agg[name][k] for k in a} == a, name
        assert 0 <= agg[name]["self_us"] <= a["total_us"] + 1e-6
    # a fenced driver step's self time is what its spans leave uncovered
    assert agg["driver/step"]["self_us"] < agg["driver/step"]["total_us"]
    outs = []
    for mod in (t_report, j_report):
        assert mod.main([traced_profile, "--summary"]) == 0
        outs.append(capsys.readouterr().out)
    for out in outs:
        assert "| hybrid |" in out and "## Span summary" in out
    assert "| self (ms) |" in outs[0] and "| self (ms) |" not in outs[1]


def _names_cats(tracer):
    return sorted({(e["name"], e.get("cat")) for e in tracer.events()
                   if e["ph"] == "X"})


def _without_own_spans(pairs):
    """The (name, cat) pairs less the port's own layer spans: cat
    ``step`` (``seeds/*``, ``step/*``, ``model/*``), which ``repro`` does
    not record."""
    assert all(cat == "step" for name, cat in pairs
               if name.split("/")[0] in ("seeds", "step", "model"))
    return [(name, cat) for name, cat in pairs if cat != "step"]


@pytest.mark.parametrize("depth,staging", [(0, False), (1, True)],
                         ids=["sync", "double_buffer-staging"])
def test_driver_span_names_and_cats_match_repro(world, depth, staging):
    """The same 2-step driver run in both packages records the same set of
    (span name, cat) pairs, besides the port's own layer spans."""
    base, cfg, params, jparams = world
    tpipe = Pipeline.from_layout(base.layout, _spec(depth=depth,
                                                    staging=staging),
                                 device="cpu")
    jpipe = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "hybrid", num_parts=P_, fanouts=FANOUTS, prefetch_depth=depth,
        staging=staging, data=JDataSpec(**DATA)))
    jcfg = _cfg(JConfig)

    def j_loss_fn(p, mfgs, h, y, v):
        return j_loss(p, mfgs, h, y, v, jcfg)

    runs = {}
    for name, pipe, loss_fn, p, opt, mod, kw in (
            ("port", tpipe, _loss_fn(cfg), params, init_opt_state(params),
             obs_trace, {"device": "cpu"}),
            ("repro", jpipe, j_loss_fn, jparams,
             j_opt(jparams, kind="adamw"), j_trace, {})):
        tracer = mod.start(None)
        try:
            with pipe.train_driver(loss_fn, batch=8, lr=0.01,
                                   **kw) as d:
                for k in range(2):
                    p, opt, _, _ = d.step(p, opt, k)
        finally:
            mod.stop(export=False)
        runs[name] = _names_cats(tracer)
    assert ("step/update", "step") in runs["port"]
    assert _without_own_spans(runs["port"]) == runs["repro"]


def test_serve_span_names_and_cats_match_repro(world):
    """The same arrivals through both packages' ``GNNServer`` record the
    same set of (span name, cat) pairs, lanes and predict spans alike,
    besides the port's own layer spans (the prepare half's)."""
    from repro.serve import GNNServer as JServer
    from repro.serve import Predictor as JPredictor
    from repro_torch.serve import GNNServer, Predictor

    _, cfg, params, jparams = world
    jpipe = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "hybrid", num_parts=P_, fanouts=FANOUTS, data=JDataSpec(**DATA)))
    arrivals = [(0.000, 3), (0.0005, 9), (0.002, 11), (0.004, 3)]
    runs = {}
    for name, server, mod in (
            ("port", GNNServer(Predictor(_pipe(world), params, cfg,
                                         buckets=(1, 4), device="cpu"),
                               max_delay=1e-3, device="cpu"), obs_trace),
            ("repro", JServer(JPredictor(jpipe, jparams, _cfg(JConfig),
                                         buckets=(1, 4)),
                              max_delay=1e-3), j_trace)):
        tracer = mod.start(None)
        try:
            server.run(arrivals, warmup=True)
        finally:
            mod.stop(export=False)
        runs[name] = _names_cats(tracer)
    assert ("step/sample", "step") in runs["port"]
    assert _without_own_spans(runs["port"]) == runs["repro"]
    assert ("serve/predict", "serve") in runs["port"]
