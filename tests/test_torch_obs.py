"""The port's observability package (``repro_torch.obs``) on the CPU: the
single-process cases of ``tests/test_obs.py`` on the port (tracer ring and
export schema, no-op spans, thread tracks, stager span order, the metrics
registry and its warn-once overflow watch, driver spans at depth 0 and 1,
fenced losses equal to unfenced ones, the stage profile and the report
round trip, the serving loop's virtual-clock lanes, rank-trace merging),
plus cross-checks against ``repro``:

  * a trace the port exports passes ``repro.obs.trace.validate_trace``;
  * ``repro.obs.report`` and ``repro_torch.obs.report`` give the same share
    and summary tables for the same trace file;
  * the port's driver, executor and serving spans carry ``repro``'s names
    and cats for the same runs.

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
from repro_torch.models.gnn import GNNConfig, gnn_loss, params_from_numpy
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
    outer = evs[1]
    assert outer["cat"] == "driver" and outer["args"] == {"step": 3}
    assert outer["dur"] >= evs[0]["dur"]


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


def test_module_level_span_is_noop_when_off():
    assert obs_trace.active_tracer() is None
    with obs_trace.span("ignored", cat="driver"):
        pass                                     # must not raise
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
    assert all(e["cat"] == "stager" for e in evs)


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
    ours, theirs = (t_report.stage_shares(traced_profile),
                    j_report.stage_shares(traced_profile))
    assert sorted(ours) == ["hybrid", "vanilla"] and ours == theirs
    assert t_report.render_share_table(ours) \
        == j_report.render_share_table(theirs)
    agg = t_report.span_summary(traced_profile)
    assert agg == j_report.span_summary(traced_profile)
    assert t_report.render_summary_table(agg) \
        == j_report.render_summary_table(agg)
    outs = []
    for mod in (t_report, j_report):
        assert mod.main([traced_profile, "--summary"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "| hybrid |" in outs[0]


def _names_cats(tracer):
    return sorted({(e["name"], e.get("cat")) for e in tracer.events()
                   if e["ph"] == "X"})


@pytest.mark.parametrize("depth,staging", [(0, False), (1, True)],
                         ids=["sync", "double_buffer-staging"])
def test_driver_span_names_and_cats_match_repro(world, depth, staging):
    """The same 2-step driver run in both packages records the same set of
    (span name, cat) pairs."""
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
    assert runs["port"] == runs["repro"]


def test_serve_span_names_and_cats_match_repro(world):
    """The same arrivals through both packages' ``GNNServer`` record the
    same set of (span name, cat) pairs, lanes and predict spans alike."""
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
    assert runs["port"] == runs["repro"]
    assert ("serve/predict", "serve") in runs["port"]
