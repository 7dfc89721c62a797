"""The serving slice's recycler and the hot-set scorers and cache policy
that came with it, against ``repro`` on the CPU, and the port's
``serve_gnn`` launcher.

Held exactly (host-side numpy and Python on both sides): the recycler's
answers and stats on a fixed request and step trace, ``FrequencyTracker``
counts and top-k, ``blend(w)`` scores, and the ``frequency`` cache's ids.
Served outputs, recycled ones included, equal direct ``predict`` bit for
bit (the fixed-salt contract).
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro.core.cache import BlendScorer as JBlend
from repro.core.cache import FrequencyTracker as JTracker
from repro.core.cache import frequency_caches as j_frequency_caches
from repro.core.cache import resolve_hot_scorer as j_resolve_scorer
from repro.data.spec import DataSpec as JDataSpec
from repro.pipeline import Pipeline as JPipeline
from repro.obs.trace import validate_trace as j_validate
from repro.pipeline import PipelineSpec as JSpec
from repro.serve.recycler import RecyclingCache as JRecycler
from repro.serve.recycler import hot_set_admit as j_admit
from repro_torch.core.cache import (BlendScorer, FrequencyTracker,
                                    available_hot_scorers, frequency_caches,
                                    resolve_hot_scorer)
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.launch import serve_gnn
from repro_torch.models.gnn import GNNConfig, init_gnn_params
from repro_torch.obs import trace as t_trace
from repro_torch.obs.trace import validate_trace as t_validate
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.serve.server import SERVE_VPID
from repro_torch.serve import (GNNServer, Predictor, RecyclingCache,
                               hot_set_admit, resolve_arrival)

DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=4, seed=3)
FANOUTS = (4, 3)


@pytest.fixture(scope="module")
def pair():
    jp = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "hybrid", num_parts=2, fanouts=FANOUTS, data=JDataSpec(**DATA)))
    tp = TPipeline.build_from_source(spec=TSpec.from_scheme(
        "hybrid", num_parts=2, fanouts=FANOUTS, data=TDataSpec(**DATA)),
        device="cpu")
    return jp, tp


def _trace(seed: int):
    """A fixed request trace: (seed id, serve step) lookups, each a miss
    followed by an insert, over a skewed id range."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random(400) < 0.7, rng.integers(0, 12, 400),
                   rng.integers(0, 200, 400))
    steps = np.cumsum(rng.random(400) < 0.3)
    return list(zip(ids.tolist(), steps.tolist()))


@pytest.mark.parametrize("kw", [
    dict(capacity=8, tau=5, rho=1.0),
    dict(capacity=64, tau=2, rho=0.3),
    dict(capacity=16, tau=64, rho=0.6, admit=range(0, 12, 2)),
    dict(capacity=4, tau=0, rho=0.0)],
    ids=["lru", "rho-budget", "admission", "off"])
def test_recycling_cache_matches_repro_on_a_trace(kw):
    hot = kw.pop("admit", None)
    t = RecyclingCache(**kw, admit=hot_set_admit(hot) if hot else None)
    j = JRecycler(**kw, admit=j_admit(hot) if hot else None)
    for seed, step in _trace(1):
        a, b = t.lookup(seed, step), j.lookup(seed, step)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        else:
            row = np.full(3, seed * 10 + step, np.float32)
            t.insert(seed, row, step)
            j.insert(seed, row, step)
    assert t.stats() == j.stats()
    assert len(t) == len(j)
    with pytest.raises(ValueError, match="rho"):
        RecyclingCache(rho=1.5)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_frequency_tracker_matches_repro(decay):
    t, j = FrequencyTracker(300, decay=decay), JTracker(300, decay=decay)
    rng = np.random.default_rng(2)
    for _ in range(20):
        batch = rng.integers(-5, 310, size=rng.integers(1, 60))
        t.observe(batch)
        j.observe(batch)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.total_observed == j.total_observed
    for k in (1, 10, 300):
        np.testing.assert_array_equal(t.topk(k), j.topk(k))
    probe = [0, 5, 17, 299]
    np.testing.assert_array_equal(t.is_hot(probe, 10), j.is_hot(probe, 10))


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_blend_scores_match_repro(pair, weight):
    jp, tp = pair
    n = tp.layout.graph.num_nodes
    ids = np.random.default_rng(3).integers(0, n, size=500)
    t, j = BlendScorer(weight), JBlend(weight)
    t.scores(tp.layout.graph)
    j.scores(jp.layout.graph)
    t.observe(ids)
    j.observe(ids)
    np.testing.assert_array_equal(t.scores(tp.layout.graph),
                                  j.scores(jp.layout.graph))
    np.testing.assert_array_equal(t.top_ids(tp.layout.graph, 50),
                                  j.top_ids(jp.layout.graph, 50))
    # by registry name, with no observations: blend starts at degree order
    np.testing.assert_array_equal(
        resolve_hot_scorer(f"blend({weight})").top_ids(tp.layout.graph, 20),
        j_resolve_scorer(f"blend({weight})").top_ids(jp.layout.graph, 20))
    assert set(available_hot_scorers()) == {"blend", "degree", "frequency"}


def test_frequency_cache_ids_match_repro(pair):
    jp, tp = pair
    for cap in (32, 5000):               # 5000: more slots than accesses
        t = frequency_caches(tp.layout, cap, fanouts=FANOUTS, seed=4)
        j = j_frequency_caches(jp.layout, cap, fanouts=FANOUTS, seed=4)
        np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    with pytest.raises(ValueError, match="fanouts"):
        frequency_caches(tp.layout, 8, fanouts=None)


@pytest.mark.parametrize("salt_policy", ["fixed", "step"])
def test_server_recycles_and_matches_direct_predict(pair, salt_policy):
    _, tp = pair
    cfg = GNNConfig(in_dim=12, hidden_dim=16, num_classes=4, num_layers=2,
                    fanouts=FANOUTS, dropout=0.0)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(1), "cpu")
    pred = Predictor(tp, params, cfg, buckets=(1, 8), base_salt=3,
                     device="cpu")
    arrivals = resolve_arrival("hotset")(
        120, 2000.0, tp.layout.graph.num_nodes, seed=0, hot_k=6,
        graph=tp.layout.graph)
    recycler = RecyclingCache(capacity=32, tau=3, rho=0.5)
    server = GNNServer(pred, max_delay=1e-3, recycler=recycler,
                       salt_policy=salt_policy, device="cpu")
    stats, out = server.run(arrivals, collect_outputs=True)
    s = stats.summary()
    assert 0 < s["num_recycled"] <= 0.5 * s["num_requests"]
    assert s["recycled_fraction"] == s["num_recycled"] / 120
    assert s["recycler"] == recycler.stats()
    assert s["recycler"]["hits"] == s["num_recycled"]
    assert server.step == s["num_flushes"]
    if salt_policy == "fixed":
        direct = pred.predict([v for _, v in arrivals])
        np.testing.assert_array_equal(out, direct)
    with pytest.raises(ValueError, match="salt_policy"):
        GNNServer(pred, salt_policy="random", device="cpu")


def test_serve_gnn_launcher_serves_with_the_recycler():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve_gnn.main(["--device", "cpu", "--nodes", "800",
                              "--requests", "120", "--train-steps", "2",
                              "--recycle", "--hot-scorer", "blend(0.5)"])
    text = out.getvalue()
    assert "trained 2 steps" in text and "p50 " in text and "QPS" in text
    assert "recycler: hit-rate" in text
    assert res["summary"]["num_recycled"] > 0
    np.testing.assert_array_equal(res["outputs"],
                                  res["predictor"].predict(res["seeds"]))


@pytest.mark.parametrize("scheme", ["vanilla", "hybrid_partial(0.25)"])
def test_serve_gnn_launcher_serves_every_scheme(scheme):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve_gnn.main(["--device", "cpu", "--nodes", "800",
                              "--requests", "60", "--train-steps", "1",
                              "--scheme", scheme])
    text = out.getvalue()
    assert f"scheme={scheme}" in text and "p50 " in text
    assert res["summary"]["num_requests"] == 60
    np.testing.assert_array_equal(res["outputs"],
                                  res["predictor"].predict(res["seeds"]))


@pytest.mark.parametrize("flags", [["--trace", "t.json"]], ids=["trace"])
def test_serve_gnn_refuses_what_is_not_ported(flags, capsys, tmp_path):
    """``--trace``, refused until the observability slice, now runs: the
    launcher writes a trace that both packages' ``validate_trace`` accept,
    with the real-clock ``serve/predict`` spans and each request's
    virtual-clock lanes under ``repro``'s names and cats."""
    path = str(tmp_path / flags[1])
    res = serve_gnn.main(["--device", "cpu", "--nodes", "800",
                          "--requests", "60", "--train-steps", "1",
                          flags[0], path])
    assert f"trace written to {path}" in capsys.readouterr().out
    n = t_validate(path)
    assert n > 0 and j_validate(path) == n
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {(e["name"], e.get("cat")) for e in events if e["ph"] == "X"}
    assert {("serve/predict", "serve"), ("serve/queue_wait", "serve"),
            ("serve/batch_delay", "serve"), ("serve/service", "serve"),
            ("driver/step", "driver")} <= spans
    lanes = {e["tid"] for e in events
             if e["ph"] == "X" and e["pid"] == SERVE_VPID}
    assert lanes == set(range(res["summary"]["num_requests"]))
    assert t_trace.active_tracer() is None
