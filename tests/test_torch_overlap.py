"""Overlapped training in the port: the double-buffered driver, seed and
feature staging and the ``staged`` store, on the CPU.

Port against port, bit for bit: every prefetch depth, staging on and off,
the sampling-only split and every feature store give the synchronous
driver's losses and parameters, and restarts replay the stream.  Against
``repro``: the ``"fold"`` seed stream, the host replay of the sampler
(also with the fused backend's window, which ``repro``'s replay lacks),
the seed draw, and a 3-step depth-1 loss trajectory (``repro`` jitted
under its vmap executor; losses within rtol 1e-4, for the reasons
``tests/test_torch_train.py`` gives).

Every test that starts a stager closes it (``with`` or ``finally``); a
stager's ``get`` waits at most ``staging._WAIT_S`` seconds.
"""
import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

from repro.core.partition import seeds_per_worker_host as j_seeds_host
from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.optim import optimizers as jopt
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro.pipeline.prefetch import SeedStream as JSeedStream
from repro.pipeline.staging import _frontier_src_nodes_host as j_replay
from repro_torch.core import dist as tdist
from repro_torch.core.feature_store import StagedStore
from repro_torch.core.graph import CSCGraph
from repro_torch.core.partition import seeds_per_worker_host
from repro_torch.core.sampler import sample_mfgs
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.kernels.fused_sample import MAX_DEG_WINDOW
from repro_torch.kernels.ops import fused_sample_level
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import gnn_loss, init_gnn_params
from repro_torch.models.gnn import params_from_numpy
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import optimizers as topt
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.pipeline.prefetch import (DoubleBufferDriver, SeedStream,
                                           SyncDriver, available_prefetchers,
                                           resolve_prefetcher)
from repro_torch.pipeline.specs import PrefetchSpec
from repro_torch.pipeline.staging import (FeatureStager, SeedStager,
                                          _frontier_src_nodes_host,
                                          make_stager)

DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=4, seed=3)
FANOUTS = (4, 3)
K = 64
BATCH = 16
LR = 0.006
STEPS = 4


def _cfg(pkg=TConfig):
    return pkg(in_dim=12, hidden_dim=32, num_classes=4, num_layers=2,
               fanouts=FANOUTS, dropout=0.0)


def _loss_fn(p, mfgs, h, lab, v):
    return gnn_loss(p, mfgs, h, lab, v, _cfg())


@pytest.fixture(scope="module")
def world():
    """(P = 4 port pipeline with a K-row cache and the pinned_hot store,
    initial params, the synchronous reference run (losses, params))."""
    pipe = TPipeline.build_from_source(spec=_spec(), device="cpu")
    params = init_gnn_params(_cfg(), torch.Generator().manual_seed(0), "cpu")
    ref = _run(pipe, params, _spec())
    return pipe, params, ref


def _spec(store="pinned_hot", depth=0, staging=False, **prefetch):
    spec = TSpec.from_scheme("hybrid+fused", num_parts=4, fanouts=FANOUTS,
                             cache_capacity=K, feature_store=store,
                             prefetch_depth=depth, staging=staging,
                             data=TDataSpec(**DATA))
    if prefetch:
        spec = dataclasses.replace(spec, prefetch=dataclasses.replace(
            spec.prefetch, **prefetch))
    return spec


def _run(base, params, spec, *, steps=STEPS, store=None, staging=None):
    """``steps`` steps of a fresh pipeline over ``base``'s layout: (losses,
    final params, rounds per step, last metrics)."""
    pipe = TPipeline.from_layout(base.layout, spec, device="cpu")
    if store is not None:
        pipe.feature_store = store
    with pipe.train_driver(_loss_fn, batch=BATCH, lr=LR, staging=staging,
                           device="cpu") as driver:
        p, opt, losses = params, topt.init_opt_state(params), []
        for _ in range(steps):
            p, opt, loss, metrics = driver.step(p, opt)
            losses.append(float(loss))
    return losses, p, pipe.counter.rounds / steps, metrics


def _assert_same(run, ref):
    assert run[0] == ref[0]
    for a, b in zip(topt.tree_leaves(run[1]), topt.tree_leaves(ref[1])):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# port against port, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("staging", [False, True], ids=["plain", "staged"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_drivers_match_the_sync_run(world, depth, staging):
    pipe, params, ref = world
    run = _run(pipe, params, _spec(depth=depth, staging=staging))
    _assert_same(run, ref)
    assert run[2] == 2                   # refills use the uncounted twin


def test_sampling_only_prefetch_matches_the_sync_run(world):
    pipe, params, ref = world
    _assert_same(_run(pipe, params, _spec(depth=1, features=False)), ref)


@pytest.mark.parametrize("store", ["exchange", "staged-device",
                                   "staged-host"])
def test_stores_match_pinned_hot(world, store):
    """``staged`` (both combines) and ``exchange`` equal the pinned_hot
    sync run; ``staged`` runs no feature round and moves no feature
    bytes."""
    pipe, params, ref = world
    name, _, combine = store.partition("-")
    obj = StagedStore(combine=combine) if combine else None
    run = _run(pipe, params, _spec(store=name, depth=1), store=obj)
    _assert_same(run, ref)
    assert run[2] == (0 if name == "staged" else 2)
    assert float(run[3]["cache_hit_rate"]) == float(ref[3]["cache_hit_rate"])
    if name == "staged":
        assert float(run[3]["feature_utilized_bytes"]) == 0.0


def test_restart_and_reset_replay_the_stream(world):
    pipe, params, ref = world
    spec = _spec(depth=2, staging=True)
    tp = TPipeline.from_layout(pipe.layout, spec, device="cpu")
    with tp.train_driver(_loss_fn, batch=BATCH, lr=LR,
                         device="cpu") as driver:
        p, opt, losses = params, topt.init_opt_state(params), []
        for k in range(STEPS):
            if k == 2:
                mid = (p, opt)
            p, opt, loss, _ = driver.step(p, opt)
            losses.append(float(loss))
        assert losses == ref[0]
        p, opt = mid
        for k in (2, 3):                 # out of sequence: refill both
            p, opt, loss, _ = driver.step(p, opt, step_idx=k)
            assert float(loss) == ref[0][k]
        _assert_same((ref[0], p), ref)
        driver.reset()
        p, opt = params, topt.init_opt_state(params)
        p, opt, loss, _ = driver.step(p, opt)
        assert float(loss) == ref[0][0]


def test_adopted_stager_survives_driver_close(world):
    pipe, params, ref = world
    stream = SeedStream(pipe, BATCH)
    with SeedStager(stream, depth=0, lead=2) as stager:
        run = _run(pipe, params, _spec(), staging=stager)
        _assert_same(run, ref)
        seeds, salt = stager.get(1)      # still running
        assert torch.equal(seeds, stream.seeds(1)) and salt == 1


def test_make_stager_resolves_the_staging_argument(world):
    pipe, _, _ = world
    staged = TPipeline.from_layout(pipe.layout, _spec("staged", depth=1),
                                   device="cpu")
    stream = SeedStream(staged, BATCH)
    assert make_stager(False, stream, depth=0, pipeline=pipe) == (None,
                                                                   False)
    stager, owned = make_stager(None, stream, depth=1, pipeline=staged)
    try:
        assert isinstance(stager, FeatureStager) and owned
        assert stager.slots == 2 and stager._pool_n == 4  # 2*depth+lead+1
        assert stager._window == MAX_DEG_WINDOW    # the fused backend's
    finally:
        stager.close()
    with SeedStager(stream) as plain:
        with pytest.raises(ValueError, match="needs a FeatureStager"):
            make_stager(plain, stream, depth=1, pipeline=staged)
        assert make_stager(plain, stream, depth=0,
                           pipeline=pipe) == (plain, False)


def _stager_spans(tracer) -> dict:
    """{span name: count} of the stager thread's spans in a trace."""
    out = {}
    for e in tracer.events():
        if e["ph"] == "X" and e["name"].startswith("stager/") \
                and e["name"] != "stager/get":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_stager_serves_the_stream_and_reseeks(world):
    """Each produce, and each of its stages, is timed by a span on the
    stager's trace track (one h2d a produce)."""
    pipe, _, _ = world
    stream = SeedStream(pipe, BATCH, strategy="fold", base_salt=5)
    tracer = obs_trace.start(None)
    try:
        with SeedStager(stream, depth=1, lead=2) as stager:
            for k in (0, 1, 7, 8, 2):
                seeds, salt = stager.get(k)
                assert torch.equal(seeds, stream.seeds(k))
                assert salt == stream.salt_int(k)
            stager.seek(4)
            assert torch.equal(stager.get(4)[0], stream.seeds(4))
            stats = stager.stats()
            assert stats["empty_waits"] >= 1 and stats["pinned_bytes"] == 0
    finally:
        obs_trace.stop(export=False)
    spans = _stager_spans(tracer)
    assert spans["stager/produce"] >= 6
    assert set(spans) == {"stager/produce", "stager/seeds_host",
                          "stager/h2d"}
    assert spans["stager/h2d"] == spans["stager/produce"]
    with pytest.raises(RuntimeError, match="closed"):
        stager.get(5)
    stager.close()                       # idempotent


def test_stager_propagates_worker_errors():
    class BrokenStream:
        def seeds_host(self, k):
            raise RuntimeError("argsort exploded")

        def salt_int(self, k):
            return 0

    with SeedStager(BrokenStream(), depth=0, lead=1) as stager:
        with pytest.raises(RuntimeError, match="argsort exploded"):
            stager.get(0)


def test_stager_rejects_a_bad_ring(world):
    stream = SeedStream(world[0], BATCH)
    with pytest.raises(ValueError, match="depth must be >= 0"):
        SeedStager(stream, depth=-1)
    with pytest.raises(ValueError, match="lead must be >= 1"):
        SeedStager(stream, lead=0)


@pytest.mark.parametrize("combine", ["device", "host"])
def test_feature_stager_rows_equal_the_fetch(world, combine):
    """The staged rows are the owners' rows of the frontier the device
    samples; under the device combine the cache's hits are zeroed."""
    pipe, _, _ = world
    staged = TPipeline.from_layout(pipe.layout, _spec("staged", depth=1),
                                   device="cpu")
    staged.feature_store = StagedStore(combine=combine)
    stream = SeedStream(staged, BATCH)
    tracer = obs_trace.start(None)
    try:
        with FeatureStager(stream, pipeline=staged, depth=1) as stager:
            for k in (0, 1, 3, 1):           # 3 and then 1 reuse pool buffers
                seeds, salt, rows = stager.get(k)
                src = sample_mfgs(staged.layout.graph, seeds, FANOUTS, salt,
                                  backend="fused_cuda")[-1].src_nodes
                want = tdist.fetch_features(src, staged.layout.offsets, 4,
                                            staged.layout.features, None)
                if combine == "device":
                    hit, _ = tdist.cache_lookup(staged.cache, src)
                    assert hit.any()
                    want = torch.where(hit[..., None], 0.0, want)
                assert torch.equal(rows, want)
            assert stager.pinned_bytes == 0  # pinned on CUDA only
    finally:
        obs_trace.stop(export=False)
    assert set(_stager_spans(tracer)) == {
        "stager/produce", "stager/seeds_host", "stager/frontier_replay",
        "stager/gather_rows", "stager/h2d"}


def test_prefetch_spec_validation_and_registry():
    assert PrefetchSpec().mode == "sync"
    assert PrefetchSpec(depth=2).mode == "double_buffer"
    for kw, msg in (({"depth": -1}, "depth must be >= 0"),
                    ({"lead": 0}, "lead must be >= 1"),
                    ({"seed_stream": "random"}, "unknown seed_stream"),
                    ({"sampling": False}, "without sampling"),
                    ({"depth": 1, "sampling": False, "features": False},
                     "prefetches nothing")):
        with pytest.raises(ValueError, match=msg):
            PrefetchSpec(**kw)
    with pytest.raises(ValueError, match="depth >= 1"):
        _spec("staged", depth=0)
    with pytest.raises(ValueError, match="features=True"):
        _spec("staged", depth=1, features=False)
    assert available_prefetchers() == ("double_buffer", "sync")
    assert resolve_prefetcher("sync") is SyncDriver
    assert resolve_prefetcher("double_buffer") is DoubleBufferDriver
    with pytest.raises(KeyError, match="unknown prefetcher"):
        resolve_prefetcher("triple")


# --------------------------------------------------------------------------
# against repro
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """P = 2 repro and port pipelines at depth 1 (exchange store) over the
    same data, with repro's parameters carried across."""
    jp = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "hybrid+fused", num_parts=2, fanouts=FANOUTS,
        fused_backend="reference", prefetch_depth=1,
        data=JDataSpec(**DATA)))
    tp = TPipeline.build_from_source(spec=TSpec.from_scheme(
        "hybrid+fused", num_parts=2, fanouts=FANOUTS, prefetch_depth=1,
        data=TDataSpec(**DATA)), device="cpu")
    jparams = j_init(jax.random.key(0), _cfg(JConfig))
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        "cpu")
    return jp, tp, jparams, tparams


@pytest.mark.parametrize("strategy", ["counter", "fold"])
def test_seed_stream_matches_repro(pair, strategy):
    jp, tp, _, _ = pair
    for base in (0, 3, 2 ** 32 - 1):
        js = JSeedStream(jp, BATCH, strategy=strategy, base_salt=base)
        ts = SeedStream(tp, BATCH, strategy=strategy, base_salt=base)
        for k in (0, 1, 7, 1000, 2 ** 20 + 5):
            assert ts.salt_int(k) == js.salt_int(k)
            np.testing.assert_array_equal(ts.seeds_host(k),
                                          js.seeds_host(k))


def test_frontier_replay_matches_repro_and_the_sampler(pair):
    jp, tp, _, _ = pair
    indptr, indices = tp.layout.graph.numpy()
    ts = SeedStream(tp, BATCH, strategy="fold", base_salt=2)
    for k in (0, 1, 9):
        seeds, salt = ts.seeds_host(k), ts.salt_int(k)
        want = sample_mfgs(tp.layout.graph, torch.from_numpy(seeds),
                           FANOUTS, salt)[-1].src_nodes.numpy()
        for p in range(2):
            got = _frontier_src_nodes_host(indptr, indices, seeds[p],
                                           FANOUTS, salt)
            np.testing.assert_array_equal(got, want[p])
            np.testing.assert_array_equal(
                got, j_replay(np.asarray(jp.layout.graph.indptr),
                              np.asarray(jp.layout.graph.indices),
                              seeds[p], FANOUTS, salt))


def test_frontier_replay_applies_the_fused_window():
    """On a graph whose in-degrees (up to 40) exceed a window of 4, the
    replay with the window equals the fused level's draws and differs from
    the unwindowed replay, which ``repro``'s transcription is."""
    rng = np.random.default_rng(0)
    n = 300
    deg = rng.integers(0, 41, size=n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    graph = CSCGraph(indptr=torch.from_numpy(indptr),
                     indices=torch.from_numpy(indices))
    level = functools.partial(fused_sample_level, window=4)
    seeds = np.where(rng.random((2, 24)) < 0.1, -1,
                     rng.integers(0, n, size=(2, 24))).astype(np.int32)
    fanouts = (3, 2)
    differs = False
    for salt in (0, 77):
        sink = []
        want = sample_mfgs(graph, torch.from_numpy(seeds), fanouts, salt,
                           level_fn=functools.partial(
                               level, overflow_sink=sink))[-1].src_nodes
        assert sum(int(o.sum()) for o in sink) > 0
        for p in range(2):
            got = _frontier_src_nodes_host(indptr, indices, seeds[p],
                                           fanouts, salt, window=4)
            np.testing.assert_array_equal(got, want[p].numpy())
            plain = _frontier_src_nodes_host(indptr, indices, seeds[p],
                                             fanouts, salt)
            differs |= not np.array_equal(plain, got)
    assert differs


def test_depth_one_trajectory_matches_repro(pair):
    jp, tp, jparams, tparams = pair
    jloss = lambda p, m, h, lab, v: j_loss(p, m, h, lab, v, _cfg(JConfig))
    jd = jp.train_driver(jloss, batch=BATCH, lr=LR)
    jpar, jst, jlosses = jparams, jopt.init_opt_state(jparams), []
    for _ in range(3):
        jpar, jst, loss, _ = jd.step(jpar, jst)
        jlosses.append(float(loss))
    jd.close()
    with tp.train_driver(_loss_fn, batch=BATCH, lr=LR,
                         device="cpu") as td:
        assert td.mode == "double_buffer" and td.depth == 1
        tpar, tst, tlosses = tparams, topt.init_opt_state(tparams), []
        for _ in range(3):
            tpar, tst, loss, _ = td.step(tpar, tst)
            tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_seeds_per_worker_host_matches_repro_without_device_copies(
        pair, monkeypatch):
    """The seed draw reads the layout's host copies: repro's seeds, and no
    ``Tensor.cpu`` after the first call (none at all for a layout from
    ``build_layout``, which keeps them)."""
    jp, tp, _, _ = pair
    calls = []
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    fresh = dataclasses.replace(tp.layout, offsets_host=None,
                                labels_host=None)
    for layout, first_calls in ((tp.layout, 0), (fresh, 2)):
        for i, salt in enumerate((0, 9, 2 ** 32 - 1)):
            got = seeds_per_worker_host(layout, BATCH, salt)
            np.testing.assert_array_equal(
                got, j_seeds_host(jp.layout, BATCH, salt))
            assert len(calls) == (first_calls if i == 0 else 0)
            calls.clear()
