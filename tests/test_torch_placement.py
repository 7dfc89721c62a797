"""The placement slice: ``repro_torch.core.placement`` and the partitioned
sampling protocol on the stacked worker axis against ``repro``'s, on the
CPU, over ``conftest.py``'s 800-node graph at P = 2 and 4.

``repro``'s per-worker programs run jitted under ``jax.vmap(...,
axis_name=AXIS)``.  Integer outputs (local topology, hot-set plans, draws,
MFGs, round counts, utilized bytes) and the plans' float fractions are
held bit for bit.  One training step per scheme on the ``exchange`` store
is held to the tolerances of ``tests/test_torch_train.py``: loss rtol
1e-5, gradients rtol 1e-4 with atol 1e-6 (XLA and torch order their fp32
sums differently).  ``repro``'s ``hybrid+fused`` and ``pinned_hot`` need
``pl.load``, which the installed JAX lacks, so they are not run here.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dist as jdist
from repro.core import partition as jpart
from repro.core import placement as jplace
from repro.core.sampler import resolve_backend as j_backend
from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro.pipeline import PlanSpec as JPlanSpec
from repro.serve import GNNServer as JServer
from repro.serve import Predictor as JPredictor
from repro_torch.core import dist as tdist
from repro_torch.core import partition as tpart
from repro_torch.core import placement as tplace
from repro_torch.core.graph import CSCGraph as TCSCGraph
from repro_torch.core.sampler import resolve_backend as t_backend
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import gnn_loss, params_from_numpy
from repro_torch.optim import init_opt_state, tree_leaves
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.pipeline import PlanSpec as TPlanSpec
from repro_torch.pipeline.specs import PrefetchSpec, SamplerSpec
from repro_torch.pipeline.staging import FeatureStager
from repro_torch.serve import GNNServer, Predictor
from repro_torch.serve.traffic import hotset_arrivals

FANOUTS = (4, 3, 2)
L = len(FANOUTS)
BATCH = 16
SALT = 5
SCHEMES = ("vanilla", "hybrid", "hybrid_partial(0.0)",
           "hybrid_partial(0.25)", "hybrid_partial(1.0)")
MFG_FIELDS = ("dst_nodes", "src_nodes", "num_src", "edges", "edge_mask",
              "indptr")


def _world(P, ds):
    """(P, {scheme: (repro plan, port plan)}, repro layout, port layout),
    both layouts from one ldg assignment of the 800-node graph."""
    feats, labels = np.asarray(ds.features), np.asarray(ds.labels)
    assign = jpart.resolve_partitioner("ldg").assign(ds.graph, P,
                                                     labels >= 0)
    jlayout = jpart.build_layout(ds.graph, feats, labels, assign, P)
    tgraph = TCSCGraph(indptr=torch.from_numpy(np.array(ds.graph.indptr)),
                       indices=torch.from_numpy(np.array(ds.graph.indices)))
    tlayout = tpart.build_layout(tgraph, feats, labels, assign, P)
    plans = {s: (jplace.resolve_scheme(s).build(jlayout),
                 tplace.resolve_scheme(s).build(tlayout)) for s in SCHEMES}
    return P, plans, jlayout, tlayout


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, small_dataset):
    return _world(request.param, small_dataset)


@pytest.fixture(scope="module")
def world4(small_dataset):
    """The P = 4 world, for what does not depend on the worker count."""
    return _world(4, small_dataset)


def _shards(jlayout, tlayout, jplan, tplan):
    ji, jx = jplan.shard_topology()
    ti, tx = tplan.shard_topology()
    return (jdist.WorkerShard(jlayout.features, jlayout.labels, ji, jx),
            tdist.WorkerShard(tlayout.features, tlayout.labels, ti, tx))


def _eq(got: torch.Tensor, ref, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                  err_msg=what)


# --------------------------------------------------------------------------
# registry and specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hybrid", "vanilla", "hybrid_partial(0.25)",
                                  "hybrid_partial(1)", "hybrid+fused",
                                  "bad(x)"])
def test_parse_scheme_name_matches_repro(name):
    try:
        ref = jplace.parse_scheme_name(name)
    except ValueError as e:
        with pytest.raises(ValueError, match="must be a float"):
            tplace.parse_scheme_name(name)
        assert "must be a float" in str(e)
        return
    assert tplace.parse_scheme_name(name) == ref


@pytest.mark.parametrize("name,frac,err", [
    ("hybrid_partial(0.25)", 0.5, "conflicting"),
    ("vanilla", 0.5, "takes no replication"),
    ("hybrid", 0.1, "takes no replication"),
    ("hybrid_partial", None, "needs a replication fraction"),
    ("hybrid_partial(1.5)", None, r"in \[0, 1\]"),
])
def test_resolve_scheme_errors_match_repro(name, frac, err):
    for mod in (jplace, tplace):
        with pytest.raises(ValueError, match=err):
            mod.resolve_scheme(name, frac=frac)


def test_registry_matches_repro():
    assert tplace.available_schemes() == jplace.available_schemes() \
        == ("hybrid", "hybrid_partial", "vanilla")
    with pytest.raises(KeyError, match="unknown placement scheme"):
        tplace.resolve_scheme("ring")
    s = tplace.resolve_scheme("hybrid_partial", frac=0.25)
    assert s.frac == jplace.resolve_scheme("hybrid_partial(0.25)").frac
    # only hybrid samples through the level backend
    assert [tplace.resolve_scheme(n).uses_level_backend
            for n in ("vanilla", "hybrid", "hybrid_partial(0.5)")] \
        == [False, True, False]


def test_plan_spec_replicate_frac_matches_repro():
    for cls in (JPlanSpec, TPlanSpec):
        spec = cls(num_parts=2, scheme="hybrid_partial(0.25)")
        assert (spec.scheme, spec.replicate_frac) == ("hybrid_partial", 0.25)
        spec = cls(num_parts=2, scheme="hybrid_partial(0.25)",
                   replicate_frac=0.25)
        assert spec.replicate_frac == 0.25
        with pytest.raises(ValueError, match="conflicting"):
            cls(num_parts=2, scheme="hybrid_partial(0.25)",
                replicate_frac=0.5)
        with pytest.raises(ValueError, match="unknown scheme"):
            cls(num_parts=2, scheme="ring")
        with pytest.raises(ValueError, match="takes no replication"):
            cls(num_parts=2, scheme="vanilla", replicate_frac=0.5)
        with pytest.raises(ValueError, match="needs a replication"):
            cls(num_parts=2, scheme="hybrid_partial")


@pytest.mark.parametrize("name", ["vanilla", "hybrid", "hybrid+fused",
                                  "hybrid_partial(0.25)",
                                  "hybrid_partial(1.0)"])
def test_from_scheme_mapping_and_expected_rounds_match_repro(name):
    j = JSpec.from_scheme(name, num_parts=2, fanouts=FANOUTS)
    t = TSpec.from_scheme(name, num_parts=2, fanouts=FANOUTS)
    assert (t.plan.scheme, t.plan.replicate_frac) \
        == (j.plan.scheme, j.plan.replicate_frac)
    fused = {"fused_pallas": "fused_cuda"}
    assert t.sampler.backend == fused.get(j.sampler.backend,
                                          j.sampler.backend)
    assert t.expected_rounds == j.expected_rounds
    with pytest.raises(ValueError, match="unknown scheme"):
        TSpec.from_scheme("ring", num_parts=2, fanouts=FANOUTS)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

def test_build_vanilla_bit_identical(world):
    P, _, jlayout, tlayout = world
    jv = jpart.build_vanilla(jlayout)
    tv = tpart.build_vanilla(tlayout)
    assert isinstance(tv, tpart.VanillaPlan) and tv.layout is tlayout
    local_indptr, local_indices = tv.local_indptr, tv.local_indices
    assert local_indptr.dtype == local_indices.dtype == torch.int32
    _eq(local_indptr, jv.local_indptr)
    _eq(local_indices, jv.local_indices)
    # -1 padding past each worker's slice, the row pointer's tail flat
    assert (local_indices < 0).any() or P == 1
    last = local_indptr[:, -1]
    assert int(last.max()) == local_indices.shape[1]


@pytest.mark.parametrize("scheme", ["vanilla", "hybrid_partial(0.0)",
                                    "hybrid_partial(0.25)",
                                    "hybrid_partial(1.0)"])
def test_plan_fields_bit_identical(world, scheme):
    _, plans, _, _ = world
    jp, tp = plans[scheme]
    assert tp.remote_source_fraction == jp.remote_source_fraction
    assert 0.0 < tp.remote_source_fraction < 1.0
    for j, t in zip(jp.shard_topology(), tp.shard_topology()):
        _eq(t, j)
    if scheme == "vanilla":
        return
    _eq(tp.hot_graph.indptr, jp.hot_graph.indptr, "hot indptr")
    _eq(tp.hot_graph.indices, jp.hot_graph.indices, "hot indices")
    _eq(tp.hot_mask, jp.hot_mask, "hot mask")
    for f in ("frac", "hot_count", "cold_remote_source_fraction",
              "replicated_edges", "replicated_edge_fraction", "complete"):
        assert getattr(tp, f) == getattr(jp, f), f


def test_hybrid_plan_needs_no_local_topology(world):
    _, plans, _, tlayout = world
    _, tp = plans["hybrid"]
    assert tp.shard_topology() == (None, None)
    assert tp.replicated_graph is tlayout.graph


# --------------------------------------------------------------------------
# the partitioned protocol
# --------------------------------------------------------------------------

def _frontier(tlayout, P, N, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, tlayout.graph.num_nodes, (P, N)).astype(np.int32)
    ids[rng.random((P, N)) < 0.2] = -1
    return ids


def test_sample_neighbors_local_bit_identical(world):
    P, plans, jlayout, tlayout = world
    jp, tp = plans["vanilla"]
    ids = _frontier(tlayout, P, 60, P)       # owned, foreign and -1 ids
    off = np.asarray(jlayout.offsets)

    def per(li, lx, o, n, x):
        return jdist.sample_neighbors_local(li, lx, o, n, x, 5,
                                            jnp.uint32(SALT))
    ref = jax.jit(jax.vmap(per))(jp.local_indptr, jp.local_indices,
                                 jnp.asarray(off[:-1]),
                                 jnp.asarray(off[1:] - off[:-1]),
                                 jnp.asarray(ids))
    my_offset, n_local = tdist.worker_ranges(tlayout.offsets)
    got = tdist.sample_neighbors_local(tp.local_indptr, tp.local_indices,
                                       my_offset, n_local,
                                       torch.from_numpy(ids), 5, SALT)
    assert got.dtype == torch.int32
    _eq(got, ref)
    own = tdist.owner_of(tlayout.offsets, torch.from_numpy(ids))
    mine = own == torch.arange(P, dtype=torch.int32).view(P, 1)
    assert (got[~mine] == -1).all() and (got[mine] >= 0).any()


def test_exchange_sample_level_bit_identical(world):
    P, plans, jlayout, tlayout = world
    jp, tp = plans["vanilla"]
    jshard, tshard = _shards(jlayout, tlayout, jp, tp)
    ids = _frontier(tlayout, P, 40, 10 + P)
    jc = jdist.RoundCounter()

    def per(shard, x):
        return jdist.exchange_sample_level(shard, jlayout.offsets, P, x, 3,
                                           jnp.uint32(SALT), jc)
    ref, ref_bytes = jax.jit(jax.vmap(per, axis_name=jdist.AXIS))(
        jshard, jnp.asarray(ids))
    tc = tdist.RoundCounter()
    got, got_bytes = tdist.exchange_sample_level(
        tshard, tlayout.offsets, P, torch.from_numpy(ids), 3, SALT, tc)
    _eq(got, ref)
    _eq(got_bytes, ref_bytes)
    assert (got[torch.from_numpy(ids) < 0] == -1).all()
    assert tc.kinds == jc.kinds == ["sampling", "sampling"]
    assert tc.bytes_per_round == jc.bytes_per_round


def _j_sample(jplan, jshard, seeds, fused, backend):
    counter = jdist.RoundCounter()
    level_fn = j_backend(backend)

    def per(shard, s):
        return jplan.sample(shard, s, FANOUTS, jnp.uint32(SALT),
                            level_fn=level_fn, fused=fused, counter=counter)
    mfgs, util = jax.jit(jax.vmap(per, axis_name=jdist.AXIS))(
        jshard, jnp.asarray(seeds))
    return mfgs, util, counter


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_mfgs_rounds_and_bytes_bit_identical(world, scheme, fused):
    P, plans, jlayout, tlayout = world
    jp, tp = plans[scheme]
    jshard, tshard = _shards(jlayout, tlayout, jp, tp)
    seeds = tpart.seeds_per_worker_host(tlayout, BATCH, SALT)
    # hybrid picks its construction by level backend, the others by flag
    backend = "reference" if fused else "unfused"
    jm, jb, jc = _j_sample(jp, jshard, seeds, fused, backend)
    tc = tdist.RoundCounter()
    tm, tb = tp.sample(tshard, torch.from_numpy(seeds), FANOUTS, SALT,
                       level_fn=t_backend(backend), fused=fused, counter=tc)
    assert len(tm) == len(jm) == L
    for d, (t, j) in enumerate(zip(tm, jm)):
        for f in MFG_FIELDS:
            _eq(getattr(t, f), getattr(j, f), f"level {d} {f}")
    assert tb.shape == (P,) and tb.dtype == torch.float32
    _eq(tb, jb)
    assert tc.kinds == jc.kinds
    assert tc.bytes_per_round == jc.bytes_per_round
    rounds = tp.scheme.trace_sampling_rounds(L, plan=tp)
    assert tc.sampling_rounds == rounds
    assert rounds == (0 if scheme in ("hybrid", "hybrid_partial(1.0)")
                      else 2 * (L - 1))
    # every scheme draws the same minibatch as hybrid
    hm, _ = plans["hybrid"][1].sample(None, torch.from_numpy(seeds),
                                      FANOUTS, SALT)
    for t, h in zip(tm, hm):
        for f in MFG_FIELDS:
            assert torch.equal(getattr(t, f), getattr(h, f)), f


# --------------------------------------------------------------------------
# pipelines: estimates, steps, drivers, serving, staging
# --------------------------------------------------------------------------

def _specs(scheme, P, **kw):
    return (JSpec.from_scheme(scheme, num_parts=P, fanouts=FANOUTS, **kw),
            TSpec.from_scheme(scheme, num_parts=P, fanouts=FANOUTS, **kw))


def _cfgs():
    kw = dict(in_dim=12, hidden_dim=16, num_classes=4, num_layers=L,
              fanouts=FANOUTS, dropout=0.0)
    return JConfig(**kw), TConfig(**kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_round_estimates_and_edge_cut_match_repro(world, scheme):
    P, _, jlayout, tlayout = world
    js, ts = _specs(scheme, P)
    jpipe = JPipeline.from_layout(jlayout, js)
    tpipe = TPipeline.from_layout(tlayout, ts, device="cpu")
    assert tpipe.expected_rounds == jpipe.expected_rounds
    assert tpipe.expected_rounds_estimate == jpipe.expected_rounds_estimate
    assert tpipe.edge_cut_fraction == jpipe.edge_cut_fraction
    assert 0.0 < tpipe.edge_cut_fraction < 1.0
    assert 2.0 <= tpipe.expected_rounds_estimate <= 2.0 * L


@pytest.mark.parametrize("scheme", ["vanilla", "hybrid",
                                    "hybrid_partial(0.25)"])
def test_one_training_step_matches_repro(world4, scheme):
    P, _, jlayout, tlayout = world4
    js, ts = _specs(scheme, P)
    jpipe = JPipeline.from_layout(jlayout, js)
    tpipe = TPipeline.from_layout(tlayout, ts, device="cpu")
    jcfg, tcfg = _cfgs()
    jparams = j_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        "cpu")
    seeds = tpipe.seeds_host(BATCH, SALT)
    jl, jg, jm = jax.jit(jpipe.step_fn(
        lambda p, m, h, lab, v: j_loss(p, m, h, lab, v, jcfg)))(
            jparams, jnp.asarray(seeds), jnp.uint32(SALT))
    tl, tg, tm = tpipe.step_fn(
        lambda p, m, h, lab, v: gnn_loss(p, m, h, lab, v, tcfg),
        device="cpu")(tparams, torch.from_numpy(seeds), SALT)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for tlay, jlay in zip(tg, jg):
        for k in jlay:
            np.testing.assert_allclose(tlay[k].numpy(), np.asarray(jlay[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("sampling_utilized_bytes", "feature_utilized_bytes"):
        assert float(tm[k]) == float(jm[k]), k
    assert tpipe.counter.kinds == jpipe.counter.kinds
    assert tpipe.counter.rounds == tpipe.expected_rounds


@pytest.mark.parametrize("scheme,store,rounds", [
    ("vanilla", "exchange", 6), ("hybrid", "exchange", 2),
    ("hybrid_partial(0.25)", "exchange", 6),
    ("hybrid_partial(1.0)", "exchange", 2), ("vanilla", "staged", 4)])
def test_round_counts_under_prefetch(world4, scheme, store, rounds):
    """``repro``'s ``test_trace_round_counts_under_prefetch`` on the port:
    one step's rounds under the sync and double-buffered drivers (the
    refill twin is uncounted), equal to ``repro``'s structural count for
    the exchange store; every run's losses equal the sync exchange
    run's bit for bit."""
    P, _, jlayout, tlayout = world4
    _, tcfg = _cfgs()

    def loss_fn(p, m, h, lab, v):
        return gnn_loss(p, m, h, lab, v, tcfg)

    params = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in j_init(jax.random.key(0), _cfgs()[0])], "cpu")

    def run(store, depth):
        spec = TSpec.from_scheme(scheme, num_parts=P, fanouts=FANOUTS,
                                 feature_store=store, prefetch_depth=depth)
        pipe = TPipeline.from_layout(tlayout, spec, device="cpu")
        with pipe.train_driver(loss_fn, batch=8, lr=0.01,
                               device="cpu") as driver:
            p, opt = params, init_opt_state(params)
            losses = []
            for k in range(2):
                p, opt, loss, _ = driver.step(p, opt, k)
                losses.append(float(loss))
        return pipe, losses

    ref_pipe, ref = run("exchange", 0)
    js, _ = _specs(scheme, P)
    assert ref_pipe.expected_rounds \
        == JPipeline.from_layout(jlayout, js).expected_rounds
    for depth in ((0, 1) if store == "exchange" else (1,)):
        pipe, losses = (ref_pipe, ref) if (store, depth) == ("exchange", 0) \
            else run(store, depth)
        assert pipe.counter.rounds == 2 * rounds, depth
        assert losses == ref, depth


def test_staging_window_comes_from_the_placement(world4):
    """Only a scheme that samples through the level backend replays the
    host sampler with the backend's window; vanilla and hybrid_partial
    draw windowless under any backend."""
    P, _, _, tlayout = world4
    from repro_torch.kernels.fused_sample import MAX_DEG_WINDOW as WINDOW
    from repro_torch.pipeline.prefetch import SeedStream
    for scheme, backend, want in (
            ("vanilla", "fused_cuda", None),
            ("hybrid_partial(0.25)", "fused_cuda", None),
            ("vanilla", "reference", None),
            ("hybrid", "fused_cuda", WINDOW), ("hybrid", "unfused", None)):
        spec = TSpec(plan=TPlanSpec(num_parts=P, scheme=scheme,
                                    feature_store="staged"),
                     sampler=SamplerSpec(fanouts=FANOUTS, backend=backend),
                     prefetch=PrefetchSpec(depth=1))
        pipe = TPipeline.from_layout(tlayout, spec, device="cpu")
        with FeatureStager(SeedStream(pipe, 8), pipeline=pipe,
                           depth=1) as stager:
            assert stager._window == want, (scheme, backend)


def test_vanilla_predictor_equals_hybrid_bit_for_bit(world):
    P, _, _, tlayout = world
    _, tcfg = _cfgs()
    params = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in j_init(jax.random.key(0), _cfgs()[0])], "cpu")
    seeds = np.random.default_rng(P).integers(0, 800, 40)
    out = {}
    for scheme in ("vanilla", "hybrid", "hybrid_partial(0.25)"):
        pipe = TPipeline.from_layout(tlayout, TSpec.from_scheme(
            scheme, num_parts=P, fanouts=FANOUTS), device="cpu")
        pred = Predictor(pipe, params, tcfg, buckets=(8, 32),
                         base_salt=SALT, device="cpu")
        out[scheme] = pred.predict(seeds)
    assert out["vanilla"].shape == (40, 4)
    assert np.isfinite(out["vanilla"]).all()
    np.testing.assert_array_equal(out["vanilla"], out["hybrid"])
    np.testing.assert_array_equal(out["hybrid_partial(0.25)"],
                                  out["hybrid"])


def test_server_buckets_match_repro():
    """``GNNServer(buckets=...)`` sizes the flushes by its own buckets,
    not the predictor's: the same flush count and bucket histogram as
    ``repro``'s server, and served rows equal to direct ``predict``."""
    data = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
                num_features=12, num_classes=4, seed=3)
    fanouts = (4, 3)
    kw = dict(in_dim=12, hidden_dim=16, num_classes=4, num_layers=2,
              fanouts=fanouts, dropout=0.0)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = j_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        "cpu")
    jpipe = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "vanilla", num_parts=2, fanouts=fanouts, data=JDataSpec(**data)))
    tpipe = TPipeline.build_from_source(spec=TSpec.from_scheme(
        "vanilla", num_parts=2, fanouts=fanouts, data=TDataSpec(**data)),
        device="cpu")
    jpred = JPredictor(jpipe, jparams, jcfg, buckets=(8, 32), base_salt=SALT)
    tpred = Predictor(tpipe, tparams, tcfg, buckets=(8, 32), base_salt=SALT,
                      device="cpu")
    arrivals = hotset_arrivals(60, 4000.0, 800, graph=tpipe.dataset.graph,
                               hot_k=16, seed=0)
    buckets = (1, 4)
    jstats, jserved = JServer(jpred, buckets=buckets, max_delay=1e-3).run(
        arrivals, collect_outputs=True)
    server = GNNServer(tpred, buckets=buckets, max_delay=1e-3, device="cpu")
    assert server.buckets.sizes == buckets != tpred.buckets.sizes
    tstats, tserved = server.run(arrivals, collect_outputs=True)
    assert tstats.num_flushes == jstats.num_flushes
    assert tstats.bucket_histogram == jstats.bucket_histogram
    assert set(tstats.bucket_histogram) <= set(buckets)
    np.testing.assert_array_equal(
        tserved, tpred.predict([s for _, s in arrivals]))
    np.testing.assert_allclose(tserved, jserved, rtol=1e-5, atol=1e-5)
    default = GNNServer(tpred, device="cpu")
    assert default.buckets == tpred.buckets


def test_gnn_trainer_runs_every_scheme(world4):
    P, _, _, tlayout = world4
    from repro_torch.train.loop import GNNTrainer
    _, tcfg = _cfgs()
    out = {}
    for scheme in ("vanilla", "hybrid", "hybrid_partial(0.25)"):
        with GNNTrainer(layout=tlayout, cfg=tcfg, scheme=scheme,
                        batch_per_worker=8, device="cpu") as tr:
            out[scheme] = tr.run_epoch(0, steps_per_epoch=2)
            params = tree_leaves(tr.params)
        out[scheme]["params"] = params
    assert [out[s]["comm_rounds_per_step"] for s in out] == [6, 2, 6]
    for s in ("vanilla", "hybrid_partial(0.25)"):
        assert out[s]["loss"] == out["hybrid"]["loss"]
        assert all(torch.equal(a, b) for a, b in
                   zip(out[s]["params"], out["hybrid"]["params"]))


def test_mfg_fields_cover_the_dataclass():
    from repro_torch.core.mfg import MFG
    assert tuple(f.name for f in dataclasses.fields(MFG)) == MFG_FIELDS
