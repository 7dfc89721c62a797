"""``repro``'s seed API and public surface in the port, against ``repro``
on the CPU: the deprecated step shims (``dist.make_worker_step``,
``run_stacked``, ``make_shard_map_step``), the cached step
(``cache.make_cached_worker_step``, ``run_stacked_cached``,
``build_degree_caches``), the legacy plans (``VanillaPlan``,
``HybridPlan``, ``plan_from_legacy``), the legacy keywords of the step
builders (``vanilla_fused`` with a raw ``level_fn``) and the kernels'
MFG-level ops and oracle names.

``repro``'s side samples with its ``reference`` backend (``sample_level``:
its Pallas sampler cannot run here), jitted under ``jax.vmap``; every
in-degree of the toy graph lies inside the fused kernel's window.  Both
packages start from ``repro``'s parameters (``params_from_numpy``) with
dropout 0.

Tolerances, as the port's training parity tests state them (fp32; XLA and
torch order their sums differently): loss rtol 1e-5, gradients rtol 1e-4
with atol 1e-6.  Integers (MFGs, plans, cache ids, round counts) and the
hit rate are compared exactly, and so is the port against itself (shim
against pipeline, cached against uncached).

Torch runs on one thread: under xdist many small ops oversubscribe the
cores.
"""
import os
import sys
import textwrap
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import cache as jcache
from repro.core import dist as jdist
from repro.core import partition as jpart
from repro.core import placement as jplace
from repro.core.sampler import sample_level as j_sample_level
from repro.data.synthetic_graph import make_power_law_graph as j_graph
from repro.kernels import ref as jref
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.pipeline.prefetch import make_prepare_consume as j_prepare_consume
from repro_torch.core import cache as tcache
from repro_torch.core import dist as tdist
from repro_torch.core import partition as tpart
from repro_torch.core import placement as tplace
from repro_torch.core.sampler import sample_level as t_sample_level
from repro_torch.data.synthetic_graph import make_power_law_graph as t_graph
from repro_torch.kernels import gather as tgather
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import multihost
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import gnn_loss as t_loss
from repro_torch.models.gnn import params_from_numpy, params_to_numpy
from repro_torch.optim import tree_leaves
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.pipeline.prefetch import make_prepare as t_make_prepare

P = 4
FANOUTS = (4, 3)
BATCH = 16
SALT = 7
SEED_SALT = 2
CACHE_K = 64
KW = dict(in_dim=12, hidden_dim=16, num_classes=4, num_layers=2,
          fanouts=FANOUTS, dropout=0.0)
MFG_FIELDS = ("dst_nodes", "src_nodes", "num_src", "edges", "edge_mask",
              "indptr")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world():
    """Both packages' layout and vanilla shards of one 800-node graph at
    P = 4, seeds, ``repro``'s initial parameters in both forms."""
    jds = j_graph(800, 6, num_features=12, num_classes=4, seed=3)
    tds = t_graph(800, 6, num_features=12, num_classes=4, seed=3)
    assign = jpart.partition_graph(jds.graph, P, jds.labeled_mask, seed=0)
    jlayout = jpart.build_layout(jds.graph, jds.features, jds.labels,
                                 assign, P)
    tlayout = tpart.build_layout(tds.graph, tds.features, tds.labels,
                                 assign, P)
    jv, tv = jpart.build_vanilla(jlayout), tpart.build_vanilla(tlayout)
    jshards = jdist.WorkerShard(features=jlayout.features,
                                labels=jlayout.labels,
                                local_indptr=jv.local_indptr,
                                local_indices=jv.local_indices)
    tshards = tdist.WorkerShard(features=tlayout.features,
                                labels=tlayout.labels,
                                local_indptr=tv.local_indptr,
                                local_indices=tv.local_indices)
    jparams = j_init(jax.random.key(0), JConfig(**KW))
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        "cpu")
    return dict(jlayout=jlayout, tlayout=tlayout, jv=jv, tv=tv,
                jshards=jshards, tshards=tshards, jparams=jparams,
                tparams=tparams,
                jseeds=jpart.seeds_per_worker(jlayout, BATCH, SEED_SALT),
                tseeds=tpart.seeds_per_worker(tlayout, BATCH, SEED_SALT))


def _loss_fns():
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    return (lambda p, m, h, lab, v: j_loss(p, m, h, lab, v, jcfg),
            lambda p, m, h, lab, v: t_loss(p, m, h, lab, v, tcfg))


def _shim(pkg_dist, layout, scheme, counter=None, **kw):
    jfn, tfn = _loss_fns()
    return pkg_dist.make_worker_step(
        graph_replicated=layout.graph if scheme == "hybrid" else None,
        offsets=layout.offsets, num_parts=P, fanouts=FANOUTS, scheme=scheme,
        loss_fn=jfn if pkg_dist is jdist else tfn, counter=counter, **kw)


def _port_shim(w, scheme, counter=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return _shim(tdist, w["tlayout"], scheme, counter, **kw)


@pytest.fixture(scope="module")
def repro_runs(world):
    """``repro``'s shim + ``run_stacked`` under each scheme, jitted (its
    round counter read after the one trace), and its cached step."""
    w = world
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for scheme in ("vanilla", "hybrid"):
            counter = jdist.RoundCounter()
            step = _shim(jdist, w["jlayout"], scheme, counter)
            loss, grads = jax.jit(
                lambda p, sh, s, step=step: jdist.run_stacked(
                    step, p, sh, s, jnp.uint32(SALT)))(
                w["jparams"], w["jshards"], w["jseeds"])
            out[scheme] = (loss, grads, counter)
        cache = jcache.build_degree_caches(w["jlayout"], CACHE_K)
        jfn, _ = _loss_fns()
        cstep = jcache.make_cached_worker_step(
            graph_replicated=w["jlayout"].graph, offsets=w["jlayout"].offsets,
            num_parts=P, fanouts=FANOUTS, loss_fn=jfn)
        out["cached"] = jax.jit(
            lambda p, sh, s, c: jcache.run_stacked_cached(
                cstep, p, sh, s, jnp.uint32(SALT), c))(
            w["jparams"], w["jshards"], w["jseeds"], cache)
        out["cache"] = cache
    return out


def _assert_near_repro(t_loss_v, t_grads, j_loss_v, j_grads):
    np.testing.assert_allclose(float(t_loss_v), float(j_loss_v), rtol=1e-5)
    t_np = params_to_numpy(t_grads)
    j_np = [{k: np.asarray(v) for k, v in layer.items()}
            for layer in j_grads]
    for tl, jl in zip(t_np, j_np):
        assert tl.keys() == jl.keys()
        for k in tl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-6)


def _assert_same(a, b):
    """Two results of the port: loss and every gradient leaf bit for
    bit."""
    assert torch.equal(a[0], b[0])
    for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# (i) the shim and run_stacked against repro's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["vanilla", "hybrid"])
def test_shim_run_stacked_matches_repro(world, repro_runs, scheme):
    w = world
    counter = tdist.RoundCounter()
    step = _port_shim(w, scheme, counter)
    loss, grads = tdist.run_stacked(step, w["tparams"], w["tshards"],
                                    w["tseeds"], SALT)
    jloss, jgrads, jcounter = repro_runs[scheme]
    _assert_near_repro(loss, grads, jloss, jgrads)
    assert counter.rounds == jcounter.rounds == {"vanilla": 4,
                                                 "hybrid": 2}[scheme]
    assert counter.kinds == jcounter.kinds
    assert counter.bytes_per_round == jcounter.bytes_per_round


# --------------------------------------------------------------------------
# (ii) the shims warn, and the shim is the pipeline's step
# --------------------------------------------------------------------------

def test_shims_warn_deprecation(world):
    w = world
    with pytest.warns(DeprecationWarning, match="repro_torch.pipeline"):
        _shim(tdist, w["tlayout"], "hybrid")
    with pytest.warns(DeprecationWarning, match="repro_torch.pipeline"):
        cache = tcache.build_degree_caches(w["tlayout"], CACHE_K)
    assert tuple(cache.ids.shape) == (P, CACHE_K)
    with pytest.warns(DeprecationWarning, match="resolve_hot_scorer"):
        hot = tcache.degree_hot_ids(w["tlayout"].graph, 10)
    with pytest.warns(DeprecationWarning):
        jhot = jcache.degree_hot_ids(w["jlayout"].graph, 10)
    np.testing.assert_array_equal(hot, jhot)


@pytest.mark.parametrize("scheme", ["vanilla", "hybrid"])
def test_shim_equals_pipeline_bit_for_bit(world, scheme):
    w = world
    spec = TSpec.from_scheme(scheme, num_parts=P, fanouts=FANOUTS)
    pipe = TPipeline.from_layout(w["tlayout"], spec, device="cpu")
    _, tfn = _loss_fns()
    loss, grads, _ = pipe.step_fn(tfn, device="cpu")(
        w["tparams"], w["tseeds"], SALT)
    shim = tdist.run_stacked(_port_shim(w, scheme), w["tparams"],
                             w["tshards"], w["tseeds"], SALT)
    _assert_same(shim, (loss, grads))


# --------------------------------------------------------------------------
# (iii) the cached step
# --------------------------------------------------------------------------

def test_cached_step_equals_uncached_and_repro(world, repro_runs):
    w = world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cache = tcache.build_degree_caches(w["tlayout"], CACHE_K)
    jcache_ = repro_runs["cache"]
    np.testing.assert_array_equal(cache.ids.numpy(),
                                  np.asarray(jcache_.ids))
    np.testing.assert_array_equal(cache.rows.numpy(),
                                  np.asarray(jcache_.rows))
    _, tfn = _loss_fns()
    counter = tdist.RoundCounter()
    cstep = tcache.make_cached_worker_step(
        graph_replicated=w["tlayout"].graph, offsets=w["tlayout"].offsets,
        num_parts=P, fanouts=FANOUTS, loss_fn=tfn, counter=counter)
    loss, grads, hit_rate = tcache.run_stacked_cached(
        cstep, w["tparams"], w["tshards"], w["tseeds"], SALT, cache)
    assert counter.rounds == 2
    base = tdist.run_stacked(_port_shim(w, "hybrid"), w["tparams"],
                             w["tshards"], w["tseeds"], SALT)
    _assert_same((loss, grads), base)
    jloss, jgrads, jhit = repro_runs["cached"]
    assert hit_rate.dtype == torch.float32
    assert float(hit_rate) == float(jhit) > 0.0
    _assert_near_repro(loss, grads, jloss, jgrads)


def test_fetch_features_cached_reexported():
    assert tcache.fetch_features_cached is tdist.fetch_features_cached


# --------------------------------------------------------------------------
# (iv) the legacy plans, (v) plan_from_legacy
# --------------------------------------------------------------------------

def test_legacy_plans_bit_identical(world):
    w = world
    jv, tv = w["jv"], w["tv"]
    assert isinstance(tv, tpart.VanillaPlan) and tv.layout is w["tlayout"]
    for f in ("local_indptr", "local_indices"):
        assert getattr(tv, f).dtype == torch.int32
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)))
    jh, th = jpart.build_hybrid(w["jlayout"]), tpart.build_hybrid(
        w["tlayout"])
    assert isinstance(th, tpart.HybridPlan) and th.layout is w["tlayout"]
    for f in ("offsets", "features", "labels", "node_valid"):
        np.testing.assert_array_equal(getattr(th.layout, f).numpy(),
                                      np.asarray(getattr(jh.layout, f)))
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(
            getattr(th.layout.graph, f).numpy(),
            np.asarray(getattr(jh.layout.graph, f)))


def test_plan_from_legacy_outcomes_equal_repro(world):
    w = world
    jl, tl = w["jlayout"], w["tlayout"]
    for scheme in ("vanilla", "hybrid"):
        kw = dict(offsets=None, num_parts=P)
        jp = jplace.plan_from_legacy(
            scheme, graph_replicated=jl.graph if scheme == "hybrid"
            else None, **kw)
        tp = tplace.plan_from_legacy(
            scheme, graph_replicated=tl.graph if scheme == "hybrid"
            else None, **kw)
        assert type(tp).__name__ == type(jp).__name__
        assert tp.scheme.name == jp.scheme.name == scheme
        assert tp.num_parts == jp.num_parts == P
        assert tp.local_indptr is None and jp.local_indptr is None
        assert tp.remote_source_fraction == jp.remote_source_fraction
        assert (tp.replicated_graph is tl.graph) == (scheme == "hybrid")
        assert (jp.replicated_graph is jl.graph) == (scheme == "hybrid")
    # a layout-free vanilla plan holds no shard topology
    for mod in (jplace, tplace):
        with pytest.raises(ValueError, match="built without a layout"):
            mod.plan_from_legacy("vanilla", num_parts=P).shard_topology()
    for scheme, graph in (("hybrid", None), ("hybrid_partial(0.25)", None),
                          ("hybrid_partial", None), ("ring", None),
                          ("hybrid_partial(x)", None)):
        with pytest.raises(ValueError) as je:
            jplace.plan_from_legacy(scheme, graph_replicated=graph)
        with pytest.raises(ValueError) as te:
            tplace.plan_from_legacy(scheme, graph_replicated=graph)
        assert str(te.value).replace("repro_torch", "repro") == \
            str(je.value), scheme


# --------------------------------------------------------------------------
# (vi) vanilla_fused with a raw level_fn
# --------------------------------------------------------------------------

def test_vanilla_fused_with_raw_level_fn_gives_repro_mfgs(world,
                                                          monkeypatch):
    w = world
    jfn, _ = _loss_fns()
    jprep, _ = j_prepare_consume(
        offsets=w["jlayout"].offsets, num_parts=P, fanouts=FANOUTS,
        loss_fn=jfn, scheme="vanilla", level_fn=j_sample_level,
        vanilla_fused=True)
    jb = jax.jit(jax.vmap(lambda sh, s: jprep(sh, s, jnp.uint32(SALT)),
                          axis_name=jdist.AXIS))(w["jshards"], w["jseeds"])

    def prepare(vanilla_fused):
        return t_make_prepare(offsets=w["tlayout"].offsets, num_parts=P,
                              fanouts=FANOUTS, scheme="vanilla",
                              level_fn=t_sample_level,
                              vanilla_fused=vanilla_fused)

    unfused_calls = []
    real = tdist.unfused_coo_csc_pass

    def counting(*a):
        unfused_calls.append(1)
        return real(*a)

    monkeypatch.setattr(tdist, "unfused_coo_csc_pass", counting)
    tb = prepare(True)(w["tshards"], w["tseeds"], SALT)
    # the override builds each level's row pointer directly
    assert not unfused_calls
    for tm, jm in zip(tb.mfgs, jb.mfgs):
        for f in MFG_FIELDS:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)), f)
    np.testing.assert_array_equal(tb.h_src.numpy(), np.asarray(jb.h_src))
    # the default with a raw level_fn pays the COO->CSC passes, same MFGs
    tu = prepare(None)(w["tshards"], w["tseeds"], SALT)
    assert len(unfused_calls) == len(FANOUTS)
    for a, b in zip(tu.mfgs, tb.mfgs):
        assert all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in MFG_FIELDS)


# --------------------------------------------------------------------------
# (vii) the MFG-level kernel ops and the oracle names
# --------------------------------------------------------------------------

def test_kernel_ops_and_oracle_names_match_repro(world):
    w = world
    jg, tg = w["jlayout"].graph, w["tlayout"].graph
    rng = np.random.default_rng(0)
    seeds = rng.integers(-1, 800, 40).astype(np.int32)
    for window in (2048, 4):
        samples, R, overflow = tops.fused_sample(
            tg, torch.from_numpy(seeds), 5, SALT, window=window)
        js, jr, jo = jref.ref_windowed_fused_sample(
            jg, jnp.asarray(seeds), 5, jnp.uint32(SALT), window)
        np.testing.assert_array_equal(samples.numpy(), np.asarray(js))
        np.testing.assert_array_equal(R.numpy(), np.asarray(jr))
        assert int(overflow) == jo
    assert jo > 0                           # window 4 truncates hubs
    js, jr = jref.ref_fused_sample(jg, jnp.asarray(seeds), 5,
                                   jnp.uint32(SALT))
    ts, tr = tref.ref_fused_sample(tg, torch.from_numpy(seeds), 5, SALT)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))

    # one MFG of the port's sampler: the aggregate over its edges
    mfg = t_sample_level(tg, torch.from_numpy(seeds), 5, SALT)
    h = rng.standard_normal((int(mfg.src_nodes.shape[-1]), 7)).astype(
        np.float32)
    want = np.asarray(jref.ref_mean_aggregate(jnp.asarray(mfg.edges.numpy()),
                                              jnp.asarray(h)))
    for got in (tops.sage_aggregate(mfg, torch.from_numpy(h)),
                tref.ref_mean_aggregate(mfg.edges, torch.from_numpy(h))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    # row gathers over ids in [-1, M): repro's oracles clamp ids past the
    # table, the port's kernels give them +0.0 rows
    table = rng.standard_normal((30, 9)).astype(np.float32)
    ids = rng.integers(-1, 30, 50).astype(np.int32)
    want = np.asarray(jref.ref_feature_gather(jnp.asarray(ids),
                                              jnp.asarray(table)))
    for got in (tops.feature_gather(torch.from_numpy(ids),
                                    torch.from_numpy(table)),
                tref.ref_feature_gather(torch.from_numpy(ids),
                                        torch.from_numpy(table))):
        np.testing.assert_array_equal(got.numpy(), want)
    from repro.kernels.gather import gather_rows_reference as j_gather_ref
    ids = rng.integers(-1, 40, 50).astype(np.int32)     # some past K
    np.testing.assert_array_equal(
        tgather.gather_rows_reference(torch.from_numpy(table),
                                      torch.from_numpy(ids)).numpy(),
        np.asarray(j_gather_ref(jnp.asarray(table), jnp.asarray(ids))))


# --------------------------------------------------------------------------
# (viii) make_shard_map_step in a 2-rank gloo fleet
# --------------------------------------------------------------------------

FLEET_RANK = textwrap.dedent("""
    import os
    import warnings
    import numpy as np
    import torch
    from repro_torch.core import dist
    from repro_torch.core.partition import (build_layout, build_vanilla,
                                            partition_graph,
                                            seeds_per_worker)
    from repro_torch.data.synthetic_graph import make_power_law_graph
    from repro_torch.launch import multihost
    from repro_torch.models.gnn import (GNNConfig, gnn_loss, init_gnn_params)

    P, FANOUTS, BATCH, SALT = 2, (3, 3), 8, 5

    def world():
        ds = make_power_law_graph(300, 5, num_features=6, num_classes=3,
                                  seed=1)
        assign = partition_graph(ds.graph, P, ds.labeled_mask, seed=0)
        layout = build_layout(ds.graph, ds.features, ds.labels, assign, P)
        v = build_vanilla(layout)
        shards = dist.WorkerShard(features=layout.features,
                                  labels=layout.labels,
                                  local_indptr=v.local_indptr,
                                  local_indices=v.local_indices)
        cfg = GNNConfig(in_dim=6, hidden_dim=8, num_classes=3,
                        num_layers=2, fanouts=FANOUTS, dropout=0.0)
        params = init_gnn_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        return layout, shards, cfg, params, seeds_per_worker(layout, BATCH,
                                                             3)

    def step(layout, cfg, scheme, group=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return dist.make_worker_step(
                graph_replicated=layout.graph, offsets=layout.offsets,
                num_parts=P, fanouts=FANOUTS, scheme=scheme,
                loss_fn=lambda p, m, h, y, v: gnn_loss(p, m, h, y, v, cfg),
                group=group)

    def flat(loss, grads):
        return np.concatenate([[float(loss)]] + [
            g.reshape(-1).numpy() for layer in grads
            for _, g in sorted(layer.items())])

    if __name__ == "__main__":
        torch.set_num_threads(1)
        rank, _, _ = multihost.init_from_env()
        layout, shards, cfg, params, seeds = world()
        group = dist.rank_group(P)
        out = {}
        for scheme in ("hybrid", "vanilla"):
            run = dist.make_shard_map_step(step(layout, cfg, scheme, group),
                                           group)
            out[scheme] = flat(*run(params, shards, seeds, SALT))
        np.savez(os.path.join(os.environ["SEED_API_OUT"],
                              f"rank{rank}.npz"), **out)
        torch.distributed.destroy_process_group()
""")


def test_shard_map_step_refuses_a_step_of_another_group(world):
    group = tdist.RankGroup(lo=0, hi=1, num_parts=2)
    with pytest.raises(ValueError, match="group"):
        tdist.make_shard_map_step(_port_shim(world, "hybrid"), group)


def test_shard_map_step_fleet_equals_run_stacked(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(FLEET_RANK)
    env = dict(os.environ, SEED_API_OUT=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    multihost.launch([sys.executable, str(script)], num_procs=2,
                     device="cpu", timeout=FLEET_TIMEOUT,
                     log_dir=str(tmp_path / "logs"), env=env)
    ns = {"__name__": "stacked"}
    exec(FLEET_RANK, ns)
    layout, shards, cfg, params, seeds = ns["world"]()
    for scheme in ("hybrid", "vanilla"):
        stacked = ns["flat"](*tdist.run_stacked(
            ns["step"](layout, cfg, scheme), params, shards, seeds,
            ns["SALT"]))
        for r in range(2):
            got = np.load(tmp_path / f"rank{r}.npz")[scheme]
            np.testing.assert_array_equal(got, stacked, err_msg=scheme)


def test_paper_table1_and_have_ogb_equal_repro():
    from repro.data import ogb as jogb
    from repro.data.synthetic_graph import PAPER_TABLE1 as J_TABLE1
    from repro_torch.data import ogb as togb
    from repro_torch.data.synthetic_graph import PAPER_TABLE1 as T_TABLE1
    assert T_TABLE1 == J_TABLE1
    assert togb.HAVE_OGB is jogb.HAVE_OGB
