"""The port's feature cache and feature stores against ``repro``'s, on
the CPU.

  * Seeds per step, cache ids (sentinel padding included) and cache rows
    are bit-identical to ``repro``'s.
  * The ``pinned_hot`` store's rows and hit counts equal ``repro``'s
    ``PinnedHotStore`` (its ``jnp`` gather; ``repro``'s Pallas
    ``gather_rows`` needs ``pl.load``, which the installed JAX lacks), and
    the port's ``pinned_hot`` equals its ``exchange`` store with the same
    cache bit for bit.
  * Spec validation and the registries.

``repro``'s prepare half runs jitted under ``jax.vmap`` over the worker
axis; the port's runs once over the stacked axis.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dist as jdist
from repro.core.cache import degree_caches as j_degree_caches
from repro.data.spec import DataSpec as JDataSpec
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro_torch.core import dist as tdist
from repro_torch.core.cache import (SENTINEL, available_cache_policies,
                                    degree_caches, resolve_cache_policy)
from repro_torch.core.feature_store import (ExchangeStore, PinnedHotStore,
                                            available_feature_stores,
                                            resolve_feature_store)
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.pipeline import PlanSpec

DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=4, seed=3)
FANOUTS = (4, 3)
K = 64
BATCH = 16


def _jspec(P, store, cache=K):
    return JSpec.from_scheme("hybrid+fused", num_parts=P, fanouts=FANOUTS,
                             fused_backend="reference", cache_capacity=cache,
                             feature_store=store, data=JDataSpec(**DATA))


def _tspec(P, store, cache=K):
    return TSpec.from_scheme("hybrid+fused", num_parts=P, fanouts=FANOUTS,
                             cache_capacity=cache, feature_store=store,
                             data=TDataSpec(**DATA))


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request):
    P = request.param
    jpin = JPipeline.build_from_source(spec=_jspec(P, "pinned_hot"))
    tpin = TPipeline.build_from_source(spec=_tspec(P, "pinned_hot"),
                                       device="cpu")
    texc = TPipeline.from_layout(tpin.layout, _tspec(P, "exchange"),
                                 device="cpu")
    return P, jpin, tpin, texc


def _j_prepare(jpipe, seeds, salt):
    prepare, _ = jpipe.make_prepare_consume(lambda *a: 0.0, counted=False)
    run = jax.jit(jax.vmap(lambda sh, s, c, t: prepare(sh, s, t, c),
                           in_axes=(0, 0, 0, None), axis_name=jdist.AXIS))
    return run(jpipe.shards, jnp.asarray(seeds), jpipe.cache,
               jnp.uint32(salt))


def _t_prepare(tpipe, seeds, salt):
    prepare, _ = tpipe.make_prepare_consume(lambda *a: None, counted=False,
                                            device="cpu")
    return prepare(tpipe.shards, torch.from_numpy(seeds), salt, tpipe.cache)


@pytest.mark.parametrize("salt", [0, 7, 2**32 - 1])
def test_seeds_per_step_bit_identical(world, salt):
    P, jpin, tpin, _ = world
    for batch in (1, BATCH, 500):
        np.testing.assert_array_equal(tpin.seeds_host(batch, salt),
                                      jpin.seeds_host(batch, salt))
    assert tpin.seeds(BATCH, salt).dtype == torch.int32


def test_cache_ids_and_rows_bit_identical(world):
    P, jpin, tpin, _ = world
    assert tpin.cache.ids.shape == (P, K)
    np.testing.assert_array_equal(tpin.cache.ids.numpy(),
                                  np.asarray(jpin.cache.ids))
    np.testing.assert_array_equal(tpin.cache.rows.numpy(),
                                  np.asarray(jpin.cache.rows))


def test_cache_pads_with_the_sentinel_when_remote_nodes_run_out(world):
    """A capacity above the remote node count pads each worker's sorted
    ids with 2**31 - 1 after the valid ones and zero rows, as ``repro``
    does."""
    P, jpin, tpin, _ = world
    cap = 1000
    t = degree_caches(tpin.layout, cap)
    j = j_degree_caches(jpin.layout, cap)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    ids = t.ids.numpy()
    pad = ids == SENTINEL
    assert pad.any()
    for row, row_pad in zip(ids, pad):
        n = int((~row_pad).sum())
        assert row_pad[n:].all()                   # padding is a suffix
        assert (np.diff(row[:n]) > 0).all()        # valid ids ascend
    assert not t.rows.numpy()[pad].any()


@pytest.mark.parametrize("salt", [3, 11])
def test_pinned_hot_rows_and_hits_match_repro(world, salt):
    P, jpin, tpin, _ = world
    seeds = tpin.seeds_host(BATCH, salt)
    jb = _j_prepare(jpin, seeds, salt)
    tb = _t_prepare(tpin, seeds, salt)
    np.testing.assert_array_equal(tb.mfgs[-1].src_nodes.numpy(),
                                  np.asarray(jb.mfgs[-1].src_nodes))
    np.testing.assert_array_equal(tb.h_src.numpy(), np.asarray(jb.h_src))
    np.testing.assert_array_equal(tb.hits.numpy(), np.asarray(jb.hits))
    assert int(tb.hits.sum()) > 0
    np.testing.assert_array_equal(
        tb.comm["feature_utilized_bytes"].numpy(),
        np.asarray(jb.comm["feature_utilized_bytes"]))


def test_pinned_hot_equals_exchange_with_the_same_cache(world):
    P, _, tpin, texc = world
    assert isinstance(tpin.feature_store, PinnedHotStore)
    assert isinstance(texc.feature_store, ExchangeStore)
    for salt in (0, 5):
        seeds = tpin.seeds_host(BATCH, salt)
        a = _t_prepare(tpin, seeds, salt)
        b = _t_prepare(texc, seeds, salt)
        assert torch.equal(a.h_src, b.h_src)
        assert torch.equal(a.hits, b.hits)


def test_cached_fetch_rows_equal_the_uncached_fetch(world):
    """Hits served from the cache give the owners' rows bit for bit, and
    only misses ride the exchange (its 2 rounds are still counted)."""
    P, _, tpin, _ = world
    seeds = tpin.seeds_host(BATCH, 1)
    src = _t_prepare(tpin, seeds, 1).mfgs[-1].src_nodes
    lay = tpin.layout
    plain = tdist.fetch_features(src, lay.offsets, P, lay.features, None)
    counter = tdist.RoundCounter()
    h, hits = tdist.fetch_features_cached(src, lay.offsets, P,
                                          lay.features, tpin.cache, counter)
    assert torch.equal(h, plain)
    is_hit, _ = tdist.cache_lookup(tpin.cache, src)
    assert torch.equal(hits, is_hit.sum(dim=-1))
    assert counter.kinds == ["feature", "feature"]


def test_registries_and_spec_validation():
    assert available_feature_stores() == ("exchange", "pinned_hot",
                                          "staged")
    assert available_cache_policies() == ("degree", "frequency")
    assert resolve_feature_store("pinned_hot").needs_cache
    assert resolve_cache_policy("degree") is degree_caches
    with pytest.raises(ValueError, match="cache_capacity > 0"):
        PlanSpec(num_parts=2, feature_store="pinned_hot")
    with pytest.raises(ValueError, match="unknown feature store"):
        PlanSpec(num_parts=2, feature_store="remote", cache_capacity=4)
    with pytest.raises(ValueError, match="unknown cache policy"):
        PlanSpec(num_parts=2, cache_capacity=4, cache_policy="lru")
    with pytest.raises(ValueError, match="cache_capacity must be >= 0"):
        PlanSpec(num_parts=2, cache_capacity=-1)
    with pytest.raises(ValueError, match="needs a built cache"):
        PinnedHotStore().fetch(torch.zeros((1, 2), dtype=torch.int32), None,
                               None, offsets=None, num_parts=1)
