"""Exact layer-wise inference in the port (``repro_torch.core.inference``)
against ``repro.core.inference`` and a dense reference, on the CPU.

  * ``full_neighborhood_level``'s MFG equals ``repro``'s bit for bit in all
    six fields, uncapped and capped, with padding seeds.
  * ``layerwise_inference`` equals ``repro``'s within the port's forward
    parity tolerance, rtol = atol = 1e-5 (fp32; XLA and torch order their
    matmul reductions differently), uncapped and capped; and a float64
    dense-adjacency reference (mean over in-edges, as
    ``tests/test_convs_inference.py`` builds it) within the same.
  * A cap at or above the max in-degree gives the uncapped bits; a cap
    below it takes each node's first in-edges in CSC order; a cap below 1
    raises.
  * The batch size does not change the logits' bits (``rowwise_matmul``
    issues every product in fixed row blocks, and a row's mean does not
    depend on its batchmates).
  * A graph whose max in-degree is past the forward kernel's
    ``MAX_STAGED_IDS`` runs uncapped (on the CPU the plain version; on the
    card ``chip_smoke.py`` phase 11 holds the wide-row kernel to the
    f-ordered loop).

``repro``'s side is jitted (its layer is one jitted program per width).
Parameters are ``repro``'s, carried across with ``params_from_numpy``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.inference import full_neighborhood_level as j_full
from repro.core.inference import layerwise_inference as j_infer
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import init_gnn_params as j_init
from repro_torch.core.graph import CSCGraph
from repro_torch.core.inference import (full_neighborhood_level, in_edges,
                                        inference_width, layerwise_inference)
from repro_torch.kernels.sage_aggregate import MAX_STAGED_IDS
from repro_torch.models.gnn import GNNConfig, params_from_numpy

RTOL = ATOL = 1e-5
MFG_FIELDS = ("dst_nodes", "src_nodes", "num_src", "edges", "edge_mask",
              "indptr")
BATCH = 64


def _cfgs(num_layers=2):
    kw = dict(in_dim=12, hidden_dim=16, num_classes=4,
              num_layers=num_layers, fanouts=(3,) * num_layers, dropout=0.0)
    return JConfig(**kw), GNNConfig(**kw)


@pytest.fixture(scope="module")
def world(small_dataset):
    """(repro dataset, port graph, port features, repro params, port
    params, configs) on the 800-node graph."""
    ds = small_dataset
    g = CSCGraph(indptr=torch.from_numpy(np.array(ds.graph.indptr)),
                 indices=torch.from_numpy(np.array(ds.graph.indices)))
    jcfg, tcfg = _cfgs()
    jparams = j_init(jax.random.key(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    feats = torch.from_numpy(np.array(ds.features, np.float32))
    return ds, g, feats, jparams, tparams, jcfg, tcfg


@pytest.fixture(scope="module")
def uncapped(world):
    """(port logits, repro logits), uncapped."""
    ds, g, feats, jparams, tparams, jcfg, tcfg = world
    got = layerwise_inference(tparams, g, feats, tcfg, batch_size=BATCH)
    ref = j_infer(jparams, ds.graph, jnp.asarray(ds.features), jcfg,
                  batch_size=BATCH)
    return got.numpy(), np.asarray(ref)


def _max_degree(g: CSCGraph) -> int:
    return int(g.degrees().max())


def _dense_reference(graph: CSCGraph, feats, params, num_layers,
                     cap=None) -> np.ndarray:
    """float64 mean over each node's (first ``cap``) in-edges, then the
    SAGE products, layer by layer."""
    indptr, indices = graph.numpy()
    n = graph.num_nodes
    A = np.zeros((n, n))
    for v in range(n):
        nb = indices[indptr[v]:indptr[v + 1]]
        for u in (nb if cap is None else nb[:cap]):
            A[v, u] += 1.0
    deg = np.maximum(A.sum(1, keepdims=True), 1.0)
    h = np.asarray(feats, np.float64)
    for layer in range(num_layers):
        p = {k: np.asarray(v, np.float64) for k, v in params[layer].items()}
        out = h @ p["w_self"] + ((A @ h) / deg) @ p["w_neigh"] + p["b"]
        h = np.maximum(out, 0.0) if layer < num_layers - 1 else out
    return h


# --------------------------------------------------------------------------
# the MFG
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 5, 1], ids=["max-degree", "cap5",
                                                   "cap1"])
def test_full_neighborhood_level_matches_repro_bit_for_bit(world, cap):
    ds, g, *_ = world
    width = _max_degree(g) if cap is None else cap
    seeds = np.arange(100, 164, dtype=np.int32)
    seeds[[5, 40]] = -1
    seeds[7] = int(np.argmax(np.diff(np.asarray(ds.graph.indptr))))
    seeds[-1] = g.num_nodes - 1
    ref = jax.jit(lambda s: j_full(ds.graph, s, width))(jnp.asarray(seeds))
    got = full_neighborhood_level(g, torch.from_numpy(seeds), width)
    for field in MFG_FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def test_in_edges_are_the_first_in_edges_in_csc_order(world):
    _, g, *_ = world
    indptr, indices = g.numpy()
    seeds = torch.tensor([0, 3, -1, g.num_nodes - 1], dtype=torch.int32)
    for width in (1, 4, _max_degree(g) + 2):
        samples, valid = in_edges(g, seeds, width)
        assert samples.dtype == torch.int32 and samples.shape == (4, width)
        for i, v in enumerate(seeds.tolist()):
            want = ([] if v < 0
                    else indices[indptr[v]:indptr[v + 1]][:width].tolist())
            assert samples[i, :len(want)].tolist() == want
            assert valid[i].sum() == len(want)
            assert (samples[i, len(want):] == -1).all()


# --------------------------------------------------------------------------
# the logits
# --------------------------------------------------------------------------

def test_layerwise_inference_matches_repro(uncapped, world):
    got, ref = uncapped
    _, g, *_ = world
    assert got.shape == (g.num_nodes, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cap", [8, 3])
def test_capped_inference_matches_repro(world, cap):
    ds, g, feats, jparams, tparams, jcfg, tcfg = world
    assert cap < _max_degree(g)
    got = layerwise_inference(tparams, g, feats, tcfg, batch_size=BATCH,
                              max_degree=cap)
    ref = j_infer(jparams, ds.graph, jnp.asarray(ds.features), jcfg,
                  batch_size=BATCH, max_degree=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_layerwise_inference_matches_dense_reference(uncapped, world):
    got, _ = uncapped
    _, g, feats, _, tparams, _, tcfg = world
    ref = _dense_reference(g, feats.numpy(),
                           [{k: v.numpy() for k, v in p.items()}
                            for p in tparams], tcfg.num_layers)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_cap_at_or_above_max_degree_gives_the_uncapped_bits(uncapped,
                                                             world):
    got, _ = uncapped
    _, g, feats, _, tparams, _, tcfg = world
    for cap in (_max_degree(g), _max_degree(g) + 13):
        capped = layerwise_inference(tparams, g, feats, tcfg,
                                     batch_size=BATCH, max_degree=cap)
        np.testing.assert_array_equal(capped.numpy(), got)


def test_cap_truncates_to_the_first_in_edges(world):
    """A node of in-degree above the cap takes the mean over its first
    ``cap`` in-edges in CSC order: a one-layer model against the dense
    reference built from those edges, and a node over the cap differs
    from the uncapped result."""
    _, g, feats, _, tparams, _, _ = world
    cap = 3
    _, cfg1 = _cfgs(num_layers=1)
    layer = [{"w_self": tparams[0]["w_self"][:, :4],
              "w_neigh": tparams[0]["w_neigh"][:, :4],
              "b": tparams[0]["b"][:4]}]
    got = layerwise_inference(layer, g, feats, cfg1, batch_size=BATCH,
                              max_degree=cap).numpy()
    np_layer = [{k: v.numpy() for k, v in layer[0].items()}]
    ref = _dense_reference(g, feats.numpy(), np_layer, 1, cap=cap)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    full = layerwise_inference(layer, g, feats, cfg1,
                               batch_size=BATCH).numpy()
    over = (g.degrees() > cap).numpy()
    assert over.any()
    assert not np.allclose(got[over], full[over])
    np.testing.assert_array_equal(got[~over], full[~over])


@pytest.mark.parametrize("cap", [0, -3])
def test_cap_below_one_raises(world, cap):
    _, g, feats, _, tparams, _, tcfg = world
    with pytest.raises(ValueError, match="max_degree must be >= 1"):
        layerwise_inference(tparams, g, feats, tcfg, max_degree=cap)
    with pytest.raises(ValueError, match="max_degree must be >= 1"):
        inference_width(g, cap)


@pytest.mark.parametrize("batch_size", [7, 100, 800, 1024])
def test_batch_size_does_not_change_the_bits(uncapped, world, batch_size):
    got, _ = uncapped
    _, g, feats, _, tparams, _, tcfg = world
    other = layerwise_inference(tparams, g, feats, tcfg,
                                batch_size=batch_size)
    np.testing.assert_array_equal(other.numpy(), got)


def test_wide_rows_past_the_staged_ids_run_uncapped():
    """A hub of in-degree MAX_STAGED_IDS + 40: the inference width is past
    the ids a block of the forward kernel stages, and the uncapped logits
    match the dense reference."""
    n = MAX_STAGED_IDS + 200
    rng = np.random.default_rng(0)
    hub_src = rng.permutation(np.arange(1, n))[:MAX_STAGED_IDS + 40]
    dst = np.concatenate([np.zeros(hub_src.size, np.int64),
                          rng.integers(1, n, 3 * n)])
    src = np.concatenate([hub_src, rng.integers(0, n, 3 * n)])
    keep = dst != src
    dst, src = dst[keep], src[keep]
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    g = CSCGraph(indptr=torch.from_numpy(np.cumsum(indptr).astype(
                     np.int32)),
                 indices=torch.from_numpy(src[order].astype(np.int32)))
    assert inference_width(g) == MAX_STAGED_IDS + 40
    cfg = GNNConfig(in_dim=4, hidden_dim=8, num_classes=3, num_layers=2,
                    fanouts=(3, 3), dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    params = [{"w_self": torch.randn(a, b, generator=gen),
               "w_neigh": torch.randn(a, b, generator=gen),
               "b": torch.randn(b, generator=gen)}
              for a, b in ((4, 8), (8, 3))]
    feats = torch.randn(n, 4, generator=gen)
    got = layerwise_inference(params, g, feats, cfg, batch_size=256)
    assert got.shape == (n, 3) and torch.isfinite(got).all()
    # the dense reference as sparse sums (an n x n float64 matrix would be
    # 0.5 GB)
    indptr_np, indices_np = g.numpy()
    dst_of = np.repeat(np.arange(n), np.diff(indptr_np))
    deg = np.maximum(np.diff(indptr_np), 1)[:, None]
    h = feats.numpy().astype(np.float64)
    for layer, p in enumerate(params):
        agg = np.zeros_like(h)
        np.add.at(agg, dst_of, h[indices_np])
        w = {k: v.numpy().astype(np.float64) for k, v in p.items()}
        out = h @ w["w_self"] + (agg / deg) @ w["w_neigh"] + w["b"]
        h = np.maximum(out, 0.0) if layer == 0 else out
    np.testing.assert_allclose(got.numpy(), h, rtol=RTOL, atol=ATOL)
