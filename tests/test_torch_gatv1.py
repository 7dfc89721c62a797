"""The port's ``gatv1`` conv (the published GAT: self-loop attention,
concatenated hidden heads, averaged output heads, a skip, ELU) on the CPU,
where its attention runs the ``gat_attention`` kernels' plain versions:

  * logits and the gradient of every parameter against the benchmark's
    plain reference (``portbench/models/gatv1.py``, written from the
    layer's equations) on random message-flow graphs, seeded weights with
    biases moved off zero and dropout 0.5 drawn from one generator seed on
    both sides, rtol = atol = 1e-5 (fp32; the two order their products'
    and sums' additions differently, as ``tests/test_torch_convs.py``'s);
  * the graphs hold a row whose only slot is the self loop, rows whose
    sampled edges name the row itself, and padded rows (no valid edge):
    the self loop alone gives the row's own projection, a sampled self
    edge counts as nothing beside the self slot;
  * the attention's table contract: its plain forward equals gathering
    each slot's row and attending over the gathered rows, to the bit, and
    its plain backward (the table's gradient) is autograd's through that
    composition, on duplicate sources, a hub, rows with no valid edge,
    sampled self edges, with and without the worker axis;
  * 751 574 parameters at the configuration's widths (PyG's
    ``ogbn_products_gat.py``), from the port's ``init_gnn_params`` and the
    reference's ``init_params`` alike; ``gat`` builds no ``b_att`` and
    keeps relu;
  * exact inference (``layerwise_inference``) within 1e-5 of the sampled
    forward at dropout 0 where the fanouts take every in-edge.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference
from repro_torch.core.graph import csc_from_numpy_edges
from repro_torch.core.inference import layerwise_inference
from repro_torch.core.mfg import MFG
from repro_torch.core.sampler import sample_mfgs
from repro_torch.kernels.gat_attention import (gat_attention_backward_plain,
                                               gat_attention_plain,
                                               per_edge_attention_plain)
from repro_torch.models.gnn import (GNNConfig, _rows, apply_layer,
                                    gnn_forward, init_gnn_params)

ROOT = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5
MODEL = {"conv": "gatv1", "in_dim": 12, "hidden_dim": 16, "num_classes": 5,
         "num_layers": 3, "fanouts": [3, 3, 2], "dropout": 0.5,
         "gat_heads": 4}
NET = reference.load_model(ROOT / "portbench/models", "gatv1")


def _cfg(model=MODEL, **kw):
    model = dict(model, **kw)
    return GNNConfig(**{k: tuple(v) if k == "fanouts" else v
                        for k, v in model.items()})


def _graphs(seed=0, top=6):
    """(the reference's levels, the port's MFGs, h0 (1, N, 12)), top
    first, one worker: row 0 of every level samples itself, row 1 only
    the self loop, the last row padding."""
    rng = np.random.default_rng(seed)
    levels, mfgs, S = [], [], top
    for F in MODEL["fanouts"]:
        N = S + S * F
        edges = rng.integers(-1, N, size=(1, S, F))
        edges[0, 0, 0] = edges[0, 0, F - 1] = 0
        edges[0, 1] = edges[0, -1] = -1
        dst = torch.arange(S)[None]
        dst[0, -1] = -1
        levels.append(reference.Level(dst=dst, edges=torch.from_numpy(edges),
                                      src=None))
        e32 = torch.from_numpy(edges.astype(np.int32))
        mfgs.append(MFG(dst_nodes=dst.int(),
                        src_nodes=torch.arange(N, dtype=torch.int32)[None],
                        num_src=torch.tensor([N]), edges=e32,
                        edge_mask=e32 >= 0,
                        indptr=torch.zeros((1, S + 1), dtype=torch.int32)))
        S = N
    h0 = torch.from_numpy(rng.standard_normal((1, S, MODEL["in_dim"]),
                                              dtype=np.float32))
    return levels, mfgs, h0


def _params(seed=5):
    rng = np.random.default_rng(seed)
    params = NET.init_params(MODEL, seed, "cpu")
    for layer in params:
        for k in ("b_att", "b"):
            layer[k] = torch.from_numpy(rng.standard_normal(
                layer[k].shape, dtype=np.float32)) * 0.1
    return params


def _leaves(params):
    return {f"l{i}.{k}": v.clone().requires_grad_(True)
            for i, layer in enumerate(params) for k, v in layer.items()}


def _shaped(params, leaves):
    return [{n: leaves[f"l{i}.{n}"] for n in layer}
            for i, layer in enumerate(params)]


def test_forward_and_gradients_match_the_plain_reference():
    levels, mfgs, h0 = _graphs()
    params = _params()
    ref_l, port_l = _leaves(params), _leaves(params)
    want = NET.forward(_shaped(params, ref_l), levels, 0, h0[0], MODEL,
                       torch.Generator().manual_seed(7),
                       lambda x, w: x @ w)
    got = gnn_forward(_shaped(params, port_l), mfgs, h0, _cfg(),
                      generator=torch.Generator().manual_seed(7))[0]
    np.testing.assert_allclose(got.detach(), want.detach(), rtol=RTOL,
                               atol=ATOL)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        want.shape, dtype=np.float32))
    g_ref = torch.autograd.grad((want * w).sum(), list(ref_l.values()))
    g_port = torch.autograd.grad((got * w).sum(), list(port_l.values()))
    for name, a, b in zip(ref_l, g_port, g_ref):
        assert float(b.abs().max()) > 0, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_self_loop_rows_and_sampled_self_edges():
    """At dropout 0, one hidden layer: a row with no valid edge (only its
    self loop, or padding) attends to itself alone; a row whose sampled
    edges name itself gives what it gives with those edges invalid."""
    _, mfgs, h0 = _graphs()
    cfg = _cfg(dropout=0.0)
    layer = NET.init_params(MODEL, 3, "cpu")[0]
    mfg = mfgs[-1]

    def run(m):
        return apply_layer(layer, m, h0, cfg, is_last=False)[0]

    out = run(mfg)
    h_dst = h0[0, :mfg.num_dst]
    alone = torch.nn.functional.elu(
        h_dst @ layer["w_neigh"] + layer["b_att"] + h_dst @ layer["w_self"]
        + layer["b"])
    for row in (1, mfg.num_dst - 1):
        np.testing.assert_allclose(out[row], alone[row], rtol=RTOL,
                                   atol=ATOL)
    edges = mfg.edges.clone()
    edges[0, 0][edges[0, 0] == 0] = -1
    no_self = MFG(**{**mfg.__dict__, "edges": edges,
                     "edge_mask": edges >= 0})
    assert (mfg.edges[0, 0] == 0).sum() == 2
    assert torch.equal(run(no_self)[0], out[0])


def _table_case(lead, prefix, S=24, F=3, H=3, C=5):
    """A table-contract case in float64 (z, edges, dst, keep, a_src,
    a_dst): row 0 names source 7 twice, row 1 samples itself, row 2 has no
    valid edge, rows 3 on name source 5 twice each (more slots than one
    chunk of the card's backward holds); dst the prefix or S distinct
    rows."""
    rng = np.random.default_rng(4)
    N = S + S * F
    edges = rng.integers(-1, N, (*lead, S, F))
    e = edges.reshape(-1, S, F)
    e[:, 0, :2] = 7
    e[:, 2] = -1
    e[:, 3:, 0] = e[:, 3:, 2] = 5
    dst = np.arange(S) if prefix else rng.permutation(N)[:S]
    e[:, 1, 0] = dst[1]
    dst = np.broadcast_to(dst, (*lead, S)).copy()
    keep = torch.from_numpy((edges >= 0) & (edges != dst[..., None]))
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).requires_grad_(True)
    return (t(*lead, N, H * C), torch.from_numpy(edges).int(),
            torch.from_numpy(dst).int(), keep, t(H, C), t(H, C))


@pytest.mark.parametrize("lead,prefix", [((), False), ((1,), True),
                                         ((3,), True), ((2,), False)])
def test_the_plain_backward_is_autograds_gradient(lead, prefix):
    """The table contract's plain backward against autograd through the
    per-edge composition (each slot's row gathered by ``_rows``, then
    ``per_edge_attention_plain``), float64: duplicate sources, a hub past
    one chunk, a row with no valid edge, a sampled self edge, the leading
    worker axis; the forward equals the composition to the bit."""
    z, edges, dst, keep, a_src, a_dst = _table_case(lead, prefix)
    *_, S, F = edges.shape
    H, C = a_src.shape
    rows = S * int(np.prod(lead))
    z_nb = _rows(z, edges.clamp(min=0).long())
    z_dst = _rows(z, dst.long())
    want_out, want_alpha = per_edge_attention_plain(
        z_nb.reshape(rows, F, H * C), z_dst.reshape(rows, H * C),
        keep.reshape(rows, F), a_src, a_dst)
    out, alpha = gat_attention_plain(z, edges, dst, keep, a_src, a_dst)
    assert torch.equal(out.reshape(want_out.shape), want_out)
    assert torch.equal(alpha.reshape(want_alpha.shape), want_alpha)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (*lead, S, H, C)))
    want = torch.autograd.grad((want_out * g.reshape(rows, H, C)).sum(),
                               [z, a_src, a_dst])
    got = gat_attention_backward_plain(g, z.detach(), edges, dst, keep,
                                       a_src.detach(), a_dst.detach(),
                                       alpha.detach())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # a slot not kept: no weight; a row no kept slot names: no gradient
    assert float(alpha.detach()[..., 1:, :][~keep].abs().max()) == 0.0
    ids = torch.cat([dst[..., None], edges], -1).long()
    kept = torch.cat([torch.ones_like(keep[..., :1]), keep], -1)
    N = z.shape[-2]
    flat = ids.reshape(-1, ids.shape[-2] * (F + 1)) \
        + torch.arange(rows // S)[:, None] * N
    named = torch.zeros(rows // S * N, dtype=torch.bool)
    named[flat[kept.reshape(flat.shape)]] = True
    assert float(got[0].reshape(-1, H * C)[~named].abs().max()) == 0.0
    assert int(kept[ids == 5].sum()) > 32


def test_parameter_count_at_the_configurations_widths():
    cfg = json.loads((ROOT / "portbench/configs/gat-products.json")
                     .read_text())["model"]
    port = init_gnn_params(_cfg(cfg), torch.Generator().manual_seed(0),
                           "cpu")
    ref = NET.init_params(cfg, 0, "cpu")
    for params in (port, ref):
        assert sum(v.numel() for layer in params
                   for v in layer.values()) == 751_574
    assert [{k: v.shape for k, v in layer.items()} for layer in port] == \
        [{k: v.shape for k, v in layer.items()} for layer in ref]
    assert ref[2]["w_neigh"].shape == (512, 4 * 47)
    assert ref[2]["b_att"].shape == ref[2]["b"].shape == (47,)


def test_gat_builds_no_conv_bias_and_keeps_relu():
    cfg = _cfg(conv="gat", dropout=0.0)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any("b_att" in layer for layer in params)
    _, mfgs, h0 = _graphs()
    out = apply_layer(params[0], mfgs[-1], h0, cfg, is_last=False)
    assert float(out.min()) == 0.0
    v1 = apply_layer(NET.init_params(MODEL, 0, "cpu")[0], mfgs[-1], h0,
                     _cfg(dropout=0.0), is_last=False)
    assert float(v1.min()) < 0.0            # ELU


def test_exact_inference_is_the_sampled_forward_over_every_in_edge():
    rng = np.random.default_rng(2)
    n = 60
    dst = rng.integers(0, n, 240)
    src = rng.integers(0, n, 240)
    dst[:3], src[:3] = 5, 5                 # self edges
    graph = csc_from_numpy_edges(dst, src, n)
    width = int(graph.degrees().max())
    cfg = _cfg(dropout=0.0, fanouts=[width] * 3)
    params = NET.init_params(MODEL, 9, "cpu")
    features = torch.from_numpy(rng.standard_normal(
        (n, MODEL["in_dim"]), dtype=np.float32))
    exact = layerwise_inference(params, graph, features, cfg, batch_size=16)
    seeds = torch.arange(0, n, 3, dtype=torch.int32)
    mfgs = sample_mfgs(graph, seeds, cfg.fanouts, salt=1)
    src_nodes = mfgs[-1].src_nodes
    h0 = torch.where((src_nodes >= 0)[:, None],
                     features[src_nodes.clamp(min=0).long()], 0.0)
    sampled = gnn_forward(params, mfgs, h0, cfg)
    np.testing.assert_allclose(sampled.detach(), exact[seeds.long()],
                               rtol=RTOL, atol=ATOL)
