"""The gcn, gat and gin convs of the port against ``repro.models.gnn``, on
the CPU, each a case of one test parametrised over the conv:

  * forward logits and the loss's gradients on the same MFGs with
    ``repro``'s parameters carried across, rtol = atol = 1e-5 (fp32; XLA
    and torch order their matmul and reduction sums differently);
  * the conv's own parameters: ``init_gnn_params`` gives ``repro``'s keys
    and shapes, gat's head-indivisible last layer takes the mean (no
    attention vectors), gin's ``eps`` has a gradient, gcn's unused
    ``w_self`` a zero one; gat's edges gathered from a projected table of
    more rows (exact inference's) have the bits of the projected gathered
    rows (training's);
  * ``layerwise_inference`` against ``repro``'s, uncapped and capped;
    gin's absolute tolerance is 1e-5 of its largest |logit| where that
    passes 1: its sum grows with the in-degree (logits reach 3e1 over the
    hubs here), and an entry that cancels to near zero carries the
    rounding of its row's scale;
  * one AdamW step through the ``SyncDriver`` against ``repro``'s, whose
    side runs ``fused_backend="reference"`` (its Pallas sampler needs
    ``pl.load``, which the installed JAX lacks; every degree here lies
    inside the window, where the two are bit-identical);
  * served outputs equal direct ``predict`` bit for bit.

``repro``'s side is jitted.  Widths: 12 -> 16 -> 6, so gat's hidden layer
has 4 heads of 4 and its last layer (6 % 4 != 0) falls back to the mean.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.inference import layerwise_inference as j_infer
from repro.core.sampler import sample_mfgs as j_sample_mfgs
from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_forward as j_forward
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.optim import optimizers as jopt
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro_torch.core.graph import CSCGraph
from repro_torch.core.inference import layerwise_inference
from repro_torch.core.mfg import MFG
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.models.gnn import (GNNConfig, apply_layer, gat_project,
                                    gnn_forward, gnn_loss, init_gnn_params,
                                    params_from_numpy, params_to_numpy)
from repro_torch.optim import optimizers as topt
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.serve import GNNServer, Predictor
from repro_torch.serve.traffic import hotset_arrivals

CONVS = ["gcn", "gat", "gin"]
RTOL = ATOL = 1e-5
FANOUTS = (4, 3)
DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=6, seed=3)
P = 2
BATCH = 16
LR = 0.006


def _cfgs(conv):
    kw = dict(in_dim=12, hidden_dim=16, num_classes=6, num_layers=2,
              fanouts=FANOUTS, dropout=0.0, conv=conv, gat_heads=4)
    return JConfig(**kw), GNNConfig(**kw)


def _params(conv):
    """``repro``'s parameters (gin's eps moved off 0, so it scales
    something) and the port's copy."""
    jcfg, _ = _cfgs(conv)
    jparams = j_init(jax.random.key(2), jcfg)
    jparams = jax.tree.map(lambda x: x + 0.25 if x.ndim == 0 else x,
                           jparams)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")


@pytest.fixture(scope="module")
def pipes():
    """(repro pipeline, port pipeline) on the 800-node graph, P = 2,
    hybrid+fused."""
    jspec = JSpec.from_scheme("hybrid+fused", num_parts=P, fanouts=FANOUTS,
                              fused_backend="reference",
                              data=JDataSpec(**DATA))
    tspec = TSpec.from_scheme("hybrid+fused", num_parts=P, fanouts=FANOUTS,
                              data=TDataSpec(**DATA))
    return (JPipeline.build_from_source(spec=jspec),
            TPipeline.build_from_source(spec=tspec, device="cpu"))


@pytest.fixture(scope="module")
def mfgs(pipes):
    """(repro MFGs, port MFGs, repro h0, port h0) for 12 seeds."""
    ds = pipes[0].dataset
    seeds = jnp.arange(12, dtype=jnp.int32) * 61
    jm = j_sample_mfgs(ds.graph, seeds, FANOUTS, salt=5)
    tm = [MFG(**{f.name: torch.from_numpy(np.array(getattr(m, f.name)))
                 for f in dataclasses.fields(MFG)}) for m in jm]
    src = jm[-1].src_nodes
    h0 = jnp.asarray(ds.features)[jnp.clip(src, 0)] * (src >= 0)[:, None]
    return jm, tm, h0, torch.from_numpy(np.array(h0))


def _close_trees(t_tree, j_tree, rtol=RTOL, atol=ATOL):
    for tl, jl in zip(params_to_numpy(t_tree), jax.tree.map(np.asarray,
                                                            j_tree)):
        assert tl.keys() == jl.keys()
        for k in tl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("conv", CONVS)
def test_forward_and_gradients_match_repro(mfgs, conv):
    jm, tm, jh0, th0 = mfgs
    jcfg, tcfg = _cfgs(conv)
    jparams, tparams = _params(conv)
    labels = np.arange(12, dtype=np.int32) % 6
    valid = np.ones(12, bool)
    ref = jax.jit(lambda p, h: j_forward(p, jm, h, jcfg))(jparams, jh0)
    got = gnn_forward(tparams, tm, th0, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    jg = jax.jit(jax.grad(lambda p: j_loss(
        p, jm, jh0, jnp.asarray(labels), jnp.asarray(valid), jcfg)))(
            jparams)
    leaves = topt.tree_map(lambda p: p.clone().requires_grad_(True),
                           tparams)
    loss = gnn_loss(leaves, tm, th0, torch.from_numpy(labels),
                    torch.from_numpy(valid), tcfg)
    flat = torch.autograd.grad(loss, topt.tree_leaves(leaves),
                               materialize_grads=True)
    it = iter(flat)
    _close_trees(topt.tree_map(lambda _: next(it), tparams), jg)


@pytest.mark.parametrize("conv", CONVS)
def test_conv_parameters_and_their_gradients(mfgs, conv):
    jm, tm, _, th0 = mfgs
    jcfg, tcfg = _cfgs(conv)
    ours = init_gnn_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    theirs = j_init(jax.random.key(0), jcfg)
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in ours] \
        == [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in theirs]
    _, tparams = _params(conv)
    leaves = topt.tree_map(lambda p: p.clone().requires_grad_(True),
                           tparams)
    loss = gnn_loss(leaves, tm, th0,
                    torch.from_numpy(np.arange(12, dtype=np.int32) % 6),
                    torch.ones(12, dtype=torch.bool), tcfg)
    loss.backward()
    if conv == "gat":
        # the hidden layer attends (4 heads of 4); the 6-wide last layer
        # takes the neighbour mean of its projected sources instead
        assert {"attn_src", "attn_dst"} <= set(tparams[0])
        assert "attn_src" not in tparams[1]
        layer, mfg = tparams[1], tm[0]
        h = torch.relu(gnn_forward(tparams[:1], tm[1:], th0,
                                   dataclasses.replace(tcfg, num_layers=1)))
        z = h @ layer["w_neigh"]
        valid = (mfg.edges >= 0)[..., None]
        mean = (z[mfg.edges.clamp(min=0)] * valid).sum(1) \
            / valid.sum(1).clamp(min=1)
        want = mean + h[:mfg.num_dst] @ layer["w_self"] + layer["b"]
        got = gnn_forward(tparams, tm, th0, tcfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        assert float(leaves[0]["attn_src"].grad.abs().sum()) > 0
        # exact inference gathers from gat_project's tables of every node
        # (here 5000 more rows ahead of the block's), training projects
        # the gathered rows: the same bits
        mfg, n = tm[1], th0.shape[0]
        wider = torch.cat([torch.randn((5000, th0.shape[1]),
                          generator=torch.Generator().manual_seed(1)), th0])
        projected = [t[-n:] for t in gat_project(tparams[0], wider)]
        out = apply_layer(tparams[0], mfg, th0, tcfg, is_last=False,
                          projected=projected)
        assert torch.equal(out, apply_layer(tparams[0], mfg, th0, tcfg,
                                            is_last=False))
    elif conv == "gin":
        assert all(layer["eps"].dim() == 0 for layer in tparams)
        assert all(float(layer["eps"].grad.abs()) > 0 for layer in leaves)
    else:
        assert all(layer["w_self"].grad is None for layer in leaves)


@pytest.mark.parametrize("cap", [None, 3], ids=["uncapped", "cap3"])
@pytest.mark.parametrize("conv", CONVS)
def test_layerwise_inference_matches_repro(pipes, conv, cap):
    ds = pipes[0].dataset
    jcfg, tcfg = _cfgs(conv)
    jparams, tparams = _params(conv)
    g = CSCGraph(indptr=torch.from_numpy(np.array(ds.graph.indptr)),
                 indices=torch.from_numpy(np.array(ds.graph.indices)))
    got = layerwise_inference(tparams, g, torch.from_numpy(
        np.array(ds.features, np.float32)), tcfg, batch_size=128,
        max_degree=cap)
    ref = j_infer(jparams, ds.graph, jnp.asarray(ds.features), jcfg,
                  batch_size=128, max_degree=cap)
    ref = np.asarray(ref)
    scale = max(1.0, np.abs(ref).max()) if conv == "gin" else 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=ATOL * scale)


@pytest.mark.parametrize("conv", CONVS)
def test_one_adamw_step_through_the_sync_driver_matches_repro(pipes, conv):
    jp, tp = pipes
    jcfg, tcfg = _cfgs(conv)
    jparams, tparams = _params(conv)
    jd = jp.train_driver(lambda p, m, h, y, v: j_loss(p, m, h, y, v, jcfg),
                         batch=BATCH, lr=LR)
    td = tp.train_driver(lambda p, m, h, y, v: gnn_loss(p, m, h, y, v, tcfg),
                         batch=BATCH, lr=LR, device="cpu")
    # repro's gradients of the step the driver takes first (before the
    # driver, which may donate the parameters' buffers)
    _, jg, _ = jp.step_fn(
        lambda p, m, h, y, v: j_loss(p, m, h, y, v, jcfg))(
            jparams, jnp.asarray(jp.seeds_host(BATCH, 0)), 0)
    jpar, jst, jl, _ = jd.step(jparams, jopt.init_opt_state(jparams))
    tpar, tst, tl, _ = td.step(tparams, topt.init_opt_state(tparams))
    jd.close()
    td.close()
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert int(tst.step) == 1
    # the moments carry the (clipped) gradient itself, sign included
    for tm_, jm_ in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        _close_trees(tm_, jm_)
    # AdamW's first step moves a parameter by about lr * sign(grad): where
    # repro's gradient is within the gradients' atol of zero (the first
    # test) the two signs may differ, so those entries are held to 2 lr,
    # every other one to the tolerance
    for tl_, jl_, gl in zip(params_to_numpy(tpar),
                            jax.tree.map(np.asarray, jpar),
                            jax.tree.map(np.asarray, jg)):
        for k in tl_:
            sure = np.abs(gl[k]) > ATOL
            np.testing.assert_allclose(tl_[k][sure], jl_[k][sure],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            assert np.all(np.abs(tl_[k] - jl_[k]) <= 2 * LR + ATOL), k


@pytest.mark.parametrize("conv", CONVS)
def test_served_outputs_equal_direct_predict(pipes, conv):
    _, tp = pipes
    _, tcfg = _cfgs(conv)
    _, tparams = _params(conv)
    pred = Predictor(tp, tparams, tcfg, buckets=(1, 8, 32, 128),
                     base_salt=3, device="cpu")
    arrivals = hotset_arrivals(40, 3000.0, DATA["num_nodes"],
                               graph=tp.dataset.graph, hot_k=16, seed=1)
    stats, served = GNNServer(pred, device="cpu").run(
        arrivals, collect_outputs=True)
    direct = pred.predict([s for _, s in arrivals])
    np.testing.assert_array_equal(served, direct)
    assert served.shape == (40, 6) and np.isfinite(served).all()
    assert stats.num_flushes > 1
