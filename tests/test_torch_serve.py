"""The serving slice as a whole: ``repro``'s hybrid+fused pipeline against
the port's, on the CPU.

``repro``'s side runs ``hybrid+fused`` with ``fused_backend="reference"``
(its Pallas ``fused_pallas`` backend needs ``pl.load``, which the installed
JAX lacks); every degree here lies inside the fused kernel's window, where
the two are specified to be bit-identical.  Both packages take the same
parameters (``init_gnn_params(jax.random.key(0), cfg)``, carried across by
``params_from_numpy``).

Tolerances: logits fp32 ``rtol=atol=1e-5`` (XLA and torch order their
matmul reductions differently); layouts exact; served outputs equal direct
``predict`` bit for bit (the fixed-salt determinism contract).
"""
import numpy as np
import jax
import pytest
import torch

from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import init_gnn_params as j_init
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro.serve import Predictor as JPredictor
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import params_from_numpy, params_to_numpy
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.serve import (GNNServer, Predictor, max_owner_count,
                               route_by_owner)
from repro_torch.serve.traffic import hotset_arrivals

DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=4, seed=3)
FANOUTS = (4, 3)
SALT = 5


def _cfgs():
    kw = dict(in_dim=12, hidden_dim=32, num_classes=4, num_layers=2,
              fanouts=FANOUTS, dropout=0.0)
    return JConfig(**kw), TConfig(**kw)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def pair(request):
    P = request.param
    jpipe = JPipeline.build_from_source(spec=JSpec.from_scheme(
        "hybrid+fused", num_parts=P, fanouts=FANOUTS,
        fused_backend="reference", data=JDataSpec(**DATA)))
    tpipe = TPipeline.build_from_source(spec=TSpec.from_scheme(
        "hybrid+fused", num_parts=P, fanouts=FANOUTS,
        data=TDataSpec(**DATA)), device="cpu")
    jcfg, tcfg = _cfgs()
    jparams = j_init(jax.random.key(0), jcfg)
    params_np = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in jparams]
    tparams = params_from_numpy(params_np, "cpu")
    return jpipe, tpipe, jparams, tparams


def test_port_resolves_the_fused_kernel_backend(pair):
    _, tpipe, _, _ = pair
    assert tpipe.spec.sampler.backend == "fused_cuda"
    assert tpipe.expected_rounds == 2


def test_layouts_bit_identical(pair):
    jpipe, tpipe, _, _ = pair
    np.testing.assert_array_equal(tpipe.layout.graph.indices.numpy(),
                                  np.asarray(jpipe.layout.graph.indices))
    np.testing.assert_array_equal(tpipe.layout.offsets.numpy(),
                                  np.asarray(jpipe.layout.offsets))
    np.testing.assert_array_equal(tpipe.layout.features.numpy(),
                                  np.asarray(jpipe.layout.features))


def test_params_round_trip(pair):
    _, _, jparams, tparams = pair
    for a, b in zip(params_to_numpy(tparams), jparams):
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_predictor_logits_match_repro(pair):
    jpipe, tpipe, jparams, tparams = pair
    jcfg, tcfg = _cfgs()
    seeds = np.random.default_rng(0).integers(0, DATA["num_nodes"], 40)
    jpred = JPredictor(jpipe, jparams, jcfg, buckets=(8, 32), base_salt=SALT)
    tpred = Predictor(tpipe, tparams, tcfg, buckets=(8, 32), base_salt=SALT,
                      device="cpu")
    ref = jpred.predict(seeds)
    got = tpred.predict(seeds)
    assert got.shape == (40, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_served_outputs_equal_direct_predict(pair):
    _, tpipe, _, tparams = pair
    _, tcfg = _cfgs()
    pred = Predictor(tpipe, tparams, tcfg, buckets=(1, 8, 32, 128),
                     base_salt=SALT, device="cpu")
    arrivals = hotset_arrivals(100, 3000.0, DATA["num_nodes"],
                               graph=tpipe.dataset.graph, hot_k=16, seed=0)
    stats, served = GNNServer(pred, device="cpu").run(
        arrivals, collect_outputs=True)
    direct = pred.predict([s for _, s in arrivals])
    np.testing.assert_array_equal(served, direct)
    assert stats.num_requests == 100 and stats.num_flushes > 1
    assert stats.p99 >= stats.p50 > 0 and stats.qps > 0


def test_round_counter_two_feature_rounds(pair):
    _, tpipe, _, tparams = pair
    _, tcfg = _cfgs()
    from repro_torch.models.gnn import gnn_forward
    fn = tpipe.infer_step_fn(lambda p, m, h: gnn_forward(p, m, h, tcfg),
                             counted=True, device="cpu")
    seeds = torch.full((tpipe.num_parts, 4), -1, dtype=torch.int32)
    seeds[:, 0] = tpipe.layout.offsets[:-1]
    fn(tparams, seeds, SALT)
    assert tpipe.counter.feature_rounds == 2
    assert tpipe.counter.sampling_rounds == 0


def test_route_by_owner_round_trips(pair):
    _, tpipe, _, _ = pair
    offsets = tpipe.layout.offsets.numpy()
    seeds = np.random.default_rng(4).integers(0, offsets[-1], 60)
    cap = max_owner_count(offsets, seeds)
    routed, pos = route_by_owner(offsets, seeds, cap)
    np.testing.assert_array_equal(routed[pos[:, 0], pos[:, 1]], seeds)
    owner = np.searchsorted(offsets, routed, side="right") - 1
    rows = np.broadcast_to(np.arange(len(offsets) - 1)[:, None],
                           routed.shape)
    assert (owner[routed >= 0] == rows[routed >= 0]).all()


def test_entry_points_default_to_cuda():
    """Without a GPU, an entry point not told ``device="cpu"`` raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    spec = TSpec.from_scheme("hybrid+fused", num_parts=2, fanouts=FANOUTS,
                             data=TDataSpec(**DATA))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipeline.build_from_source(spec=spec)
    tpipe = TPipeline.build_from_source(spec=spec, device="cpu")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(tpipe, None, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.infer_step_fn(lambda *a: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipeline.from_layout(tpipe.layout, spec)
    assert TPipeline.from_layout(tpipe.layout, spec,
                                 device="cpu").device.type == "cpu"


@pytest.mark.parametrize("rows", [1, 100, 4096, 4097, 9000])
def test_rowwise_matmul_rows_do_not_depend_on_row_count(rows):
    """Each row of ``rowwise_matmul`` has the bits it has in a longer
    product, and the product is ``x @ w`` within fp32 rounding (rtol/atol
    1e-5: another reduction order than one ``torch.matmul``)."""
    from repro_torch.models.gnn import rowwise_matmul
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9000, 24), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 7), dtype=np.float32))
    full = rowwise_matmul(x, w)
    part = rowwise_matmul(x[:rows].reshape(1, rows, 24), w)
    assert part.shape == (1, rows, 7)
    assert torch.equal(part[0], full[:rows])
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=1e-5,
                               atol=1e-5)
