"""A sage hidden layer's tail as one op (``models.gnn.sage_hidden_tail``,
the ``sage_epilogue`` kernels' plain versions on the CPU) against the chain
it replaces: ``rowwise_matmul(h_dst, w_self) + rowwise_matmul(agg,
w_neigh) + b``, relu, and dropout as ``out * (rand >= p) / (1 - p)``.

  * Forward bit for bit: both hidden layers of a 3-layer model, dropout
    at 0.5 and 0.3 from a generator and none; the last layer's logits.
  * Gradients within fp32 rounding of autograd through the chain (the
    weights' and the bias's sums run in another order).
  * A row's bits do not depend on the row count; one generator seed gives
    one set of bits.
  * The kernels' plain versions: the backward is the chain's gradient,
    its padded rows zero and the bias gradient their sum.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sage_aggregate import sage_aggregate
from repro_torch.kernels.sage_epilogue import (sage_epilogue_backward,
                                               sage_epilogue_backward_plain,
                                               sage_epilogue_plain)
from repro_torch.models.gnn import (ROW_CHUNK, GNNConfig, apply_layer,
                                    gnn_forward, init_gnn_params,
                                    rowwise_matmul, sage_hidden_tail)

# destinations a level, top first: the bottom layer's cross a row block
LEVELS = (50, 600, ROW_CHUNK + 904)
FANOUTS = (4, 3, 2)


class _MFG:
    def __init__(self, edges, num_dst):
        self.edges, self.num_dst = edges, num_dst


def _model(P: int, in_dim: int = 12, hidden: int = 32, dropout=0.5,
           seed: int = 0):
    """A 3-layer sage model on random MFGs with P workers stacked."""
    rng = np.random.default_rng(seed)
    cfg = GNNConfig(in_dim=in_dim, hidden_dim=hidden, num_classes=5,
                    num_layers=3, fanouts=FANOUTS, dropout=dropout)
    mfgs = []
    for S, F in zip(LEVELS, FANOUTS):
        N = S * (F + 1)
        edges = rng.integers(-1, N, size=(P, S, F)).astype(np.int32)
        mfgs.append(_MFG(torch.from_numpy(edges), S))
    N0 = LEVELS[-1] * (FANOUTS[-1] + 1)
    h0 = torch.from_numpy(rng.standard_normal((P, N0, in_dim),
                                              dtype=np.float32))
    params = init_gnn_params(cfg, torch.Generator().manual_seed(seed),
                             "cpu")
    for layer in params:                   # a bias that is not zero
        layer["b"] = torch.from_numpy(rng.standard_normal(
            layer["b"].shape, dtype=np.float32)) * 0.1
    return cfg, mfgs, h0, params


def _chain_layer(p, mfg, h, cfg, is_last, generator=None):
    """One sage layer as the chain of PyTorch ops the op replaces."""
    agg = sage_aggregate(mfg.edges, h)
    out = (rowwise_matmul(h[..., : mfg.num_dst, :], p["w_self"])
           + rowwise_matmul(agg, p["w_neigh"]) + p["b"])
    if not is_last:
        out = torch.relu(out)
        if generator is not None and cfg.dropout > 0:
            keep = torch.rand(out.shape, generator=generator) >= cfg.dropout
            out = out * keep / (1 - cfg.dropout)
    return out


def _chain_forward(params, mfgs, h0, cfg, generator=None):
    h = h0
    for layer in range(cfg.num_layers):
        h = _chain_layer(params[layer], mfgs[cfg.num_layers - 1 - layer], h,
                         cfg, layer == cfg.num_layers - 1, generator)
    return h


def _leaves(params, h0, input_grad: bool):
    params = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    h0 = h0.detach().requires_grad_(input_grad)
    return params, h0


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("dropout", [0.5, 0.3, None],
                         ids=["p0.5", "p0.3", "no-generator"])
def test_forward_equals_the_chain_bit_for_bit(P, dropout):
    cfg, mfgs, h0, params = _model(P, dropout=dropout or 0.5)

    def gen():
        return torch.Generator().manual_seed(9) if dropout else None

    h_new = h_old = h0
    g_new, g_old = gen(), gen()
    for layer in range(cfg.num_layers - 1):          # the hidden layers
        mfg = mfgs[cfg.num_layers - 1 - layer]
        h_new = apply_layer(params[layer], mfg, h_new, cfg, is_last=False,
                            generator=g_new)
        h_old = _chain_layer(params[layer], mfg, h_old, cfg, False, g_old)
        assert torch.equal(h_new, h_old), layer
    logits = gnn_forward(params, mfgs, h0, cfg, generator=gen())
    assert torch.equal(logits, _chain_forward(params, mfgs, h0, cfg, gen()))


@pytest.mark.parametrize("input_grad", [False, True],
                         ids=["features-no-grad", "features-grad"])
@pytest.mark.parametrize("dropout", [0.5, 0.0])
def test_gradients_match_autograd_through_the_chain(input_grad, dropout):
    cfg, mfgs, h0, params = _model(2, dropout=dropout)
    g = np.random.default_rng(4).standard_normal(
        (2, LEVELS[0], cfg.num_classes), dtype=np.float32)
    g = torch.from_numpy(g)
    grads = []
    for forward in (gnn_forward, _chain_forward):
        leaves, h = _leaves(params, h0, input_grad)
        out = forward(leaves, mfgs, h, cfg,
                      generator=torch.Generator().manual_seed(2))
        wrt = [v for layer in leaves for v in layer.values()]
        wrt += [h] if input_grad else []
        grads.append(torch.autograd.grad(out, wrt, g))
    for new, old in zip(*grads):
        np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("rows", [1, 100, 4096, 4097, 9000])
@pytest.mark.parametrize("dropout", [True, False],
                         ids=["dropout", "no-dropout"])
def test_rows_do_not_depend_on_row_count(rows, dropout):
    """Each row of the op has the bits it has in a longer call, as each
    row of ``rowwise_matmul`` does (``test_torch_serve.py``)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9000, 24), dtype=np.float32))
    agg = torch.from_numpy(rng.standard_normal((9000, 24),
                                               dtype=np.float32))
    layer = {k: torch.from_numpy(rng.standard_normal(shape,
                                                     dtype=np.float32))
             for k, shape in (("w_self", (24, 36)), ("w_neigh", (24, 36)),
                              ("b", (36,)))}
    u = torch.rand((9000, 36), generator=torch.Generator().manual_seed(1)) \
        if dropout else None
    full = sage_hidden_tail(x, agg, layer, u, 0.5)
    part = sage_hidden_tail(x[:rows].reshape(1, rows, 24),
                            agg[:rows].reshape(1, rows, 24), layer,
                            None if u is None else u[:rows].reshape(
                                1, rows, 36), 0.5)
    assert part.shape == (1, rows, 36)
    assert torch.equal(part[0], full[:rows])


def test_one_generator_seed_gives_one_set_of_bits():
    cfg, mfgs, h0, params = _model(1)
    a, b, c = (gnn_forward(params, mfgs, h0, cfg,
                           generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("p", [0.5, 0.3, 0.0])
def test_plain_backward_is_the_chains_gradient(p):
    rng = np.random.default_rng(7)
    s, n, grad = (torch.from_numpy(rng.standard_normal((50, 12),
                                                       dtype=np.float32))
                  for _ in range(3))
    b = torch.from_numpy(rng.standard_normal(12, dtype=np.float32))
    u = torch.rand((50, 12), generator=torch.Generator().manual_seed(0)) \
        if p else None
    x = (s + n + b).requires_grad_(True)
    y = torch.relu(x)
    if u is not None:
        y = y * (u >= p) / (1 - p)
    (want,) = torch.autograd.grad(y, x, grad)
    out = sage_epilogue_plain(s, n, b, u, p)
    assert torch.equal(out, y)
    for backward in (sage_epilogue_backward_plain, sage_epilogue_backward):
        dx, db = backward(grad, out, p, rows_pad=64)
        assert dx.shape == (64, 12)
        assert torch.equal(dx[:50], want)
        assert not dx[50:].any()
        assert torch.equal(db, dx.sum(0))
