"""``repro_torch.core.dist`` on the stacked worker axis against
``repro.core.dist`` under ``jax.vmap(..., axis_name=AXIS)``.

Owner lookup, packing buffers and round counts are exact; fetched feature
rows are compared by value (``np.array_equal``): ``repro`` masks rows by
multiplying, which can leave ``-0.0`` where the port writes ``+0.0``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import dist as jdist
from repro_torch.core import dist as tdist


def _world(P, n_per=(37, 41, 29, 45), D=6, N=50, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.array(n_per[:P])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n_max = int(counts.max())
    feats = np.zeros((P, n_max, D), np.float32)
    for p in range(P):
        feats[p, :counts[p]] = rng.normal(0, 1, (counts[p], D))
    src = rng.integers(0, offsets[-1], (P, N)).astype(np.int32)
    src[rng.random((P, N)) < 0.25] = -1
    return offsets, feats, src


def test_owner_of_matches():
    offsets, _, src = _world(4)
    ref = jdist.owner_of(jnp.asarray(offsets), jnp.asarray(src[src >= 0]))
    got = tdist.owner_of(torch.from_numpy(offsets),
                         torch.from_numpy(src[src >= 0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("P", [2, 4])
def test_pack_by_owner_matches_vmap(P):
    offsets, _, src = _world(P, seed=P)
    own_j = jdist.owner_of(jnp.asarray(offsets), jnp.asarray(src))
    ref = jax.vmap(lambda i, o: jdist.pack_by_owner(i, o, P))(
        jnp.asarray(src), own_j)
    got = tdist.pack_by_owner(torch.from_numpy(src),
                              torch.from_numpy(np.array(own_j)), P)
    for name, g, r in zip(("buf", "owner_idx", "slot_idx"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


@pytest.mark.parametrize("P", [2, 4])
def test_fetch_features_matches_vmap(P):
    offsets, feats, src = _world(P, seed=10 + P)
    counter_j = jdist.RoundCounter()
    ref = jax.vmap(
        lambda s, f: jdist.fetch_features(s, jnp.asarray(offsets), P, f,
                                          counter_j),
        axis_name=jdist.AXIS)(jnp.asarray(src), jnp.asarray(feats))
    counter_t = tdist.RoundCounter()
    got = tdist.fetch_features(torch.from_numpy(src),
                               torch.from_numpy(offsets), P,
                               torch.from_numpy(feats), counter_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.signbit(got.numpy()[src < 0]).any()     # +0.0 pad rows
    # the hybrid feature fetch is exactly 2 rounds, of the same capacity
    assert counter_t.feature_rounds == 2 and counter_t.sampling_rounds == 0
    assert counter_t.kinds == counter_j.kinds
    assert counter_t.bytes_per_round == counter_j.bytes_per_round


def test_exchange_is_a_transpose_of_the_stacked_buffer():
    P = 3
    buf = torch.arange(P * P * 2).view(P, P, 2)
    ref = jax.vmap(lambda b: jdist.exchange(b, None),
                   axis_name=jdist.AXIS)(jnp.asarray(buf.numpy()))
    np.testing.assert_array_equal(tdist.exchange(buf, None).numpy(),
                                  np.asarray(ref))


def test_ordered_reductions():
    x = np.random.default_rng(1).normal(0, 1, (4, 3)).astype(np.float32)
    ref_m = jax.vmap(lambda a: jdist.pmean_ordered(a),
                     axis_name=jdist.AXIS)(jnp.asarray(x))
    ref_s = jax.vmap(lambda a: jdist.psum_ordered(a),
                     axis_name=jdist.AXIS)(jnp.asarray(x))
    np.testing.assert_allclose(tdist.pmean_ordered(torch.from_numpy(x))
                               .numpy(), np.asarray(ref_m)[0], rtol=1e-6)
    np.testing.assert_allclose(tdist.psum_ordered(torch.from_numpy(x))
                               .numpy(), np.asarray(ref_s)[0], rtol=1e-6)
