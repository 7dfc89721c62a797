"""``repro_torch.core.sampler`` against ``repro.core.sampler``.

Same inputs (numpy, seeded) through both packages; every integer output
must be bit-identical (``np.array_equal``): the hash and salt over the full
uint32 range, per-seed draws, the relabel, and every MFG field of
multi-level sampling with the ``reference`` and ``unfused`` backends.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sampler as jsampler
from repro.core.graph import CSCGraph as JCSC
from repro_torch.core import sampler as tsampler
from repro_torch.core.graph import CSCGraph as TCSC

# one compiled program per shape instead of op-by-op dispatch
_jit_mfgs = jax.jit(jsampler.sample_mfgs, static_argnums=(2,),
                    static_argnames=("backend",))
_jit_neighbors = jax.jit(jsampler.sample_neighbors, static_argnums=(2,))
_jit_relabel = jax.jit(jsampler.relabel)

U32_EDGES = np.array([0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31,
                      2**32 - 2, 2**32 - 1], np.uint64)
SALTS = [0, 1, 7, 0x9E3779B9, 2**31, 2**32 - 1]


def _graphs(ds):
    indptr = np.asarray(ds.graph.indptr)
    indices = np.asarray(ds.graph.indices)
    return (JCSC(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices)),
            TCSC(indptr=torch.from_numpy(indptr.astype(np.int32)),
                 indices=torch.from_numpy(indices.astype(np.int32))))


def _seeds(n, size, seed, pad=0.2):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size).astype(np.int32)
    s[rng.random(size) < pad] = -1
    return s


@pytest.mark.parametrize("salt", SALTS)
def test_hash_u32_full_range(salt):
    rng = np.random.default_rng(salt % 1000)
    x = np.concatenate([U32_EDGES,
                        rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    ref = np.asarray(jsampler.hash_u32(jnp.asarray(x.astype(np.uint32)),
                                       jnp.uint32(salt)))
    got = tsampler.hash_u32(torch.from_numpy(x.astype(np.int64)), salt)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  ref.astype(np.uint64))


@pytest.mark.parametrize("salt", SALTS)
def test_level_salt_wraparound(salt):
    for depth in range(4):
        ref = int(jsampler.level_salt(jnp.uint32(salt), depth))
        assert tsampler.level_salt(salt, depth) == ref


@pytest.mark.parametrize("fanout,salt", [(1, 0), (3, 5), (4, 2**32 - 1),
                                         (10, 123456)])
def test_sample_neighbors_matches(small_dataset, fanout, salt):
    jg, tg = _graphs(small_dataset)
    seeds = _seeds(jg.num_nodes, 64, fanout)
    js, jv = _jit_neighbors(jg, jnp.asarray(seeds), fanout,
                            jnp.uint32(salt))
    ts, tv = tsampler.sample_neighbors(tg, torch.from_numpy(seeds), fanout,
                                       salt)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("fanout", [2, 5])
def test_relabel_matches(small_dataset, fanout):
    jg, tg = _graphs(small_dataset)
    seeds = _seeds(jg.num_nodes, 40, 11)
    seeds[3] = seeds[5]                          # duplicate seed
    js, jv = _jit_neighbors(jg, jnp.asarray(seeds), fanout, jnp.uint32(3))
    ref = _jit_relabel(jnp.asarray(seeds), js, jv)
    got = tsampler.relabel(torch.from_numpy(seeds),
                           torch.from_numpy(np.array(js)),
                           torch.from_numpy(np.array(jv)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


MFG_FIELDS = ("dst_nodes", "src_nodes", "num_src", "edges", "edge_mask",
              "indptr")


@pytest.mark.parametrize("backend", ["reference", "unfused"])
@pytest.mark.parametrize("fanouts,salt", [((4, 3), 0), ((5, 2, 2), 99),
                                          ((3,), 2**32 - 1)])
def test_sample_mfgs_matches(small_dataset, backend, fanouts, salt):
    jg, tg = _graphs(small_dataset)
    seeds = _seeds(jg.num_nodes, 16, len(fanouts))
    ref = _jit_mfgs(jg, jnp.asarray(seeds), fanouts, jnp.uint32(salt),
                    backend=backend)
    got = tsampler.sample_mfgs(tg, torch.from_numpy(seeds), fanouts, salt,
                               backend=backend)
    for level, (g, r) in enumerate(zip(got, ref)):
        for field in MFG_FIELDS:
            np.testing.assert_array_equal(
                getattr(g, field).numpy(), np.asarray(getattr(r, field)),
                err_msg=f"level {level} field {field}")


@pytest.mark.parametrize("backend", ["reference", "unfused", "fused_cuda"])
def test_stacked_worker_rows_match_per_row_sampling(small_dataset, backend):
    """(P, S) seeds sample each row exactly as repro samples that row
    alone — the stacked axis replaces vmap."""
    jg, tg = _graphs(small_dataset)
    P, fanouts, salt = 3, (4, 3), 17
    seeds = np.stack([_seeds(jg.num_nodes, 12, p) for p in range(P)])
    got = tsampler.sample_mfgs(tg, torch.from_numpy(seeds), fanouts, salt,
                               backend=backend)
    for p in range(P):
        ref = _jit_mfgs(jg, jnp.asarray(seeds[p]), fanouts,
                        jnp.uint32(salt), backend="reference")
        for g, r in zip(got, ref):
            for field in MFG_FIELDS:
                np.testing.assert_array_equal(
                    getattr(g, field)[p].numpy(),
                    np.asarray(getattr(r, field)),
                    err_msg=f"worker {p} field {field}")


def test_backend_registry():
    tsampler.resolve_backend("fused_cuda")      # registers on first use
    assert {"reference", "unfused", "fused_cuda"} <= set(
        tsampler.available_backends())
    with pytest.raises(KeyError):
        tsampler.resolve_backend("no_such_backend")
