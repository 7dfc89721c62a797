"""The port's kernel wrappers on CPU tensors (their plain versions) against
``repro``'s kernels and oracles.

  * fused_sample: exact against ``ref_fused_sample`` (every degree inside
    the window) and against ``ref_windowed_fused_sample`` with a small
    window on a graph with hubs, where the overflow count is non-zero.
  * sage_aggregate: fp32 ``rtol=atol=1e-5`` against ``repro``'s Pallas
    kernel in interpret mode and ``ref_mean_aggregate`` (the sums run in
    another order).  A numpy model of the CUDA forward's arithmetic (ids
    staged per tile of ``forward_plan``, f-ordered predicated sums from
    +0.0) equals an f-ordered torch loop bit for bit, is batch-invariant,
    and agrees with the plain version and ``repro`` within 1e-5.  At wide
    F (past the ids a block stages) the CPU path agrees with ``repro``'s
    ``mean_aggregate`` within 1e-5 (rows all valid, all -1, all >= N,
    mixed).
  * feature_gather: rows equal by value (``np.array_equal``) to ``repro``'s
    Pallas kernel in interpret mode.
  * gather_rows: exact against ``repro``'s ``gather_rows_reference`` (its
    Pallas ``gather_rows`` needs ``pl.load``, which the installed JAX
    lacks), all-invalid and out-of-range ids included.
  * sage_aggregate backward: the gradient through ``sage_aggregate``
    equals autograd of the plain version and, within fp32 ``rtol=atol=
    1e-5``, ``jax.grad`` of ``repro``'s mean; the transpose the CUDA
    backward kernel reads (``backward_index``), walked in Python as the
    kernel walks it, gives the same gradient.  The plain version of the
    transpose's first pass (``backward_prep_plain``: int32 keys, ``denom``,
    the per-source-row histogram) agrees with ``backward_index`` and, as a
    scatter, with ``jax.vjp`` of ``repro``'s mean.
  * gat_attention (the table contract): a destination's output bits do
    not depend on how many rows share the batch; the per-source passes of
    the CUDA backward, walked in Python as the kernels walk them (chunks of
    ``CHUNK`` slots over ``backward_index``'s transpose, one partial a
    window, a row's later chunks added in chunk order), give the plain
    version's table gradient, hubs past one chunk included.
  * the single-pass scan's scratch (``kernels/scan.py``) at 0, 1, tile - 1,
    tile and tile + 1 items, and the wrappers' 2**31 size guards.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.  Here the wrappers must take the
plain version for CPU tensors and refuse anything else.
"""
import inspect
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.graph import CSCGraph as JCSC
from repro.core.graph import csc_from_numpy_edges as j_csc
from repro.core.mfg import MFG as JMFG
from repro.core.mfg import mean_aggregate as j_mean_aggregate
from repro.kernels.feature_gather import feature_gather as j_feature_gather
from repro.kernels.gather import gather_rows_reference
from repro.kernels.ref import (ref_feature_gather, ref_fused_sample,
                               ref_mean_aggregate, ref_windowed_fused_sample)
from repro.kernels.sage_aggregate import sage_aggregate as j_sage_aggregate
from repro_torch.core.graph import CSCGraph as TCSC
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels import ref as tref
from repro_torch.kernels.feature_gather import (feature_gather,
                                                feature_gather_plain)
from repro_torch.kernels.fused_sample import fused_sample
from repro_torch.kernels.gat_attention import (
    CHUNK, gat_attention, gat_attention_backward, gat_attention_backward_plain,
    gat_attention_plain, per_edge_attention_backward_plain,
    per_edge_attention_plain)
from repro_torch.kernels.gather import gather_rows, gather_rows_plain
from repro_torch.kernels.sage_epilogue import (sage_epilogue,
                                               sage_epilogue_backward)
from repro_torch.kernels.sage_aggregate import (MAX_STAGED_IDS,
                                                WIDE_CHUNK_IDS, WIDE_THREADS,
                                                backward_index,
                                                backward_prep_plain,
                                                forward_max_threads,
                                                forward_plan,
                                                pairs_per_thread,
                                                sage_aggregate,
                                                sage_aggregate_backward,
                                                sage_aggregate_backward_plain,
                                                sage_aggregate_plain,
                                                sage_backward_index)
from repro_torch.kernels.fused_sample import (LARGE_LEVEL, LARGE_TILE,
                                              SMALL_TILE, seeds_per_tile)
from repro_torch.kernels.scan import scan_scratch, scan_tiles


def _hub_graph(seed=0, n=300, m=6000, alpha=1.2):
    """Skewed in-degrees: a few hubs far above a small window."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(alpha, n) + 1.0
    dst = rng.choice(n, size=m, p=w / w.sum())
    src = rng.integers(0, n, m)
    g = j_csc(dst, src, n)
    indptr = np.array(g.indptr)
    indices = np.array(g.indices)
    return (JCSC(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices)),
            TCSC(indptr=torch.from_numpy(indptr),
                 indices=torch.from_numpy(indices)))


def _seeds(n, size, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size).astype(np.int32)
    s[rng.random(size) < 0.2] = -1
    return s


@pytest.mark.parametrize("fanout,salt", [(1, 3), (5, 0), (15, 2**32 - 1)])
def test_fused_sample_matches_ref(fanout, salt):
    jg, tg = _hub_graph(alpha=3.0)
    assert int(tg.degrees().max()) < 2048          # default window unused
    seeds = _seeds(jg.num_nodes, 96, fanout)
    js, jr = ref_fused_sample(jg, jnp.asarray(seeds), fanout,
                              jnp.uint32(salt))
    ts, tr, tovf = fused_sample(tg.indptr, tg.indices,
                                torch.from_numpy(seeds), salt, fanout=fanout)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tovf) == 0


@pytest.mark.parametrize("window,fanout", [(4, 3), (4, 10), (16, 5)])
def test_fused_sample_window_overflow(window, fanout):
    jg, tg = _hub_graph(seed=1)
    seeds = _seeds(jg.num_nodes, 128, window)
    js, jr, jovf = ref_windowed_fused_sample(jg, jnp.asarray(seeds), fanout,
                                             jnp.uint32(9), window)
    assert jovf > 0
    ts, tr, tovf = fused_sample(tg.indptr, tg.indices,
                                torch.from_numpy(seeds), 9, fanout=fanout,
                                window=window)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tovf) == jovf
    # the port's own windowed oracle agrees with repro's
    os_, or_, oovf = tref.ref_windowed_fused_sample(
        tg, torch.from_numpy(seeds), fanout, 9, window)
    np.testing.assert_array_equal(os_.numpy(), np.asarray(js))
    np.testing.assert_array_equal(or_.numpy(), np.asarray(jr))
    assert oovf == jovf


def test_fused_sample_stacked_rows():
    """(B, S) seeds: one R and one overflow count per row."""
    jg, tg = _hub_graph(seed=2)
    seeds = np.stack([_seeds(jg.num_nodes, 50, s) for s in range(3)])
    ts, tr, tovf = fused_sample(tg.indptr, tg.indices,
                                torch.from_numpy(seeds), 4, fanout=6,
                                window=8)
    for b in range(3):
        js, jr, jovf = ref_windowed_fused_sample(
            jg, jnp.asarray(seeds[b]), 6, jnp.uint32(4), 8)
        np.testing.assert_array_equal(ts[b].numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr[b].numpy(), np.asarray(jr))
        assert int(tovf[b]) == jovf


@pytest.mark.parametrize("S", [1, SMALL_TILE - 1, SMALL_TILE,
                               SMALL_TILE + 1])
def test_fused_sample_tile_edge_shapes(S):
    """The shapes the card checks the kernel's tiles on: S = 1, S around
    the tile, B = 1 and a row of only padding seeds, with overflow."""
    jg, tg = _hub_graph(seed=3)
    seeds = np.stack([_seeds(jg.num_nodes, S, S), np.full(S, -1, np.int32)])
    for rows in (seeds[:1], seeds):
        ts, tr, tovf = fused_sample(tg.indptr, tg.indices,
                                    torch.from_numpy(rows), 5, fanout=3,
                                    window=8)
        for b in range(rows.shape[0]):
            js, jr, jovf = ref_windowed_fused_sample(
                jg, jnp.asarray(rows[b]), 3, jnp.uint32(5), 8)
            np.testing.assert_array_equal(ts[b].numpy(), np.asarray(js))
            np.testing.assert_array_equal(tr[b].numpy(), np.asarray(jr))
            assert int(tovf[b]) == jovf
    assert (ts[1] == -1).all() and not tr[1].any() and int(tovf[1]) == 0


@pytest.mark.parametrize("S,F,N,D", [(1, 1, 1, 1), (4, 3, 10, 8),
                                     (130, 7, 300, 16), (64, 15, 64, 130),
                                     (37, 5, 200, 33)])
def test_sage_aggregate_matches_repro(S, F, N, D):
    rng = np.random.default_rng(S + F + N + D)
    edges = rng.integers(-1, N, (S, F)).astype(np.int32)
    h = rng.normal(0, 1, (N, D)).astype(np.float32)
    got = sage_aggregate(torch.from_numpy(edges), torch.from_numpy(h))
    kern = j_sage_aggregate(jnp.asarray(edges), jnp.asarray(h), tile_s=32,
                            tile_n=32, interpret=True)
    ref = ref_mean_aggregate(jnp.asarray(edges), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sage_aggregate_invalid_rows_and_duplicates():
    edges = np.array([[-1, -1, -1], [2, 2, 0], [1, -1, 1]], np.int32)
    h = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = sage_aggregate(torch.from_numpy(edges), torch.from_numpy(h))
    ref = ref_mean_aggregate(jnp.asarray(edges), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros(3))
    np.testing.assert_allclose(got[1].numpy(), (2 * h[2] + h[0]) / 3)


def test_sage_aggregate_stacked_workers():
    rng = np.random.default_rng(5)
    edges = rng.integers(-1, 40, (3, 20, 4)).astype(np.int32)
    h = rng.normal(0, 1, (3, 40, 12)).astype(np.float32)
    got = sage_aggregate(torch.from_numpy(edges), torch.from_numpy(h))
    for b in range(3):
        ref = ref_mean_aggregate(jnp.asarray(edges[b]), jnp.asarray(h[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def _forward_walk(edges, h, vec=True):
    """The CUDA forward's arithmetic in numpy, tile by tile as
    ``forward_plan`` cuts the rows: a tile's ids staged once, each row's
    valid count taken from them, each column summed over f in ascending
    order from +0.0, adding +0.0 for an invalid slot (a predicated load,
    not a skipped one), then divided by the count; a row with no valid id
    writes +0.0."""
    B, S, F = edges.shape
    N, D = h.shape[1:]
    R, _ = forward_plan(D, F, vec)
    flat = h.reshape(B * N, D)
    e = edges.reshape(B * S, F)
    out = np.empty((B * S, D), np.float32)
    for row0 in range(0, B * S, R):
        rows = np.arange(row0, min(row0 + R, B * S))
        ids = e[rows].copy()                         # staged once
        ok = (ids >= 0) & (ids < N)
        count = ok.sum(axis=1)
        src = (rows // S)[:, None] * N + np.clip(ids, 0, max(N - 1, 0))
        acc = np.zeros((rows.size, D), np.float32)
        for f in range(F):
            acc = acc + np.where(ok[:, f, None], flat[src[:, f]],
                                 np.float32(0))
        mean = acc / np.maximum(count, 1).astype(np.float32)[:, None]
        out[rows] = np.where(count[:, None] > 0, mean, np.float32(0))
    return out.reshape(B, S, D)


def _f_ordered_mean(edges, h):
    """The masked mean as an f-ordered torch loop: acc = 0, then acc +
    where(valid_f, h[e_f], 0) for each f in order, over clamp(count, 1)."""
    N, D = h.shape[-2:]
    acc = torch.zeros((*edges.shape[:-1], D))
    count = torch.zeros(edges.shape[:-1])
    for f in range(edges.shape[-1]):
        idx = edges[..., f].long()
        ok = (idx >= 0) & (idx < N)
        rows = torch.gather(h, 1, idx.clamp(0, N - 1)[..., None].expand(
            -1, -1, D))
        acc = acc + torch.where(ok[..., None], rows, 0.0)
        count = count + ok
    return acc / count.clamp(min=1)[..., None]


def _forward_inputs(B, S, F, N, D, seed, lo=-1, hi=None):
    """Edges with a tile of only -1 rows and a duplicate run; ids in
    [lo, hi), N + 2 by default (ids >= N are invalid)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(lo, N + 2 if hi is None else hi,
                         (B, S, F)).astype(np.int32)
    edges[0, :min(S, 5)] = -1
    edges[-1, -1] = edges[-1, -1, 0]
    h = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    return edges, h


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("F,D", [(5, 100), (10, 256), (15, 256), (1, 1),
                                 (33, 33)])
def test_forward_walk_matches_f_ordered_loop_and_repro(F, D):
    """The kernel's arithmetic equals the f-ordered loop bit for bit (ids
    -1 and >= N, duplicates, rows of only -1 ids: +0.0), and the plain
    version and ``repro``'s Pallas kernel (interpret mode, ids < N, the
    ids its count takes as valid) within 1e-5."""
    B, S, N = 2, 40, 50
    edges, h = _forward_inputs(B, S, F, N, D, F + D)
    model = _forward_walk(edges, h)
    loop = _f_ordered_mean(torch.from_numpy(edges), torch.from_numpy(h))
    np.testing.assert_array_equal(_bits(model), _bits(loop.numpy()))
    np.testing.assert_array_equal(_bits(_forward_walk(edges, h, vec=False)),
                                  _bits(model))
    assert not model[0, :5].any() and not np.signbit(model[0, :5]).any()
    plain = sage_aggregate_plain(torch.from_numpy(edges), torch.from_numpy(h))
    np.testing.assert_allclose(model, plain.numpy(), rtol=1e-5, atol=1e-5)
    below, _ = _forward_inputs(B, S, F, N, D, F + D, hi=N)
    model = _forward_walk(below, h)
    for b in range(B):
        kern = j_sage_aggregate(jnp.asarray(below[b]), jnp.asarray(h[b]),
                                tile_s=32, tile_n=32, interpret=True)
        np.testing.assert_allclose(model[b], np.asarray(kern), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("D", [100, 256])
def test_forward_walk_is_batch_invariant(D):
    """A row's bits do not depend on the bucket: the rows of a call on
    ``edges[:, :k]`` (k = 1, 7, 32) equal the first k rows of the full
    call, and a worker alone (B = 1) or over a taller table (larger N)
    gives the same rows."""
    F = 5 if D == 100 else 15
    edges, h = _forward_inputs(3, 70, F, 40, D, D)
    full = _forward_walk(edges, h)
    for k in (1, 7, 32):
        np.testing.assert_array_equal(
            _bits(_forward_walk(edges[:, :k], h)), _bits(full[:, :k]))
    np.testing.assert_array_equal(_bits(_forward_walk(edges[1:2], h[1:2])),
                                  _bits(full[1:2]))
    valid = np.where(edges < 40, edges, -1)
    tall = np.concatenate([h, np.ones((3, 9, D), np.float32)], axis=1)
    np.testing.assert_array_equal(_bits(_forward_walk(valid, tall)),
                                  _bits(_forward_walk(valid, h)))


def test_forward_plan_depends_on_d_and_f_only():
    """The launch shape is a function of D, F and the float4 path alone;
    on the main path no lane idles at D = 100 (two pairs a thread) and a
    row gets 64 threads at D = 256; every plan fits the staged ids and the
    thread bound."""
    assert list(inspect.signature(forward_plan).parameters) == ["D", "F",
                                                                "vec"]
    R, threads = forward_plan(100, 5, True)
    assert threads * pairs_per_thread(5) == R * 25 and threads % 32 == 0
    for F in (10, 15):
        R, threads = forward_plan(256, F, True)
        assert pairs_per_thread(F) == 1 and threads == R * 64
    for F in (0, 1, 5, 10, 15, 33, MAX_STAGED_IDS, MAX_STAGED_IDS + 1,
              11361, 2 * MAX_STAGED_IDS):
        for D in (0, 1, 33, 100, 130, 256, 4096):
            for vec in (True, False):
                R, threads = forward_plan(D, F, vec)
                assert R >= 1 and R * F <= max(MAX_STAGED_IDS, F)
                assert threads % 32 == 0
                assert 32 <= threads <= forward_max_threads(F)
                # a wide row (F past the staged ids) is one row a block of
                # the wide kernel's fixed width, whatever D is
                if F > MAX_STAGED_IDS:
                    assert (R, threads) == (1, WIDE_THREADS)


def _wide_inputs(F, D, N=300, seed=0):
    """Wide rows (F past the staged ids), one of each kind: every id valid,
    only -1, only ids >= N, and mixed (mostly -1 padding as exact
    inference pads, a few ids >= N, valid ids around the wide kernel's
    chunk boundaries and the row's ends)."""
    rng = np.random.default_rng(seed + F + D)
    edges = np.full((4, F), -1, np.int32)
    edges[0] = rng.integers(0, N, F)
    edges[2] = rng.integers(N, N + 50, F)
    live = rng.random(F) < 0.01
    edges[3, live] = rng.integers(-1, N + 3, int(live.sum()))
    for b in range(0, F, WIDE_CHUNK_IDS):
        near = slice(max(b - 5, 0), min(b + 5, F))
        edges[3, near] = rng.integers(0, N, near.stop - near.start)
    edges[3, -3:] = rng.integers(0, N, 3)
    h = rng.normal(0, 1, (N, D)).astype(np.float32)
    return edges, h


@pytest.mark.parametrize("D", [33, 100])
@pytest.mark.parametrize("F", [MAX_STAGED_IDS + 1, MAX_STAGED_IDS + 3, 11361])
def test_wide_rows_match_repro_mean_aggregate(F, D):
    """The forward's CPU path at wide F (rows all valid, all -1, all >= N,
    mixed) against ``repro.core.mfg.mean_aggregate`` on the same inputs,
    within 1e-5 (the sums run in another order); rows with no valid id are
    +0.0."""
    edges, h = _wide_inputs(F, D)
    N = h.shape[0]
    got = sage_aggregate(torch.from_numpy(edges), torch.from_numpy(h))
    mask = (edges >= 0) & (edges < N)
    S = edges.shape[0]
    mfg = JMFG(dst_nodes=jnp.arange(S), src_nodes=jnp.arange(N),
               num_src=jnp.int32(N), edges=jnp.asarray(edges),
               edge_mask=jnp.asarray(mask),
               indptr=jnp.zeros(S + 1, jnp.int32))
    ref = jax.jit(j_mean_aggregate)(mfg, jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert not got[1:3].any() and not torch.signbit(got[1:3]).any()


@pytest.mark.parametrize("N,M,D", [(1, 1, 1), (50, 30, 8), (300, 129, 33),
                                   (64, 200, 100)])
def test_feature_gather_matches_repro(N, M, D):
    rng = np.random.default_rng(N + M + D)
    ids = rng.integers(-1, M + 3, N).astype(np.int32)
    table = rng.normal(0, 1, (M, D)).astype(np.float32)
    got = feature_gather(torch.from_numpy(ids), torch.from_numpy(table))
    kern = j_feature_gather(jnp.asarray(ids), jnp.asarray(table), tile_i=32,
                            tile_t=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    ok = (ids >= 0) & (ids < M)
    ref = ref_feature_gather(jnp.asarray(np.where(ok, ids, -1)),
                             jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.signbit(got.numpy()[~ok]).any()      # +0.0 rows


def test_feature_gather_stacked_tables():
    rng = np.random.default_rng(8)
    ids = rng.integers(-1, 25, (4, 30)).astype(np.int32)
    table = rng.normal(0, 1, (4, 25, 6)).astype(np.float32)
    got = feature_gather_plain(torch.from_numpy(ids), torch.from_numpy(table))
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(ref_feature_gather(
                jnp.asarray(ids[b]), jnp.asarray(table[b]))))


@pytest.mark.parametrize("N,K,D,lo,hi", [
    (1, 1, 1, -1, 2), (50, 30, 8, -1, 33), (300, 129, 100, -5, 200),
    (64, 16, 4, -3, 0), (40, 7, 33, 7, 20)],
    ids=["tiny", "mixed", "wide", "all-invalid", "all-out-of-range"])
def test_gather_rows_matches_repro(N, K, D, lo, hi):
    rng = np.random.default_rng(N + K + D)
    ids = rng.integers(lo, hi, N).astype(np.int32)
    table = rng.normal(0, 1, (K, D)).astype(np.float32)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    ref = gather_rows_reference(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ok = (ids >= 0) & (ids < K)
    assert not got.numpy()[~ok].any()
    assert not np.signbit(got.numpy()[~ok]).any()      # +0.0 rows


def test_gather_rows_stacked_tables():
    rng = np.random.default_rng(9)
    ids = rng.integers(-4, 25, (4, 30)).astype(np.int32)
    ids[1] = -1
    table = rng.normal(0, 1, (4, 20, 6)).astype(np.float32)
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == (4, 30, 6)
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(gather_rows_reference(
                jnp.asarray(table[b]), jnp.asarray(ids[b]))))


def _kernel_walk(edges, grad_out, N):
    """The backward kernel's loop in Python over ``backward_index``: each
    source row sums grad_out[dst] / denom[dst] over its slots in order."""
    rowptr, slots, denom = (t.numpy() for t in backward_index(
        torch.from_numpy(edges), N))
    F = edges.shape[-1]
    g = grad_out.reshape(-1, grad_out.shape[-1])
    out = np.zeros((rowptr.size - 1, g.shape[1]), np.float32)
    for r in range(rowptr.size - 1):
        for k in range(rowptr[r], rowptr[r + 1]):
            dst = slots[k] // F
            out[r] += g[dst] / denom[dst]
    return out.reshape(*edges.shape[:-2], N, g.shape[1])


@pytest.mark.parametrize("B,S,F,N,D", [(1, 1, 1, 1, 1), (1, 6, 3, 5, 4),
                                       (3, 20, 4, 40, 12),
                                       (2, 33, 7, 9, 5)])
def test_sage_aggregate_trains_on_the_cpu(B, S, F, N, D):
    """The gradient through ``sage_aggregate`` equals autograd of the plain
    version, ``sage_aggregate_backward``, the kernel's walk over its
    transpose, and ``jax.grad`` of ``repro``'s mean (duplicates count by
    multiplicity; rows no edge names get 0)."""
    rng = np.random.default_rng(B * S + F + N + D)
    edges = rng.integers(-2, N + 2, (B, S, F)).astype(np.int32)
    edges[0, 0] = edges[0, 0, 0]                     # a duplicate run
    h = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    go = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = sage_aggregate(torch.from_numpy(edges), ht)
    (got,) = torch.autograd.grad(out, ht, torch.from_numpy(go))
    hp = torch.from_numpy(h).requires_grad_(True)
    (plain,) = torch.autograd.grad(
        sage_aggregate_plain(torch.from_numpy(edges), hp), hp,
        torch.from_numpy(go))
    assert torch.equal(got, plain)
    assert torch.equal(sage_aggregate_backward_plain(
        torch.from_numpy(edges), torch.from_numpy(go), N), plain)
    np.testing.assert_allclose(_kernel_walk(edges, go, N), plain.numpy(),
                               rtol=1e-5, atol=1e-5)
    for b in range(B):
        e = jnp.asarray(np.where((edges[b] >= 0) & (edges[b] < N),
                                 edges[b], -1))
        _, vjp = jax.vjp(lambda x: ref_mean_aggregate(e, x),
                         jnp.asarray(h[b]))
        (jg,) = vjp(jnp.asarray(go[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def test_backward_index_orders_each_source_rows_slots():
    edges = np.array([[[2, 0, 2], [-1, 2, 5], [0, 0, -1]]], np.int32)
    rowptr, slots, denom = backward_index(torch.from_numpy(edges), 3)
    assert rowptr.tolist() == [0, 3, 3, 6]
    assert slots[:6].tolist() == [1, 6, 7, 0, 2, 4]
    assert denom.tolist() == [3.0, 1.0, 2.0]


def _prep_edges(B, S, F, N, seed):
    """Edges with ids -1 and >= N, a duplicate run, and source row 0 named
    by more than 32 slots of worker 0."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(-2, N + 2, (B, S, F)).astype(np.int32)
    edges[0, 0] = edges[0, 0, 0]
    edges[0, 1:, 0] = 0
    return edges


@pytest.mark.parametrize("B,S,F,N,D", [(1, 40, 1, 3, 4), (4, 50, 5, 30, 8),
                                       (2, 70, 3, 1, 5)])
def test_backward_prep_plain_matches_index_and_repro(B, S, F, N, D):
    edges = _prep_edges(B, S, F, N, B + S + F)
    keys, denom, counts = backward_prep_plain(torch.from_numpy(edges), N)
    e = edges.reshape(B, S * F)
    valid = (e >= 0) & (e < N)
    want = np.where(valid, e + np.arange(B)[:, None] * N, B * N).ravel()
    assert keys.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(
        denom.numpy(), np.maximum(valid.reshape(B * S, F).sum(-1), 1))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(want, minlength=B * N + 1)
                                  [:B * N])
    assert counts[0] > 32                            # a hub row
    rowptr, slots, denom_i = backward_index(torch.from_numpy(edges), N)
    np.testing.assert_array_equal(np.diff(rowptr.numpy()), counts.numpy())
    assert torch.equal(denom_i, denom)
    np.testing.assert_array_equal(keys.numpy()[slots.numpy()],
                                  np.sort(want, kind="stable"))
    # the prep pass as a scatter: grad_h[key] += grad_out[dst] / denom[dst]
    go = np.random.default_rng(D).normal(0, 1, (B, S, D)).astype(np.float32)
    g = go.reshape(B * S, D)
    dst = np.arange(B * S * F) // F
    grad = np.zeros((B * N + 1, D), np.float32)
    np.add.at(grad, keys.numpy(), g[dst] / denom.numpy()[dst, None])
    grad = grad[:B * N].reshape(B, N, D)
    for b in range(B):
        eb = jnp.asarray(np.where((edges[b] >= 0) & (edges[b] < N),
                                  edges[b], -1))
        h = np.zeros((N, D), np.float32)
        _, vjp = jax.vjp(lambda x: ref_mean_aggregate(eb, x), jnp.asarray(h))
        (jg,) = vjp(jnp.asarray(go[b]))
        np.testing.assert_allclose(grad[b], np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


_SIZES = {"0": lambda t: 0, "1": lambda t: 1, "tile-1": lambda t: t - 1,
          "tile": lambda t: t, "tile+1": lambda t: t + 1}


@pytest.mark.parametrize("tile", [SMALL_TILE, LARGE_TILE])
@pytest.mark.parametrize("size", list(_SIZES))
def test_scan_scratch_sizes(tile, size):
    n = _SIZES[size](tile)
    tiles = scan_tiles(n, tile)
    assert tiles == max(1, -(-n // tile))
    assert (tiles - 1) * tile < max(n, 1) <= tiles * tile
    buf, extra = scan_scratch(tiles, n, "cpu")
    assert buf.dtype == torch.int64 and not buf.any()
    assert extra.dtype == torch.int32 and extra.shape == (n,)
    assert buf.numel() * 8 >= (tiles + 1) * 8 + n * 4
    if n:
        assert extra.data_ptr() == buf.data_ptr() + (tiles + 1) * 8


def test_seeds_per_tile_grows_past_the_large_level():
    assert seeds_per_tile(0) == seeds_per_tile(LARGE_LEVEL) == SMALL_TILE
    assert seeds_per_tile(LARGE_LEVEL + 1) == LARGE_TILE
    assert LARGE_TILE % SMALL_TILE == 0


@pytest.mark.parametrize("which", ["fused_sample", "sage_backward_index",
                                   "sage_aggregate_backward",
                                   "sage_aggregate"])
def test_kernel_size_guards_raise(which):
    """Shapes past the kernels' int32 offsets (for the forward: 2**31
    destination rows, one block each on the wide-row path) raise before
    any launch.  A fanout past the ids the forward stages per block is no
    longer refused: it takes the wide-row kernel."""
    meta = torch.device("meta")
    idx = torch.zeros(3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        if which == "sage_aggregate":
            sage_aggregate(torch.zeros((4, 2 ** 29, MAX_STAGED_IDS + 1),
                                       dtype=torch.int32, device=meta),
                           torch.ones((4, 16, 4), device=meta))
        elif which == "fused_sample":
            fused_sample(idx, idx, torch.zeros((4, 2 ** 28), dtype=torch.int32,
                                               device=meta), 0, fanout=2)
        elif which == "sage_backward_index":
            sage_backward_index(torch.zeros((4, 2 ** 20, 512),
                                            dtype=torch.int32, device=meta),
                                16)
        else:
            sage_aggregate_backward(
                torch.zeros((4, 16, 2), dtype=torch.int32, device=meta),
                torch.ones((4, 16, 4), device=meta), 2 ** 29)


def _gat_table_case(lead, seed=0, S=24, F=3, H=2, C=3, prefix=True):
    """A table-contract case in float64: z (*lead, N, H * C), edges,
    dst, keep, a_src, a_dst.  Row 0 names source 7 twice, row 1 samples
    itself, row 2 has no valid edge, and rows 3 on name source 5 twice
    each (a hub past one chunk); dst is the prefix, or S distinct rows of
    the table."""
    rng = np.random.default_rng(seed)
    N = S + S * F
    edges = rng.integers(-1, N, (*lead, S, F))
    e = edges.reshape(-1, S, F)
    e[:, 0, :2] = 7
    e[:, 2] = -1
    e[:, 3:, 0] = e[:, 3:, 2] = 5
    dst = np.arange(S) if prefix else rng.permutation(N)[:S]
    e[:, 1, 0] = dst[1]
    dst = np.broadcast_to(dst, (*lead, S)).copy()
    keep = (edges >= 0) & (edges != dst[..., None])
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s))
    return (t(*lead, N, H * C), torch.from_numpy(edges).int(),
            torch.from_numpy(dst).int(), torch.from_numpy(keep),
            t(H, C), t(H, C))


def test_gat_attention_rows_do_not_depend_on_the_batch():
    """The first rows of a batch, run alone on the same table, give the
    same bits as in the whole batch."""
    xs = _gat_table_case((2,), seed=3)
    z, edges, dst, keep, a_src, a_dst = (x.float() if x.is_floating_point()
                                         else x for x in xs)
    out, alpha = gat_attention(z, edges, dst, keep, a_src, a_dst)
    for k in (1, 5, 17):
        o, a = gat_attention(z, edges[:, :k], dst[:, :k], keep[:, :k], a_src,
                             a_dst)
        assert torch.equal(o, out[:, :k]) and torch.equal(a, alpha[:, :k])


def _walk_source_passes(dzs, ids, kept, N):
    """The CUDA backward's per-source passes in Python: ``dzs`` (rows, K,
    D) each slot's gradient, ``ids`` (B, S, K) each slot's table row.
    Pass 1 writes one partial a window of ``CHUNK`` positions of the
    transpose, for the chunk after a row's first that starts there; pass 2
    sums each row's first chunk, then adds its later chunks' partials in
    chunk order.  Unwritten partials hold NaN."""
    B, S, K = ids.shape
    T = B * N
    rowptr, slots, _ = backward_index(ids, N)
    rowptr, slots = rowptr.tolist(), slots.tolist()
    flat = (ids + torch.arange(B).view(B, 1, 1) * N).reshape(-1).tolist()
    on = kept.reshape(-1).tolist()
    D = dzs.shape[-1]
    terms = dzs.reshape(-1, D)

    def chunk(p, q):
        acc = torch.zeros(D, dtype=dzs.dtype)
        for s in slots[p:q]:
            if on[s]:
                acc = acc + terms[s]
        return acc

    windows = -(-B * S * K // CHUNK)
    part = torch.full((windows, D), float("nan"), dtype=dzs.dtype)
    for j in range(windows):
        p0 = j * CHUNK
        if p0 >= rowptr[T]:
            continue
        r = flat[slots[p0]]
        rp, rq = rowptr[r], rowptr[r + 1]
        if rp == p0:
            continue
        p = rp + -(-(p0 - rp) // CHUNK) * CHUNK
        if p < rq:
            part[j] = chunk(p, min(p + CHUNK, rq))
    dz = torch.empty((T, D), dtype=dzs.dtype)
    for r in range(T):
        rp, rq = rowptr[r], rowptr[r + 1]
        acc = chunk(rp, min(rp + CHUNK, rq))
        for p in range(rp + CHUNK, rq, CHUNK):
            acc = acc + part[p // CHUNK]
        dz[r] = acc
    return dz


@pytest.mark.parametrize("prefix", [True, False])
def test_gat_source_passes_walk_matches_the_plain_gradient(prefix):
    z, edges, dst, keep, a_src, a_dst = _gat_table_case((3,), seed=4,
                                                        prefix=prefix)
    B, S, F = edges.shape
    N, HC = z.shape[-2:]
    H, C = a_src.shape
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, H, C)))
    _, alpha = gat_attention_plain(z, edges, dst, keep, a_src, a_dst)
    want, _, _ = gat_attention_backward_plain(g, z, edges, dst, keep, a_src,
                                              a_dst, alpha)
    ids = torch.cat([dst[..., None], edges], -1)
    zs = z.reshape(-1, HC)[(ids.clamp(min=0).long()
                            + torch.arange(B).view(B, 1, 1) * N)]
    rows = B * S
    zs = zs.reshape(rows, F + 1, HC)
    dz_nb, dz_dst, _, _ = per_edge_attention_backward_plain(
        g.reshape(rows, H, C), zs[:, 1:], zs[:, 0], keep.reshape(rows, F),
        a_src, a_dst, alpha.reshape(rows, F + 1, H))
    kept = torch.cat([torch.ones_like(keep[..., :1]), keep], -1)
    got = _walk_source_passes(torch.cat([dz_dst[:, None], dz_nb], 1), ids,
                              kept, N)
    # the hub: source 5 of each worker, past one chunk
    assert int((ids == 5)[kept].sum()) > B * CHUNK
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-12,
                               atol=1e-12)


def test_gat_per_edge_contract_is_the_table_contract_on_gathered_rows():
    """The table contract's plain version equals gathering each slot's row
    and running the per-edge one, to the bit."""
    z, edges, dst, keep, a_src, a_dst = _gat_table_case((2,), seed=6)
    B, S, F = edges.shape
    HC = z.shape[-1]
    out, alpha = gat_attention_plain(z, edges, dst, keep, a_src, a_dst)
    rows = B * S
    z_nb = torch.stack([z[b][edges[b].clamp(min=0).long()]
                        for b in range(B)])
    z_dst = torch.stack([z[b][dst[b].long()] for b in range(B)])
    o, a = per_edge_attention_plain(z_nb.reshape(rows, F, HC),
                                    z_dst.reshape(rows, HC),
                                    keep.reshape(rows, F), a_src, a_dst)
    assert torch.equal(out.reshape(o.shape), o)
    assert torch.equal(alpha.reshape(a.shape), a)


def test_cpu_tensors_take_the_plain_version_without_launching():
    reset_launch_counts()
    jg, tg = _hub_graph()
    fused_sample(tg.indptr, tg.indices, torch.tensor([0, 1], dtype=torch.int32),
                 0, fanout=2)
    h = torch.ones(3, 4, requires_grad=True)
    out = sage_aggregate(torch.zeros((2, 2), dtype=torch.int32), h)
    out.sum().backward()
    sage_aggregate_backward(torch.zeros((2, 2), dtype=torch.int32),
                            torch.ones(2, 4), 3)
    sage_backward_index(torch.zeros((2, 2), dtype=torch.int32), 3)
    feature_gather(torch.zeros(2, dtype=torch.int32), torch.ones(3, 4))
    gather_rows(torch.ones(3, 4), torch.zeros(2, dtype=torch.int32))
    out = sage_epilogue(torch.ones(2, 4), torch.ones(2, 4), torch.ones(4),
                        torch.rand(2, 4), 0.5)
    sage_epilogue_backward(torch.ones(2, 4), out, 0.5, rows_pad=3)
    z, keep, a = torch.ones(5, 8), torch.ones(2, 3, dtype=torch.bool), \
        torch.ones(2, 4)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    dst = torch.arange(2, dtype=torch.int32)
    out, alpha = gat_attention(z, ids, dst, keep, a, a)
    gat_attention_backward(out, z, ids, dst, keep, a, a, alpha)
    assert launch_counts() == {"fused_sample": 0, "gather_rows": 0,
                               "feature_gather": 0, "sage_aggregate": 0,
                               "sage_epilogue": 0,
                               "sage_epilogue_backward": 0,
                               "gat_attention": 0,
                               "gat_attention_backward": 0,
                               "sage_backward_index": 0,
                               "sage_aggregate_backward": 0}


@pytest.mark.parametrize("which", ["fused_sample", "sage_aggregate",
                                   "sage_aggregate_backward",
                                   "sage_backward_index",
                                   "feature_gather", "gather_rows",
                                   "sage_epilogue",
                                   "sage_epilogue_backward",
                                   "gat_attention",
                                   "gat_attention_backward"])
def test_non_cpu_tensors_never_fall_back(which):
    """A tensor off the CPU launches the kernel or raises; one on a device
    the kernels do not serve raises."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        if which == "fused_sample":
            idx = torch.zeros(3, dtype=torch.int32, device=meta)
            fused_sample(idx, idx, idx, 0, fanout=2)
        elif which == "sage_aggregate":
            sage_aggregate(torch.zeros((2, 2), dtype=torch.int32,
                                       device=meta),
                           torch.ones((3, 4), device=meta))
        elif which == "sage_aggregate_backward":
            sage_aggregate_backward(torch.zeros((2, 2), dtype=torch.int32,
                                                device=meta),
                                    torch.ones((2, 4), device=meta), 3)
        elif which == "sage_backward_index":
            sage_backward_index(torch.zeros((2, 2), dtype=torch.int32,
                                            device=meta), 3)
        elif which == "gather_rows":
            gather_rows(torch.ones((3, 4), device=meta),
                        torch.zeros(2, dtype=torch.int32, device=meta))
        elif which == "sage_epilogue":
            x = torch.ones((2, 4), device=meta)
            sage_epilogue(x, x, torch.ones(4, device=meta), x, 0.5)
        elif which == "sage_epilogue_backward":
            x = torch.ones((2, 4), device=meta)
            sage_epilogue_backward(x, x, 0.5)
        elif which in ("gat_attention", "gat_attention_backward"):
            z, a = torch.ones((5, 8), device=meta), \
                torch.ones((2, 4), device=meta)
            ids = torch.zeros((2, 3), dtype=torch.int32, device=meta)
            dst = torch.zeros(2, dtype=torch.int32, device=meta)
            keep = torch.ones((2, 3), dtype=torch.bool, device=meta)
            if which == "gat_attention":
                gat_attention(z, ids, dst, keep, a, a)
            else:
                gat_attention_backward(torch.ones((2, 2, 4), device=meta), z,
                                       ids, dst, keep, a, a,
                                       torch.ones((2, 4, 2), device=meta))
        else:
            feature_gather(torch.zeros(2, dtype=torch.int32, device=meta),
                           torch.ones((3, 4), device=meta))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises; nothing carries on without the
    kernels."""
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed: the missing-compiler path cannot "
                    "be shown")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
