"""The port's host-side build against ``repro``'s: synthetic datasets
(every source family and split), every partitioner's assignment (in
memory and over an edge stream), ``build_layout``, the on-disk format
across the two packages, the ingest path and the dataset statistics must
be bit-identical (``np.array_equal``) for the same spec and seed; the
schedules agree within 1e-7 (float32 on both sides)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.partition import build_layout as j_build_layout
from repro.core.partition import partition_graph as j_partition
from repro.core.partition import resolve_partitioner as j_resolve
from repro.data.spec import DataSpec as JDataSpec
from repro.data.spec import resolve_dataset as j_resolve_dataset
from repro_torch.core.partition import build_layout as t_build_layout
from repro_torch.core.partition import partition_graph as t_partition
from repro_torch.core.partition import resolve_partitioner as t_resolve
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.data.spec import resolve_dataset as t_resolve_dataset

SPECS = [dict(source="powerlaw(1.8)", num_nodes=600, avg_degree=6,
              num_features=12, num_classes=4, seed=3),
         dict(source="uniform", num_nodes=500, avg_degree=5,
              num_features=7, num_classes=3, split="random(0.5)", seed=1)]


def _datasets(kw):
    return (j_resolve_dataset(data=JDataSpec(**kw)),
            t_resolve_dataset(data=TDataSpec(**kw)))


@pytest.mark.parametrize("kw", SPECS, ids=["powerlaw", "uniform"])
def test_datasets_bit_identical(kw):
    jd, td = _datasets(kw)
    np.testing.assert_array_equal(td.graph.indptr.numpy(),
                                  np.asarray(jd.graph.indptr))
    np.testing.assert_array_equal(td.graph.indices.numpy(),
                                  np.asarray(jd.graph.indices))
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert td.name == jd.name and td.num_classes == jd.num_classes


@pytest.mark.parametrize("kw", SPECS, ids=["powerlaw", "uniform"])
@pytest.mark.parametrize("P", [2, 4])
def test_ldg_assignment_bit_identical(kw, P):
    jd, td = _datasets(kw)
    ref = j_partition(jd.graph, P, jd.labeled_mask, seed=P)
    got = t_partition(td.graph, P, td.labeled_mask, seed=P)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        t_resolve("ldg").assign(td.graph, P, td.labeled_mask),
        j_resolve("ldg").assign(jd.graph, P, jd.labeled_mask))


@pytest.mark.parametrize("P", [2, 4])
def test_build_layout_bit_identical(P):
    jd, td = _datasets(SPECS[0])
    assign = j_partition(jd.graph, P, jd.labeled_mask)
    ref = j_build_layout(jd.graph, jd.features, jd.labels, assign, P)
    got = t_build_layout(td.graph, td.features, td.labels, assign, P)
    np.testing.assert_array_equal(got.graph.indptr.numpy(),
                                  np.asarray(ref.graph.indptr))
    np.testing.assert_array_equal(got.graph.indices.numpy(),
                                  np.asarray(ref.graph.indices))
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(ref.offsets))
    np.testing.assert_array_equal(got.perm, ref.perm)
    for field in ("features", "labels", "node_valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        t_resolve("metis_not_ported")
    with pytest.raises(ValueError):
        TDataSpec(source="rmat_not_ported")


# --------------------------------------------------------------------------
# the rest of the data layer and the partitioners
# --------------------------------------------------------------------------

from repro.core.adaptive import AdaptiveFanout as JAdaptive  # noqa: E402
from repro.core.partition import (  # noqa: E402
    partition_graph_streaming as j_streaming)
from repro.core.partition import refine_partition as j_refine  # noqa: E402
from repro.data import csc_from_edge_stream as j_csc_stream  # noqa: E402
from repro.data import dataset_stats as j_stats  # noqa: E402
from repro.data import iter_edge_chunks as j_chunks  # noqa: E402
from repro.data import load_dataset as j_load  # noqa: E402
from repro.data import save_dataset as j_save  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.pipeline import PipelineSpec as JSpec  # noqa: E402
from repro_torch.core.adaptive import AdaptiveFanout  # noqa: E402
from repro_torch.core.graph import (COOGraph, coo_to_csc,  # noqa: E402
                                    csc_to_coo, validate_csc)
from repro_torch.core.partition import (  # noqa: E402
    partition_graph_streaming as t_streaming)
from repro_torch.core.partition import refine_partition  # noqa: E402
from repro_torch.data import (csc_from_edge_stream,  # noqa: E402
                              dataset_stats, iter_edge_chunks, load_dataset,
                              save_dataset, stats_label, stream_edges)
from repro_torch.data import smoke as t_smoke  # noqa: E402
from repro_torch.optim import cosine_schedule, linear_warmup  # noqa: E402
from repro_torch.pipeline import Pipeline as TPipeline  # noqa: E402
from repro_torch.pipeline import PipelineSpec as TSpec  # noqa: E402

FAMILIES = {
    "rmat": dict(source="rmat(0.57,0.19,0.19,0.05)", num_nodes=800,
                 avg_degree=6, num_features=8, num_classes=4, seed=5),
    "sbm": dict(source="sbm(4,0.9,0.1)", num_nodes=800, avg_degree=6,
                num_features=8, num_classes=3, seed=2),
    "powerlaw-degree_stratified": dict(
        source="powerlaw(2.1)", num_nodes=800, avg_degree=6,
        num_features=8, num_classes=4, split="degree_stratified(0.3)",
        seed=4),
    "rmat-degree_stratified": dict(
        source="rmat(0.5,0.2,0.2,0.1)", num_nodes=777, avg_degree=5,
        num_features=8, num_classes=4, split="degree_stratified(0.2,5)",
        seed=1),
}
CHUNK = 311          # edges a chunk: off every power of two


def _same_dataset(td, jd):
    np.testing.assert_array_equal(np.asarray(td.graph.indptr),
                                  np.asarray(jd.graph.indptr))
    np.testing.assert_array_equal(np.asarray(td.graph.indices),
                                  np.asarray(jd.graph.indices))
    np.testing.assert_array_equal(np.asarray(td.features),
                                  np.asarray(jd.features))
    np.testing.assert_array_equal(np.asarray(td.labels),
                                  np.asarray(jd.labels))
    assert td.name == jd.name and td.num_classes == jd.num_classes


@pytest.fixture(scope="module")
def families():
    return {k: _datasets(kw) for k, kw in FAMILIES.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_source_families_and_splits_bit_identical(families, family):
    jd, td = families[family]
    _same_dataset(td, jd)
    labeled = td.labels >= 0
    assert 0 < labeled.sum() < labeled.size
    if family.startswith("sbm"):
        assert len(np.unique(td.labels[labeled])) == 3


def test_degree_stratified_labels_every_degree_band(families):
    _, td = families["powerlaw-degree_stratified"]
    deg = np.diff(td.graph.numpy()[0])
    labeled = td.labels >= 0
    # the policy breaks degree ties by hash, so these bands (ties by id)
    # are not quite its buckets
    order = np.argsort(deg, kind="stable")
    for band in np.array_split(order, 10):
        assert 0.1 < labeled[band].mean() < 0.5
    assert abs(labeled.mean() - 0.3) < 0.01


@pytest.mark.parametrize("name", ["hash", "random", "labelprop(1)",
                                  "labelprop(3)"])
@pytest.mark.parametrize("P", [2, 4])
def test_partitioners_bit_identical(families, name, P):
    jd, td = families["rmat"]
    got = t_resolve(name).assign(td.graph, P, td.labeled_mask, seed=P)
    ref = j_resolve(name).assign(jd.graph, P, jd.labeled_mask, seed=P)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    assert np.bincount(got, minlength=P).max() <= 1.05 * got.size / P + 1


@pytest.mark.parametrize("sweeps", [1, 3])
def test_refinement_only_lowers_the_cut(families, sweeps):
    jd, td = families["sbm"]
    base = t_partition(td.graph, 4, td.labeled_mask)
    got = refine_partition(td.graph, base, 4, td.labeled_mask,
                           sweeps=sweeps)
    ref = j_refine(jd.graph, j_partition(jd.graph, 4, jd.labeled_mask), 4,
                   jd.labeled_mask, sweeps=sweeps)
    np.testing.assert_array_equal(got, ref)
    from repro_torch.core.partition import edge_cut
    assert edge_cut(td.graph, got) <= edge_cut(td.graph, base)


@pytest.mark.parametrize("name", ["ldg", "hash", "random"])
@pytest.mark.parametrize("P", [2, 4])
def test_assign_stream_bit_identical(families, name, P):
    jd, td = families["powerlaw-degree_stratified"]
    got = t_resolve(name).assign_stream(
        iter_edge_chunks(td.graph, CHUNK), td.graph.num_nodes, P,
        td.labeled_mask, seed=1)
    ref = j_resolve(name).assign_stream(
        j_chunks(jd.graph, CHUNK), jd.graph.num_nodes, P, jd.labeled_mask,
        seed=1)
    np.testing.assert_array_equal(got, ref)
    if name == "ldg":
        np.testing.assert_array_equal(
            t_streaming(iter_edge_chunks(td.graph, CHUNK),
                        td.graph.num_nodes, P, td.labeled_mask),
            j_streaming(j_chunks(jd.graph, CHUNK), jd.graph.num_nodes, P,
                        jd.labeled_mask))


def test_streaming_is_refused_where_there_is_none(families):
    _, td = families["rmat"]
    with pytest.raises(NotImplementedError, match="no streaming variant"):
        t_resolve("labelprop").assign_stream(
            iter_edge_chunks(td.graph, CHUNK), td.graph.num_nodes, 2,
            td.labeled_mask)


def test_metis_refuses_cleanly_without_pymetis():
    try:
        import pymetis  # noqa: F401
        pytest.skip("pymetis is installed: the refusal cannot happen")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pymetis"):
        t_resolve("metis")
    with pytest.raises(ValueError, match="takes no parameters"):
        t_resolve("hash(3)")


@pytest.mark.parametrize("mmap", [True, False], ids=["mmap", "eager"])
@pytest.mark.parametrize("writer", ["repro", "port"])
def test_npz_files_load_in_the_other_package(families, tmp_path, writer,
                                             mmap):
    jd, td = families["sbm"]
    if writer == "repro":
        path = j_save(jd, str(tmp_path / "ds"))
        back = load_dataset(path, mmap=mmap)
        _same_dataset(back, jd)
    else:
        path = save_dataset(td, str(tmp_path / "ds"))
        back = j_load(path, mmap=mmap)
        _same_dataset(td, back)
    assert isinstance(load_dataset(path, mmap=mmap).graph.indptr,
                      torch.Tensor)


def test_load_refuses_a_foreign_or_newer_file(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(ValueError, match="no meta member"):
        load_dataset(path)
    with pytest.raises(FileNotFoundError):
        load_dataset(str(tmp_path / "missing.npz"))


@pytest.mark.parametrize("chunk", [1, CHUNK, 10 ** 6])
def test_csc_from_edge_stream(families, tmp_path, chunk):
    jd, td = families["rmat"]
    n = td.graph.num_nodes
    got = csc_from_edge_stream(lambda: iter_edge_chunks(td.graph, chunk), n)
    ref = j_csc_stream(lambda: j_chunks(jd.graph, chunk), n)
    for a, b in ((got.indptr, ref.indptr), (got.indices, ref.indices),
                 (got.indptr, td.graph.indptr),
                 (got.indices, td.graph.indices)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = save_dataset(td, str(tmp_path / "g"))
    loaded = load_dataset(path)
    disk = csc_from_edge_stream(lambda: stream_edges(loaded, chunk), n)
    np.testing.assert_array_equal(disk.indices.numpy(),
                                  td.graph.indices.numpy())
    with pytest.raises(TypeError, match="factory"):
        csc_from_edge_stream(iter_edge_chunks(td.graph, chunk), n)


def test_dataset_stats_and_validate_csc(families):
    for jd, td in families.values():
        assert dataset_stats(td) == j_stats(jd)
        validate_csc(td.graph)
    jd, td = families["rmat"]
    assert stats_label(dataset_stats(td)).startswith(td.name)
    coo = csc_to_coo(td.graph)
    back = coo_to_csc(COOGraph(row=coo.row, col=coo.col), td.graph.num_nodes)
    assert torch.equal(back.indptr, td.graph.indptr)
    assert torch.equal(back.indices, td.graph.indices)
    bad = type(td.graph)(indptr=td.graph.indptr,
                         indices=td.graph.indices.clone().fill_(
                             td.graph.num_nodes))
    with pytest.raises(ValueError, match="out of range"):
        validate_csc(bad)


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["memory", "stream"])
def test_build_from_a_saved_file_gives_repro_layout(families, tmp_path,
                                                    chunk):
    jd, _ = families["powerlaw-degree_stratified"]
    path = j_save(jd, str(tmp_path / "pl"))
    kw = dict(num_parts=4, fanouts=(3, 2), partitioner="hash")
    jp = JPipeline.build_from_source(
        path, JSpec.from_scheme("hybrid", fused_backend="reference", **kw),
        partition_chunk_edges=chunk)
    tp = TPipeline.build_from_source(path, TSpec.from_scheme("hybrid",
                                                             **kw),
                                     partition_chunk_edges=chunk,
                                     device="cpu")
    assert tp.dataset.name == jd.name
    np.testing.assert_array_equal(tp.layout.perm, jp.layout.perm)
    for field in ("offsets", "features", "labels", "node_valid"):
        np.testing.assert_array_equal(getattr(tp.layout, field).numpy(),
                                      np.asarray(getattr(jp.layout, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tp.layout.graph.indices.numpy(),
                                  np.asarray(jp.layout.graph.indices))


def test_adaptive_fanout_ladder_matches_repro():
    losses = [1.0, 1.0, 1.0, 0.5, 0.5, 0.499, 0.499, 0.499, 0.1]
    ladder = ((15, 10, 5), (10, 7, 4), (5, 5, 3))
    ours, theirs = AdaptiveFanout(ladder=ladder), JAdaptive(ladder=ladder)
    for loss in losses:
        assert ours.update(loss) == theirs.update(loss)
        assert ours.fanouts == theirs.fanouts
        assert ours.edges_per_seed == theirs.edges_per_seed
    assert ours.stage == len(ladder) - 1


def test_schedules_match_repro():
    for step in range(0, 40, 3):
        np.testing.assert_allclose(
            float(linear_warmup(step, base_lr=0.01, warmup_steps=7)),
            float(jsched.linear_warmup(step, base_lr=0.01, warmup_steps=7)),
            rtol=0, atol=1e-7)
        kw = dict(base_lr=0.01, warmup_steps=5, total_steps=30,
                  min_ratio=0.1)
        np.testing.assert_allclose(
            float(cosine_schedule(torch.tensor(step), **kw)),
            float(jsched.cosine_schedule(jnp.int32(step), **kw)),
            rtol=0, atol=1e-7)


def test_data_smoke_runs_at_toy_size(capsys):
    t_smoke.main(["--nodes", "120", "--degree", "4"])
    assert "data-smoke PASSED (4 source families)" in capsys.readouterr().out
