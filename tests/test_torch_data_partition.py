"""The port's host-side build against ``repro``'s: synthetic datasets, the
``ldg`` assignment and ``build_layout`` must be bit-identical
(``np.array_equal``) for the same spec and seed."""
import numpy as np
import pytest

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
