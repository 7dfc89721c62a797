"""The port's roofline (``repro_torch.roofline``) held to ``repro``'s.

``model_flops`` equals ``repro``'s float for float for every arch x
shape; ``extrapolate`` and ``RooflineTerms`` compute as ``repro``'s do,
over the H100's data-sheet constants (``repro_torch.launch.mesh``), and no
TPU v5e constant is left in the port.  ``CostCounter`` counts one
device's work: a (B, d) @ (d, f) product with f sharded over a 4-rank
``model`` axis counts a quarter of the global FLOPs, and a Shard ->
Replicate redistribute counts one all-gather at its result's bytes.
"""
import dataclasses
import math
import pathlib
import re

import pytest
import torch

import repro.configs as j_cfg
from repro import roofline as j_roof
from repro_torch import roofline as t_roof
from repro_torch.configs import ARCH_ALIASES, SHAPES, get_config, get_shape
from repro_torch.launch import mesh as t_mesh

PORT = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"


@pytest.mark.parametrize("arch", list(ARCH_ALIASES))
def test_model_flops_equal_repro(arch):
    for name in SHAPES:
        assert t_roof.model_flops(get_config(arch), get_shape(name)) == \
            j_roof.model_flops(j_cfg.get_config(arch), j_cfg.get_shape(name))


def test_extrapolate_equals_repro():
    p1 = {"flops": 3.0e12, "hbm_bytes": 2.5e10, "coll_bytes": 1.0e8,
          "fusable": 0.0}
    p2 = {"flops": 5.5e12, "hbm_bytes": 4.0e10, "coll_bytes": 1.75e8,
          "fusable": 6.7e7}
    for units in (1, 2, 28, 38 / 6):
        assert t_roof.extrapolate(p1, p2, units) == \
            j_roof.extrapolate(p1, p2, units)


def test_terms_over_the_h100_data_sheet():
    assert (t_mesh.PEAK_FLOPS_BF16, t_mesh.HBM_BW, t_mesh.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    kw = dict(flops=9.89e14, hbm_bytes=6.7e12, coll_bytes=4.5e10,
              model_flops_global=1.0e17, chips=256, fusable=6.0e12)
    t, j = t_roof.RooflineTerms(**kw), j_roof.RooflineTerms(**kw)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(2.0)
    assert t.t_collective == pytest.approx(0.1)
    # the fusable subtraction is capped at 80 % of the raw bytes
    assert t.t_memory_adjusted == pytest.approx(0.2 * 2.0)
    assert t.dominant == "memory"
    assert t.useful_flops_ratio == j.useful_flops_ratio == \
        pytest.approx(1.0e17 / (9.89e14 * 256))
    assert set(t.as_dict()) == set(j.as_dict())
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert math.isnan(t_roof.RooflineTerms(0, 1, 1, 1, 256).
                      useful_flops_ratio)
    assert t_roof.COLLECTIVE_KINDS == j_roof._COLLECTIVES


def test_no_v5e_constant_in_the_port():
    v5e = re.compile(r"\b(?:197e12|819e9|50e9|197\s*TFLOP|819\s*GB)\b")
    hits = [str(p) for p in PORT.rglob("*.py") if v5e.search(p.read_text())]
    assert not hits


@pytest.fixture(scope="module")
def model_mesh():
    """A 4-rank ``model`` mesh of a fake-backend job (this process is rank
    0)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun_gnn import fake_job
    with fake_job(4):
        yield init_device_mesh("cpu", (4,), mesh_dim_names=("model",))


def test_counts_one_devices_flops(model_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    B, d, f = 8, 64, 96
    g = torch.Generator().manual_seed(0)
    x = DTensor.from_local(torch.randn(B, d, generator=g), model_mesh,
                           [Replicate()], run_check=False)
    w = DTensor.from_local(torch.randn(d, f // 4, generator=g), model_mesh,
                           [Shard(1)], run_check=False)
    counter = t_roof.CostCounter()
    with counter:
        y = x @ w
    assert tuple(y.shape) == (B, f) and y.placements == (Shard(1),)
    assert counter.flops == 2 * B * d * f / 4
    # the local product's operands and result, once each
    assert counter.hbm_bytes == 4 * (B * d + d * f // 4 + B * f // 4)
    assert counter.coll_total == 0


def test_counts_a_redistribute_at_result_bytes(model_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n, m = 16, 10
    x = DTensor.from_local(torch.ones(n // 4, m), model_mesh, [Shard(0)],
                           run_check=False)
    counter = t_roof.CostCounter()
    with counter:
        full = x.redistribute(model_mesh, [Replicate()])
    assert tuple(full.to_local().shape) == (n, m)
    assert counter.coll_counts == {"all-reduce": 0, "all-gather": 1,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 0}
    assert counter.coll_bytes["all-gather"] == n * m * 4
    assert counter.flops == 0


def test_counter_skips_shape_propagation(model_mesh):
    """DTensor runs each op once more at global shapes to learn its output
    (in a fake mode of its own): the count holds the local op only, also
    inside a fake mode (as the dry-run traces)."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mode = FakeTensorMode()
    with mode:
        x = DTensor.from_local(torch.empty(4, 32), model_mesh, [Replicate()],
                               run_check=False)
        w = DTensor.from_local(torch.empty(32, 5), model_mesh, [Shard(1)],
                               run_check=False)
    counter = t_roof.CostCounter()
    with mode, tracing(TracingContext(FakeTensorMode())), counter:
        x @ w
    assert counter.flops == 2 * 4 * 32 * 5
