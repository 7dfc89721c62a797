"""The port's sharding rules and sharding trees (``repro_torch.sharding``,
``repro_torch.launch.specs``) held to ``repro``'s.

``spec_for_param`` equals ``repro``'s for every leaf of every full
config's parameters (``repro``'s own ``abstract_params`` through
``jax.eval_shape``) on the pod and multi-pod meshes and their 8-way
model-parallel shapes; ``batch_spec`` / ``cache_spec`` on ``repro``'s
test cases; ``batch_shardings`` and ``decode_state_shardings`` for every
arch x shape (on ``jax.sharding.AbstractMesh``\\s); and the DTensor
placements of a spec give the local shard shape that ``NamedSharding``
computes for it.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.configs as j_cfg
from repro import sharding as j_sh
from repro.launch import specs as j_specs
from repro_torch import sharding as t_sh
from repro_torch.configs import ARCH_ALIASES, SHAPES, get_config, get_shape
from repro_torch.launch import specs as t_specs


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "pod": {"data": 16, "model": 16},
    "multipod": {"pod": 2, "data": 16, "model": 16},
    "pod_tp8": {"data": 32, "model": 8},
    "multipod_tp8": {"pod": 2, "data": 32, "model": 8},
}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat(tree) -> dict:
    """``repro``'s tree as {path: leaf} under its path strings."""
    return {_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree) -> dict:
    out = {}
    t_sh.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _abstract(mesh: str) -> AbstractMesh:
    shape = MESHES[mesh]
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@pytest.fixture(scope="module")
def repro_params():
    """``repro``'s parameter shapes for every full config (eval_shape)."""
    return {arch: {p: tuple(x.shape) for p, x in _flat(
        j_specs.abstract_params(j_cfg.get_config(arch))).items()}
        for arch in ARCH_ALIASES}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_param_every_leaf(repro_params, mesh):
    fake = FakeMesh(MESHES[mesh])
    for arch in ARCH_ALIASES:
        ours = _port_flat(t_specs.abstract_params(get_config(arch)))
        assert {p: tuple(x.shape) for p, x in ours.items()} == \
            repro_params[arch], arch
        for path, shape in repro_params[arch].items():
            want = j_sh.spec_for_param(path, shape, fake)
            got = t_sh.spec_for_param(path, shape, fake)
            assert tuple(got) == tuple(want), (arch, path, got, want)


def test_spec_trees_match_repro_param_specs(repro_params):
    """``param_specs`` (the tree) equals ``repro``'s, leaf for leaf."""
    mesh = _abstract("pod")
    for arch in ("qwen2-7b", "zamba2-1.2b", "whisper-small"):
        cfg = get_config(arch)
        want = _flat(j_sh.param_specs(
            j_specs.abstract_params(j_cfg.get_config(arch)), mesh))
        got = _port_flat(t_sh.param_specs(t_specs.abstract_params(cfg),
                                          mesh))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("shape", [
    (256, 4096), (32, 32768), (128, 1), (1, 524288), (16, 8), (2, 3),
    (48, 5), (512, 1, 1), (64,)])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec(shape, mesh):
    fake = FakeMesh(MESHES[mesh])
    assert tuple(t_sh.batch_spec(shape, fake)) == \
        tuple(j_sh.batch_spec(shape, fake))


@pytest.mark.parametrize("kw", [{}, {"kv_head_dim": 2},
                                {"batch_dim": 0, "kv_head_dim": 2}])
@pytest.mark.parametrize("shape", [
    (28, 128, 32768, 4, 128), (56, 128, 32768, 8, 128),
    (24, 128, 32768, 32, 64), (61, 1, 524288, 8, 128),
    (24, 128, 24, 64, 128), (12, 128, 1500, 12, 64), (3, 5, 7, 9, 11)])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_spec(shape, kw, mesh):
    fake = FakeMesh(MESHES[mesh])
    assert tuple(t_sh.cache_spec(shape, fake, **kw)) == \
        tuple(j_sh.cache_spec(shape, fake, **kw))


def test_repro_rule_cases():
    """``repro``'s own rule cases (``tests/test_sharding_rules.py``)."""
    pod, multi = FakeMesh(MESHES["pod"]), FakeMesh(MESHES["multipod"])
    P = t_sh.P
    assert t_sh.spec_for_param("embed/tokens", (152064, 3584), pod) == \
        P("model", None)
    assert t_sh.spec_for_param("blocks/moe/w1", (61, 384, 7168, 2048),
                               multi) == P(None, ("pod", "data"), None,
                                           "model")
    assert t_sh.spec_for_param("blocks/moe/w2", (56, 8, 16384, 6144),
                               pod) == P(None, None, "model", "data")
    assert t_sh.batch_spec((1, 524288), pod) == P(None, None)
    assert t_sh.batch_spec((32, 32768), multi) == P(("pod", "data"), None)
    assert tuple(t_sh.P()) == tuple(JP()) == ()
    assert tuple(P(("pod", "data"), None)) == tuple(JP(("pod", "data"),
                                                       None))


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_batch_and_decode_state_shardings(mesh):
    am = _abstract(mesh)
    for arch in ARCH_ALIASES:
        jcfg, cfg = j_cfg.get_config(arch), get_config(arch)
        for name in SHAPES:
            jshape, shape = j_cfg.get_shape(name), get_shape(name)
            want = j_specs.batch_shardings(j_specs.input_specs(jcfg, jshape),
                                           am)
            got = t_specs.batch_shardings(t_specs.input_specs(cfg, shape),
                                          am)
            assert set(got) == set(want), (arch, name)
            for k in want:
                assert tuple(got[k]) == tuple(want[k].spec), (arch, name, k)
            want = {p: tuple(ns.spec) for p, ns in _flat(
                j_specs.decode_state_shardings(
                    j_specs.abstract_decode_state(jcfg, jshape), am)).items()}
            got = {p: tuple(s) for p, s in _port_flat(
                t_specs.decode_state_shardings(
                    t_specs.abstract_decode_state(cfg, shape), am)).items()}
            assert got == want, (arch, name)


def test_opt_shardings_tree_mirrors_params():
    cfg = get_config("mixtral-8x22b")
    pstruct = t_specs.abstract_params(cfg)
    ostruct = t_specs.abstract_opt_state(cfg, pstruct)
    mesh = FakeMesh(MESHES["pod"])
    got = t_specs.opt_shardings_tree(ostruct, pstruct, mesh)
    want = t_sh.param_specs(pstruct, mesh)
    assert tuple(got.step) == () and got.mu == want and got.nu == want


@pytest.fixture(scope="module")
def fake_meshes():
    """DeviceMeshes of a 512-rank fake job (rank 0): pod and multi-pod."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun_gnn import fake_job
    with fake_job(512):
        yield {
            "multipod": init_device_mesh(
                "cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model")),
            "multipod_tp8": init_device_mesh(
                "cpu", (2, 32, 8), mesh_dim_names=("pod", "data", "model")),
        }


@pytest.mark.parametrize("mesh", ["multipod", "multipod_tp8"])
def test_placements_shard_shape_equals_jax(fake_meshes, repro_params, mesh):
    """DTensor's local shard shape under ``placements(spec)`` equals
    ``NamedSharding(mesh, spec).shard_shape`` for every parameter of three
    configs (tuples of axes on one dim included: kimi's experts)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    dm, am = fake_meshes[mesh], _abstract(mesh)
    n = 0
    for arch in ("kimi-k2-1t-a32b", "qwen2-7b", "mamba2-130m"):
        for path, shape in repro_params[arch].items():
            spec = t_sh.spec_for_param(path, shape, dm)
            local, _ = compute_local_shape_and_global_offset(
                torch.Size(shape), dm, t_sh.placements(spec, dm))
            want = NamedSharding(am, JP(*spec)).shard_shape(shape)
            assert tuple(local) == tuple(want) == \
                t_sh.local_shape(shape, spec, dm), (arch, path, spec)
            n += any(isinstance(e, tuple) for e in spec)
    assert n > 0          # a dim over ("pod", "data") was among them


def test_placements_refuse_axes_out_of_mesh_order(fake_meshes):
    with pytest.raises(ValueError, match="mesh's order"):
        t_sh.placements(t_sh.P(("data", "pod")), fake_meshes["multipod"])
