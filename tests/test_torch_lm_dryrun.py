"""The port's LM dry-run (``repro_torch.launch.dryrun``) held to
``repro``'s.

``shape_applicable`` and ``depth_units`` equal ``repro``'s for every arch
x shape, ``--opt`` parses as ``repro``'s ``main`` parses it; rank 0 of a
256-rank fake-backend job traces ``mamba2-130m`` x ``decode_32k`` at full
size (``repro``'s ``tests/test_system.py`` compiles that combo on 512
host devices), and a reduced MoE config with its depth probes on a small
fake mesh gives ``repro``'s record keys and a roofline.  The DTensor
hooks of the models leave the one-device path as it was: a reduced
config's loss and gradients through DTensors on a one-rank mesh equal the
plain ones.
"""
import dataclasses
import os

import pytest
import torch

import repro.configs as j_cfg
from repro_torch.configs import (ARCH_ALIASES, SHAPES, get_config,
                                 get_reduced, get_shape)
from repro_torch.launch import dryrun as t_dry

# repro's dry-run asks for 512 host devices at import; this process keeps
# the device count it has
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dry  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one torch thread each under the parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_shape_applicable_and_depth_units_equal_repro():
    for arch in ARCH_ALIASES:
        cfg, jcfg = get_config(arch), j_cfg.get_config(arch)
        for name in SHAPES:
            assert t_dry.shape_applicable(cfg, get_shape(name)) == \
                j_dry.shape_applicable(jcfg, j_cfg.get_shape(name))
        units, c1, c2 = t_dry.depth_units(cfg)
        j_units, j1, j2 = j_dry.depth_units(jcfg)
        assert units == j_units
        assert dataclasses.asdict(c1) == dataclasses.asdict(j1)
        assert dataclasses.asdict(c2) == dataclasses.asdict(j2)


@pytest.mark.parametrize("opt", [
    "", "prefill_last", "moe_shard,ssm_shard", "moe_group",
    "moe_group:8,attn_chunk", "attn_chunk:512,ce_chunk",
    "ce_chunk:256,prefill_last,unknown"])
def test_opt_parsing_equals_repro(monkeypatch, opt):
    seen = {}

    def fake_run_combo(arch, shape, mesh, *, skip_probes, out_dir,
                       param_overrides):
        seen["overrides"] = param_overrides
        return {"status": "ok"}

    monkeypatch.setattr(j_dry, "run_combo", fake_run_combo)
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "qwen2-7b",
                                     "--shape", "train_4k", "--opt", opt])
    with pytest.raises(SystemExit) as done:
        j_dry.main()
    assert done.value.code == 0
    assert (t_dry.parse_opt(opt) or None) == seen["overrides"]


def test_full_size_decode_on_a_256_rank_fake_job(tmp_path):
    rec = t_dry.run_combo("mamba2-130m", "decode_32k", "pod",
                          skip_probes=True, out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    # the decode state is written in place: its buffers come back aliased
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert (tmp_path / "mamba2-130m__decode_32k__pod.json").exists()
    skipped = t_dry.run_combo("qwen2-7b", "long_500k", "pod")
    assert skipped["status"] == "skipped"


def test_reduced_moe_with_probes_has_repro_keys():
    """mixtral (reduced: 4 experts over a 2 x 2 mesh) at train_4k: the
    full step with remat, the two probes, and ``repro``'s keys."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun_gnn import fake_job
    cfg = dataclasses.replace(get_reduced("mixtral-8x22b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    with fake_job(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rec = t_dry.run_combo("mixtral-8x22b", "train_4k", "pod", cfg=cfg,
                              mesh=mesh)
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "chips", "compile_s", "memory",
            "collective_schedule_counts", "roofline", "status",
            "total_s"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    assert set(rec["collective_schedule_counts"]) == set(
        ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"))
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0 and roof["hbm_bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert rec["chips"] == 4


def test_dtensor_hooks_keep_the_values():
    """A reduced MoE config's loss and gradients through DTensors on a
    one-rank mesh (every hook taken, nothing split) equal the plain
    path's."""
    import torch.distributed as tdist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves
    from repro_torch.sharding import distribute, param_specs

    cfg = get_reduced("mixtral-8x22b")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    loss, _ = lm.lm_loss(params, batch, cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves)

    started = not tdist.is_initialized()
    mesh = make_host_mesh(device_type="cpu")
    try:
        dparams = distribute(params, param_specs(params, mesh), mesh)
        dleaves = tree_leaves(dparams)
        with implicit_replication():
            dloss, _ = lm.lm_loss(dparams, batch, cfg, remat=False)
            dgrads = torch.autograd.grad(dloss, dleaves)
        assert float(dloss.detach().full_tensor()) == \
            pytest.approx(float(loss.detach()), rel=1e-6)
        for a, b in zip(grads, dgrads):
            torch.testing.assert_close(b.full_tensor(), a, rtol=1e-5,
                                       atol=1e-6)
    finally:
        if started:
            tdist.destroy_process_group()
