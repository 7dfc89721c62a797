"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/*_torch.py``) import neither ``jax`` nor the
JAX package ``repro``.

  * In a subprocess where ``import jax`` and ``import repro`` fail, every
    module of ``repro_torch`` imports.
  * A static scan of the port's sources finds no such import statement, so
    a later change cannot add one in a code path the subprocess misses.
"""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the training slice's modules, which both checks must reach by name
TRAINING_SLICE = ("core.feature_store", "core.cache", "kernels.gather",
                  "optim", "optim.optimizers", "pipeline.worker", "train",
                  "train.loop", "train.checkpoint", "launch",
                  "launch.train_gnn")
# the overlap slice's modules
OVERLAP_SLICE = ("pipeline.staging", "pipeline.prefetch", "serve.recycler",
                 "launch.serve_gnn")
# the exact-inference and observability slice's modules
OBS_SLICE = ("core.inference", "obs", "obs.trace", "obs.metrics",
             "obs.profile", "obs.report")
# the convs, data-layer and partitioner slice's new modules
DATA_SLICE = ("data.dataset_io", "data.ingest", "data.stats", "data.smoke",
              "data.ogb", "core.adaptive", "optim.schedule")
# the multi-rank slice's modules (chip_smoke.py runs its fleet's ranks as
# itself, so the scan of chip_smoke.py covers them)
FLEET_SLICE = ("launch.multihost", "pipeline.executor", "core.dist")
# the dry-run slice's module and the port's examples
DRYRUN_SLICE = ("launch.dryrun_gnn",)
# the LM scaffold's modules (part 1)
LM_SLICE = ("configs", "configs.minitron_4b", "configs.whisper_small",
            "configs.qwen2_7b", "configs.mamba2_130m", "configs.zamba2_1p2b",
            "configs.mixtral_8x22b", "configs.stablelm_1p6b",
            "configs.h2o_danube3_4b", "configs.qwen2_vl_7b",
            "configs.kimi_k2_1t_a32b", "models.layers", "models.attention",
            "models.moe", "models.ssm", "models.lm", "data.tokens",
            "launch.specs", "launch.serve_lm", "launch.serve", "launch.train")
# the LM scaffold's modules (part 2: the mesh, the sharding rules, the
# roofline, the dry-run, the models' DTensor hooks)
LM2_SLICE = ("launch.mesh", "sharding", "roofline", "launch.dryrun",
             "models.spmd")
EXAMPLES = ("quickstart_torch.py", "distributed_hybrid_torch.py",
            "train_gnn_e2e_torch.py", "serve_lm_torch.py")
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s,]|$)",
                       re.MULTILINE)


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + [ROOT / "examples" / name for name in EXAMPLES])


def test_every_module_imports_without_jax_or_repro():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in [m for m in sys.modules
                             if sys.modules[m] is not None]
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.split())
    assert len(names) >= 40
    assert {f"repro_torch.{m}"
            for m in TRAINING_SLICE + OVERLAP_SLICE + OBS_SLICE
            + DATA_SLICE + FLEET_SLICE + DRYRUN_SLICE + LM_SLICE
            + LM2_SLICE} <= names


def test_static_scan_finds_no_jax_or_repro_import():
    scanned = {p.relative_to(PORT).with_suffix("").as_posix().replace(
        "/", ".").removesuffix(".__init__") for p in _port_sources()
        if PORT in p.parents}
    assert set(TRAINING_SLICE + OVERLAP_SLICE + OBS_SLICE
               + DATA_SLICE + FLEET_SLICE + DRYRUN_SLICE + LM_SLICE
               + LM2_SLICE) <= scanned
    assert all(p.is_file() for p in _port_sources())
    offenders = []
    for path in _port_sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group().strip()}")
    assert not offenders, offenders


def test_scan_pattern_tells_repro_from_repro_torch():
    assert FORBIDDEN.search("import jax")
    assert FORBIDDEN.search("from jax.numpy import x")
    assert FORBIDDEN.search("    from repro.core import dist")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("import repro_torch")
    assert not FORBIDDEN.search("from repro_torch.core import dist")
