"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/*_torch.py``) import neither ``jax`` nor the
JAX package ``repro``.

  * In a subprocess where ``import jax`` and ``import repro`` fail, every
    module of ``repro_torch`` imports.
  * A static scan of the port's sources finds no such import statement, so
    a later change cannot add one in a code path the subprocess misses.

And the port does all that ``repro`` does: a static scan of every module
pair finds each public name of a ``repro`` module in its ``repro_torch``
counterpart, apart from the names ``NO_COUNTERPART`` lists with the
reason each has none.
"""
import ast
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
REPRO = ROOT / "src" / "repro"
# public names of repro without a counterpart in repro_torch, by module
# ("*": the whole module), each with its reason
NO_COUNTERPART = {
    ("compat", "*"): "shims for JAX 0.4.x's shard_map and mesh APIs",
    ("core.dist", "AXIS"): "the named vmap / shard_map axis; the port's "
                           "workers are stacked on axis 0",
    ("roofline", "collective_bytes"): "parses HLO text; the port counts "
                                      "collectives with CostCounter",
    ("roofline", "fusable_bytes"): "parses HLO text; the port counts "
                                   "bytes with CostCounter",
    ("launch.dryrun", "lower_combo"): "lowers a combo to HLO; the port "
                                      "runs it on fake tensors",
    ("launch.mesh", "ICI_BW"): "a TPU interconnect rate; the port's is "
                               "LINK_BW (NVLink)",
    ("launch.multihost", "ENV_COORDINATOR"): "jax.distributed's "
                                             "coordinator variable; the "
                                             "port's rendezvous is "
                                             "ENV_ADDRESS",
    ("launch.multihost", "ENV_LOCAL_DEVICES"): "jax.distributed's "
                                               "placeholder devices a "
                                               "process; a port rank "
                                               "holds its workers",
    ("kernels.feature_gather", "TILE_I"): "a Pallas tile",
    ("kernels.feature_gather", "TILE_T"): "a Pallas tile",
    ("kernels.sage_aggregate", "TILE_S"): "a Pallas tile",
    ("kernels.sage_aggregate", "TILE_N"): "a Pallas tile",
    ("kernels.gather", "BLOCK_ROWS"): "a Pallas grid step's rows",
    ("kernels.ops", "INTERPRET"): "Pallas interpret mode; a CPU tensor "
                                  "takes the plain version",
    ("models.attention", "PROBE_UNROLL"): "unrolls lax.scan for an HLO "
                                          "probe; the port counts in "
                                          "eager mode",
    ("obs.trace", "instant"): "no caller in the port: its markers are "
                              "spans, which carry their step and parent",
}
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


def _module_name(path: pathlib.Path, root: pathlib.Path) -> str:
    return path.relative_to(root).with_suffix("").as_posix().replace(
        "/", ".").removesuffix(".__init__").removesuffix("__init__")


def _repro_public_names(path: pathlib.Path) -> set:
    """What a module of repro offers: the names it defines or assigns at
    top level, lists in ``__all__`` or re-exports with ``noqa: F401``."""
    text = path.read_text()
    lines = text.splitlines()
    names = set()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names.update(ast.literal_eval(node.value))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if "noqa: F401" in "\n".join(
                    lines[node.lineno - 1:node.end_lineno]):
                names.update(a.asname or a.name.split(".")[0]
                             for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _port_names(path: pathlib.Path) -> set:
    """Every name a module of the port binds at top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0]
                         for a in node.names)
    return names


def test_port_has_every_public_name_of_repro():
    missing, absent = [], set()
    for path in sorted(REPRO.rglob("*.py")):
        mod = _module_name(path, REPRO)
        twin = PORT / path.relative_to(REPRO)
        if not twin.is_file():
            absent.add((mod, "*"))
            continue
        have = _port_names(twin)
        for name in sorted(_repro_public_names(path) - have):
            if (mod, name) not in NO_COUNTERPART:
                missing.append(f"{mod}.{name}")
            absent.add((mod, name))
    assert not missing, f"public names of repro the port lacks: {missing}"
    # the allow-list names only what is absent, each with its reason
    assert set(NO_COUNTERPART) == absent, \
        set(NO_COUNTERPART) ^ absent
    assert all(reason.strip() for reason in NO_COUNTERPART.values())


def test_name_scan_reads_defs_assigns_all_and_reexports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(textwrap.dedent("""
        import os
        from a import b  # noqa: F401
        from c import (d,
                       e)  # noqa: F401
        X, (Y, Z) = 1, (2, 3)
        T: int = 4
        __all__ = ["W"]
        def f(): pass
        class K: pass
        _hidden = 5
    """))
    assert _repro_public_names(src) == {"b", "d", "e", "X", "Y", "Z", "T",
                                        "W", "f", "K"}
    assert {"os", "b", "d", "e", "f", "K", "_hidden"} <= _port_names(src)
