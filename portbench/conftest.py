"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny configuration and its cells added as files and entries, as a later
change would add them.  Runs stay on the CPU (the port's kernels
run their plain versions there) and skip the harness's look for a chip."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TINY = {"num_nodes": 3000, "avg_degree": 8, "num_features": 16,
        "num_classes": 5, "labeled_fraction": 0.3}
TINY_MODEL = {"in_dim": 16, "hidden_dim": 32, "num_classes": 5,
              "fanouts": [4, 3, 2]}
TINY_TRAFFIC = ("fastsample", "vanilla", "cached")
TINY_CACHE = 256                   # a cache short of the remote rows


def make_tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` plus the
    configuration ``tiny``, the mixes ``tiny-<traffic>`` (32 seeds a
    worker, the cache as the mix has it), the cells
    ``tiny.<traffic>`` (checked against ``sage-products``' limits) and
    every metric entry extended to them."""
    dest = Path(dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/sage-products.json")
                     .read_text())
    cfg.update(TINY)
    cfg["model"] = dict(cfg["model"], **TINY_MODEL)
    (dest / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="portbench/configs/tiny.json"))
    for traffic in TINY_TRAFFIC:
        mix = json.loads((ROOT / f"portbench/mixes/{traffic}.json")
                         .read_text())
        mix.update(batch=32, warmup_steps=4, trace_steps=2, label_steps=2,
                   stage_steps=2)
        (dest / f"portbench/mixes/tiny-{traffic}.json").write_text(
            json.dumps(mix))
        cell = f"tiny.{traffic}"
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": f"tiny-{traffic}", "chips": 1,
                                   "why": "a CPU test's cell"})
        shutil.copy(ROOT / f"portbench/checks/sage-products.{traffic}.json",
                    dest / f"portbench/checks/{cell}.json")
    for entry in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in entry:
            entry["workloads"] = entry["workloads"] + [
                f"tiny.{c.split('.')[1]}" for c in entry["workloads"]
                if c.startswith("sage-products.")]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def one_thread():
    """Torch on one thread for the test, restored afterwards (many small
    ops oversubscribe the cores under xdist)."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tiny_root(tmp_path, one_thread):
    return make_tiny_root(tmp_path / "checkout")
