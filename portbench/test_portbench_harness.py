"""The harness finds every piece of a cell by name, the benchmark's file
keeps to its contract, and a later change can add a configuration, a mix,
a per-layer metric and a model by adding files and entries only."""
import json
import re
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_bench(ROOT)


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        cfg = json.loads(harness.config_path(ROOT, bench, cell["config"])
                         .read_text())
        mix = harness.load_mix(ROOT, bench, cell["traffic"])
        limits = harness.load_limits(ROOT, bench, cell["name"])
        assert cfg["model"]["in_dim"] == cfg["num_features"]
        assert cfg["model"]["num_classes"] == cfg["num_classes"]
        assert mix["loop"] == "closed"
        assert set(limits) == set(harness.compare.NUMBERS)
        for traced in (False, True):
            assert harness.cell_metrics(bench, cell["name"], traced)


def test_every_metric_reader_declares_its_entry(bench):
    for kind, run in (("end_to_end", "untraced"), ("per_layer", "traced")):
        for entry in bench[kind]:
            reader = harness.load_metric(ROOT, bench, entry["name"])
            assert (reader.UNIT, reader.SOURCE, reader.RUN) == (
                entry["unit"], entry["source"], run)
            if kind == "per_layer":
                assert (reader.LAYER, reader.MOVES) == (entry["layer"],
                                                        entry["moves"])


def test_benchmark_file_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1].startswith("portbench/")
    assert 1 <= bench["run_seconds"] <= 51
    cells = {c["name"] for c in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    used = {c["config"] for c in bench["workloads"]}
    assert {c["name"] for c in bench["configs"]} == used
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(cfg["name"]) and TEXT.match(cfg["source"])
        assert cfg["file"].startswith("portbench/configs/")
        assert (ROOT / cfg["file"]).is_file()
        assert all(NAME.match(k) for k in cfg["reduced"])
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and TEXT.match(cell["why"])
    assert sum(c["chips"] == 4 for c in bench["workloads"]) <= max(
        1, len(cells) // 4)
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for cell in cells:        # setup_s, one more end-to-end, one per-layer
        assert len(harness.cell_metrics(bench, cell, False)) >= 2
        assert harness.cell_metrics(bench, cell, True)
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_new_config_mix_and_metric_are_found_by_name(tiny_root):
    """Add, as files and entries only: a configuration, a mix and a
    per-layer metric; one run of the new cell reports the metric."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs/tiny.json").read_text())
    cfg["graph_seed"] = 5
    (pb / "configs/tiny-other.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "mixes/tiny-fastsample.json").read_text())
    mix["batch"] = 24
    (pb / "mixes/tiny-b24.json").write_text(json.dumps(mix))
    (pb / "checks/tiny-other.b24.json").write_text(
        (pb / "checks/tiny.fastsample.json").read_text())
    (pb / "metrics/window_steps.py").write_text(
        '"""Steps in the measured window."""\n'
        'NAME = "window_steps"\nUNIT = "steps"\nLAYER = "end to end"\n'
        'SOURCE = "host_clock"\nRUN = "traced"\n'
        'MOVES = "train_seeds_per_device_s"\n\n\n'
        'def read(run):\n    return run.window_steps\n')
    bench["configs"].append(dict(bench["configs"][-1], name="tiny-other",
                                 file="portbench/configs/tiny-other.json"))
    bench["workloads"].append({"name": "tiny-other.b24",
                               "config": "tiny-other", "traffic": "tiny-b24",
                               "chips": 1, "why": "added by files"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "end to end",
                               "moves": "train_seeds_per_device_s",
                               "workloads": ["tiny-other.b24"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = harness.run("tiny-other.b24", 2 ** 31 + 77, 0.3, True,
                      root=tiny_root, device="cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"window_steps"}
    assert out["metrics"]["window_steps"]["value"] == out["attempted"] > 0
    assert list(out)[-1] == "checks"
    built = list((tiny_root / "build/portbench").iterdir())
    assert [p.name.split("-")[0] for p in built] == ["tiny"]
    assert not [p for p in built if p.name.startswith(".")]


# a GCN layer: relu(0.5 (h_dst + mean of the sampled neighbours) @ w_neigh
# + b), the port's ``conv="gcn"``; SCALE is the 0.5
GCN = '''"""GCN over the sampled message-flow graphs."""
import torch

from portbench import reference


def init_params(model, seed, device):
    dims = reference.layer_dims(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [{"w_neigh": torch.randn((a, b), generator=gen, device=device)
             * (2.0 / a) ** 0.5, "b": torch.zeros(b, device=device)}
            for a, b in zip(dims, dims[1:])]


def forward(params, levels, p, h0, model, gen, mm):
    L = model["num_layers"]
    h = h0
    for layer in range(L):
        edges = levels[L - 1 - layer].edges[p]
        S = edges.shape[0]
        x = SCALE(h[:S] + reference.neighbour_mean(h, edges))
        out = mm(x, params[layer]["w_neigh"]) + params[layer]["b"]
        if layer < L - 1:
            out = reference.dropout(torch.relu(out), model["dropout"], gen)
        h = out
    return h


def gemm_flops(model, step):
    L = model["num_layers"]
    dims = reference.layer_dims(model)
    fwd = igrad = 0.0
    for layer in range(L):
        rows = sum(w["dst"] for w in step["levels"][L - 1 - layer]["workers"])
        fwd += 2.0 * rows * dims[layer] * dims[layer + 1]
        igrad += 2.0 * rows * dims[layer] * dims[layer + 1] * (layer > 0)
    return {"forward": fwd, "weight_grad": fwd, "input_grad": igrad,
            "total": 2 * fwd + igrad}
'''


def add_cell(root, name: str, model: dict) -> str:
    """Add, as files and entries only, the configuration ``name``: the
    tiny one with ``model`` over its model, and its cell
    ``<name>.fastsample``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/tiny.json").read_text())
    cfg["model"] = dict(cfg["model"], **model)
    (pb / f"configs/{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}.fastsample"
    (pb / f"checks/{cell}.json").write_text(
        (pb / "checks/tiny.fastsample.json").read_text())
    bench["configs"].append(dict(bench["configs"][-1], name=name,
                                 file=f"portbench/configs/{name}.json"))
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "tiny-fastsample", "chips": 1,
                               "why": "added by files"})
    for entry in bench["per_layer"]:
        if "tiny.fastsample" in entry.get("workloads", []):
            entry["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("scale,correct", [("0.5 * ", True), ("", False)])
def test_a_second_conv_is_added_as_files(tiny_root, scale, correct):
    """A gcn model file, a configuration and a cell, added as files and
    entries only, run ``correct``; with the 0.5 of gcn's self-plus-mean
    dropped from the reference, not."""
    (tiny_root / "portbench/models/gcn.py").write_text(
        GCN.replace("SCALE(", f"{scale}("))
    cell = add_cell(tiny_root, "tiny-gcn", {"conv": "gcn"})
    out = harness.run(cell, 2 ** 31 + 41, 0.2, True, root=tiny_root,
                      device="cpu")
    assert out["correct"] is correct, out["checks"]
    assert out["metrics"]["train_mfu"]["value"] > 0


@pytest.mark.parametrize("model,error,names", [
    ({"conv": "gat"}, FileNotFoundError, "models/gat.py"),
    ({"gat_head": 8}, ValueError, "'gat_head'")])
def test_a_model_the_harness_cannot_build_fails_before_set_up(
        tiny_root, model, error, names):
    """A conv with no model file, or a model key that GNNConfig does not
    declare, is an error that names it, before any dataset is built; no
    other model stands in."""
    cell = add_cell(tiny_root, "tiny-bad", model)
    with pytest.raises(error, match=re.escape(names)):
        harness.run(cell, 5, 0.2, False, root=tiny_root, device="cpu")
    assert not (tiny_root / "build").exists()


@pytest.mark.parametrize("cell,rounds", [("tiny.fastsample", 2),
                                         ("tiny.vanilla", 6),
                                         ("tiny.cached", 2)])
def test_a_tiny_cell_runs_end_to_end(tiny_root, cell, rounds):
    out = harness.run(cell, 12345, 0.3, False, root=tiny_root, device="cpu")
    assert out["correct"] is True, out["checks"]
    # the card's rate needs a device trace, which a CPU run has not
    assert set(out["metrics"]) == {"setup_s"}
    assert out["metrics"]["setup_s"]["value"] > 0
    card = harness.load_metric(tiny_root, harness.load_bench(tiny_root),
                               "train_seeds_per_device_s")
    dev = [("a", 0, 10 ** 9), ("b", 5 * 10 ** 8, 2 * 10 ** 9)]
    assert card.read(SimpleNamespace(window_dev=dev, window_steps=2,
                                     seeds_per_step=100)) == 100
    assert out["attempted"] > 0 and out["failed"] == 0
    traced = harness.run(cell, 54321, 0.3, True, root=tiny_root,
                         device="cpu")
    assert traced["metrics"]["rounds_per_step"]["value"] == rounds
    assert traced["metrics"]["train_mfu"]["value"] > 0
    assert traced["metrics"]["window_seeds_per_s"]["value"] > 0
    hit_rate = traced["metrics"].get("cache_hit_rate", {}).get("value")
    assert (0 < hit_rate < 100) if cell == "tiny.cached" else hit_rate is None


def test_a_killed_build_leaves_nothing_to_load(tmp_path, monkeypatch):
    from portbench import dataset
    from portbench.conftest import make_tiny_root

    root = make_tiny_root(tmp_path / "c")
    cfg = root / "portbench/configs/tiny.json"
    cache = root / "build/portbench"

    def killed(name, array):
        if name.name.startswith("features"):
            raise KeyboardInterrupt
        return real(name, array)

    real = dataset.np.save
    monkeypatch.setattr(dataset.np, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        dataset.load_or_build(cfg, cache, 4, log=lambda *a: None)
    assert not [p for p in cache.iterdir() if not p.name.startswith(".")]
    monkeypatch.setattr(dataset.np, "save", real)
    data, built = dataset.load_or_build(cfg, cache, 4, log=lambda *a: None)
    assert built and data["features"].shape == (3000, 16)
    again, built = dataset.load_or_build(cfg, cache, 4, log=lambda *a: None)
    assert not built
    assert (again["assign"] == data["assign"]).all()
