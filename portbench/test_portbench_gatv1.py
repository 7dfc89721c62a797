"""The ``gatv1`` model file and the ``gat_attention_roofline`` reader, at a
size a test run holds, on the CPU:

* a tiny ``gatv1`` cell, added as files and entries, runs ``correct``
  under the ``gat-products.fastsample`` cell's limits; the TF32 control
  and each of the reference's faults (half the batch, the exchange left
  out, a shifted draw), put in the program's place, are not correct by
  them;
* the reader's least bytes and the model file's GEMM operations equal
  hand counts on a small structure; the reader reads nothing from a
  program without the kernels.
"""
import json
from types import SimpleNamespace

import pytest

from portbench import compare, dataset, harness, reference
from portbench.conftest import ROOT, make_tiny_root

CELL = "tiny-gatv1.fastsample"
LIMITS = json.loads((ROOT / "portbench/checks/gat-products.fastsample.json")
                    .read_text())["limits"]
MODEL = {"conv": "gatv1", "gat_heads": 4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout with the tiny configuration's gatv1 twin
    ``tiny-gatv1`` and its cell ``tiny-gatv1.fastsample``, checked by the
    ``gat-products`` cell's limits."""
    root = make_tiny_root(tmp_path_factory.mktemp("gatv1") / "checkout")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/tiny.json").read_text())
    cfg["model"] = dict(cfg["model"], **MODEL)
    (pb / "configs/tiny-gatv1.json").write_text(json.dumps(cfg))
    (pb / f"checks/{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    bench["configs"].append(dict(bench["configs"][-1], name="tiny-gatv1",
                                 file="portbench/configs/tiny-gatv1.json"))
    bench["workloads"].append({"name": CELL, "config": "tiny-gatv1",
                               "traffic": "tiny-fastsample", "chips": 1,
                               "why": "a CPU test's cell"})
    for entry in bench["per_layer"]:
        if "gat-products.fastsample" in entry.get("workloads", []):
            entry["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cfg


def test_a_tiny_gatv1_cell_is_correct(tiny, one_thread):
    root, _ = tiny
    out = harness.run(CELL, 2 ** 31 + 61, 0.2, True, root=root,
                      device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["train_mfu"]["value"] > 0
    # the card's kernels do not run on the CPU: nothing to read
    assert "gat_attention_roofline" not in out["metrics"]


def test_the_control_and_the_faults_are_not_correct(tiny, one_thread):
    root, cfg = tiny
    bench = harness.load_bench(root)
    mix = harness.load_mix(root, bench, "tiny-fastsample")
    data, _ = dataset.load_or_build(root / "portbench/configs/tiny-gatv1.json",
                                    root / "build/portbench", 4,
                                    log=lambda *a: None)
    net = reference.load_model(root / "portbench/models", "gatv1")
    s = harness.seed_streams(2 ** 31 + 7)
    args = (data, net, cfg["model"], cfg["optimizer"], mix, s["weights"],
            s["base_salt"], s["dropout"])
    ref = reference.train(*args)
    planted = {"control": reference.train(*args, precision="tf32")}
    for fault in reference.FAULTS:
        planted[fault] = reference.train(*args, fault=fault)
    for name, run in planted.items():
        correct, table = compare.judge(compare.readings(run, ref), LIMITS)
        assert not correct, (name, table)


def _step():
    """Two levels (top first), two workers; the top's S = 3, F = 2.  A
    level's valid sources are the next level's destinations (the top's:
    7 and 5, of which 3 and 2 are its destinations) and, below the
    bottom, the frontier (14 and 11)."""
    return {"P": 2, "frontier": [14, 11], "levels": [
        {"S": 3, "F": 2, "workers": [
            {"dst": 3, "edges": 5, "refs": 5, "with_edges": 3},
            {"dst": 2, "edges": 3, "refs": 3, "with_edges": 2}]},
        {"S": 9, "F": 2, "workers": [
            {"dst": 7, "edges": 12, "refs": 10, "with_edges": 7},
            {"dst": 5, "edges": 9, "refs": 8, "with_edges": 5}]}]}


MODEL2 = {"conv": "gatv1", "in_dim": 6, "hidden_dim": 8, "num_classes": 3,
          "num_layers": 2, "fanouts": [2, 2], "dropout": 0.5, "gat_heads": 2}


def test_the_attention_bytes_are_a_hand_count():
    reader = harness.load_metric(ROOT, harness.load_bench(ROOT),
                                 "gat_attention_roofline")
    # layer 0 (bottom level, S 9, F 2): rows of 2 x 4 floats (32 B);
    # layer 1 (top level, S 3, F 2): rows of 2 x 3 floats (24 B); per
    # worker (valid sources, valid destinations)
    want = 0
    for row, S, F, workers in ((32, 9, 2, ((14, 7), (11, 5))),
                               (24, 3, 2, ((7, 3), (5, 2)))):
        for src, dst in workers:
            inputs = src * row + S * F * 4 + 2 * row
            want += inputs + dst * row                        # forward
            want += dst * row + inputs + src * row + 2 * row
    assert reader.attention_bytes(MODEL2, _step()) == want
    run = SimpleNamespace(trace={"dev": [], "launches": {}}, model=MODEL2,
                          trace_counts=[_step()])
    assert reader.read(run) is None


def test_the_gemm_operations_are_a_hand_count():
    net = reference.load_model(ROOT / "portbench/models", "gatv1")
    # layer 0: 6 -> 2 heads x 4 (skip 6 -> 8); layer 1: 8 -> 2 heads x 3
    # (skip 8 -> 3); per worker: each valid source projected once
    fwd = igrad = 0.0
    for layer, (d_in, hc, d_out, workers) in enumerate((
            (6, 8, 8, ((14, 7), (11, 5))), (8, 6, 3, ((7, 3), (5, 2))))):
        for src, dst in workers:
            per = (2 * src * d_in * hc + 2 * dst * d_in * d_out
                   + 2 * hc * (src + dst))
            fwd += per
            igrad += per if layer else 0
    got = net.gemm_flops(MODEL2, _step())
    assert got == {"forward": fwd, "weight_grad": fwd, "input_grad": igrad,
                   "total": 2 * fwd + igrad}
