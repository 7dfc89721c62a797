"""The two readers of the program's own spans on the card's idle gaps,
``seed_draw_idle_ms`` and ``step_python_idle_ms``, on hand-made labels."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.conftest import ROOT

MIX = {"label_steps": 2}


@pytest.fixture(scope="module")
def readers():
    bench = harness.load_bench(ROOT)
    return {name: harness.load_metric(ROOT, bench, name)
            for name in ("seed_draw_idle_ms", "step_python_idle_ms")}


def _run(labels):
    return SimpleNamespace(mix=MIX, trace={"idle_labels": labels})


def test_readers_split_the_program_spans_idle_time_a_step(readers):
    labels = {"seeds/draw": 0.12, "driver/step": 0.004, "step/sample": 0.002,
              "model/backward": 0.001, "driver/seeds": 0.0005,
              "aten::mm": 0.05, "portbench.step": 0.01, "python": 0.003}
    run = _run(labels)
    assert readers["seed_draw_idle_ms"].read(run) == pytest.approx(60.0)
    assert readers["step_python_idle_ms"].read(run) == pytest.approx(3.75)


def test_a_draw_that_left_no_gap_reads_zero(readers):
    run = _run({"driver/step": 0.002, "aten::mm": 0.05})
    assert readers["seed_draw_idle_ms"].read(run) == 0.0
    assert readers["step_python_idle_ms"].read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("trace", [None, {"idle_labels": {
    "portbench.seeds_host": 0.19, "portbench.step": 0.02, "aten::mm": 0.01}}],
    ids=["untraced", "no-program-ranges"])
def test_readers_report_nothing_without_program_spans(readers, trace):
    run = SimpleNamespace(mix=MIX, trace=trace)
    for reader in readers.values():
        assert reader.read(run) is None
