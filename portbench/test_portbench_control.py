"""The check that decides ``correct`` fails its control and the faults a
training cell can have, at a size a test run holds, on the CPU.

* The control: the reference put in the program's place in TF32 (here
  its operands rounded to TF32's mantissa; on the card the measured
  control switches TF32 on), judged against the float32 reference by each
  cell's limits.
* The faults, planted in the program under a tiny cell's whole run: a
  step that returns its state unchanged; half of each worker's batch left
  out of the loss, the mean taken over the rest; the exchange between the
  workers left out; a sampled neighbour altered where the sampler draws
  it; and in the cell with a cache, the cached rows served as zeros, or
  from the next slot of the cache, where ``gather_rows`` serves them.
  The ``cached`` cell's cache holds every remote row, so its exchange
  carries no row between workers and cannot lose one.
"""
import json

import pytest
import torch

from portbench import compare, harness, reference
from portbench.conftest import ROOT, make_tiny_root

# every cell with limits, those of cells kept out of BENCHMARK.json too
CELLS = sorted(p.stem for p in (ROOT / "portbench/checks").glob("*.json"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("control") / "checkout")
    bench = harness.load_bench(root)
    cfg = json.loads(harness.config_path(root, bench, "tiny").read_text())
    from portbench import dataset
    data, _ = dataset.load_or_build(root / "portbench/configs/tiny.json",
                                    root / "build/portbench", 4,
                                    log=lambda *a: None)
    net = reference.load_model(root / "portbench/models",
                               cfg["model"]["conv"])
    return root, bench, cfg, data, net


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(tiny, cell, one_thread):
    root, bench, cfg, data, net = tiny
    mix = harness.load_mix(root, bench, "tiny-" + cell.split(".")[1])
    limits = json.loads((ROOT / f"portbench/checks/{cell}.json")
                        .read_text())["limits"]
    for seed in (11, 2 ** 31 + 3, 2 ** 33 + 1):
        s = harness.seed_streams(seed)
        args = (data, net, cfg["model"], cfg["optimizer"], mix,
                s["weights"], s["base_salt"], s["dropout"])
        ref = reference.train(*args)
        control = reference.train(*args, precision="tf32")
        correct, table = compare.judge(compare.readings(control, ref),
                                       limits)
        assert not correct, table


def _shifted(draw):
    def draw_columns(v, deg, fanout, salt):
        col, valid = draw(v, deg, fanout, salt)
        return torch.remainder(col + 1, deg.clamp(min=1)[..., None]), valid
    return draw_columns


def plant(monkeypatch, fault):
    from repro_torch.core import dist, feature_store, sampler
    from repro_torch.kernels import fused_sample
    from repro_torch.models import gnn
    from repro_torch.pipeline import prefetch

    if fault == "unchanged":
        step = prefetch.SyncDriver.step

        def unchanged(self, params, opt_state, step_idx=None):
            _, _, loss, metrics = step(self, params, opt_state, step_idx)
            return params, opt_state, loss, metrics
        monkeypatch.setattr(prefetch.SyncDriver, "step", unchanged)
    elif fault == "half_batch":
        loss = gnn.gnn_loss

        def half(params, mfgs, h0, labels, valid, cfg, **kw):
            valid = valid.clone()
            valid[..., valid.shape[-1] // 2:] = False
            return loss(params, mfgs, h0, labels, valid, cfg, **kw)
        monkeypatch.setattr(gnn, "gnn_loss", half)
    elif fault == "no_exchange":
        monkeypatch.setattr(dist, "exchange",
                            lambda buf, counter, kind="other", group=None:
                            buf)
    elif fault == "shifted_draw":
        for mod in (sampler, dist, fused_sample):
            monkeypatch.setattr(mod, "draw_columns",
                                _shifted(sampler.draw_columns))
    elif fault == "cache_rows_zeroed":
        monkeypatch.setattr(
            feature_store, "gather_rows", lambda rows, pos: torch.zeros(
                (*pos.shape, rows.shape[-1]), dtype=rows.dtype,
                device=rows.device))
    elif fault == "cache_slot_shifted":
        gather = feature_store.gather_rows

        def next_slot(rows, pos):
            return gather(rows, torch.where(
                pos >= 0, (pos + 1) % rows.shape[1], pos).to(pos.dtype))
        monkeypatch.setattr(feature_store, "gather_rows", next_slot)
    else:
        raise ValueError(fault)


CORE_FAULTS = ("unchanged", "half_batch", "no_exchange", "shifted_draw")
CACHE_FAULTS = ("unchanged", "half_batch", "shifted_draw",
                "cache_rows_zeroed", "cache_slot_shifted")


@pytest.mark.parametrize("fault,traffic", [
    pytest.param(fault, traffic, id=f"{fault}-{traffic}")
    for fault in dict.fromkeys(CORE_FAULTS + CACHE_FAULTS)
    for traffic in ("fastsample", "vanilla", "cached")
    if fault in (CACHE_FAULTS if traffic == "cached" else CORE_FAULTS)])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault,
                                        traffic, one_thread):
    root = make_tiny_root(tmp_path / "checkout")
    plant(monkeypatch, fault)
    out = harness.run(f"tiny.{traffic}", 2 ** 31 + 99, 0.2, False,
                      root=root, device="cpu")
    assert out["correct"] is False, out["checks"]
