"""The pod-scale dry-run of the port (``repro_torch.launch.dryrun_gnn``)
against ``repro``'s (``repro.launch.dryrun_gnn``), on the CPU.

``repro``'s dry-run compiles the per-worker step under ``shard_map`` over
256 placeholder host devices in a fresh process; the port's traces rank 0
of a 256-rank fake-backend job on fake tensors, in this process.  Both run
at 500 nodes a worker and 128 seeds, both schemes.  Held equal: the
rounds (all, sampling, feature, expected), the all-to-all count, and the
collective bytes a device: ``repro`` counts each collective's result
shape, and its all-gathers hold the gradient and the loss (XLA drops the
metrics' gathers as dead code), so the port's all-to-all bytes plus its
gradient and loss gathers equal ``repro``'s total exactly.  The peak is
an estimate on both sides (XLA's buffer assignment, ``MemTracker``): held
within 10 %.
"""
import json
import sys

import pytest

from repro_torch.launch import dryrun_gnn

ARGS = ("--workers", "256", "--scheme", "both", "--nodes-per-worker", "500",
        "--batch", "128")
SCHEMES = ("vanilla", "hybrid")
# repro's collective bytes a device at ARGS: all-to-all + (gradient, loss)
REPRO_BYTES = {"hybrid": 17_855_152_128 + 292_205_568,
               "vanilla": 18_016_632_832 + 292_205_568}


@pytest.fixture(scope="module")
def repro_records(subproc, tmp_path_factory):
    out = tmp_path_factory.mktemp("repro_dryrun")
    subproc.run([sys.executable, "-m", "repro.launch.dryrun_gnn", *ARGS,
                 "--out", str(out)], timeout=300)
    return {s: json.loads((out / f"gnn__{s}__w256.json").read_text())
            for s in SCHEMES}


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_dryrun")
    records = dryrun_gnn.main([*ARGS, "--out", str(out)])
    assert [r["scheme"] for r in records] == list(SCHEMES)
    for r in records:
        written = json.loads(
            (out / f"gnn__{r['scheme']}__w256.json").read_text())
        assert written == r
    return {r["scheme"]: r for r in records}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_rounds_match_repro(repro_records, port_records, scheme):
    j, t = repro_records[scheme], port_records[scheme]
    for key in ("rounds_traced", "sampling_rounds_traced",
                "feature_rounds_traced", "expected_rounds"):
        assert t[key] == j[key], key
    assert t["rounds_traced"] == (2 if scheme == "hybrid" else 6)
    assert t["sampling_rounds_traced"] == (0 if scheme == "hybrid" else 4)
    assert len(t["bytes_per_round"]) == t["rounds_traced"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_record_keys_and_collective_counts(repro_records, port_records,
                                           scheme):
    j, t = repro_records[scheme], port_records[scheme]
    assert set(j) <= set(t)
    for key in ("workload", "scheme", "workers", "partitioner", "executor",
                "prefetch_depth", "status"):
        assert t[key] == j[key], key
    assert t["tensors"] == "fake (cpu, plain versions)"
    assert set(t["collective_counts"]) == set(j["collective_counts"])
    assert (t["collective_counts"]["all-to-all"]
            == j["collective_counts"]["all-to-all"])
    # the port gathers one concatenated gradient, the loss and 5 metrics
    assert t["collective_counts"]["all-gather"] == 7
    for kind in ("all-reduce", "reduce-scatter", "collective-permute"):
        assert t["collective_counts"][kind] == 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_collective_bytes_match_repro(repro_records, port_records, scheme):
    j, t = repro_records[scheme], port_records[scheme]
    by_what = t["collective_bytes_by_what"]
    a2a = t["collective_bytes_by_kind"]["all-to-all"]
    assert a2a == sum(t["bytes_per_round"])
    grads_loss = by_what["all-gather/grads"] + by_what["all-gather/loss"]
    assert a2a + grads_loss == j["collective_bytes_per_device"] \
        == REPRO_BYTES[scheme]
    assert t["collective_bytes_per_device"] == (
        a2a + grads_loss + by_what["all-gather/metrics"])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_peak_within_a_tenth_of_repro(repro_records, port_records, scheme):
    j, t = repro_records[scheme], port_records[scheme]
    assert abs(t["peak_estimate_bytes"] / j["peak_estimate_bytes"] - 1) \
        < 0.10


def test_512_workers_double_every_round(port_records, tmp_path):
    rec, = dryrun_gnn.main(["--workers", "512", "--scheme", "hybrid",
                            "--nodes-per-worker", "500", "--batch", "128",
                            "--out", str(tmp_path)])
    at256 = port_records["hybrid"]
    assert rec["workers"] == 512
    assert rec["rounds_traced"] == 2 and rec["sampling_rounds_traced"] == 0
    assert rec["bytes_per_round"] == [2 * b for b in
                                      at256["bytes_per_round"]]


def test_refuses_an_unknown_partitioner(tmp_path):
    with pytest.raises(KeyError, match="nope"):
        dryrun_gnn.main(["--partitioner", "nope", "--out", str(tmp_path)])
