"""The operation and byte counters against hand counts at tiny shapes, and
the trace arithmetic on made-up records."""
import pytest
import torch

from portbench import counts, devtrace, h100, reference
from portbench.conftest import ROOT
from portbench.reference import Level

# two workers, capacity 2 seeds, fanout 2; worker 1 has one padding seed
TOP = Level(dst=torch.tensor([[5, 9], [3, -1]]),
            edges=torch.tensor([[[2, 3], [0, -1]], [[1, 2], [-1, -1]]]),
            src=torch.tensor([[5, 9, 7, 8, -1, -1], [3, -1, 4, 6, -1, -1]]))
# below it, fanout 1 over the 6-wide frontier
LOW = Level(dst=TOP.src,
            edges=torch.tensor([[[1], [0], [-1], [-1], [-1], [-1]],
                                [[2], [-1], [-1], [-1], [-1], [-1]]]),
            src=torch.tensor([[5, 9, 7, 8, -1, -1, 2, -1, -1, -1, -1, -1],
                              [3, -1, 4, 6, -1, -1, -1, -1, -1, -1, -1, -1]]))
ONE_LAYER = {"num_layers": 1, "in_dim": 4, "hidden_dim": 8,
             "num_classes": 3}
TWO_LAYERS = {"num_layers": 2, "in_dim": 4, "hidden_dim": 8,
              "num_classes": 3}


def t(nbytes, ops=0.0):
    return max(nbytes / h100.HBM_BYTES_PER_S, ops / h100.FP32_FLOP_PER_S)


def test_summary_counts_by_hand():
    s = counts.summarize([TOP])
    assert s["P"] == 2 and s["N"] == 6
    assert s["levels"][0]["S"] == 2 and s["levels"][0]["F"] == 2
    assert s["levels"][0]["workers"] == [
        {"dst": 2, "edges": 3, "refs": 3, "with_edges": 2},
        {"dst": 1, "edges": 2, "refs": 2, "with_edges": 1}]
    assert s["fetched"] == 7                   # {5, 9, 7, 8} and {3, 4, 6}
    assert s["frontier"] == [4, 3] and s["hits"] == [0, 0]


def test_cache_hits_and_misses_by_hand():
    # worker 0 caches 7 (and 100, not sampled), worker 1 caches 3 and 6
    # (and 9, which only worker 0 sampled)
    cache = [torch.tensor([7, 100]), torch.tensor([3, 6, 9])]
    s = counts.summarize([TOP], cache)
    assert s["frontier"] == [4, 3] and s["hits"] == [1, 2]
    assert s["fetched"] == 4                   # misses {5, 9, 8} and {4}
    # ids 2 x 12 x 4, the 4 missed rows of 16 B, the (2, 12, 4) reply
    assert counts.feature_gather_bound(s, 4) == pytest.approx(t(544))
    # slot ids 2 x 6 x 4, the 3 hit rows, the (2, 6, 4) output
    assert counts.gather_rows_bound(s, 4) == pytest.approx(t(288))


def test_gemm_flops_by_hand():
    gemm_flops = reference.load_model(ROOT / "portbench/models",
                                      "sage").gemm_flops
    one = gemm_flops(ONE_LAYER, counts.summarize([TOP]))
    # 3 valid destinations, two 4 x 3 products, 2 flops a multiply-add
    assert one == {"forward": 144.0, "weight_grad": 144.0,
                   "input_grad": 0.0, "total": 288.0}
    two = gemm_flops(TWO_LAYERS, counts.summarize([TOP, LOW]))
    # layer 1 eats LOW: 4 + 3 valid destinations, 4 -> 8; layer 2 eats TOP:
    # 3 valid destinations, 8 -> 3, and has an input gradient
    first, second = 4 * 7 * 4 * 8, 4 * 3 * 8 * 3
    assert two["forward"] == two["weight_grad"] == first + second
    assert two["input_grad"] == second


def test_kernel_bounds_by_hand():
    s = counts.summarize([TOP])
    # seeds 16 B, row pointers 3 x 8, neighbour ids 5 x 4, samples 32,
    # row pointer 24, overflow 8; 14 operations a drawn slot
    assert counts.fused_sample_bound(s) == pytest.approx(t(124, 70))
    # ids 2 x 12 x 4, 7 distinct rows of 16 B, the (2, 12, 4) reply
    assert counts.feature_gather_bound(s, 4) == pytest.approx(t(592))
    fwd, bwd = counts.sage_aggregate_bounds(ONE_LAYER, s)
    assert fwd == pytest.approx(t(96, 20) + t(80, 16)) and bwd == 0.0
    fwd2, bwd2 = counts.sage_aggregate_bounds(
        TWO_LAYERS, counts.summarize([TOP, LOW]))
    # backward of the second layer (over TOP, N = 6 rows of 8): row
    # pointer 28, a slot an edge, a gradient row and divisor a destination
    # with an edge, the (6, 8) gradient written
    assert bwd2 == pytest.approx(t(28 + 12 + 2 * 36 + 192, 48)
                                 + t(28 + 8 + 36 + 192, 32))
    assert fwd2 > fwd


def test_trace_arithmetic_on_made_up_records():
    dev = [("void (anonymous namespace)::fused_sample_kernel<4>(int*)", 10,
            20),
           ("sage_aggregate_kernel<5, float4>", 15, 30),
           ("Memcpy HtoD", 50, 60),
           ("void (anonymous namespace)::fused_sample_kernel<4>(int*)", 70,
            75)]
    merged = devtrace.busy_intervals(dev)
    assert merged == [[10, 30], [50, 60], [70, 75]]
    assert devtrace.idle_gaps(merged, 0, 100) == [(0, 10), (30, 50),
                                                  (60, 70), (75, 100)]
    host = [("portbench.step", 0, 100), ("portbench.seeds_host", 28, 52),
            ("aten::sort", 29, 31)]
    labels = devtrace.label_gaps(devtrace.idle_gaps(merged, 0, 100), host)
    assert labels == pytest.approx({"portbench.step": 45e-9,
                                    "portbench.seeds_host": 20e-9})
    assert devtrace.short_name(dev[0][0]) == "fused_sample_kernel"
    assert devtrace.device_by_name(dev)["fused_sample_kernel"] == \
        pytest.approx(15e-9)
    # all launches kept, one dropped (the mean stands in), none kept
    assert devtrace.kernel_seconds(dev, ("fused_sample_kernel",), 2) == \
        pytest.approx(15e-9)
    assert devtrace.kernel_seconds(dev, ("fused_sample_kernel",), 3) == \
        pytest.approx(22.5e-9)
    assert devtrace.kernel_seconds(dev, ("feature_gather_kernel",), 1) \
        is None
