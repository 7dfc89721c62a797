"""The ``sage_epilogue_roofline`` reader on a hand-built traced run: its
byte count, its device time, and nothing read from a program without the
kernels."""
from types import SimpleNamespace

import pytest

from portbench import harness, h100
from portbench.conftest import ROOT

MODEL = {"hidden_dim": 256, "dropout": 0.5}
FWD = ("void (anonymous namespace)::sage_epilogue_kernel<4, true>"
       "(float const*, float const*, float const*, float const*, long long,"
       " int, float, float, float*)")
BWD = ("void (anonymous namespace)::sage_epilogue_backward_kernel<4>"
       "(float const*, float const*, long long, long long, int, int, float,"
       " float*, float*)")


@pytest.fixture(scope="module")
def reader():
    return harness.load_metric(ROOT, harness.load_bench(ROOT),
                               "sage_epilogue_roofline")


def _step(P=4, sizes=(1000, 16000, 176000)):
    return {"P": P, "levels": [{"S": S, "F": F, "workers": [{}] * P}
                               for S, F in zip(sizes, (15, 10, 5))]}


def test_tail_bytes_count_each_hidden_layers_arrays_once(reader):
    # levels but the top: 16 000 and 176 000 rows a worker, 4 workers;
    # 4 arrays forward with the uniforms, 3 backward, 4 bytes, 256 wide;
    # the bias read or its gradient written once a launch
    want = 7 * (16000 + 176000) * 4 * 256 * 4 + 2 * 2 * 4 * 256 * 4
    assert reader.tail_bytes(MODEL, _step()) == want
    no_drop = dict(MODEL, dropout=0.0)
    assert reader.tail_bytes(no_drop, _step()) == \
        want - (16000 + 176000) * 4 * 256 * 4
    assert reader.tail_bytes(MODEL, _step(P=1, sizes=(10, 20))) == \
        7 * 20 * 256 * 4 + 2 * 256 * 4


def test_reads_the_share_of_the_kernels_device_time(reader):
    steps = [_step(), _step()]
    # one step's 8 launches of each kernel, 1 ms and 0.5 ms apiece
    dev = ([(FWD, 0, 1_000_000)] * 16 + [(BWD, 0, 500_000)] * 16
           + [("at::native::vectorized_elementwise_kernel", 0, 10 ** 9)])
    run = SimpleNamespace(model=MODEL, trace_counts=steps, trace={
        "dev": dev, "launches": {"sage_epilogue": 16,
                                 "sage_epilogue_backward": 16}})
    nbytes = 2 * reader.tail_bytes(MODEL, _step())
    assert reader.read(run) == pytest.approx(
        100.0 * nbytes / h100.HBM_BYTES_PER_S / 0.024)
    # a record the tracer dropped: the kept ones' mean stands for it
    run.trace["dev"] = dev[1:]
    assert reader.read(run) == pytest.approx(
        100.0 * nbytes / h100.HBM_BYTES_PER_S / 0.024)


@pytest.mark.parametrize("trace", [None, {"dev": [], "launches": {
    "fused_sample": 3, "sage_aggregate": 12}}],
    ids=["untraced", "program-without-the-kernels"])
def test_reports_nothing_without_the_kernels(reader, trace):
    run = SimpleNamespace(model=MODEL, trace_counts=[_step()], trace=trace)
    assert reader.read(run) is None
