"""The port's examples (``examples/*_torch.py``), each run on the CPU at
a small size through its ``main``, with the original's asserts inside:
the quickstart's sampled accuracy above 0.3; the distributed example's
rounds (2L for vanilla, 2 for the hybrid variants) and identical loss
trajectories across vanilla, hybrid, hybrid+fused and the cache; the
end-to-end trainer's falling loss and checkpoint round trip.  Without
``--device`` every example asks for the GPU, so here it refuses.
"""
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' steps are many small ops: under the suite's parallel
    workers, torch's intra-op threads oversubscribe the cores and slow
    them tenfold, so each test runs them on one thread."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_learns():
    acc = _load("quickstart_torch").main(["--device", "cpu"],
                                         num_nodes=6000, epochs=3,
                                         batch=256)
    assert acc > 0.3


def test_distributed_hybrid_schemes_identical():
    results = _load("distributed_hybrid_torch").main(
        ["--device", "cpu"], num_nodes=4000, batch=32)
    assert list(results) == ["vanilla", "hybrid", "hybrid+fused",
                             "hybrid+cache"]
    first = results["vanilla"]
    assert len(first) == 6
    for name, losses in results.items():
        assert losses == first, name


@pytest.mark.parametrize("extra", [[], ["--scheme", "vanilla",
                                        "--cache-capacity", "64"]],
                         ids=["hybrid+fused", "vanilla+cache"])
def test_e2e_trains_and_restores(tmp_path, extra):
    ckpt = tmp_path / "e2e.npz"
    out = _load("train_gnn_e2e_torch").main(
        ["--device", "cpu", "--steps", "6", "--feature-dim", "64",
         "--hidden", "128", "--batch", "32", "--ckpt", str(ckpt), *extra])
    assert ckpt.is_file()
    assert out["last"] < out["first"]


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "distributed_hybrid_torch",
                                  "train_gnn_e2e_torch"])
def test_examples_default_to_the_gpu(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
