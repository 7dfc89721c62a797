"""The fleet executors of the port (``multiprocess``, ``shard_map``) and
their launcher, on the CPU over gloo.

* Launcher units (``repro_torch.launch.multihost``), mirroring
  ``tests/test_multihost.py``: their ranks do not import torch.
* ``build_layout(local_parts=)`` against ``repro``'s, every field.
* One real 2-rank fleet, launched once for the module: the collectives
  (``exchange``, ``pmean_ordered``, ``psum_ordered``) against their
  stacked versions, and the matrix {vanilla, hybrid,
  hybrid_partial(0.25)} x prefetch depth {0, 2} x seed staging {off, on},
  3 steps each, against the stacked executor.
* ``train_gnn`` as a fleet, ``multiprocess`` and ``shard_map``, with a
  merged trace.

The rule the fleet's floats are held to: every executor, the stacked
one included, takes each worker's own gradient (one backward a worker)
and averages them over all P workers in worker order (``repro``'s rule),
so a worker's forward and backward do not depend on how the workers are
split.  So:

  * integers (MFGs, fetched rows, rounds and their bytes), step 0's loss
    and step 0's gradients are bit for bit the stacked run's;
  * the 3-step losses, the parameters after the first step and after the
    last are bit for bit the stacked run's;
  * every fleet cell gives the same losses and parameters bit for bit,
    on both ranks, across drivers, staging and schemes (the schemes draw
    the same neighbours here), as the stacked runs do.

Every fleet launch has its own timeout, well under the suite's.
"""
import json
import os
import socket
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
FLEET_TIMEOUT = 110.0          # seconds, per fleet launch
P = 2
STEPS = 3
LR = 0.01
SCHEMES = ("vanilla", "hybrid", "hybrid_partial(0.25)")
CELLS = [(s, d, st) for s in SCHEMES for d in (0, 2) for st in (0, 1)]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


# --------------------------------------------------------------------------
# launcher units (the ranks import no torch)
# --------------------------------------------------------------------------

def test_pick_port_is_bindable():
    port = multihost.pick_port()
    assert 0 < port < 65536
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_rank_env_wiring():
    base = {"PATH": "/usr/bin"}
    env = multihost.rank_env(base, rank=1, num_procs=4, port=12345,
                             device="cpu")
    assert env[multihost.ENV_RANK] == "1"
    assert env[multihost.ENV_NUM_PROCS] == "4"
    assert env[multihost.ENV_ADDRESS] == "127.0.0.1:12345"
    assert env[multihost.ENV_DEVICE] == "cpu"
    assert env["PATH"] == "/usr/bin"
    assert base == {"PATH": "/usr/bin"}          # input not mutated
    assert multihost.is_worker(env)
    assert not multihost.is_worker(base)


def test_launch_validates_num_procs():
    with pytest.raises(ValueError, match="num_procs"):
        multihost.launch([sys.executable, "-c", "pass"], num_procs=0)


def test_launch_success_captures_per_rank_logs(tmp_path):
    script = ("import os; "
              f"print('rank', os.environ['{multihost.ENV_RANK}'], 'of', "
              f"os.environ['{multihost.ENV_NUM_PROCS}'])")
    log_dir = multihost.launch([sys.executable, "-c", script], num_procs=2,
                               timeout=60, log_dir=str(tmp_path))
    assert log_dir == str(tmp_path)
    for r in range(2):
        assert f"rank {r} of 2" in (tmp_path / f"rank{r}.out").read_text()


def test_worker_failure_kills_fleet_and_reports(tmp_path):
    """Rank 1 crashes: the launcher kills the healthy rank, which would
    otherwise sleep out its wait, and raises with rank 1's stderr."""
    script = textwrap.dedent(f"""
        import os, sys, time
        if os.environ["{multihost.ENV_RANK}"] == "1":
            print("boom from rank 1", file=sys.stderr)
            sys.exit(3)
        time.sleep(300)
    """)
    t0 = time.monotonic()
    with pytest.raises(multihost.WorkerFailure) as ei:
        multihost.launch([sys.executable, "-c", script], num_procs=2,
                         timeout=100, log_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60        # killed, not timed out
    assert ei.value.rank == 1
    assert ei.value.returncode == 3
    assert "boom from rank 1" in ei.value.stderr_tail
    assert "boom from rank 1" in str(ei.value)


def test_hang_detection_times_out(tmp_path):
    with pytest.raises(TimeoutError, match="exceeded"):
        multihost.launch([sys.executable, "-c",
                          "import time; time.sleep(120)"], num_procs=2,
                         timeout=2, log_dir=str(tmp_path))


# --------------------------------------------------------------------------
# the rank-local layout against repro's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_parts", [2, 4])
def test_build_layout_local_parts_matches_repro(num_parts):
    from repro.core.partition import build_layout as j_build
    from repro.core.partition import partition_graph as j_partition
    from repro.data.synthetic_graph import make_power_law_graph as j_graph
    from repro_torch.core.partition import build_layout as t_build
    from repro_torch.data.synthetic_graph import make_power_law_graph

    ds = make_power_law_graph(600, 6, num_features=8, num_classes=4,
                              seed=0)
    jds = j_graph(600, 6, num_features=8, num_classes=4, seed=0)
    assign = j_partition(jds.graph, num_parts, jds.labeled_mask, seed=0)
    per = num_parts // 2
    for lo, hi in ((0, per), (per, num_parts), (0, num_parts)):
        j = j_build(jds.graph, jds.features, jds.labels, assign, num_parts,
                    local_parts=(lo, hi))
        t = t_build(ds.graph, ds.features, ds.labels, np.asarray(assign),
                    num_parts, local_parts=(lo, hi))
        assert t.local_parts == j.local_parts == (lo, hi)
        for name in ("offsets", "features", "labels", "node_valid"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                err_msg=name)
        np.testing.assert_array_equal(t.perm, j.perm)
        np.testing.assert_array_equal(t.graph.indptr.numpy(),
                                      np.asarray(j.graph.indptr))
        np.testing.assert_array_equal(t.graph.indices.numpy(),
                                      np.asarray(j.graph.indices))
        # the other ranks' partitions are zero rows
        off = t.offsets.numpy()
        for p in range(num_parts):
            if not lo <= p < hi:
                assert not t.features[p].any()
            else:
                assert t.features[p, :off[p + 1] - off[p]].abs().sum() > 0
    for bad in ((1, 1), (-1, 1), (0, num_parts + 1)):
        with pytest.raises(ValueError, match="out of range"):
            t_build(ds.graph, ds.features, ds.labels, np.asarray(assign),
                    num_parts, local_parts=bad)


# --------------------------------------------------------------------------
# one real 2-rank fleet: the collectives and the matrix
# --------------------------------------------------------------------------

COMMON = textwrap.dedent("""
    import numpy as np
    import torch
    from repro_torch.data.synthetic_graph import make_power_law_graph
    from repro_torch.models.gnn import GNNConfig, gnn_loss, params_from_numpy
    from repro_torch.optim import init_opt_state
    from repro_torch.pipeline import Pipeline
    from repro_torch.pipeline.specs import (PipelineSpec, PlanSpec,
                                            PrefetchSpec, SamplerSpec)

    P, STEPS, LR, BATCH = 2, 3, 0.01, 8
    ds = make_power_law_graph(600, 6, num_features=8, num_classes=4,
                              seed=0)
    cfg = GNNConfig(in_dim=8, hidden_dim=8, num_classes=4, num_layers=2,
                    fanouts=(3, 3), dropout=0.0)

    def loss_fn(p, mfgs, h, y, v):
        return gnn_loss(p, mfgs, h, y, v, cfg)

    def spec(scheme, depth, staging, executor):
        return PipelineSpec(
            plan=PlanSpec(num_parts=P, scheme=scheme),
            sampler=SamplerSpec(fanouts=cfg.fanouts, backend="reference"),
            executor=executor,
            prefetch=PrefetchSpec(depth=depth, staging=bool(staging)))

    def flat(params):
        return np.concatenate([v.detach().cpu().numpy().ravel()
                               for layer in params
                               for _, v in sorted(layer.items())])

    def run(pipe, params0, out, key):
        params = params_from_numpy(params0, "cpu")
        opt = init_opt_state(params, kind="adamw")
        losses = []
        with pipe.train_driver(loss_fn, batch=BATCH, lr=LR,
                               device="cpu") as driver:
            for k in range(STEPS):
                params, opt, loss, _ = driver.step(params, opt, k)
                losses.append(float(loss))
                if k == 0:
                    out[key + "|params1"] = flat(params)
        out[key + "|losses"] = np.asarray(losses, np.float64)
        out[key + "|params"] = flat(params)
        out[key + "|kinds"] = np.asarray(pipe.counter.kinds)
        out[key + "|bytes"] = np.asarray(pipe.counter.bytes_per_round)

    def first_step(pipe, params0, out, key):
        # step 0's MFGs, fetched rows and gradients
        params = params_from_numpy(params0, "cpu")
        seeds = pipe.seeds(BATCH, 0)
        prepare, _ = pipe.make_prepare_consume(loss_fn, counted=False,
                                               device="cpu")
        b = prepare(pipe.shards, seeds, 0, pipe.cache)
        for i, m in enumerate(b.mfgs):
            for f in ("dst_nodes", "src_nodes", "num_src", "edges",
                      "edge_mask", "indptr"):
                out[f"{key}|mfg{i}.{f}"] = getattr(m, f).numpy()
        out[key + "|h_src"] = b.h_src.numpy()
        loss, grads, _ = pipe.step_fn(loss_fn, device="cpu")(params, seeds,
                                                           0)
        out[key + "|loss0"] = np.asarray(float(loss), np.float64)
        out[key + "|grads0"] = flat(grads)
""")

FLEET_WORKER = COMMON + textwrap.dedent("""
    import os
    from repro_torch.core import dist
    from repro_torch.core.partition import build_layout, partition_graph
    from repro_torch.launch import multihost

    rank, num_procs, _ = multihost.init_from_env()
    per = P // num_procs
    group = dist.rank_group(P)
    out = {}

    # the collectives on seeded inputs (every rank draws all rows and
    # keeps its own)
    # keeps its own), at P = 2 and at P = 4 (two workers a rank)
    for nw in (2, 4):
        g = dist.rank_group(nw)
        rng = np.random.default_rng(nw)
        full_i = torch.from_numpy(rng.integers(-1, 1000, (nw, nw, 7),
                                               np.int32))
        full_f = torch.from_numpy(rng.standard_normal((nw, nw, 5, 3),
                                                      np.float32))
        red = torch.from_numpy(rng.standard_normal((nw, 4, 3), np.float32))
        red_i = torch.from_numpy(rng.integers(0, 99, (nw,), np.int64))
        rows = slice(g.lo, g.hi)
        ctr = dist.RoundCounter()
        out[f"{nw}|ex_int"] = dist.exchange(full_i[rows], ctr, "feature",
                                            group=g).numpy()
        out[f"{nw}|ex_float"] = dist.exchange(full_f[rows], ctr, "sampling",
                                              group=g).numpy()
        out[f"{nw}|ex_bytes"] = np.asarray(ctr.bytes_per_round)
        out[f"{nw}|pmean"] = dist.pmean_ordered(red[rows], g).numpy()
        out[f"{nw}|psum"] = dist.psum_ordered(red[rows], g).numpy()
        out[f"{nw}|psum_int"] = dist.psum_ordered(red_i[rows], g).numpy()
        out[f"{nw}|gathered"] = dist.all_workers(red[rows], g).numpy()

    params0 = [dict(layer) for layer in np.load(
        os.environ["FLEET_PARAMS"], allow_pickle=True)["params"]]
    assign = partition_graph(ds.graph, P, ds.labeled_mask, seed=0)
    layout = build_layout(ds.graph, ds.features, ds.labels, assign, P,
                          local_parts=(rank * per, (rank + 1) * per))
    for scheme in ("vanilla", "hybrid", "hybrid_partial(0.25)"):
        for depth in (0, 2):
            for staging in (0, 1):
                key = f"{scheme}|{depth}|{staging}"
                pipe = Pipeline.from_layout(
                    layout, spec(scheme, depth, staging, "multiprocess"),
                    device="cpu")
                run(pipe, params0, out, key)
        first_step(pipe, params0, out, scheme)
    # rank 1 derives another partition (two nodes swap owners): the
    # build refuses it on every rank
    alt = assign.copy()
    if rank == 1:
        a, b = np.flatnonzero(alt == 0)[0], np.flatnonzero(alt == 1)[0]
        alt[a], alt[b] = 1, 0
    try:
        Pipeline.from_layout(build_layout(
            ds.graph, ds.features, ds.labels, alt, P,
            local_parts=(rank * per, (rank + 1) * per)),
            spec("hybrid", 0, 0, "multiprocess"), device="cpu")
        out["partition_refusal"] = np.asarray("")
    except RuntimeError as e:
        out["partition_refusal"] = np.asarray(str(e))
    # two workers a rank: vanilla's rounds through the 2 x 2 exchange
    assign4 = partition_graph(ds.graph, 4, ds.labeled_mask, seed=0)
    layout4 = build_layout(ds.graph, ds.features, ds.labels, assign4, 4,
                           local_parts=(2 * rank, 2 * rank + 2))
    P = 4
    first_step(Pipeline.from_layout(
        layout4, spec("vanilla", 0, 0, "multiprocess"), device="cpu"),
        params0, out, "P4")
    np.savez(os.path.join(os.environ["FLEET_OUT"], f"rank{rank}.npz"),
             **out)
    torch.distributed.destroy_process_group()
""")


def _stacked_reference(params0):
    """The same matrix on the stacked executor, in this process."""
    ns: dict = {}
    exec(COMMON, ns)
    from repro_torch.core.partition import build_layout, partition_graph
    ds = ns["ds"]
    assign = partition_graph(ds.graph, P, ds.labeled_mask, seed=0)
    layout = build_layout(ds.graph, ds.features, ds.labels, assign, P)
    out = {}
    for scheme, depth, staging in CELLS:
        pipe = ns["Pipeline"].from_layout(
            layout, ns["spec"](scheme, depth, staging, "vmap"),
            device="cpu")
        ns["run"](pipe, params0, out, f"{scheme}|{depth}|{staging}")
        if (depth, staging) == (2, 1):
            ns["first_step"](pipe, params0, out, scheme)
    assign4 = partition_graph(ds.graph, 4, ds.labeled_mask, seed=0)
    layout4 = build_layout(ds.graph, ds.features, ds.labels, assign4, 4)
    ns["P"] = 4
    ns["first_step"](ns["Pipeline"].from_layout(
        layout4, ns["spec"]("vanilla", 0, 0, "vmap"), device="cpu"),
        params0, out, "P4")
    return out, layout


def _repro_params():
    """``repro``'s initial parameters for the matrix's model, as numpy."""
    import jax
    from repro.models.gnn import GNNConfig, init_gnn_params
    cfg = GNNConfig(in_dim=8, hidden_dim=8, num_classes=4, num_layers=2,
                    fanouts=(3, 3), dropout=0.0)
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in init_gnn_params(jax.random.key(0), cfg)]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Launch the 2-rank fleet once; returns (per-rank outputs, stacked
    outputs, stacked layout, initial params)."""
    tmp = tmp_path_factory.mktemp("fleet")
    params0 = _repro_params()
    params_path = str(tmp / "params.npz")
    arr = np.empty(len(params0), object)
    arr[:] = params0
    np.savez(params_path, params=arr)
    multihost.launch([sys.executable, "-c", FLEET_WORKER], num_procs=P,
                     device="cpu", timeout=FLEET_TIMEOUT,
                     log_dir=str(tmp / "logs"),
                     env=_env(FLEET_OUT=str(tmp), FLEET_PARAMS=params_path,
                              OMP_NUM_THREADS="2"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(P)]
    stacked, layout = _stacked_reference(params0)
    return ranks, stacked, layout, params0


@pytest.mark.parametrize("nw", [2, 4], ids=["1_worker_a_rank",
                                         "2_workers_a_rank"])
def test_fleet_collectives_equal_stacked(fleet, nw):
    from repro_torch.core import dist
    ranks = fleet[0]
    rng = np.random.default_rng(nw)
    full_i = torch.from_numpy(rng.integers(-1, 1000, (nw, nw, 7), np.int32))
    full_f = torch.from_numpy(rng.standard_normal((nw, nw, 5, 3),
                                                  np.float32))
    red = torch.from_numpy(rng.standard_normal((nw, 4, 3), np.float32))
    red_i = torch.from_numpy(rng.integers(0, 99, (nw,), np.int64))
    ctr = dist.RoundCounter()
    ex_i = dist.exchange(full_i, ctr, "feature").numpy()
    ex_f = dist.exchange(full_f, ctr, "sampling").numpy()
    per = nw // P
    for r, out in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_array_equal(out[f"{nw}|ex_int"], ex_i[rows])
        np.testing.assert_array_equal(out[f"{nw}|ex_float"], ex_f[rows])
        np.testing.assert_array_equal(out[f"{nw}|ex_bytes"],
                                      ctr.bytes_per_round)
        # bit for bit, on every rank
        for key, want in (("pmean", dist.pmean_ordered(red)),
                          ("psum", dist.psum_ordered(red)),
                          ("psum_int", dist.psum_ordered(red_i)),
                          ("gathered", red)):
            np.testing.assert_array_equal(out[f"{nw}|{key}"], want.numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("scheme", SCHEMES + ("P4",))
def test_fleet_prepare_equals_stacked_rows(fleet, scheme):
    """Step 0's MFGs and fetched rows: each rank's are the stacked run's
    rows of its workers, bit for bit, under every scheme, and under
    vanilla with two workers a rank (``P4``); its loss and its gradients
    are the stacked ones bit for bit."""
    ranks, stacked = fleet[0], fleet[1]
    keys = [k for k in stacked if k.startswith(scheme + "|mfg")
            or k == scheme + "|h_src"]
    assert len(keys) == 2 * 6 + 1
    for r, out in enumerate(ranks):
        per = stacked[scheme + "|h_src"].shape[0] // P
        for k in keys:
            np.testing.assert_array_equal(
                out[k], stacked[k][r * per:(r + 1) * per],
                err_msg=f"rank {r} {k}")
        assert out[scheme + "|loss0"] == stacked[scheme + "|loss0"]
        np.testing.assert_array_equal(out[scheme + "|grads0"],
                                      stacked[scheme + "|grads0"],
                                      err_msg=scheme)


def test_fleet_matrix_against_stacked(fleet):
    ranks, stacked = fleet[0], fleet[1]
    for scheme, depth, staging in CELLS:
        key = f"{scheme}|{depth}|{staging}"
        want_rounds = 2 if scheme == "hybrid" else 4
        for out in ranks:
            # rounds and their per-worker bytes: the stacked program's
            np.testing.assert_array_equal(out[key + "|kinds"],
                                          stacked[key + "|kinds"])
            np.testing.assert_array_equal(out[key + "|bytes"],
                                          stacked[key + "|bytes"])
            assert out[key + "|kinds"].size == STEPS * want_rounds
            # the losses and the parameters after the first and the last
            # step: bit for bit
            for what in ("losses", "params1", "params"):
                np.testing.assert_array_equal(out[f"{key}|{what}"],
                                              stacked[f"{key}|{what}"],
                                              err_msg=f"{key} {what}")


def test_fleet_cells_agree_bit_for_bit(fleet):
    """Every cell of the fleet gives the same losses and parameters, on
    both ranks: drivers, staging and schemes change nothing."""
    ranks = fleet[0]
    ref = ranks[0]["vanilla|0|0|losses"], ranks[0]["vanilla|0|0|params"]
    for scheme, depth, staging in CELLS:
        key = f"{scheme}|{depth}|{staging}"
        for out in ranks:
            np.testing.assert_array_equal(out[key + "|losses"], ref[0],
                                          err_msg=key)
            np.testing.assert_array_equal(out[key + "|params"], ref[1],
                                          err_msg=key)


def test_fleet_cell_against_repro_vmap(fleet):
    """The hybrid cell's losses against ``repro``'s vmap executor (jitted,
    in this process) from the same parameters: rtol 1e-4, as the stacked
    port is held in ``tests/test_torch_train.py``."""
    import jax
    from repro.core.partition import build_layout, partition_graph
    from repro.data.synthetic_graph import make_power_law_graph
    from repro.models.gnn import GNNConfig, gnn_loss
    from repro.optim import init_opt_state
    from repro.pipeline import (Pipeline, PipelineSpec, PlanSpec,
                                PrefetchSpec, SamplerSpec)
    ranks, params0 = fleet[0], fleet[3]
    ds = make_power_law_graph(600, 6, num_features=8, num_classes=4,
                              seed=0)
    assign = partition_graph(ds.graph, P, ds.labeled_mask, seed=0)
    layout = build_layout(ds.graph, ds.features, ds.labels, assign, P)
    cfg = GNNConfig(in_dim=8, hidden_dim=8, num_classes=4, num_layers=2,
                    fanouts=(3, 3), dropout=0.0)
    spec = PipelineSpec(plan=PlanSpec(num_parts=P, scheme="hybrid"),
                        sampler=SamplerSpec(fanouts=cfg.fanouts,
                                            backend="reference"),
                        executor="vmap", prefetch=PrefetchSpec(depth=0))
    pipe = Pipeline.from_layout(layout, spec)
    driver = pipe.train_driver(
        lambda p, m, h, y, v: gnn_loss(p, m, h, y, v, cfg), batch=8, lr=LR)
    params = [{k: jax.numpy.asarray(v) for k, v in layer.items()}
              for layer in params0]
    opt = init_opt_state(params, kind="adamw")
    losses = []
    for k in range(STEPS):
        params, opt, loss, _ = driver.step(params, opt, k)
        losses.append(float(loss))
    for out in ranks:
        np.testing.assert_allclose(out["hybrid|0|0|losses"], losses,
                                   rtol=1e-4)


def test_fleet_layout_refusals(fleet):
    """A rank-local layout is refused by the stacked executor, by a fleet
    rank whose workers it does not cover, by a cache and by the staged
    store."""
    from repro_torch.core import partition
    from repro_torch.pipeline import Pipeline
    from repro_torch.pipeline.specs import (PipelineSpec, PlanSpec,
                                            PrefetchSpec, SamplerSpec)
    layout = fleet[2]
    local = partition.PartitionLayout(**{
        **{f: getattr(layout, f) for f in
           ("graph", "offsets", "perm", "features", "labels", "node_valid",
            "num_parts", "offsets_host", "labels_host")},
        "local_parts": (0, 1)})
    sampler = SamplerSpec(fanouts=(3, 3), backend="reference")
    with pytest.raises(ValueError, match="rank-local"):
        Pipeline.from_layout(local, PipelineSpec(
            plan=PlanSpec(num_parts=P), sampler=sampler), device="cpu")
    with pytest.raises(ValueError, match="rank-local build"):
        Pipeline.build(layout.graph, np.zeros((600, 8), np.float32),
                       np.zeros(600, np.int32), PipelineSpec(
                           plan=PlanSpec(num_parts=P, cache_capacity=8),
                           sampler=sampler, executor="multiprocess"),
                       local_parts=(0, 1), device="cpu")
    with pytest.raises(ValueError, match="never materializes"):
        Pipeline.from_layout(local, PipelineSpec(
            plan=PlanSpec(num_parts=P, feature_store="staged"),
            sampler=sampler, executor="multiprocess",
            prefetch=PrefetchSpec(depth=1)), device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        Pipeline.from_layout(layout, PipelineSpec(
            plan=PlanSpec(num_parts=P), sampler=sampler,
            executor="multiprocess"), device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        PipelineSpec(plan=PlanSpec(num_parts=P), sampler=sampler,
                     executor="pmap")


def test_fleet_refuses_ranks_that_partition_differently(fleet):
    """Each rank partitions the graph itself; when two ranks derive
    different assignments, ``Pipeline.from_layout`` raises on every rank
    instead of mixing other workers' rows into the rounds."""
    for r, out in enumerate(fleet[0]):
        msg = str(out["partition_refusal"])
        assert "the ranks disagree on the partition" in msg, (r, msg)


# --------------------------------------------------------------------------
# train_gnn as a fleet
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--executor", "multiprocess", "--num-procs", "2", "--devices", "4"],
    ["--executor", "shard_map", "--devices", "2"],
], ids=["multiprocess", "shard_map"])
def test_train_gnn_fleet_with_merged_trace(argv, tmp_path):
    import subprocess

    from repro_torch.obs.trace import validate_trace
    trace = str(tmp_path / "t.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.train_gnn",
           "--device", "cpu", "--nodes", "1500", "--epochs", "1",
           "--steps-per-epoch", "2", "--batch", "16", "--mh-timeout",
           str(FLEET_TIMEOUT), "--trace", trace, *argv]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=FLEET_TIMEOUT + 10,
                          env=_env(OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "2 comm rounds/step" in out
    assert "run complete" in out and "merged fleet trace" in out
    with open(trace) as f:
        merged = json.load(f)
    assert validate_trace(merged) > 0
    names = {ev.get("args", {}).get("name") for ev in merged["traceEvents"]
             if ev.get("name") == "process_name"}
    assert {"rank0", "rank1"} <= names
    spans = {ev["name"] for ev in merged["traceEvents"]
             if ev.get("ph") == "X"}
    assert {"driver/step", "comm/all_to_all", "comm/all_gather"} <= spans
