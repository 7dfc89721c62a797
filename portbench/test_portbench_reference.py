"""The plain reference against ``repro_torch`` on a tiny graph on the CPU:
the same seeds, the same message-flow graphs under both schemes' rules
(a hub past the fused sampler's window included), the same rows through
the exchange and through the pinned cache, the kernels' counts of cache
hits against the program's, and training steps within float32
rounding."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import compare, counts, dataset, harness, reference
from portbench.conftest import ROOT, TINY, TINY_CACHE, TINY_MODEL

HUB_IN, HUB_OUT = 2500, 600       # a node past the 2048-neighbour window


def hub_dataset(seed: int = 3) -> dict:
    """A tiny power-law dataset with one node of 2500 in-edges and 600
    out-edges, partitioned by the benchmark's LDG into 4."""
    indptr, indices, feats, labels = dataset.power_law_graph(
        TINY["num_nodes"], TINY["avg_degree"],
        num_features=TINY["num_features"], num_classes=TINY["num_classes"],
        labeled_fraction=TINY["labeled_fraction"], alpha=1.8, homophily=0.6,
        seed=seed)
    n = indptr.size - 1
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), np.diff(indptr))
    hub = 7
    extra_src = rng.integers(0, n, HUB_IN)
    extra_dst = rng.integers(0, n, HUB_OUT)
    src = np.concatenate([indices, extra_src, np.full(HUB_OUT, hub)])
    dst = np.concatenate([dst, np.full(HUB_IN, hub), extra_dst])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    indices = src[order].astype(np.int32)
    assign = dataset.ldg_assign(indptr, indices, 4, labels >= 0)
    return {"indptr": indptr, "indices": indices, "features": feats,
            "labels": labels, "assign": assign, "hub": hub}


def tiny_cfg(traffic: str):
    cfg = json.loads((ROOT / "portbench/configs/sage-products.json")
                     .read_text())
    cfg.update(TINY)
    cfg["model"] = dict(cfg["model"], **TINY_MODEL)
    mix = json.loads((ROOT / f"portbench/mixes/{traffic}.json").read_text())
    mix["batch"] = 32
    return cfg, mix


def sage():
    return reference.load_model(ROOT / "portbench/models", "sage")


def program(data, cfg, mix, seed):
    return harness.Program(data, cfg, mix, harness.seed_streams(seed), "cpu",
                           sage(), harness.gnn_config(cfg["model"]),
                           log=lambda *a: None)


@pytest.fixture(scope="module")
def data():
    return hub_dataset()


@pytest.mark.parametrize("traffic", ["fastsample", "vanilla", "cached"])
def test_seeds_and_mfgs_equal_the_port(data, traffic, one_thread):
    cfg, mix = tiny_cfg(traffic)
    prog = program(data, cfg, mix, 9)
    layout = reference.make_layout(data, 4, "cpu")
    prepare, _ = prog.pipe.make_prepare_consume(prog.loss_fn, counted=False,
                                                device="cpu")
    for salt in (0, 17, 2 ** 32 - 1):
        seeds = reference.draw_seeds(layout, mix["batch"], salt)
        np.testing.assert_array_equal(prog.pipe.seeds_host(mix["batch"],
                                                           salt), seeds)
        batch = prepare(prog.pipe.shards, torch.from_numpy(
            seeds.astype(np.int32)), salt, prog.pipe.cache)
        levels = reference.sample_step(layout, seeds, cfg["model"]["fanouts"],
                                       salt, mix["sample_window"])
        for mfg, lvl in zip(batch.mfgs, levels):
            assert torch.equal(mfg.src_nodes.long(), lvl.src)
            assert torch.equal(mfg.edges.long(), lvl.edges)
            assert torch.equal(mfg.dst_nodes.long(), lvl.dst)
        h = batch.h_src
        src = levels[-1].src
        ref_h = torch.where((src >= 0)[..., None], layout.features[
            layout.perm[src.clamp(min=0)]], 0.0)
        assert torch.equal(h, ref_h)


@pytest.mark.parametrize("capacity", ["all_remote", TINY_CACHE])
def test_cache_hit_rate_holds_the_programs_hits(data, capacity, one_thread):
    """``cache_hit_rate`` reads the hit share the program's driver reports
    a step; the kernels' counts of hits, over the benchmark's sampling and
    the program's cached rows, give the same shares (``check_hits``), and
    a different share ends the run.  Under ``all_remote`` every worker
    caches every node it does not own, so its hits are its remote
    frontier ids."""
    cfg, mix = tiny_cfg("cached")
    mix["cache_capacity"] = capacity
    prog = program(data, cfg, mix, 4)
    layout = reference.make_layout(data, 4, "cpu")
    ids = prog.pipe.cache.ids.long()
    steps, shares = [], []
    for k in range(3):
        prog.step()
        shares.append(float(prog.metrics["cache_hit_rate"]))
        salt = (harness.seed_streams(4)["base_salt"] + k) % 2 ** 32
        levels = reference.sample_step(
            layout, reference.draw_seeds(layout, mix["batch"], salt),
            cfg["model"]["fanouts"], salt, mix["sample_window"])
        steps.append(counts.summarize(levels, ids))
        src = levels[-1].src
        owner = torch.from_numpy(np.searchsorted(
            layout.offsets, src.clamp(min=0).numpy(), side="right") - 1)
        remote = ((src >= 0) & (owner != torch.arange(4)[:, None])).sum(-1)
        if capacity == "all_remote":
            assert steps[-1]["hits"] == remote.tolist()
        else:
            assert 0 < sum(steps[-1]["hits"]) < int(remote.sum())
    if capacity == "all_remote":
        n = layout.perm.numel()
        owned = np.diff(layout.offsets)
        assert ((ids < n).sum(-1).numpy() == n - owned).all()
    harness.check_hits(steps, shares)
    with pytest.raises(RuntimeError, match="cache hit share"):
        harness.check_hits(steps, [x + 1e-3 for x in shares])
    reader = harness.load_metric(ROOT, harness.load_bench(ROOT),
                                 "cache_hit_rate")
    read = reader.read(SimpleNamespace(trace={"hit_share": shares},
                                       mix=mix))
    assert read == pytest.approx(100.0 * np.mean(shares)) and 0 < read < 100


def test_the_window_rule_is_the_fused_samplers(data, one_thread):
    """Past the window the fused sampler draws from the first 2048
    in-neighbours, the windowless one from all; the reference follows
    each."""
    from repro_torch.core import sampler
    from repro_torch.kernels import ops

    cfg, mix = tiny_cfg("fastsample")
    prog = program(data, cfg, mix, 1)
    layout = reference.make_layout(data, 4, "cpu")
    hub_new = int(layout.old_to_new[data["hub"]])
    frontier = torch.tensor([[hub_new, 3, -1, 11]] * 4)
    graph = prog.pipe.layout.graph
    fused = ops.fused_sample_level(graph, frontier.int(), 5, 99)
    plain = sampler.sample_level(graph, frontier.int(), 5, 99)
    win = reference.sample_level(layout, frontier, 5, 99, 2048)
    free = reference.sample_level(layout, frontier, 5, 99, None)
    assert torch.equal(fused.edges.long(), win.edges)
    assert torch.equal(fused.src_nodes.long(), win.src)
    assert torch.equal(plain.edges.long(), free.edges)
    assert torch.equal(plain.src_nodes.long(), free.src)
    assert not torch.equal(win.src, free.src)


@pytest.mark.parametrize("traffic", ["fastsample", "vanilla", "cached"])
def test_training_steps_agree_within_rounding(data, traffic, one_thread):
    cfg, mix = tiny_cfg(traffic)
    streams = harness.seed_streams(2 ** 31 + 5)
    prog = program(data, cfg, mix, 2 ** 31 + 5)
    got = prog.checked_steps()
    ref = reference.train(data, sage(), cfg["model"], cfg["optimizer"], mix,
                          streams["weights"], streams["base_salt"],
                          streams["dropout"], device="cpu")
    read = compare.readings(got, ref)
    assert max(read.values()) < 1e-5, read
    assert len(ref["losses"]) == 3 and all(ref["grad_norms"].values())
