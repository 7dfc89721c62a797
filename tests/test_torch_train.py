"""The training slice as a whole: ``repro``'s hybrid+fused training step
against the port's, on the CPU.

``repro``'s side runs ``hybrid+fused`` with ``fused_backend="reference"``
(its Pallas sampler needs ``pl.load``, which the installed JAX lacks;
every degree here lies inside the fused kernel's window, where the two
are bit-identical), jitted under ``jax.vmap``.  Both packages start from
``repro``'s parameters (carried across by ``params_from_numpy``) with
dropout 0.

Tolerances (fp32; XLA and torch order their matmul and reduction sums
differently; both packages average the per-worker gradients in worker
order):

  * one step's loss: rtol 1e-5; gradients: rtol 1e-4 with atol 1e-6
    (entries near zero carry the absolute rounding of sums over O(100)
    rows);
  * optimizer updates fed identical gradients: rtol 1e-6, atol 1e-7
    (the same elementwise formulas; only ``pow`` and ``sqrt`` may round
    differently);
  * a 3-step loss trajectory through the drivers: rtol 1e-4.  AdamW's
    first step moves every parameter by about lr whatever its gradient's
    size, so a near-zero gradient whose sign differs between XLA and
    torch moves a parameter by 2 lr; the losses stay close, the
    parameters need not, so the trajectory compares losses only.
"""
import contextlib
import dataclasses
import io
import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.mfg import MFG as JMFG
from repro.data.spec import DataSpec as JDataSpec
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_accuracy as j_accuracy
from repro.models.gnn import gnn_loss as j_loss
from repro.models.gnn import init_gnn_params as j_init
from repro.obs.trace import validate_trace as j_validate
from repro.optim import optimizers as jopt
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineSpec as JSpec
from repro.train import checkpoint as jckpt
from repro.train.loop import GNNTrainer as JTrainer
from repro_torch.data.spec import DataSpec as TDataSpec
from repro_torch.launch import train_gnn as t_launch
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.obs import trace as t_trace
from repro_torch.obs.trace import validate_trace as t_validate
from repro_torch.models.gnn import (apply_layer, gnn_accuracy, gnn_loss,
                                    params_from_numpy, params_to_numpy)
from repro_torch.optim import optimizers as topt
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.pipeline import PipelineSpec as TSpec
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.loop import GNNTrainer as TTrainer

DATA = dict(source="powerlaw(1.8)", num_nodes=800, avg_degree=6,
            num_features=12, num_classes=4, seed=3)
FANOUTS = (4, 3)
K = 64
BATCH = 16
LR = 0.006


def _cfgs():
    kw = dict(in_dim=12, hidden_dim=32, num_classes=4, num_layers=2,
              fanouts=FANOUTS, dropout=0.0)
    return JConfig(**kw), TConfig(**kw)


def _loss_fns():
    jcfg, tcfg = _cfgs()
    return (lambda p, m, h, lab, v: j_loss(p, m, h, lab, v, jcfg),
            lambda p, m, h, lab, v: gnn_loss(p, m, h, lab, v, tcfg))


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def pair(request):
    """(P, {store: (repro pipeline, port pipeline)}, repro params, port
    params) for the ``pinned_hot`` and ``exchange`` stores over one
    cache of K entries per worker."""
    P = request.param
    pipes = {}
    for store in ("pinned_hot", "exchange"):
        jspec = JSpec.from_scheme(
            "hybrid+fused", num_parts=P, fanouts=FANOUTS,
            fused_backend="reference", cache_capacity=K, feature_store=store,
            data=JDataSpec(**DATA))
        tspec = TSpec.from_scheme(
            "hybrid+fused", num_parts=P, fanouts=FANOUTS, cache_capacity=K,
            feature_store=store, data=TDataSpec(**DATA))
        if not pipes:
            jp = JPipeline.build_from_source(spec=jspec)
            tp = TPipeline.build_from_source(spec=tspec, device="cpu")
        else:
            first_j, first_t = pipes["pinned_hot"]
            jp = JPipeline.from_layout(first_j.layout, jspec)
            tp = TPipeline.from_layout(first_t.layout, tspec, device="cpu")
        pipes[store] = (jp, tp)
    jcfg, _ = _cfgs()
    jparams = j_init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        "cpu")
    return P, pipes, jparams, tparams


def _assert_close_trees(t_tree, j_tree, rtol, atol):
    for tl, jl in zip(params_to_numpy(t_tree),
                      [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in j_tree]):
        assert tl.keys() == jl.keys()
        for k in tl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("store", ["pinned_hot", "exchange"])
@pytest.mark.parametrize("salt", [0, 9])
def test_one_step_loss_and_grads_match_repro(pair, store, salt):
    P, pipes, jparams, tparams = pair
    jp, tp = pipes[store]
    jloss_fn, tloss_fn = _loss_fns()
    seeds = tp.seeds_host(BATCH, salt)
    jl, jg, jm = jax.jit(jp.step_fn(jloss_fn))(jparams, jnp.asarray(seeds),
                                               jnp.uint32(salt))
    tl, tg, tm = tp.step_fn(tloss_fn, device="cpu")(
        tparams, torch.from_numpy(seeds), salt)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_close_trees(tg, jg, rtol=1e-4, atol=1e-6)
    assert set(tm) == {"cache_hit_rate", "sampling_utilized_bytes",
                       "feature_utilized_bytes", "sampler_window_overflow",
                       "sampler_window_overflow_per_level"}
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, err_msg=k)
    assert float(tm["cache_hit_rate"]) > 0


def test_step_has_two_feature_rounds(pair):
    P, pipes, _, tparams = pair
    _, tp = pipes["pinned_hot"]
    _, tloss_fn = _loss_fns()
    before = list(tp.counter.kinds)
    tp.step_fn(tloss_fn, device="cpu")(tparams, tp.seeds(BATCH, 1), 1)
    assert tp.counter.kinds[len(before):] == ["feature", "feature"]
    assert tp.expected_rounds == 2


def test_pinned_hot_and_exchange_steps_bit_identical(pair):
    P, pipes, _, tparams = pair
    _, tloss_fn = _loss_fns()
    out = {}
    for store, (_, tp) in pipes.items():
        out[store] = tp.step_fn(tloss_fn, device="cpu")(
            tparams, tp.seeds(BATCH, 4), 4)
    (la, ga, _), (lb, gb, _) = out["pinned_hot"], out["exchange"]
    assert torch.equal(la, lb)
    for a, b in zip(topt.tree_leaves(ga), topt.tree_leaves(gb)):
        assert torch.equal(a, b)


def test_three_step_loss_trajectory_matches_repro(pair):
    P, pipes, jparams, tparams = pair
    jp, tp = pipes["pinned_hot"]
    jloss_fn, tloss_fn = _loss_fns()
    jd = jp.train_driver(jloss_fn, batch=BATCH, lr=LR)
    td = tp.train_driver(tloss_fn, batch=BATCH, lr=LR, device="cpu")
    jpar, jst = jparams, jopt.init_opt_state(jparams)
    tpar, tst = tparams, topt.init_opt_state(tparams)
    jlosses, tlosses = [], []
    for _ in range(3):
        jpar, jst, jl, _ = jd.step(jpar, jst)
        tpar, tst, tl, tm = td.step(tpar, tst)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    jd.close()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert int(tst.step) == 3 and "grad_norm" in tm


def test_accuracy_matches_repro(pair):
    P, pipes, jparams, tparams = pair
    jp, tp = pipes["pinned_hot"]
    jcfg, tcfg = _cfgs()
    seeds = tp.seeds_host(BATCH, 2)
    prepare, _ = tp.make_prepare_consume(None, counted=False, device="cpu")
    b = prepare(tp.shards, torch.from_numpy(seeds), 2, tp.cache)
    acc = gnn_accuracy(tparams, list(b.mfgs), b.h_src, b.seed_labels,
                       b.seed_valid, tcfg)
    assert acc.shape == (P,)
    for p in range(P):
        mfgs = [JMFG(**{f.name: jnp.asarray(getattr(m, f.name)[p].numpy())
                        for f in dataclasses.fields(m)}) for m in b.mfgs]
        ja = j_accuracy(jparams, mfgs, jnp.asarray(b.h_src[p].numpy()),
                        jnp.asarray(b.seed_labels[p].numpy()),
                        jnp.asarray(b.seed_valid[p].numpy()), jcfg)
        np.testing.assert_allclose(float(acc[p]), float(ja), rtol=1e-6)


# --------------------------------------------------------------------------
# optimizers, fed identical gradients
# --------------------------------------------------------------------------

def _grad_trees(rng, shapes):
    g = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32)
          for k, s in shapes.items()}]
    g[0]["b"][0] = 1e-12                 # near-zero: +-1 in AdamW step 1
    return ([{k: jnp.asarray(v) for k, v in g[0].items()}],
            [{k: torch.from_numpy(v.copy()) for k, v in g[0].items()}])


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizers_match_repro_on_identical_grads(kind, clip):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jp = [{k: jnp.asarray(v) for k, v in p0.items()}]
    tp = [{k: torch.from_numpy(v.copy()) for k, v in p0.items()}]
    js = jopt.init_opt_state(jp, kind=kind)
    ts = topt.init_opt_state(tp, kind=kind)
    for _ in range(3):
        jg, tg = _grad_trees(rng, shapes)
        if clip is not None:
            jg, jn = jopt.clip_by_global_norm(jg, clip)
            tg, tn = topt.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, js = jopt.apply_updates(jp, jg, js, kind=kind, lr=LR)
        tp, ts = topt.apply_updates(tp, tg, ts, kind=kind, lr=LR)
        _assert_close_trees(tp, jp, rtol=1e-6, atol=1e-7)
        for tm, jm in ((ts.mu, js.mu), (ts.nu, js.nu)):
            _assert_close_trees(tm, jm, rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


def test_global_norm_matches_repro():
    rng = np.random.default_rng(3)
    tree = [{"a": rng.standard_normal((4, 4)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}]
    j = jopt.global_norm([{k: jnp.asarray(v) for k, v in tree[0].items()}])
    t = topt.global_norm([{k: torch.from_numpy(v) for k, v in
                           tree[0].items()}])
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_restores_in_the_other_package(pair, tmp_path, writer):
    _, _, jparams, tparams = pair
    jtree = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    ttree = {"params": tparams, "opt": topt.init_opt_state(tparams)}
    path = str(tmp_path / "ckpt.npz")
    if writer == "repro":
        jckpt.save_checkpoint(path, jtree, step=7)
        got, step = tckpt.restore_checkpoint(path, ttree)
        _assert_close_trees(got["params"], jparams, rtol=0, atol=0)
        assert isinstance(got["opt"], topt.OptState)
    else:
        tckpt.save_checkpoint(path, ttree, step=7)
        got, step = jckpt.restore_checkpoint(path, jtree)
        _assert_close_trees(tparams, got["params"], rtol=0, atol=0)
    assert step == 7
    with np.load(path) as f:
        assert "params/0/w_self" in f.files and "opt/.mu/1/b" in f.files


def test_checkpoint_refuses_a_dtype_cast(tmp_path):
    path = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(path, {"m": torch.zeros(3)})
    with pytest.raises(ValueError, match="refusing to cast"):
        tckpt.restore_checkpoint(path, {"m": torch.zeros(3,
                                                         dtype=torch.int32)})
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_checkpoint(path, {"__step__": torch.zeros(1)})


# --------------------------------------------------------------------------
# trainer, launcher, dropout
# --------------------------------------------------------------------------

def test_trainer_epoch_matches_repro_trainer(pair):
    """``GNNTrainer`` on the ``hybrid`` scheme (``repro``'s trainer builds
    its fused scheme on the Pallas sampler, so ``hybrid`` is the scheme
    both can run here) with the exchange store and a cache."""
    P, pipes, jparams, tparams = pair
    layout_j, layout_t = pipes["exchange"][0].layout, \
        pipes["exchange"][1].layout
    jcfg, tcfg = _cfgs()
    jt = JTrainer(layout=layout_j, cfg=jcfg, scheme="hybrid",
                  batch_per_worker=BATCH, cache_capacity=K)
    tt = TTrainer(layout=layout_t, cfg=tcfg, scheme="hybrid",
                  batch_per_worker=BATCH, cache_capacity=K, device="cpu")
    jt.params, jt.opt_state = jparams, jopt.init_opt_state(jparams)
    tt.params, tt.opt_state = tparams, topt.init_opt_state(tparams)
    jr = jt.run_epoch(0, steps_per_epoch=2)
    tr = tt.run_epoch(0, steps_per_epoch=2)
    jt.close()
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-4)
    np.testing.assert_allclose(tr["cache_hit_rate"], jr["cache_hit_rate"],
                               rtol=1e-6)
    assert tr["comm_rounds_per_step"] == jr["comm_rounds_per_step"] == 2
    logits = tt.predictor(buckets=(8,)).predict([0, 5, 9])
    assert logits.shape == (3, tcfg.num_classes)
    assert np.isfinite(logits).all()


def test_trainer_refuses_prefetch_and_the_driver_double_buffer(pair):
    """Once a refusal, now the contract that replaced it: the trainer at
    ``prefetch_depth=1`` and the ``double_buffer`` driver give the
    synchronous run's losses and parameters bit for bit."""
    _, pipes, _, tparams = pair
    _, tp = pipes["exchange"]
    _, tcfg = _cfgs()
    _, tloss_fn = _loss_fns()
    runs = {}
    for depth in (0, 1):
        with TTrainer(layout=tp.layout, cfg=tcfg, batch_per_worker=BATCH,
                      prefetch_depth=depth, device="cpu") as tt:
            tt.params, tt.opt_state = tparams, topt.init_opt_state(tparams)
            runs[depth] = (tt.run_epoch(0, steps_per_epoch=3), tt.params)
            assert tt.driver.mode == ("sync", "double_buffer")[depth]
    assert runs[1][0]["loss"] == runs[0][0]["loss"]
    assert runs[1][0]["final_loss"] == runs[0][0]["final_loss"]
    assert runs[1][0]["comm_rounds_per_step"] == 2
    for a, b in zip(topt.tree_leaves(runs[1][1]),
                    topt.tree_leaves(runs[0][1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="depth >= 1"):
        tp.train_driver(tloss_fn, batch=BATCH, mode="double_buffer",
                        device="cpu")
def test_launcher_trains_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_launch.main(["--device", "cpu", "--nodes", "800", "--devices",
                       "4", "--feature-store", "pinned_hot",
                       "--cache-capacity", "64", "--epochs", "1",
                       "--steps-per-epoch", "2", "--batch", "16"])
    text = out.getvalue()
    assert "2 comm rounds/step (0 sampling + 2 feature" in text
    assert "epoch 0: loss" in text and "cache-hit" in text


@pytest.mark.parametrize("flags,rounds", [
    (["--prefetch-depth", "1"], 2), (["--staging"], 2),
    (["--cache-policy", "frequency", "--cache-capacity", "64"], 2),
    (["--feature-store", "staged", "--prefetch-depth", "1"], 0)],
    ids=["prefetch-depth", "staging", "cache-policy-frequency",
         "feature-store-staged"])
def test_launcher_runs_the_overlap_and_cache_flags(flags, rounds):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_launch.main(["--device", "cpu", "--nodes", "800", "--devices",
                       "4", "--epochs", "1", "--steps-per-epoch", "2",
                       "--batch", "16", *flags])
    text = out.getvalue()
    assert f"{rounds} comm rounds/step (0 sampling + {rounds} feature" \
        in text
    assert "epoch 0: loss" in text and f"rounds/step {rounds} " in text


@pytest.mark.parametrize("flags,rounds", [
    (["--executor", "vmap"], "2 comm rounds/step (0 sampling + 2 feature"),
    (["--executor", "stacked"],
     "2 comm rounds/step (0 sampling + 2 feature"),
    (["--scheme", "vanilla"], "6 comm rounds/step (4 sampling + 2 feature"),
    (["--scheme", "hybrid_partial(0.25)"],
     "6 comm rounds/step (4 sampling + 2 feature")],
    ids=["executor-vmap", "executor-stacked", "scheme-vanilla",
         "scheme-hybrid_partial"])
def test_launcher_trains_every_scheme_and_executor_name(flags, rounds):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_launch.main(["--device", "cpu", "--nodes", "800", "--devices",
                       "4", "--epochs", "1", "--steps-per-epoch", "2",
                       "--batch", "16", *flags])
    text = out.getvalue()
    assert rounds in text and "epoch 0: loss" in text
    assert "edge-cut" in text
    assert ("partial replication:" in text) == ("hybrid_partial" in flags[1])
    if flags[0] == "--executor":
        assert f"executor={flags[1]}" in text


@pytest.mark.parametrize("flags", [
    ["--executor", "shard_map"], ["--shard-map"], ["--trace", "t.json"],
    ["--executor", "multiprocess"]],
    ids=["executor", "shard-map", "trace", "executor-multiprocess"])
def test_launcher_refuses_what_is_not_ported(flags, capsys, tmp_path,
                                             monkeypatch):
    """Nothing is refused any more.  ``--trace``, refused until the
    observability slice, now runs: with ``--trace-fence`` the launcher
    writes a trace that both packages' ``validate_trace`` accept, holding
    the driver's spans with ``repro``'s names and cats.  The ``shard_map``
    and ``multiprocess`` executors, refused until the multi-rank slice,
    now run as a fleet of OS processes (2 ranks here) whose rank 0 output
    the launcher prints."""
    if flags[0] == "--trace":
        path = str(tmp_path / flags[1])
        t_launch.main(["--device", "cpu", "--nodes", "800", "--devices",
                       "4", "--epochs", "1", "--steps-per-epoch", "2",
                       "--batch", "16", "--prefetch-depth", "1",
                       "--trace", path, "--trace-fence"])
        assert f"trace written to {path}" in capsys.readouterr().out
        n = t_validate(path)
        assert n > 0 and j_validate(path) == n
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = {(e["name"], e.get("cat")) for e in events
                 if e["ph"] == "X"}
        assert {("driver/step", "driver"), ("driver/seeds", "driver"),
                ("driver/warmup", "driver"),
                ("driver/runner_step", "driver"),
                ("prefetch/prepare", "prefetch"),
                ("prefetch/consume", "prefetch")} <= spans
        assert t_trace.active_tracer() is None
        return
    src = str(pathlib.Path(__file__).resolve().parent.parent / "src")
    monkeypatch.setenv("PYTHONPATH", src)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    t_launch.main(["--device", "cpu", *flags, "--nodes", "800",
                   "--devices", "2", "--epochs", "1", "--steps-per-epoch",
                   "1", "--batch", "8", "--mh-timeout", "100"])
    out = capsys.readouterr().out
    executor = "shard_map" if flags[0] == "--shard-map" else flags[1]
    assert f"executor={executor}" in out
    assert "2 comm rounds/step" in out and "epoch 0: loss" in out
    assert f"{executor} run complete: 2 ranks x 1 workers" in out


def test_dropout_draws_from_the_generator():
    _, tcfg = _cfgs()
    cfg = TConfig(in_dim=12, hidden_dim=32, num_classes=4, num_layers=2,
                  fanouts=FANOUTS, dropout=0.5)
    rng = np.random.default_rng(0)
    layer = {"w_self": torch.from_numpy(rng.standard_normal(
                 (12, 32), dtype=np.float32)),
             "w_neigh": torch.zeros((12, 32)), "b": torch.ones(32)}

    class _MFG:
        num_dst = 500
        edges = torch.full((500, 2), -1, dtype=torch.int32)

    h = torch.from_numpy(rng.standard_normal((600, 12), dtype=np.float32))
    plain = apply_layer(layer, _MFG, h, cfg, is_last=False)
    a = apply_layer(layer, _MFG, h, cfg, is_last=False,
                    generator=torch.Generator().manual_seed(3))
    b = apply_layer(layer, _MFG, h, cfg, is_last=False,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], plain[kept] * 2.0)
    live = plain != 0
    share = float((kept & live).sum() / live.sum())
    assert 0.45 < share < 0.55
    no_drop = apply_layer(layer, _MFG, h, tcfg, is_last=False,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(no_drop, plain)


@pytest.mark.parametrize("conv", ["sage", "gat"])
def test_stacked_grads_equal_per_worker(conv):
    """One step at P = 4 on the stacked executor: its loss and gradients
    are, bit for bit, the mean in worker order of each worker's own
    forward and backward on its own slice of the batch (``repro``'s
    rule)."""
    from repro_torch.models.gnn import init_gnn_params
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.pipeline.prefetch import worker_rows

    P = 4
    cfg = TConfig(in_dim=12, hidden_dim=32, num_classes=4, num_layers=2,
                  fanouts=FANOUTS, dropout=0.0, conv=conv)
    tp = TPipeline.build_from_source(
        spec=TSpec.from_scheme("hybrid+fused", num_parts=P,
                               fanouts=FANOUTS, data=TDataSpec(**DATA)),
        device="cpu")
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def loss_fn(p, m, h, lab, v):
        return gnn_loss(p, m, h, lab, v, cfg)

    seeds = tp.seeds(BATCH, 5)
    loss, grads, _ = tp.step_fn(loss_fn, device="cpu")(params, seeds, 5)

    prepare, _ = tp.make_prepare_consume(loss_fn, counted=False,
                                         device="cpu")
    b = prepare(tp.shards, seeds, 5)
    losses, per_worker = [], []
    for w in range(P):
        one = slice(w, w + 1)
        leaves = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in params]
        lw = loss_fn(leaves, [worker_rows(m, one) for m in b.mfgs],
                     b.h_src[one], b.seed_labels[one], b.seed_valid[one])
        gw = torch.autograd.grad(lw.sum(), tree_leaves(leaves),
                                 materialize_grads=True)
        losses.append(lw.detach())
        per_worker.append(gw)
    assert torch.equal(loss, torch.cat(losses).mean(dim=0))
    got = tree_leaves(grads)
    assert len(got) == len(per_worker[0])
    for i, g in enumerate(got):
        want = torch.stack([gw[i] for gw in per_worker]).mean(dim=0)
        assert torch.equal(g, want), i
    assert any(bool(g.abs().sum() > 0) for g in got)
