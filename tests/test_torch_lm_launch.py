"""The port's LM configs, meta-device specs, token source, train step,
launchers (``train``, ``serve_lm``, the ``serve`` alias) and
``examples/serve_lm_torch.py``, held to ``repro``'s.

Configs, parameter counts, the meta-device shapes and dtypes of all ten
full configs (kimi's 1 T parameters included) and the token batches are
equal exactly; three ``make_lm_train_step`` steps give ``repro``'s losses
and gradient norms within rtol 1e-4, and step 0's gradients within 2e-4 of
each leaf's largest |entry|.  The launchers and the example run on the CPU
at the reduced sizes through their ``main(argv)``.
"""
import dataclasses
import importlib.util
import pathlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_cfg
from repro.data.tokens import MarkovTokenSource as JSource
from repro.launch import specs as j_specs
from repro.models import lm as j_lm
from repro.optim import init_opt_state as j_init_opt
from repro.train.loop import make_lm_train_step as j_make_step
import repro_torch.configs as t_cfg
from repro_torch.data.tokens import MarkovTokenSource as TSource
from repro_torch.launch import specs as t_specs
from repro_torch.models import lm as t_lm
from repro_torch.optim import init_opt_state, tree_leaves, tree_map
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.loop import make_lm_train_step

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
STEP_RTOL = 1e-4
GRAD_RTOL = 2e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one torch thread each under the parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- configs -----------------------------------------------------------------

def test_registry_equal():
    assert t_cfg.ARCH_IDS == j_cfg.ARCH_IDS
    assert t_cfg.ARCH_ALIASES == j_cfg.ARCH_ALIASES
    assert {k: dataclasses.asdict(v) for k, v in t_cfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_cfg.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(t_cfg.ModelConfig)] == \
        [f.name for f in dataclasses.fields(j_cfg.ModelConfig)]
    assert t_cfg.get_shape("decode_32k").seq_len == 32_768


@pytest.mark.parametrize("arch", j_cfg.ARCH_IDS)
def test_configs_and_counts_equal(arch):
    alias = {v: k for k, v in j_cfg.ARCH_ALIASES.items()}[arch]
    for get in ("get_config", "get_reduced"):
        mine = getattr(t_cfg, get)(alias)
        ref = getattr(j_cfg, get)(alias)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert getattr(t_cfg, get)(arch) == mine
        for prop in ("resolved_head_dim", "is_encdec", "attention_free",
                     "subquadratic"):
            assert getattr(mine, prop) == getattr(ref, prop), prop
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


def test_zamba2_param_count_is_repro_quirk():
    """``repro``'s ``_ssm_params`` counts an MLP in every hybrid layer that
    ``init_model`` does not build; the port keeps the count as it is."""
    cfg = t_cfg.get_config("zamba2-1.2b")
    built = sum(x.numel() for x in tree_leaves(t_specs.abstract_params(cfg)))
    assert cfg.param_count() == j_cfg.get_config("zamba2-1.2b").param_count()
    assert cfg.param_count() > 2.5 * built


# -- meta-device specs -------------------------------------------------------

def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _shapes(tree) -> dict:
    """{path: (shape, dtype)} of a port tree, paths as JAX's keystr."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}['{k}']")
        else:
            out[prefix] = (tuple(t.shape), _dtype(t))
    walk(tree, "")
    return out


def _ref_shapes(struct) -> dict:
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(struct)}


@pytest.mark.parametrize("arch", j_cfg.ARCH_IDS)
def test_full_config_meta_params_equal_eval_shape(arch):
    cfg = t_cfg.get_config(arch)
    params = t_specs.abstract_params(cfg)
    assert all(x.device.type == "meta" for x in tree_leaves(params))
    assert _shapes(params) == _ref_shapes(
        j_specs.abstract_params(j_cfg.get_config(arch)))
    opt = t_specs.abstract_opt_state(cfg, params)
    assert t_specs.moment_dtype_for(cfg) == (
        torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32)
    assert {_dtype(x) for x in tree_leaves(opt.mu)} == {
        str(np.dtype(j_specs.moment_dtype_for(j_cfg.get_config(arch))))}


@pytest.mark.parametrize("arch", j_cfg.ARCH_IDS)
def test_input_specs_and_decode_state_equal(arch):
    cfg, ref = t_cfg.get_config(arch), j_cfg.get_config(arch)
    for name, shape in t_cfg.SHAPES.items():
        mine = t_specs.input_specs(cfg, shape)
        want = j_specs.input_specs(ref, j_cfg.SHAPES[name])
        assert {k: (tuple(v.shape), _dtype(v)) for k, v in mine.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    shape = t_cfg.SHAPES["decode_32k"]
    state = t_specs.abstract_decode_state(cfg, shape)
    want = j_specs.abstract_decode_state(ref, j_cfg.SHAPES["decode_32k"])
    for field in ("pos", "kv", "ssm", "shared_kv", "cross_kv"):
        mine_leaves = [(tuple(x.shape), _dtype(x)) for x in tree_leaves(
            _as_tree(getattr(state, field)))]
        ref_leaves = [(tuple(x.shape), str(x.dtype)) for x in
                      jax.tree.leaves(getattr(want, field))]
        assert mine_leaves == ref_leaves, field


def _as_tree(x):
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [] if x is None else x


# -- tokens ------------------------------------------------------------------

def test_markov_batches_bit_identical():
    for vocab, seed in ((512, 0), (100_352, 3)):
        a, b = TSource(vocab, seed=seed), JSource(vocab, seed=seed)
        np.testing.assert_array_equal(a.table, b.table)
        for s in range(3):
            np.testing.assert_array_equal(a.batch(4, 33, seed=s),
                                          b.batch(4, 33, seed=s))
        tb, jb = a.train_batch(2, 16, seed=5), b.train_batch(2, 16, seed=5)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])


# -- the train step ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_7b", "mixtral_8x22b"])
def test_train_step_matches_repro(arch):
    jcfg, cfg = j_cfg.get_reduced(arch), t_cfg.get_reduced(arch)
    pj = j_lm.init_model(jax.random.key(0), jcfg)
    p_np = jax.tree.map(np.asarray, pj)
    pt = t_lm.params_from_numpy(p_np, "cpu")
    jstep = jax.jit(j_make_step(jcfg, lr=1e-3, remat=False))
    tstep = make_lm_train_step(cfg, lr=1e-3, remat=False)
    jopt, topt = j_init_opt(pj), init_opt_state(pt)
    src = TSource(cfg.vocab_size, seed=0)
    for step in range(3):
        raw = src.train_batch(4, 32, seed=step)
        if step == 0:
            _check_gradients(pj, pt, raw, jcfg, cfg)
        pj, jopt, mj = jstep(pj, jopt, {k: jnp.asarray(v)
                                        for k, v in raw.items()})
        pt, topt, mt = tstep(pt, topt, {k: torch.from_numpy(v)
                                        for k, v in raw.items()})
        assert set(mt) == set(mj) == {"ce", "aux", "loss", "grad_norm"}
        for key in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=STEP_RTOL, err_msg=key)
    assert int(topt.step) == int(jopt.step) == 3


def _check_gradients(pj, pt, raw, jcfg, cfg):
    g_j = jax.grad(lambda p: j_lm.lm_loss(
        p, {k: jnp.asarray(v) for k, v in raw.items()}, jcfg,
        remat=False)[0])(pj)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(pt)]
    it = iter(leaves)
    loss, _ = t_lm.lm_loss(tree_map(lambda _: next(it), pt),
                           {k: torch.from_numpy(v) for k, v in raw.items()},
                           cfg, remat=False)
    g_t = dict(zip(_shapes(pt), torch.autograd.grad(loss, leaves)))
    for k, want in jax.tree_util.tree_leaves_with_path(g_j):
        want = np.asarray(want)
        got = g_t[jax.tree_util.keystr(k)].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= GRAD_RTOL * scale, k


# -- launchers and the example -----------------------------------------------

@pytest.mark.parametrize("arch,seq", [("stablelm-1.6b", 32),
                                      ("mamba2-130m", 128),
                                      ("qwen2-vl-7b", 32),
                                      ("whisper-small", 32)])
def test_train_launcher(tmp_path, arch, seq):
    from repro_torch.launch import train
    ckpt = str(tmp_path / "lm.npz")
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "5", "--batch", "2", "--seq", str(seq),
                      "--checkpoint", ckpt])
    assert len(out["losses"]) == 5 and out["finite"]
    tree, step = restore_checkpoint(ckpt, {"params": out["params"],
                                           "opt": out["opt"]})
    assert step == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(
            {"params": out["params"], "opt": out["opt"]})):
        assert torch.equal(a, b)


# --devices 2 against --devices 1: the MoE experts split over the ranks,
# the global-norm clip summed across them (chip_smoke.py's phase 17 too)
RANKS_TOL = dict(rtol=1e-5, atol=1e-5)


def test_train_launcher_refuses_more_devices(capsys):
    """``--devices N > 1`` is no longer refused: two gloo ranks with the
    parameters as DTensors on their (2, 1) mesh (mixtral's 4 reduced
    experts split over ``data``) give ``--devices 1``'s losses."""
    from repro_torch.launch import train
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "64"]
    two = train.main(argv + ["--devices", "2", "--mh-timeout", "120"])
    assert "2 ranks" in capsys.readouterr().out
    one = train.main(argv)
    assert two["finite"] and len(two["losses"]) == 3
    np.testing.assert_allclose(two["losses"], one["losses"], **RANKS_TOL)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-1.2b"])
def test_serve_lm_launcher(arch):
    from repro_torch.launch import serve_lm
    out = serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    vocab = t_cfg.get_reduced(arch).vocab_size
    assert out["tokens"].shape == (2, 5) and out["finite"]
    assert ((out["tokens"] >= 0) & (out["tokens"] < vocab)).all()


def test_prefill_cache_last_logits_equal_forward():
    from repro_torch.launch.serve_lm import prefill_cache
    cfg = t_cfg.get_reduced("h2o-danube-3-4b")
    params = t_lm.init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(TSource(cfg.vocab_size).batch(2, 79))
    _, logits = prefill_cache(params, toks, cfg)
    with torch.no_grad():
        want, _ = t_lm.forward(params, {"tokens": toks}, cfg, remat=False)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


def test_launchers_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    from repro_torch.launch import serve_lm, train
    for main, argv in ((train.main, ["--arch", "qwen2-7b", "--reduced"]),
                       (serve_lm.main, ["--arch", "qwen2-7b", "--reduced"]),
                       (_load_example().main, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_serve_alias_warns():
    sys.modules.pop("repro_torch.launch.serve", None)
    with pytest.warns(DeprecationWarning, match="serve_lm"):
        import repro_torch.launch.serve as alias
    from repro_torch.launch import serve_lm
    assert alias.main is serve_lm.main
    assert alias.prefill_cache is serve_lm.prefill_cache


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", EXAMPLES / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_example():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = _load_example().main(["--device", "cpu"])
    assert list(out) == ["stablelm_1p6b", "mixtral_8x22b", "mamba2_130m",
                         "zamba2_1p2b"]
    for arch, toks in out.items():
        assert toks.shape == (4, 12), arch
