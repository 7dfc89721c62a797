"""The port's LM scaffold (``repro_torch.models.{layers,attention,moe,ssm,
lm}``) held to ``repro``'s on seeded numpy inputs, in float32.

``repro``'s parameters cross over leaf by leaf (``params_from_numpy``),
since torch cannot reproduce ``jax.random``.  Tolerances: a module's
output within ``TOL`` (rtol and atol 1e-4; the two frameworks sum their
products in different orders), the logits of every reduced arch and of
every decode step within ``LOGIT_TOL`` of ``repro``'s, each gradient leaf
within ``GRAD_RTOL`` of its largest |entry|.  Integer outputs (MoE
dispatch, drops, top-k experts) are equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced as repro_reduced
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro_torch.configs import get_reduced
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm

TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-4)
GRAD_RTOL = 2e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one torch thread each under the parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@functools.lru_cache(maxsize=None)
def reference_params(arch: str):
    """``repro``'s initial parameters of the reduced arch, as numpy."""
    cfg = repro_reduced(arch)
    return jax.tree.map(np.asarray, j_lm.init_model(jax.random.key(0), cfg))


def both(arch: str):
    """(repro's config, the port's config, repro's params, the port's)."""
    p_np = reference_params(arch)
    return (repro_reduced(arch), get_reduced(arch),
            jax.tree.map(jnp.asarray, p_np),
            t_lm.params_from_numpy(p_np, "cpu"))


def make_batch(cfg, B=2, S=32, seed=0) -> dict:
    r = rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = r.normal(0, 1, (B, S // 4, cfg.d_model)
                                      ).astype(np.float32)
        grid = r.integers(0, S, (3, B, S)).astype(np.int32)
        grid[0] = np.arange(S)
        b["positions"] = grid
    if cfg.is_encdec:
        b["frames"] = r.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)
    return b


def seq_len(cfg) -> int:
    return 128 if cfg.family in ("ssm", "hybrid") else 32


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms(norm):
    cfg = dataclasses.replace(get_reduced("stablelm_1p6b"), norm=norm)
    r = rng(1)
    x = r.normal(2.0, 3.0, (2, 7, cfg.d_model)).astype(np.float32)
    p = {"scale": r.normal(1, 0.1, cfg.d_model).astype(np.float32),
         "bias": r.normal(0, 0.1, cfg.d_model).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    want = j_layers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               cfg)
    got = t_layers.apply_norm({k: t(v) for k, v in p.items()}, t(x), cfg)
    close(got, want)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp(act):
    cfg = dataclasses.replace(get_reduced("minitron_4b"), act=act)
    r = rng(2)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": r.normal(0, d ** -0.5, (d, f)),
         "w2": r.normal(0, f ** -0.5, (f, d)),
         "w3": r.normal(0, d ** -0.5, (d, f))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.normal(0, 2, (2, 5, d)).astype(np.float32)
    want = j_layers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg)
    got = t_layers.apply_mlp({k: t(v) for k, v in p.items()}, t(x), cfg)
    close(got, want)


def test_gelu_is_jax_tanh_form():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(t_layers.gelu(t(x)), jax.nn.gelu(jnp.asarray(x)),
          dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("mrope", [False, True], ids=["rope", "mrope"])
def test_rope(mrope):
    r = rng(3)
    B, S, H, Dh = 2, 9, 3, 64
    x = r.normal(0, 1, (B, S, H, Dh)).astype(np.float32)
    if mrope:
        pos = r.integers(0, 50, (3, B, S)).astype(np.int32)
        sections = (8, 12, 12)
    else:
        pos = r.integers(0, 5000, (B, S)).astype(np.int32)
        sections = ()
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                               sections)
    got = t_layers.apply_rope(t(x), t(pos), 1e4, sections)
    close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_params_numpy_round_trip():
    """f32 leaves cross both ways unchanged; a bf16 tree (``ml_dtypes``
    arrays, as ``repro``'s full configs hold) keeps its bits and comes
    back as float32."""
    p_np = reference_params("zamba2_1p2b")
    back = t_lm.params_to_numpy(t_lm.params_from_numpy(p_np, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, p_np)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      p_np)
    pt = t_lm.params_from_numpy(bf, "cpu")
    assert pt["blocks"]["ssm"]["in_proj"].dtype == torch.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), t_lm.params_to_numpy(pt), bf)


@pytest.mark.parametrize("arch", ["mamba2_130m", "qwen2_7b"],
                         ids=["tied", "untied"])
def test_embed_unembed(arch):
    jc, tc, pj, pt = both(arch)
    assert tc.tie_embeddings == (arch == "mamba2_130m")
    r = rng(4)
    tok = r.integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    close(t_layers.embed(pt["embed"], t(tok), tc),
          j_layers.embed(pj["embed"], jnp.asarray(tok), jc))
    h = r.normal(0, 1, (2, 6, jc.d_model)).astype(np.float32)
    close(t_layers.unembed(pt["embed"], t(h), tc),
          j_layers.unembed(pj["embed"], jnp.asarray(h), jc))


# -- attention ---------------------------------------------------------------

def _attn_params(arch):
    jc, tc, pj, pt = both(arch)
    return jc, tc, jax.tree.map(lambda a: a[0], pj["blocks"]["attn"]), \
        t_lm.layers(pt["blocks"], tc.num_layers)[0]["attn"]


@pytest.mark.parametrize("arch,kind", [
    ("qwen2_7b", "causal"), ("h2o_danube3_4b", "window"),
    ("whisper_small", "cross"), ("whisper_small", "encoder")])
def test_attend(arch, kind):
    jc, tc, pj, pt = _attn_params(arch)
    r = rng(5)
    B, S = 2, 96
    x = r.normal(0, 1, (B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if kind == "cross":
        enc = r.normal(0, 1, (B, 40, jc.d_model)).astype(np.float32)
        kw_j, kw_t = {"kv_x": jnp.asarray(enc)}, {"kv_x": t(enc)}
    causal = kind != "encoder"
    want = j_attn.attend(pj, jnp.asarray(x), jnp.asarray(pos), jc,
                         causal=causal, **kw_j)
    got = t_attn.attend(pt, t(x), t(pos), tc, causal=causal, **kw_t)
    close(got, want)


@pytest.mark.parametrize("arch", ["qwen2_7b", "h2o_danube3_4b"],
                         ids=["causal", "window"])
def test_chunked_attention_equals_repro_and_naive(arch):
    jc, tc, pj, pt = _attn_params(arch)
    jc = dataclasses.replace(jc, attn_chunk=32)
    tc_chunk = dataclasses.replace(tc, attn_chunk=32)
    r = rng(6)
    B, S = 2, 128                      # four chunks; the window is 64
    x = r.normal(0, 1, (B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = j_attn.attend(pj, jnp.asarray(x), jnp.asarray(pos), jc)
    got = t_attn.attend(pt, t(x), t(pos), tc_chunk)
    naive = t_attn.attend(pt, t(x), t(pos), tc)
    close(got, want)
    close(got, naive.detach().numpy())


def test_decode_attend_past_the_window():
    """The ring buffer: 80 decode steps through a 64-slot window cache,
    each step's output against ``repro``'s, the cache wrapping at 64."""
    jc, tc, pj, pt = _attn_params("h2o_danube3_4b")
    assert jc.window == 64
    r = rng(7)
    B, steps = 2, 80
    xs = r.normal(0, 1, (steps, B, 1, jc.d_model)).astype(np.float32)
    jcache = j_attn.init_kv_cache(jc, B, 96)
    tcache = t_attn.init_kv_cache(tc, B, 96, device="cpu")
    assert tcache.cache_len == jcache.cache_len == 64
    jstep = jax.jit(lambda x, pos, c: j_attn.decode_attend(pj, x, pos, c,
                                                           jc))
    for s in range(steps):
        want, jcache = jstep(jnp.asarray(xs[s]), jnp.int32(s), jcache)
        got, tcache = t_attn.decode_attend(
            pt, t(xs[s]), torch.tensor(s, dtype=torch.int32), tcache, tc)
        close(got, want)
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)


# -- MoE ---------------------------------------------------------------------

def _moe_params(arch="mixtral_8x22b"):
    jc, tc, pj, pt = both(arch)
    return jc, tc, jax.tree.map(lambda a: a[0], pj["blocks"]["moe"]), \
        t_lm.layers(pt["blocks"], tc.num_layers)[0]["moe"]


def skew(router):
    """The unit vector along expert 0's router column."""
    u = np.asarray(router)[:, 0]
    return (u / np.linalg.norm(u)).astype(np.float32)


def _repro_dispatch(top_e, E, C):
    """``repro.models.moe.apply_moe``'s dispatch lines (moe.py:84-92)."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)[order]
    seg_start = jnp.searchsorted(se, jnp.arange(E))
    slot = jnp.arange(T * k, dtype=jnp.int32) - seg_start[se]
    return se, st, slot, slot < C


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
def test_apply_moe_with_drops(arch):
    jc, tc, pj, pt = _moe_params(arch)
    r = rng(8)
    x = r.normal(0, 1, (2, 24, jc.d_model)).astype(np.float32)
    # push every token towards expert 0, past its capacity
    x += 4.0 * skew(pj["router"])
    want, aux_j = j_moe.apply_moe(pj, jnp.asarray(x), jc)
    got, aux_t = t_moe.apply_moe(pt, t(x), tc)
    close(got, want)
    close(aux_t, aux_j)
    # the dispatch: the same top-k experts, order, slots and drops
    T, E = 48, jc.num_experts
    C = t_moe.moe_capacity(tc, T)
    assert C == j_moe.moe_capacity(jc, T)
    logits_j = jnp.asarray(x).reshape(T, -1) @ pj["router"]
    _, top_e_j = jax.lax.top_k(jax.nn.softmax(logits_j, -1), jc.top_k)
    logits_t = t(x).reshape(T, -1) @ pt["router"]
    _, top_e_t, _ = t_moe._route(logits_t, E, tc.top_k)
    np.testing.assert_array_equal(top_e_t.numpy(), np.asarray(top_e_j))
    se, st, slot, keep, _ = t_moe.dispatch(top_e_t, E, C)
    for a, b in zip((se, st, slot, keep), _repro_dispatch(top_e_j, E, C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int((~keep).sum()), "the test must drop some assignments"


def test_moe_capacity_floor_division():
    cfg = get_reduced("mixtral_8x22b")
    jcfg = repro_reduced("mixtral_8x22b")
    for T in (1, 2, 3, 4, 7, 64, 1000):
        assert t_moe.moe_capacity(cfg, T) == j_moe.moe_capacity(jcfg, T)


def test_apply_moe_grouped():
    jc, tc, pj, pt = _moe_params()
    jc = dataclasses.replace(jc, moe_num_groups=4)
    tc = dataclasses.replace(tc, moe_num_groups=4)
    r = rng(9)
    x = r.normal(0, 1, (2, 16, jc.d_model)).astype(np.float32)
    x += 4.0 * skew(pj["router"])
    want, aux_j = j_moe.apply_moe(pj, jnp.asarray(x), jc)
    got, aux_t = t_moe.apply_moe(pt, t(x), tc)
    close(got, want)
    close(aux_t, aux_j)


# -- SSM ---------------------------------------------------------------------

def _ssm_params(arch="mamba2_130m"):
    jc, tc, pj, pt = both(arch)
    return jc, tc, jax.tree.map(lambda a: a[0], pj["blocks"]["ssm"]), \
        t_lm.layers(pt["blocks"], tc.num_layers)[0]["ssm"]


def test_ssd_chunked():
    r = rng(10)
    b, S, H, P, N = 2, 256, 4, 8, 16
    x = r.normal(0, 1, (b, S, H, P)).astype(np.float32)
    A = -np.abs(r.normal(0, 0.5, (b, S, H))).astype(np.float32)
    Bm = r.normal(0, 1, (b, S, N)).astype(np.float32)
    Cm = r.normal(0, 1, (b, S, N)).astype(np.float32)
    yj, sj = j_ssm.ssd_chunked(*map(jnp.asarray, (x, A, Bm, Cm)))
    yt, st = t_ssm.ssd_chunked(*map(t, (x, A, Bm, Cm)))
    close(yt, yj)
    close(st, sj)


def test_segsum_gradient_is_finite():
    """Decays of up to 100 a step: the masked differences would overflow
    ``exp`` (to inf, and NaN in the gradient) were they not masked first."""
    x = (-100 * torch.rand(2, 16)).requires_grad_(True)
    out = torch.exp(t_ssm._segsum(x))
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(x.grad).all()


def test_apply_ssm():
    jc, tc, pj, pt = _ssm_params()
    x = rng(11).normal(0, 1, (2, 128, jc.d_model)).astype(np.float32)
    close(t_ssm.apply_ssm(pt, t(x), tc), j_ssm.apply_ssm(pj, jnp.asarray(x),
                                                         jc))


def test_decode_ssm():
    jc, tc, pj, pt = _ssm_params()
    xs = rng(12).normal(0, 1, (12, 2, 1, jc.d_model)).astype(np.float32)
    jcache = j_ssm.init_ssm_cache(jc, 2)
    tcache = t_ssm.init_ssm_cache(tc, 2, device="cpu")
    jstep = jax.jit(lambda x, c: j_ssm.decode_ssm(pj, x, c, jc))
    for x in xs:
        want, jcache = jstep(jnp.asarray(x), jcache)
        got, tcache = t_ssm.decode_ssm(pt, t(x), tcache, tc)
        close(got, want)
    close(tcache.state, jcache.state)
    close(tcache.conv_buf, jcache.conv_buf)


# -- the assembled model -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _repro_forward(arch: str, last_only: bool = False):
    cfg = repro_reduced(arch)
    return jax.jit(lambda p, b: j_lm.forward(p, b, cfg, remat=False,
                                             last_only=last_only))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_all_reduced_archs(arch):
    jc, tc, pj, pt = both(arch)
    b = make_batch(jc, S=seq_len(jc))
    want, aux_j = _repro_forward(arch)(pj, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    with torch.no_grad():
        got, aux_t = t_lm.forward(pt, {k: t(v) for k, v in b.items()}, tc,
                                  remat=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got, want, LOGIT_TOL)
    close(aux_t, aux_j)


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "zamba2_1p2b"])
def test_last_only(arch):
    jc, tc, pj, pt = both(arch)
    b = make_batch(jc, S=seq_len(jc))
    want, _ = _repro_forward(arch, True)(pj, {k: jnp.asarray(v)
                                              for k, v in b.items()})
    with torch.no_grad():
        got, _ = t_lm.forward(pt, {k: t(v) for k, v in b.items()}, tc,
                              remat=False, last_only=True)
        full, _ = t_lm.forward(pt, {k: t(v) for k, v in b.items()}, tc,
                               remat=False)
    assert got.shape == (2, 1, jc.vocab_size)
    close(got, want, LOGIT_TOL)
    close(got, full[:, -1:].numpy(), dict(rtol=1e-5, atol=1e-5))


# decode_step token by token, one arch per cache family: (arch, batch,
# steps, context).  The SWA archs run past their 64-slot window; mixtral at
# batch 4 drops tokens (capacity 3 for 8 assignments).
DECODE = {"dense": ("stablelm_1p6b", 2, 12, 64),
          "swa-ring": ("h2o_danube3_4b", 2, 72, 96),
          "moe-swa": ("mixtral_8x22b", 4, 72, 96),
          "ssm": ("mamba2_130m", 2, 12, 64),
          "hybrid": ("zamba2_1p2b", 2, 12, 64),
          "vlm": ("qwen2_vl_7b", 2, 12, 64),
          "whisper-cross": ("whisper_small", 2, 12, 64)}


@pytest.mark.parametrize("family", list(DECODE))
def test_decode_step(family):
    arch, B, steps, ctx = DECODE[family]
    jc, tc, pj, pt = both(arch)
    toks = rng(13).integers(0, jc.vocab_size, (steps, B, 1)).astype(np.int32)
    if jc.is_encdec:
        frames = rng(14).normal(0, 1, (B, jc.encoder_seq, jc.d_model)
                                ).astype(np.float32)
        enc_j = jax.jit(lambda p, f: j_lm._encode(p, f, jc))(
            pj, jnp.asarray(frames))
        with torch.no_grad():
            enc_t = t_lm._encode(pt, t(frames), tc)
        close(enc_t, enc_j)
        jstate = j_lm.init_decode_state(jc, B, ctx, enc_out=enc_j, params=pj)
        tstate = t_lm.init_decode_state(tc, B, ctx, enc_out=enc_t, params=pt)
        close(tstate.cross_kv[0], jstate.cross_kv[0])
        close(tstate.cross_kv[1], jstate.cross_kv[1])
    else:
        jstate = j_lm.init_decode_state(jc, B, ctx)
        tstate = t_lm.init_decode_state(tc, B, ctx, params=pt)
    jstep = jax.jit(lambda p, s, tok: j_lm.decode_step(
        p, s, {"tokens": tok}, jc))
    for s in range(steps):
        want, jstate = jstep(pj, jstate, jnp.asarray(toks[s]))
        got, tstate = t_lm.decode_step(pt, tstate, {"tokens": t(toks[s])},
                                       tc)
        close(got, want, LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want.argmax(-1)))
    assert int(tstate.pos) == int(jstate.pos) == steps
    if tstate.kv is not None:
        close(tstate.kv.k, jstate.kv.k)
    if tstate.ssm is not None:
        close(tstate.ssm.state, jstate.ssm.state)
    if tstate.shared_kv is not None:
        close(tstate.shared_kv.v, jstate.shared_kv.v)


# -- loss and gradients ------------------------------------------------------

def _port_loss_and_grads(pt, batch, cfg, remat=False):
    from repro_torch.optim import tree_leaves, tree_map
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(pt)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), pt)
    loss, metrics = t_lm.lm_loss(p, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads


@pytest.mark.parametrize("arch,chunk", [
    ("qwen2_7b", 0), ("mixtral_8x22b", 0), ("mamba2_130m", 0),
    ("stablelm_1p6b", 8)], ids=["dense", "moe", "ssm", "ce_seq_chunk"])
def test_lm_loss_and_gradients(arch, chunk):
    jc, tc, pj, pt = both(arch)
    jc = dataclasses.replace(jc, ce_seq_chunk=chunk)
    tc = dataclasses.replace(tc, ce_seq_chunk=chunk)
    b = make_batch(jc, S=seq_len(jc), seed=3)
    b["labels"][0, :5] = -1                   # masked positions
    (loss_j, met_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, bb: j_lm.lm_loss(p, bb, jc, remat=False), has_aux=True))(
            pj, {k: jnp.asarray(v) for k, v in b.items()})
    loss_t, met_t, g_t = _port_loss_and_grads(
        pt, {k: t(v) for k, v in b.items()}, tc)
    close(loss_t, loss_j, dict(rtol=1e-5, atol=1e-5))
    close(met_t["ce"], met_j["ce"], dict(rtol=1e-5, atol=1e-5))
    close(met_t["aux"], met_j["aux"], dict(rtol=1e-5, atol=1e-6))
    leaves_j = jax.tree.leaves(g_j)
    assert len(leaves_j) == len(g_t)
    # the port's tree_leaves walks dicts in insertion order, JAX in sorted
    # key order: pair the leaves by path
    paths_j = [jax.tree_util.keystr(k) for k, _ in
               jax.tree_util.tree_leaves_with_path(g_j)]
    paths_t = _paths(pt)
    by_path = dict(zip(paths_j, leaves_j))
    for path, g in zip(paths_t, g_t):
        want = np.asarray(by_path[path])
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_RTOL * scale, (path, err, scale)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _paths(v, f"{prefix}['{k}']")
        return out
    return [prefix]


def test_remat_gives_the_same_loss_and_gradients():
    _, tc, _, pt = both("zamba2_1p2b")
    b = make_batch(tc, S=128)
    batch = {k: t(v) for k, v in b.items()}
    l0, _, g0 = _port_loss_and_grads(pt, batch, tc, remat=False)
    l1, _, g1 = _port_loss_and_grads(pt, batch, tc, remat=True)
    assert l0.item() == l1.item()
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
