"""PyTorch port: the DiffusionBlocks training step against the JAX package
on the CPU.

Reduced stablelm-1.6b (6 layers, d=256, 4 heads of 64), 3 blocks, the JAX
init bridged to torch with the AdaLN heads and norm gains randomised (at
init they are the identity and would test nothing). σ and ε are drawn on
the JAX side the way ``block_loss`` draws them (one rng split) and handed to
the port. The port runs ``impl="kernels"``, whose wrappers take their plain
versions on CPU tensors; JAX runs ``impl="auto"``. Tolerance 1e-4 (atol and
rtol) under fp32; the bf16 policy's loss within 2e-2 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import blocks as JB
from repro.core import training as JT
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.models import common as JCOM
from repro.nn import attention as JA
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import blocks as TB
from repro_torch.core import partition as TP
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.kernels import ops as TOPS
from repro_torch.launch import train as TLT
from repro_torch.models import common as TCOM
from repro_torch.nn import attention as TA
from repro_torch.nn.init import tree_items, tree_map

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
CFG = JC.reduced(JC.get_config("stablelm-1.6b"), n_layers=6)
DB = JC.DBConfig(num_blocks=3, overlap_gamma=0.1)
B, S = 2, 12
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    """(jax dbm, numpy param tree, torch dbm, tokens)."""
    jdbm = JDBM(CFG, DB)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        lay[ln]["g"] = (1.0 + 0.1 * rs.randn(*lay[ln]["g"].shape)
                        ).astype(np.float32)
    cfg_t = TC.ModelConfig(**dataclasses.asdict(CFG))
    tdbm = TDBM(cfg_t, TC.DBConfig(**dataclasses.asdict(DB)))
    tokens = JMarkovLM(vocab_size=CFG.vocab_size, seed=7).sample(
        np.random.RandomState(1), B, S)
    return jdbm, tree, tdbm, tokens


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def draws(jdbm, b, rng):
    """σ (B,1,1) and ε (B,S,d) as ``block_loss`` draws them from ``rng``."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, S, CFG.d_model), jnp.float32)
    return t(sigma), t(eps)


# ---------------------------------------------------------------------------
# Attention and one layer in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["causal", "db_concat", "window"])
def test_attend_and_attention_fwd_match_jax(setup, mask):
    jdbm, tree, tdbm, _ = setup
    n = 2 * S
    jm, tm = {"causal": (JA.causal_mask, TA.causal_mask),
              "db_concat": (JA.db_concat_mask(S), TA.db_concat_mask(S)),
              "window": (JA.sliding_window_mask(5),
                         TA.sliding_window_mask(5))}[mask]
    assert tm.kernel_mask == jm.kernel_mask
    rs = np.random.RandomState(4)
    q = rs.randn(B, n, 4, 64).astype(np.float32)
    k = rs.randn(B, n, 4, 64).astype(np.float32)
    v = rs.randn(B, n, 4, 64).astype(np.float32)
    pos = np.arange(n)
    want = JA.attend(*map(jnp.asarray, (q, k, v)), mask_mod=jm,
                     qpos=jnp.asarray(pos), kpos=jnp.asarray(pos),
                     impl="naive")
    for impl in ("kernels", "ref"):
        got = TA.attend(*map(t, (q, k, v)), mask_mod=tm, qpos=t(pos),
                        kpos=t(pos), impl=impl)
        close(got, want)
    p_attn = {k_: v_[0] for k_, v_ in tree["layers"]["attn"].items()}
    x = rs.randn(B, n, CFG.d_model).astype(np.float32)
    rope = np.concatenate([np.arange(S), np.arange(S)])
    dims = JA.AttnDims(CFG.n_heads, CFG.n_kv_heads, CFG.head_dim,
                       CFG.rope_theta)
    want, _ = JA.attention_fwd(jparams(p_attn), jnp.asarray(x), dims,
                               positions=jnp.asarray(pos), mask_mod=jm,
                               rope_positions=jnp.asarray(rope),
                               impl="naive")
    got, _ = TA.attention_fwd({k_: t(v_) for k_, v_ in p_attn.items()},
                              t(x), TA.AttnDims(*dataclasses.astuple(dims)),
                              positions=t(pos), mask_mod=tm,
                              rope_positions=t(rope), impl="kernels")
    close(got, want)


def test_attention_fwd_rejects_cross_attention(setup):
    """Cross-attention over ``kv_x`` runs since the audio family's port
    (``tests/test_torch_audio.py`` holds it to JAX); through the kernels
    it still rejects key positions that are not an arange (a packed or
    offset memory has no kernel mask), as self-attention does. Over an
    arange it matches JAX's within the file's tolerance."""
    rs = np.random.RandomState(4)
    x = rs.randn(1, 4, 32).astype(np.float32)
    mem = rs.randn(1, 6, 32).astype(np.float32)
    p = {k: (0.1 * rs.randn(32, 32)).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with pytest.raises(NotImplementedError, match="arange"):
        TA.attention_fwd(tp, torch.from_numpy(x), TA.AttnDims(2, 2, 16),
                         positions=torch.arange(4), mask_mod=None,
                         kv_x=torch.from_numpy(mem),
                         kv_positions=torch.arange(1, 7))
    got, _ = TA.attention_fwd(tp, torch.from_numpy(x), TA.AttnDims(2, 2, 16),
                              positions=torch.arange(4), mask_mod=None,
                              kv_x=torch.from_numpy(mem),
                              kv_positions=torch.arange(6))
    want, _ = JA.attention_fwd(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        JA.AttnDims(2, 2, 16), positions=jnp.arange(4), mask_mod=None,
        kv_x=jnp.asarray(mem), kv_positions=jnp.arange(6))
    close(got, want)


def test_ops_route_and_positions():
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(NotImplementedError, match="no kernel equivalent"):
        TOPS.flash_attention(x, x, x, mask_mod=lambda q, k: q[:, None] >= k)
    with pytest.raises(NotImplementedError, match="arange"):
        TOPS.flash_attention(x, x, x, mask_mod=TA.causal_mask,
                             qpos=torch.arange(1, 5))
    with pytest.raises(NotImplementedError, match="arange"):
        TOPS.flash_attention(x, x, x, kpos=torch.arange(3))
    assert TOPS._route_mask(TA.db_concat_mask(7)) == ("db_concat", None, 7)
    assert TOPS._route_mask(None) == ("full", None, None)


@pytest.mark.parametrize("concat", [True, False])
def test_tlayer_apply_train_matches_jax(setup, concat):
    jdbm, tree, tdbm, _ = setup
    rs = np.random.RandomState(5)
    n = 2 * S if concat else S
    h = rs.randn(B, n, CFG.d_model).astype(np.float32)
    sigma = np.array([0.3, 2.0], np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), tree["layers"])
    tp = jax.tree_util.tree_map(lambda a: t(a[1]), tree["layers"])
    jctx = JCOM.LayerCtx(cfg=CFG, mode="train", positions=jnp.arange(n),
                         impl="auto")
    tctx = TCOM.LayerCtx(cfg=tdbm.cfg, mode="train",
                         positions=torch.arange(n), impl="kernels")
    if concat:
        jctx.cond = jdbm.model.cond(jparams(tree), jnp.log(sigma))
        tctx.cond = tdbm.model.cond(tparams(tdbm, tree), t(np.log(sigma)))
        close(tctx.cond, jctx.cond)
        jctx.mask_mod, tctx.mask_mod = JA.db_concat_mask(S), \
            TA.db_concat_mask(S)
        rope = np.concatenate([np.arange(S), np.arange(S)])
        jctx.rope_positions, tctx.rope_positions = jnp.asarray(rope), t(rope)
        cm = np.arange(n) >= S
        jctx.cond_mask, tctx.cond_mask = jnp.asarray(cm), t(cm)
    want, _, _ = JCOM.tlayer_apply(jp, jnp.asarray(h), jctx)
    got, cache = TCOM.tlayer_apply(tp, t(h), tctx)
    assert cache is None
    close(got, want)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [5, 512])
def test_chunked_ce_matches_jax(setup, chunk):
    jdbm, tree, tdbm, tokens = setup
    rs = np.random.RandomState(6)
    h = rs.randn(B, S, CFG.d_model).astype(np.float32)
    want = JB.chunked_ce(jdbm.model, jparams(tree), jnp.asarray(h),
                         jnp.asarray(tokens), chunk=chunk)
    th = t(h).requires_grad_()
    got = TB.chunked_ce(tdbm.model, tparams(tdbm, tree), th, t(tokens),
                        chunk=chunk)
    close(got, want)
    got.backward()
    gh = jax.grad(lambda x: JB.chunked_ce(jdbm.model, jparams(tree), x,
                                          jnp.asarray(tokens), chunk=chunk)
                  )(jnp.asarray(h))
    close(th.grad, gh)


@pytest.mark.parametrize("b", [0, 2])
def test_block_loss_matches_jax(setup, b):
    jdbm, tree, tdbm, tokens = setup
    rng = jax.random.PRNGKey(10 + b)
    want, jm = jdbm.block_loss(jparams(tree), b, jnp.asarray(tokens), rng)
    sigma, eps = draws(jdbm, b, rng)
    got, tm = tdbm.block_loss(tparams(tdbm, tree), b, t(tokens), sigma=sigma,
                              eps=eps)
    close(got, want)
    close(tm["sigma_mean"], jm["sigma_mean"])


def test_block_loss_draws_from_a_generator(setup):
    _, tree, tdbm, tokens = setup
    params = tparams(tdbm, tree)
    losses = [tdbm.block_loss(params, 1, t(tokens),
                              torch.Generator().manual_seed(s))[0].item()
              for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    sig = tdbm.sample_block_sigma(torch.Generator().manual_seed(0), (256,),
                                  1)
    lo, hi = TP.block_sigma_range(tdbm.db, 1)
    assert float(sig.min()) >= lo * 0.999 and float(sig.max()) <= hi * 1.001


def test_edm_draw_functions_match_jax():
    from repro.core import edm as JE
    from repro_torch.core import edm as TE
    sig = np.array([0.01, 0.3, 5.0, 80.0], np.float32)
    close(TE.weighting(t(sig), 0.5), JE.weighting(jnp.asarray(sig), 0.5))
    u = np.array([0.05, 0.4, 0.93], np.float32)
    want = jnp.exp(DB.p_mean + DB.p_std * jax.scipy.special.ndtri(u))
    close(TE.sample_sigma_in_qrange(None, None, DB, 0.0, 1.0, u=t(u)), want)
    y = np.ones((2, 3, 4), np.float32)
    eps = np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 10
    z, e = TE.add_noise(None, t(y), t(sig[:2].reshape(2, 1, 1)), eps=t(eps))
    close(z, y + sig[:2].reshape(2, 1, 1) * eps)
    close(e, eps)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _jax_state_np(state):
    return jax.tree_util.tree_map(np.asarray, (state.mu, state.nu))


def _assert_tree_close(got_np, want_np):
    want = dict(tree_items(want_np))
    got = dict(tree_items(got_np))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path])


@pytest.mark.parametrize("b", [0, 1, 2])
def test_db_train_step_matches_jax(setup, b):
    """One fp32 step per block from shared params and draws: loss, the
    updated params and the AdamW moments within 1e-4 of JAX; the other
    blocks' units are untouched, and no grad or moment exists for them."""
    jdbm, tree, tdbm, tokens = setup
    rng = jax.random.PRNGKey(20 + b)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="auto",
                                           precision="fp32")
    jp = jparams(tree)
    jopt = j_init(jp)
    jp2, jopt2, jloss, _ = j_step(jp, jopt, jnp.asarray(tokens), rng)

    params = tparams(tdbm, tree)
    before = {p: x.clone() for p, x in tree_items(params)}
    t_init, t_step = TT.make_db_train_step(tdbm, b, TCFG, precision="fp32")
    opt = t_init(params)
    sigma, eps = draws(jdbm, b, rng)
    params2, opt2, loss, m = t_step(params, opt, t(tokens), sigma=sigma,
                                    eps=eps)
    assert params2 is params
    close(loss, jloss)
    _assert_tree_close(params_to_numpy(params),
                       jax.tree_util.tree_map(np.asarray, jp2))
    mu, nu = _jax_state_np(jopt2)
    _assert_tree_close(params_to_numpy(opt2.mu), mu)
    _assert_tree_close(params_to_numpy(opt2.nu), nu)
    assert int(opt2.step) == int(jopt2.step) == 1

    start, size = tdbm.ranges[b]
    for path, x in tree_items(opt2.mu["layers"]):
        assert x.shape[0] == size, path
    for path, x in tree_items(params):
        assert x.grad is None and not x.requires_grad, path
        if path[0] == "layers":
            outside = torch.ones(x.shape[0], dtype=torch.bool)
            outside[start:start + size] = False
            assert torch.equal(x[outside], before[path][outside]), path


def test_e2e_train_step_matches_jax(setup):
    jdbm, tree, tdbm, tokens = setup
    j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                            precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens),
                                  jax.random.PRNGKey(0))
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_e2e_train_step(tdbm, TCFG, precision="fp32")
    params, opt2, loss, _ = t_step(params, t_init(params), t(tokens))
    close(loss, jloss)
    _assert_tree_close(params_to_numpy(params),
                       jax.tree_util.tree_map(np.asarray, jp2))
    mu, nu = _jax_state_np(jopt2)
    _assert_tree_close(params_to_numpy(opt2.mu), mu)
    _assert_tree_close(params_to_numpy(opt2.nu), nu)


def test_bf16_step_loss_close_to_jax(setup):
    jdbm, tree, tdbm, tokens = setup
    rng = jax.random.PRNGKey(30)
    j_init, j_step = JT.make_db_train_step(jdbm, 1, TCFG, impl="auto",
                                           precision="bf16")
    jp = jparams(tree)
    _, _, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens), rng)
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_db_train_step(tdbm, 1, TCFG, precision="bf16")
    sigma, eps = draws(jdbm, 1, rng)
    _, opt, loss, _ = t_step(params, t_init(params), t(tokens), sigma=sigma,
                             eps=eps)
    assert abs(float(loss) - float(jloss)) <= 2e-2 * abs(float(jloss))
    assert all(x.dtype == torch.float32 for _, x in tree_items(params))
    assert all(x.dtype == torch.float32 for _, x in tree_items(opt.mu))


def test_guard_is_not_ported(setup):
    """The guard is ported now: ``guard=`` gives the guarded signature, and
    a NaN step leaves params, moments and step counter as they were."""
    _, tree, tdbm, tokens = setup
    params = tparams(tdbm, tree)
    init, step = TT.make_db_train_step(tdbm, 0, TCFG, guard=TT.GuardConfig())
    opt = init(params)
    before = [x.clone() for _, x in tree_items(params)]
    _, opt, ewma, loss, m = step(params, opt, -1.0, t(tokens),
                                 torch.Generator().manual_seed(0),
                                 loss_mult=float("nan"))
    assert not bool(m["ok"]) and float(ewma) == -1.0
    assert int(opt.step) == 0
    assert all(torch.equal(a, b) for (_, a), b in zip(tree_items(params),
                                                       before))


def test_block_view_round_trip(setup):
    _, tree, tdbm, _ = setup
    params = tparams(tdbm, tree)
    view = TT.extract_block_view(params, 2, 2)
    assert view["layers"]["attn"]["wq"].data_ptr() == \
        params["layers"]["attn"]["wq"][2].data_ptr()
    copy = tree_map(lambda _, x: x + 1.0, view)   # new storage
    TT.write_back_block_view(params, copy, 2)
    for path, x in tree_items(copy):
        whole = dict(tree_items(params))[path]
        assert torch.equal(whole[2:4] if path[0] == "layers" else whole, x)
    # a view that shares the masters' storage is already written back
    TT.write_back_block_view(params, view, 2)
    assert torch.equal(params["embed"]["table"], copy["embed"]["table"])


def test_markov_lm_is_a_copy():
    j = JMarkovLM(vocab_size=64, seed=7)
    tm = TMarkovLM(vocab_size=64, seed=7)
    assert np.array_equal(
        next(j.iterator(3, 9, seed=2)), next(tm.iterator(3, 9, seed=2)))


def test_train_cli_on_cpu(capsys):
    TLT.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
              "8", "--blocks", "2"])
    out = capsys.readouterr().out
    assert "mode=db" in out and "done" in out
    TLT.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
              "8", "--mode", "e2e", "--precision", "bf16"])
    assert "[e2e] 1 steps" in capsys.readouterr().out
