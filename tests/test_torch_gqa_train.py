"""PyTorch port: h2o-danube3-4b's training (head dim 120, 4 query heads a
KV head, a sliding window) against the JAX package on the CPU.

Reduced h2o-danube-3-4b: 2 layers, d = 480, 4 heads of 120 on 1 KV head
(the published 32:8), window 64, vocabulary 512; 2 blocks of 1 layer.
Sequences of 96 tokens, so the window binds on the e2e step's causal
stream and on both halves of a DB step. The JAX init is bridged to the
port (``params_from_jax``, the GQA tree leaf by leaf) with the AdaLN heads
and norm gains randomised (at init they are the identity and would test
nothing); σ and ε are drawn on the JAX side the way ``block_loss`` draws
them and handed to the port. The port runs ``impl="kernels"``, whose
wrappers take their plain versions on CPU tensors; JAX runs its plain path
(``impl="auto"``: naive attention at these sizes) for the losses and
steps, and its Pallas kernels (interpret mode) for attention alone.
Tolerance 1e-4 (atol and rtol) on losses, gradients, updated params and
AdamW moments, all fp32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.models import common as JCOM
from repro.nn import attention as JA
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as TLT
from repro_torch.models import common as TCOM
from repro_torch.nn import attention as TA
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)
TOL = 1e-4
ARCH = "h2o-danube-3-4b"
CFG = JC.reduced(JC.get_config(ARCH), n_layers=2, d_model=480, n_heads=4)
B, SEQ = 2, 96
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def test_reduced_config_keeps_the_shapes_under_test():
    assert (CFG.head_dim, CFG.n_heads, CFG.n_kv_heads) == (120, 4, 1)
    assert CFG.sliding_window == 64 < SEQ
    assert 120 in FA.HEAD_DIMS[torch.float32]
    assert 120 in FA.HEAD_DIMS[torch.bfloat16]


def _models(mode="concat", loss="ce"):
    db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1, causal_mode=mode,
                     loss=loss)
    return JDBM(CFG, db), TDBM(TC.ModelConfig(**dataclasses.asdict(CFG)),
                               TC.DBConfig(**dataclasses.asdict(db)))


@functools.cache
def _tree():
    """The JAX init as numpy, AdaLN heads and norm gains randomised.
    Read-only for callers."""
    jdbm, _ = _models()
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
    return tree


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def _tokens():
    return np.random.RandomState(1).randint(0, CFG.vocab_size, (B, SEQ))


def draws(jdbm, b, rng):
    """σ (B,1,1) and ε (B,S,d) as ``block_loss`` draws them from ``rng``."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, SEQ, CFG.d_model), jnp.float32)
    return t(sigma), t(eps)


def _assert_tree_close(got_np, want_np):
    want = dict(tree_items(want_np))
    got = dict(tree_items(got_np))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path])


def _assert_step_close(params, opt, jp2, jopt, unit_range=None):
    """The AdamW moments within 1e-4 of JAX's, and the updated params
    within 1e-4 wherever the gradient is 0 or at least 1e-6 (JAX's first
    moment, 0.1 g, 0 or at least 1e-7). Between, the first step's update
    lr g / (|g| + 1e-8) turns gradients that agree to 1e-9 into updates
    1e-4 apart (a slope up to lr / 4e-8 = 2.5e4), so those elements (at
    most 1 in 20: 0.5-3.5% here, most of them in the AdaLN heads) are held
    to their moments and to the step's own bound, |update| <= lr, on both
    sides.
    ``unit_range`` (start, size): the block a DB step trains, whose rows of
    the stacked layers the moments cover."""
    _assert_tree_close(params_to_numpy(opt.mu),
                       jax.tree_util.tree_map(np.asarray, jopt.mu))
    _assert_tree_close(params_to_numpy(opt.nu),
                       jax.tree_util.tree_map(np.asarray, jopt.nu))
    got = dict(tree_items(params_to_numpy(params)))
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jp2)))
    mu = dict(tree_items(jax.tree_util.tree_map(np.asarray, jopt.mu)))
    assert sorted(got) == sorted(want)
    small = total = 0
    for path, w in want.items():
        g = got[path]
        if path[0] == "layers" and unit_range is not None:
            start, size = unit_range
            close(np.delete(g, np.s_[start:start + size], 0),
                  np.delete(w, np.s_[start:start + size], 0))
            g, w = g[start:start + size], w[start:start + size]
        well = (mu[path] == 0) | (np.abs(mu[path]) >= 1e-7)
        close(g[well], w[well])
        assert (np.abs(g - w)[~well] <= 2 * TCFG.lr).all(), path
        small += int((~well).sum())
        total += well.size
    assert small <= 0.05 * total, (small, total)


# ---------------------------------------------------------------------------
# The GQA tree and attention at hd 120
# ---------------------------------------------------------------------------

def test_bridge_takes_the_gqa_tree():
    """The JAX tree bridges leaf by leaf: the K/V projections 1 head of 120
    wide against 4 query heads, every value kept, and back to numpy equal."""
    _, tdbm = _models()
    tree = _tree()
    params = tparams(tdbm, tree)
    attn = params["layers"]["attn"]
    assert tuple(attn["wq"].shape) == (2, 480, 4 * 120)
    assert tuple(attn["wk"].shape) == tuple(attn["wv"].shape) == (2, 480,
                                                                  120)
    back = dict(tree_items(params_to_numpy(params)))
    for path, x in tree_items(tree):
        np.testing.assert_array_equal(back[path], x)


@pytest.mark.parametrize("mask", ["window", "db_concat", "two_pass"])
def test_attend_matches_pallas_at_hd120_gqa(mask):
    """``attend`` under each mask the h2o training path sends (window 64 on
    96 tokens, db_concat of 2 x 96, two_pass: 96 queries over 2 x 96 keys):
    out and the gradients of q, k, v against JAX's Pallas kernels
    (interpret mode) on the same inputs, 4 query heads on 1 KV head."""
    S = SEQ
    jm, tm, sq, sk = {
        "window": (JA.sliding_window_mask(64), TA.sliding_window_mask(64),
                   S, S),
        "db_concat": (JA.db_concat_mask(S), TA.db_concat_mask(S), 2 * S,
                      2 * S),
        "two_pass": (JCOM.two_pass_mask(S), TCOM.two_pass_mask(S), S,
                     2 * S)}[mask]
    assert tm.kernel_mask == jm.kernel_mask
    rs = np.random.RandomState(12)
    q = rs.randn(B, sq, 4, 120).astype(np.float32)
    k = rs.randn(B, sk, 1, 120).astype(np.float32)
    v = rs.randn(B, sk, 1, 120).astype(np.float32)
    do = rs.randn(B, sq, 4, 120).astype(np.float32)
    qpos, kpos = np.arange(sq), np.arange(sk)
    f = lambda q_, k_, v_: JA.attend(  # noqa: E731
        q_, k_, v_, mask_mod=jm, qpos=jnp.asarray(qpos),
        kpos=jnp.asarray(kpos), impl="kernels")
    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    got = TA.attend(tq, tk, tv, mask_mod=tm, qpos=t(qpos), kpos=t(kpos),
                    impl="kernels")
    close(got, want)
    got.backward(t(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), grads):
        close(g, w)


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 0),
                                         ("two_pass", "l2", 1)])
def test_block_loss_and_grads_match_jax(mode, loss, b):
    """``block_loss`` under concat x CE (the first block) and two_pass x l2
    (the last): the loss and the gradient of every param (None where the
    block does not read it, as JAX's zeros) within 1e-4 of JAX's. The DB
    steps below take the other block of each mode."""
    jdbm, tdbm = _models(mode, loss)
    tree, tokens = _tree(), _tokens()
    rng = jax.random.PRNGKey(10 + b)
    jl = lambda p: jdbm.block_loss(p, b, jnp.asarray(tokens), rng)  # noqa: E731
    (want, jm), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jparams(tree))
    sigma, eps = draws(jdbm, b, rng)
    params = tparams(tdbm, tree)
    leaves = [x.requires_grad_() for _, x in tree_items(params)]
    got, tm = tdbm.block_loss(params, b, t(tokens), sigma=sigma, eps=eps)
    close(got, want)
    close(tm["sigma_mean"], jm["sigma_mean"])
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want_g[path]), path
        else:
            close(g, want_g[path])


@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 1),
                                         ("two_pass", "l2", 0)])
def test_db_train_step_matches_jax(mode, loss, b):
    """One fp32 DB step (concat x CE on the last block, two_pass x l2 on
    the first) from shared params and draws: loss, the
    AdamW moments and the updated params within 1e-4 of JAX's (the params
    as ``_assert_step_close`` holds them); the other block's layers
    untouched, and no moment exists for them."""
    jdbm, tdbm = _models(mode, loss)
    tree, tokens = _tree(), _tokens()
    rng = jax.random.PRNGKey(20 + b)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="auto",
                                           precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens), rng)

    params = tparams(tdbm, tree)
    before = {p: x.clone() for p, x in tree_items(params)}
    t_init, t_step = TT.make_db_train_step(tdbm, b, TCFG, precision="fp32")
    sigma, eps = draws(jdbm, b, rng)
    params2, opt2, loss_, _ = t_step(params, t_init(params), t(tokens),
                                     sigma=sigma, eps=eps)
    assert params2 is params
    close(loss_, jloss)
    start, size = tdbm.ranges[b]
    _assert_step_close(params, opt2, jp2, jopt2, (start, size))
    for path, x in tree_items(opt2.mu["layers"]):
        assert x.shape[0] == size, path
    for path, x in tree_items(params):
        if path[0] == "layers":
            outside = torch.ones(x.shape[0], dtype=torch.bool)
            outside[start:start + size] = False
            assert torch.equal(x[outside], before[path][outside]), path


def test_e2e_train_step_matches_jax():
    """One fp32 end-to-end step over 96 tokens (the window of 64 binds):
    loss, moments and updated params within 1e-4 of JAX's (as
    ``_assert_step_close`` holds them)."""
    jdbm, tdbm = _models()
    tree, tokens = _tree(), _tokens()
    j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                            precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens),
                                  jax.random.PRNGKey(0))
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_e2e_train_step(tdbm, TCFG, precision="fp32")
    params, opt2, loss_, _ = t_step(params, t_init(params), t(tokens))
    close(loss_, jloss)
    _assert_step_close(params, opt2, jp2, jopt2)


@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_train_cli_takes_h2o(capsys, mode):
    """``launch.train --arch h2o-danube-3-4b`` on the CPU (reduced, bf16
    policy): finite losses through the plain versions."""
    TLT.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
              "--precision", "bf16", "--steps", "2", "--batch", "2",
              "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "done" in out and "nan" not in out
