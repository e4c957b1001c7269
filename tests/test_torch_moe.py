"""PyTorch port: the MoE family (phi3.5-moe-42b-a6.6b's ``DecoderModel``
with MoE layers) against the JAX package on the CPU.

``reduced(phi3.5-moe-42b-a6.6b)``: 2 layers, d = 256, 4 heads of 64 on 1
KV head (the published 32:8), 4 experts of d_ff 1024, top 2, capacity
factor 1.25, LayerNorm, swiglu, vocabulary 512; 2 blocks of 1 layer. The
JAX init is bridged to the port (``params_from_jax``: the expert stacks
(layers, E, d, ff) and (layers, E, ff, d) and the router) with the AdaLN
heads and the LayerNorm gains and biases randomised (at init they are the
identity and would test nothing) and the experts redrawn at a layer's
fan-in scale; σ and ε are drawn on the JAX side the
way ``block_loss`` draws them and handed to the port, and the serving
draws are JAX's. The port runs ``impl="kernels"``, whose wrappers take
their plain versions on CPU tensors; JAX runs its plain path
(``impl="auto"``). Tolerance 1e-4 (atol and rtol) on ``moe_fwd``'s output,
aux loss and gradients, on losses (the weighted aux in them), gradients,
moments and updated params, all fp32; greedy tokens and the batcher's logs
must be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous import queue, run_both
from test_torch_gqa_train import _assert_step_close
from test_torch_serve import jax_z_draws, models

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.launch import serve as JS
from repro.nn import moe as JM
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import serve as TS
from repro_torch.launch import train as TLT
from repro_torch.models import build_model
from repro_torch.models.transformer import DecoderModel
from repro_torch.nn import moe as TM
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)
TOL = 1e-4
ARCH = "phi3.5-moe-42b-a6.6b"
CFG = JC.reduced(JC.get_config(ARCH))
T_CFG = TC.reduced(TC.get_config(ARCH))
MOE = CFG.moe
B, SEQ = 2, 24
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def test_reduced_config_keeps_the_moe_under_test():
    assert dataclasses.asdict(T_CFG) == dataclasses.asdict(CFG)
    assert CFG.family == "moe" and CFG.norm == "layernorm"
    assert (MOE.num_experts, MOE.top_k, MOE.capacity_factor) == (4, 2, 1.25)
    assert (CFG.n_heads, CFG.n_kv_heads, CFG.head_dim) == (4, 1, 64)


def _models(mode="concat", loss="ce"):
    db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1, causal_mode=mode,
                     loss=loss)
    return JDBM(CFG, db), TDBM(T_CFG, TC.DBConfig(**dataclasses.asdict(db)))


@functools.cache
def _tree():
    """The JAX init as numpy, AdaLN heads and LayerNorm gains and biases
    randomised, the experts redrawn. Read-only for callers."""
    jdbm, _ = _models()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        for k, base in (("g", 1.0), ("b", 0.0)):
            lay[ln][k] = (base + 0.1 * rs.randn(*lay[ln][k].shape)
                          ).astype(np.float32)
    # the experts at a layer's fan-in scale (the stacked init's fan-in
    # counts the layer and expert axes, which leaves them 3x smaller)
    moe = lay["moe"]
    for k, fan_in in (("wi", CFG.d_model), ("wg", CFG.d_model),
                      ("wo", CFG.d_ff)):
        moe[k] = (rs.randn(*moe[k].shape) / np.sqrt(fan_in)).astype(
            np.float32)
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


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def _moe_params(seed, skew=0.0):
    """One layer's MoE params (numpy), the router's expert 0 column raised
    by ``skew`` (a skewed router overfills expert 0)."""
    rs = np.random.RandomState(seed)
    d, ff, E = CFG.d_model, CFG.d_ff, MOE.num_experts
    p = {"router": {"w": rs.randn(d, E) / np.sqrt(d)},
         "wi": rs.randn(E, d, ff) / np.sqrt(d),
         "wg": rs.randn(E, d, ff) / np.sqrt(d),
         "wo": rs.randn(E, ff, d) / np.sqrt(ff)}
    p["router"]["w"][:, 0] += skew
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)


def _dropped(params, x):
    """(picks past capacity, picks) of the port's routing of x."""
    _, gates, _, pos, cap = TM.route(
        {"router": {"w": t(params["router"]["w"])}}, t(x), MOE)
    sel = gates > 0
    return int((sel & (pos >= cap)).sum()), int(sel.sum())


@pytest.mark.parametrize("shape,skew", [((2, 300), 0.0), ((3, 20), 0.5),
                                        ((3, 1), 0.0)])
def test_moe_fwd_matches_jax(shape, skew):
    """``moe_fwd``'s output and aux loss, and the gradients of x and of
    every param, within 1e-4 of JAX's. 600 tokens shrink the group from
    512 to 8 (600 = 8 x 75: capacity 5 a group); 60 tokens are one group
    (capacity 37) under a router skewed to expert 0; 3 tokens (a decode
    batch of 3 slots) give capacity int(1.25 x 2 x 3 / 4) = 1 for 6 picks.
    Each case drops picks past capacity."""
    params = _moe_params(5, skew)
    rs = np.random.RandomState(6)
    # a mean of 1 under the skewed router: expert 0 is every token's pick
    x = (rs.randn(*shape, CFG.d_model) + (skew > 0)).astype(np.float32)
    dout = rs.randn(*shape, CFG.d_model).astype(np.float32)
    dropped, picks = _dropped(params, x)
    assert 0 < dropped < picks

    @jax.jit
    def f(p, x_, dout_):
        out, vjp = jax.vjp(lambda p2, x2: JM.moe_fwd(p2, x2, MOE, "swiglu"),
                           p, x_)
        return out, vjp((dout_, jnp.ones((), jnp.float32)))
    (want, want_aux), (jg, jgx) = f(jparams(params), jnp.asarray(x),
                                    jnp.asarray(dout))
    tp = params_from_jax(params, "cpu", TM.moe_spec(
        CFG.d_model, CFG.d_ff, MOE, "swiglu"))
    leaves = [v.requires_grad_() for _, v in tree_items(tp)]
    tx = t(x).requires_grad_()
    got, aux = TM.moe_fwd(tp, tx, MOE, "swiglu")
    close(got, want)
    close(aux, want_aux)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    grads = torch.autograd.grad((got * t(dout)).sum() + aux,
                                leaves + [tx])
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for (path, _), g in zip(tree_items(tp), grads):
        close(g, want_g[path])
    close(grads[-1], jgx)


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    """Equal probabilities pick the lower expert, as ``jax.lax.top_k``: a
    uniform router picks experts 0 and 1; with expert 0 on top and 1 and 3
    tied for second, expert 1. The same experts as JAX's get a gate, and
    the gates and aux agree within 1e-4."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.2, 0.2], [0.2, 0.2, 0.3, 0.3]],
                     np.float32)
    vals, idx = TM.top_k(t(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    d, E = CFG.d_model, MOE.num_experts
    c = np.abs(np.random.RandomState(7).randn(d)).astype(np.float32) / d
    x = np.abs(np.random.RandomState(8).randn(1, 6, d)).astype(np.float32)
    for w in (np.zeros((d, E), np.float32),
              np.stack([2 * c, c, -c, c], axis=1)):
        logits = x @ w
        assert (logits[..., 1] == logits[..., 3]).all()
        got, aux = TM.top_k_gating(t(logits), 2)
        want, want_aux = JM._top_k_gating(jnp.asarray(logits), 2)
        np.testing.assert_array_equal(got.numpy() > 0,
                                      np.asarray(want) > 0)
        close(got, want)
        close(aux, want_aux)
        assert (got[..., 3] == 0).all() and (got[..., 1] > 0).all()


def test_bridge_carries_the_expert_stacks_bit_for_bit():
    """``params_from_jax`` takes the MoE tree: ``moe/wi``, ``wg`` (layers,
    E, d, ff), ``wo`` (layers, E, ff, d) and ``router/w`` (layers, d, E),
    every value kept, and no ``mlp``; back to numpy equal."""
    _, tdbm = _models()
    assert isinstance(tdbm.model, DecoderModel) and tdbm.model.is_moe
    tree = _tree()
    params = tparams(tdbm, tree)
    moe = params["layers"]["moe"]
    L, E, d, ff = CFG.n_layers, MOE.num_experts, CFG.d_model, CFG.d_ff
    assert tuple(moe["wi"].shape) == tuple(moe["wg"].shape) == (L, E, d, ff)
    assert tuple(moe["wo"].shape) == (L, E, ff, d)
    assert tuple(moe["router"]["w"].shape) == (L, d, E)
    assert "mlp" not in params["layers"]
    for name in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(moe[name].numpy(),
                                      tree["layers"]["moe"][name])
    back = dict(tree_items(params_to_numpy(params)))
    for path, x in tree_items(tree):
        np.testing.assert_array_equal(back[path], x)


def test_build_model_takes_moe_and_the_xlstm():
    """``build_model`` builds the MoE as a ``DecoderModel`` and the xLSTM
    as an ``XLSTMModel`` of (sLSTM, mLSTM) units."""
    model = build_model(T_CFG)
    assert isinstance(model, DecoderModel) and model.is_moe
    assert "cond" not in model.spec
    xl = build_model(TC.reduced(TC.get_config("xlstm-125m")))
    assert type(xl).__name__ == "XLSTMModel"
    assert xl.n_units == 1 and sorted(xl.spec["units"]) == ["mlstm", "slstm"]


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 0),
                                         ("two_pass", "l2", 1)])
def test_block_loss_and_grads_match_jax(mode, loss, b):
    """``block_loss`` under concat x CE (block 0) and two_pass x l2 (block
    1, both streams routed): the loss with ``router_aux_weight * aux`` in
    it, ``metrics["loss"]`` and ``metrics["aux"]``, and the gradient of
    every param (the routers' included; None where the block does not read
    it, as JAX's zeros) within 1e-4 of JAX's."""
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
    for k in ("loss", "aux", "sigma_mean"):
        close(tm[k], jm[k])
    assert 0 < float(tm["aux"].detach()) and float(got.detach()) > float(
        tm["loss"].detach())
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    seen = set()
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want_g[path]), path
        else:
            close(g, want_g[path])
            seen.add(path[:3])
    assert ("layers", "moe", "router") in seen


@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 1),
                                         ("two_pass", "l2", 0)])
def test_db_train_step_matches_jax(mode, loss, b):
    """One fp32 DB step (concat x CE on block 1, two_pass x l2 on block 0)
    from shared params and draws: loss, AdamW moments and updated params
    within 1e-4 of JAX's (as ``_assert_step_close`` holds them); the other
    block's layer untouched."""
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
    _, opt2, loss_, m = t_step(params, t_init(params), t(tokens),
                               sigma=sigma, eps=eps)
    close(loss_, jloss)
    assert "aux" in m
    start, size = tdbm.ranges[b]
    _assert_step_close(params, opt2, jp2, jopt2, (start, size))
    other = 1 - b
    assert torch.equal(params["layers"]["moe"]["wi"][other],
                       before[("layers", "moe", "wi")][other])


def test_e2e_train_step_matches_jax():
    """One fp32 end-to-end step: loss (the weighted aux of both layers in
    it), moments and updated params within 1e-4 of JAX's."""
    jdbm, tdbm = _models()
    tree, tokens = _tree(), _tokens()
    j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                            precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens),
                                  jax.random.PRNGKey(0))
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_e2e_train_step(tdbm, TCFG, precision="fp32")
    params, opt2, loss_, m = t_step(params, t_init(params), t(tokens))
    close(loss_, jloss)
    assert float(loss_) > float(m["ce"])
    _assert_step_close(params, opt2, jp2, jopt2)


@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_train_cli_takes_phi(capsys, mode):
    """``launch.train --arch phi3.5-moe-42b-a6.6b`` on the CPU (reduced,
    bf16 policy): finite losses through the plain versions."""
    TLT.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
              "--precision", "bf16", "--steps", "2", "--batch", "2",
              "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "done" in out and "nan" not in out


# ---------------------------------------------------------------------------
# Serving: the static engine and the batcher
# ---------------------------------------------------------------------------

@functools.cache
def serve_pair():
    return models(CFG, blocks=2)


def test_static_engine_greedy_matches_jax():
    """``generate`` over ragged prompts (chunked prefill, then decode):
    fp32 greedy tokens identical to JAX's engine. Each decode step routes
    the 3 slots' probe and commit tokens through capacity max(int(1.25 x
    2 x 3 / 4), 1) = 1 an expert, as JAX's does."""
    jdbm, jp, tdbm, tp = serve_pair()
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, CFG.vocab_size, size=(3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    want = JS.generate(jdbm, jp, jnp.asarray(prompts), 5,
                       rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                       precision="fp32", chunk_size=4)
    z0 = jax_z_draws(5, CFG.d_model, jdbm.db.sigma_max)
    got = TS.generate(tdbm, tp, prompts, 5, prompt_lengths=plens,
                      precision="fp32", chunk_size=4, z0=torch.from_numpy(z0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prefill", ["chunked", "per-token"])
def test_batcher_logs_match_jax(prefill):
    """Six ragged requests on 2 slots through both batchers under JAX's
    draws: per-step logs (slots, counters, free list, refcounts) and
    greedy tokens identical. Inactive slots and the probe's rows compete
    for capacity with the live ones, in both packages."""
    run_both(serve_pair(), queue(CFG, 6, seed=4), num_slots=2,
             prefill=prefill)
