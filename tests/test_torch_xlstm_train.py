"""PyTorch port: the xLSTM family's (xlstm-125m) training path against the
JAX package on the CPU.

``repro_torch.nn.xlstm``'s sequence forms (``_mlstm_parallel``,
``_mlstm_chunked``, ``_mlstm_hist_raw``, ``mlstm_fwd``, ``mlstm_two_pass``,
``slstm_fwd``, ``slstm_two_pass``) and ``XLSTMModel``'s training half (the
uncached ``apply_units`` in the ``train`` mode, ``apply_units_two_pass``),
on numpy-seeded inputs and the bridged params of ``reduced(xlstm-125m)`` cut
to 4 layers (``tests/test_torch_xlstm.py``'s ``xlstm_models``: 2 units in 2
blocks, d 256, 4 heads, mLSTM head dim 128, sLSTM head dim 64; AdaLN heads,
norms and gate biases randomised), fp32. σ and ε are drawn on the JAX side
and handed to the port.

Held to JAX: the sequence forms' values and final states within 1e-5, the
gradients of a scalar of each (its outputs against random cotangents over
the B * S tokens) with respect to the inputs and every param within 1e-4,
each leaf also to its own largest magnitude (``grad_close``); ``apply_units`` and
``apply_units_two_pass`` h within 1e-4; ``block_loss`` (two_pass x ce of
block 0, at S 12 and at S 520 > 512 on a d-32 model, which takes the
chunked branch and the chunked strict-history query): the loss and every
grad leaf within 1e-4; one DB step (two_pass x l2, block 1) and one e2e
step: the loss, the grad norm, every clipped grad leaf of ``block_loss``
and ``e2e_loss`` (the first moments), the second moments and the updated
params within 1e-4 (``_step_close`` says which elements of the params are
held to the update's bound and sign instead). A ``concat`` config routes to
two-pass, as in JAX, and the dense-cache ``prefill`` mode returns the
units' final states. ``tests/test_ssm_xlstm.py``'s identities hold in the port: the
parallel, chunked and recurrent forms agree, and the two-pass noisy stream
fed the clean one gives the clean output. The train CLI runs the family
reduced in both modes. JAX's side runs jitted: its compiles are most of
the file's time.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid_train import _draws, _tokens
from test_torch_xlstm import _cell, xlstm_models

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.nn import xlstm as JX
from repro_torch import configs as TC
from repro_torch.bridge import params_to_numpy
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import train as TTRAIN
from repro_torch.nn import cache as TKVC
from repro_torch.nn import xlstm as TX
from repro_torch.nn.init import tree_items
from repro_torch.optim import warmup_cosine

torch.set_num_threads(1)
B = 2
H = 4
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
XCFG = TC.XLSTMConfig()


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def grad_close(got, want):
    """A gradient leaf within 1e-4 of JAX's element by element (atol and
    rtol), and its largest gap within 1e-4 of its largest magnitude, so a
    leaf of small values is held to its own scale."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, (
        float(np.abs(got - want).max()), scale)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def xl():
    return xlstm_models()


def _flat(out):
    """The tensors of a (nested) tuple of outputs, Nones dropped."""
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [] if out is None else [out]


def _held_to_jax(jfn, tfn, inputs, tree=None, seed=0):
    """``jfn(params, *inputs)`` and ``tfn(params, *inputs)`` (params
    ``tree``, numpy, or None) on the same numpy inputs (B x S first): every
    output within 1e-5, and the gradients of sum(output x cotangent) over
    the outputs with respect to every input and param within 1e-4
    (``grad_close``). The cotangents are random over B * S, as a loss
    averaged over the tokens hands them back, so the gradients are O(1),
    as in training. JAX's side runs jitted."""
    rs = np.random.RandomState(seed)
    args = (jax.tree_util.tree_map(jnp.asarray, tree),
            *(jnp.asarray(x) for x in inputs))
    shapes, struct = jax.tree_util.tree_flatten(jax.eval_shape(jfn, *args))
    tokens = np.prod(inputs[0].shape[:2])
    cots = [(rs.randn(*x.shape) / tokens).astype(np.float32)
            for x in shapes]

    @jax.jit
    def run(args, cots):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(jax.tree_util.tree_unflatten(struct, cots))
    jout, jgrads = run(args, [jnp.asarray(c) for c in cots])
    jleaves = jax.tree_util.tree_leaves(jout)
    tp = (None if tree is None else
          jax.tree_util.tree_map(lambda a: t(a).requires_grad_(), tree))
    tins = [t(x).requires_grad_() for x in inputs]
    touts = _flat(tfn(tp, *tins))
    assert len(touts) == len(jleaves)
    for got, want in zip(touts, jleaves):
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want, VAL_TOL)
    pleaves = [] if tp is None else [x for _, x in tree_items(tp)]
    grads = torch.autograd.grad(touts, pleaves + tins,
                                [t(c) for c in cots])
    if tree is not None:
        want = dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                      jgrads[0])))
        for (path, _), g in zip(tree_items(tp), grads):
            grad_close(g, want[path])
    for g, w in zip(grads[len(pleaves):], jgrads[1:]):
        assert bool(torch.isfinite(g).all())
        grad_close(g, w)


def _qkv(S, seed, hd=32):
    """q, k, v (B, S, H, hd), log i and log f (B, S, H), numpy fp32: log f
    a log-sigmoid of forget logits about 2, as a trained gate holds."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, hd).astype(np.float32) for _ in range(3))
    log_i = rs.randn(B, S, H).astype(np.float32)
    log_f = -np.log1p(np.exp(-(2.0 + rs.randn(B, S, H)))).astype(np.float32)
    return [q, k, v, log_i, log_f]


# ---------------------------------------------------------------------------
# The sequence forms
# ---------------------------------------------------------------------------

MLSTM_FORMS = {
    "parallel": lambda X: lambda p, *a: X._mlstm_parallel(*a),
    "chunked 8": lambda X: lambda p, *a: X._mlstm_chunked(*a, chunk=8),
    "chunked 256": lambda X: lambda p, *a: X._mlstm_chunked(*a),
    "hist 8": lambda X: lambda p, *a: X._mlstm_hist_raw(*a, chunk=8),
    "hist 256": lambda X: lambda p, *a: X._mlstm_hist_raw(*a),
}


@pytest.mark.parametrize("form", sorted(MLSTM_FORMS))
def test_mlstm_sequence_form_matches_jax(form):
    """The quadratic form, the chunked form (a chunk of 8, S 37 not a
    multiple of it; and the default 256, S padded) with its final state,
    and the strict-history query (num, den, m; row 0 has no history, m
    -1e30), at head dim 32: values and final states within 1e-5, the
    gradients of every input within 1e-4, all finite."""
    make = MLSTM_FORMS[form]
    _held_to_jax(make(JX), make(TX), _qkv(37, len(form)))


def _x(S, d, seed, n=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, d).astype(np.float32) for _ in range(n)]


def _np_cell(xl, kind):
    return jax.tree_util.tree_map(np.asarray, _cell(xl, kind)[0])


@pytest.mark.parametrize("branch", ["parallel", "chunked"])
def test_mlstm_fwd_matches_jax(xl, branch):
    """``mlstm_fwd`` on the bridged cell params (d 256, d_in 512) in both
    of JAX's branches: parallel (S <= 512, no state asked for) and chunked
    (``return_state``, its final state too). Values within 1e-5, the
    gradients of every param and of x within 1e-4."""
    rs = branch == "chunked"
    fn = lambda X, c: lambda p, x: X.mlstm_fwd(  # noqa: E731
        p, x, H, c, return_state=rs)
    _held_to_jax(fn(JX, JC.XLSTMConfig()), fn(TX, XCFG), _x(21, 256, 4),
                 _np_cell(xl, "mlstm"))


def test_mlstm_two_pass_matches_jax(xl):
    """``mlstm_two_pass``: both streams within 1e-5, the gradients of every
    param and of both inputs within 1e-4."""
    fn = lambda X, c: lambda p, a, b: X.mlstm_two_pass(  # noqa: E731
        p, a, b, H, c)
    _held_to_jax(fn(JX, JC.XLSTMConfig()), fn(TX, XCFG), _x(21, 256, 5, 2),
                 _np_cell(xl, "mlstm"))


def test_slstm_fwd_matches_jax(xl):
    """``slstm_fwd`` with ``return_states``: the output, the final state
    and the state after every step within 1e-5; the gradients of every
    param and of x within 1e-4."""
    fn = lambda X, c: lambda p, x: X.slstm_fwd(  # noqa: E731
        p, x, H, c, return_states=True)
    _held_to_jax(fn(JX, JC.XLSTMConfig()), fn(TX, XCFG), _x(13, 256, 6),
                 _np_cell(xl, "slstm"))


def test_slstm_two_pass_matches_jax(xl):
    """``slstm_two_pass`` (the noisy cell over the S x B shifted states):
    both streams within 1e-5, the gradients of every param and of both
    inputs within 1e-4."""
    fn = lambda X, c: lambda p, a, b: X.slstm_two_pass(  # noqa: E731
        p, a, b, H, c)
    _held_to_jax(fn(JX, JC.XLSTMConfig()), fn(TX, XCFG), _x(13, 256, 7, 2),
                 _np_cell(xl, "slstm"))


# ---------------------------------------------------------------------------
# tests/test_ssm_xlstm.py's identities, in the port
# ---------------------------------------------------------------------------

def test_mlstm_parallel_chunked_recurrent_agree():
    """The quadratic, chunked (chunk 8) and recurrent forms give the same
    h within 5e-5 (the bound JAX's own test holds)."""
    q, k, v, li, lf = map(t, _qkv(37, 11, hd=16))
    y_par = TX._mlstm_parallel(q, k, v, li, lf)
    y_chk, _ = TX._mlstm_chunked(q, k, v, li, lf, chunk=8)
    close(y_chk, y_par.numpy(), 5e-5)
    st = TX.mlstm_init_state(B, H, H * 16, device="cpu")
    ys = []
    for i in range(37):
        st, y = TX._mlstm_recurrent_step(st, q[:, i], k[:, i], v[:, i],
                                         li[:, i], lf[:, i])
        ys.append(y)
    close(torch.stack(ys, 1), y_par.numpy(), 5e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_two_pass_identity(xl, kind):
    """Noisy == clean: both streams of the two-pass function give the
    clean forward's output (1e-5 clean, 1e-4 noisy, JAX's bounds), and the
    sLSTM's forward equals its decode steps token by token (2e-5)."""
    p = _cell(xl, kind)[1]
    x = t(_x(24, 256, 12)[0])
    y = getattr(TX, f"{kind}_fwd")(p, x, H, XCFG)[0]
    yc, yn = getattr(TX, f"{kind}_two_pass")(p, x, x, H, XCFG)
    close(yc, y.numpy(), 1e-5)
    close(yn, y.numpy(), 1e-4)
    if kind == "slstm":
        st = TX.slstm_init_state(B, H, 256, device="cpu")
        ys = []
        for i in range(24):
            yt, st = TX.slstm_decode_step(p, x[:, i:i + 1], H, XCFG, st)
            ys.append(yt)
        close(torch.cat(ys, 1), y.numpy(), 2e-5)


# ---------------------------------------------------------------------------
# The model's units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["train", "two_pass"])
def test_apply_units_match_jax(xl, which):
    """The uncached ``apply_units`` (``train``, no σ: plain residuals) and
    ``apply_units_two_pass`` (σ-modulated and gated noisy stream) over both
    units: h within 1e-4 of JAX's."""
    jdbm, jparams, tdbm, tparams = xl
    xc, xn = _x(17, 256, 13, 2)
    sig = np.array([0.7, 3.0], np.float32).reshape(B, 1, 1)
    n = tdbm.model.n_units
    if which == "train":
        jctx = jdbm.make_ctx(jparams, 17, "train")
        jh, _, _ = jdbm.model.apply_units(jparams, jnp.asarray(xc), 0, n,
                                          jctx)
        th, _ = tdbm.model.apply_units(tparams, t(xc), 0, n,
                                       tdbm.make_ctx(tparams, 17, "train"))
        close(th, jh, 1e-4)
        return
    jctx = jdbm.make_ctx(jparams, 17, "train", jnp.asarray(sig))
    jc, jn, _ = jdbm.model.apply_units_two_pass(
        jparams, jnp.asarray(xc), jnp.asarray(xn), 0, n, jctx)
    tctx = tdbm.make_ctx(tparams, 17, "train", t(sig))
    tc, tn = tdbm.model.apply_units_two_pass(tparams, t(xc), t(xn), 0, n,
                                             tctx)
    close(tc, jc, 1e-4)
    close(tn, jn, 1e-4)


# ---------------------------------------------------------------------------
# The losses and the steps
# ---------------------------------------------------------------------------

TINY_LONG = TC.reduced(TC.get_config("xlstm-125m"), n_layers=2, d_model=32)


def _port_models(tcfg, blocks):
    """The port's model on params from its own init (seed 0; the AdaLN
    heads randomised, 0.02) and JAX's on the same values."""
    db = TC.DBConfig(num_blocks=blocks, overlap_gamma=0.1)
    tdbm = TDBM(tcfg, db)
    g = torch.Generator().manual_seed(0)
    tparams = tdbm.init(g)
    for kind in ("slstm", "mlstm"):
        for k in ("w", "b"):
            tparams["units"][kind]["adaln"][k].normal_(0.0, 0.02,
                                                       generator=g)
    jcfg = JC.ModelConfig(**{f.name: getattr(tcfg, f.name)
                             for f in dataclasses.fields(tcfg)})
    jdbm = JDBM(jcfg, JC.DBConfig(**dataclasses.asdict(db)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tparams))
    return jdbm, jparams, tdbm, tparams


def _grads_match(loss, params, jgrads):
    leaves = [x for _, x in tree_items(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want[path]), path
        else:
            grad_close(g, want[path])


def _with_loss(models, loss):
    """``models`` with both sides' DBConfig.loss set to ``loss``."""
    jdbm, jparams, tdbm, tparams = models
    db = dataclasses.replace(jdbm.db, loss=loss)
    return (JDBM(jdbm.cfg, db), jparams,
            TDBM(tdbm.cfg, TC.DBConfig(**dataclasses.asdict(db))), tparams)


def _with_grad(params, on=True):
    for _, x in tree_items(params):
        x.requires_grad_(on)
    return params


@pytest.mark.parametrize("case", ["ce b0 S12", "ce b0 S520"])
def test_block_loss_matches_jax(xl, case):
    """``block_loss`` of block 0, routed to two-pass, on JAX's σ and ε: the
    loss and every param's gradient (zero outside the block's units and
    the periphery) within 1e-4. ``S520``: 520 tokens on a 2-layer d-32
    model (params from the port's init), so the clean mLSTM takes the
    chunked form and the history query spans 3 chunks of 256. Block 1 and
    the l2 loss: ``test_train_step_matches_jax``."""
    long = case.endswith("S520")
    models = _port_models(TINY_LONG, 1) if long else xl
    jdbm, jparams, tdbm, tparams = _with_loss(models, "ce")
    assert tdbm.causal_mode == jdbm.causal_mode == "two_pass"
    S = 520 if long else 12
    tokens = _tokens(jdbm.cfg, S=S, seed=S)
    rng = jax.random.PRNGKey(10)
    jl = jax.jit(jax.value_and_grad(
        lambda p: jdbm.block_loss(p, 0, jnp.asarray(tokens), rng,
                                  impl="auto")[0]))
    want, jg = jl(jparams)
    sigma, eps = _draws(jdbm, 0, rng, S)
    params = _with_grad(tparams)
    try:
        got, tm = tdbm.block_loss(params, 0, t(tokens), sigma=sigma,
                                  eps=eps)
        assert "ce" in tm
        close(got, want, GRAD_TOL)
        _grads_match(got, params, jg)
    finally:
        _with_grad(params, False)


def _fresh(xl):
    from repro_torch.bridge import params_from_jax
    jdbm, jparams, tdbm, _ = xl
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def _step_close(params, opt2, jp1, jp2, jopt2, view=None):
    """The first AdamW step's outputs against JAX's: every clipped
    gradient (the first moment over 1 - b1) and second moment within 1e-4,
    and every param within 1e-4 but where the gradient g is below 1e-7
    and not 0. The first update is lr g / (|g| + eps) (eps 1e-8) beside
    the weight decay: there it turns an fp32 rounding gap of 1e-9 in g
    into up to lr in the param, so those elements (0.16% in the e2e step,
    mostly the sLSTM's gate weights; asserted under 1%) are held to the
    step's own form on each side instead: from the params before the step
    ``jp1``, the update without its decay is at most lr and has the sign
    of that side's own g. ``view``: the DB step's (start, size) of the
    stacked units; the units outside it stay bit-unchanged."""
    b1, wd = TCFG.b1, TCFG.weight_decay
    lr = warmup_cosine(TCFG.lr, TCFG.warmup_steps, TCFG.steps)(1)
    before = dict(tree_items(jax.tree_util.tree_map(np.asarray, jp1)))
    want_p = dict(tree_items(jax.tree_util.tree_map(np.asarray, jp2)))
    want_mu = dict(tree_items(jax.tree_util.tree_map(np.asarray, jopt2.mu)))
    want_nu = dict(tree_items(jax.tree_util.tree_map(np.asarray, jopt2.nu)))
    got_mu, got_nu = dict(tree_items(opt2.mu)), dict(tree_items(opt2.nu))
    assert sorted(got_mu) == sorted(want_mu)
    for path in want_mu:
        close(got_mu[path] / (1 - b1), want_mu[path] / (1 - b1), GRAD_TOL)
        close(got_nu[path], want_nu[path], GRAD_TOL)
    n_loose, n_all = 0, 0
    for path, x in tree_items(params):
        got, want, p1 = x.detach().numpy(), want_p[path], before[path]
        g = want_mu[path] / (1 - b1)
        g_got = got_mu[path].numpy() / (1 - b1)
        if view is not None and path[0] == "units":
            start, size = view
            np.testing.assert_array_equal(got[:start], want[:start])
            np.testing.assert_array_equal(got[start + size:],
                                          want[start + size:])
            got, want = got[start:start + size], want[start:start + size]
            p1 = p1[start:start + size]
        sel = ~((g != 0) & (np.abs(g) < 1e-7))
        n_loose += int((~sel).sum())
        n_all += sel.size
        close(got[sel], want[sel], GRAD_TOL)
        for p2, gs in ((got, g_got), (want, g)):
            u = (p1 * (1 - lr * wd) - p2)[~sel]
            assert (np.abs(u) <= lr * (1 + 1e-3)).all(), path
            assert ((np.sign(u) == np.sign(gs[~sel]))
                    | (np.abs(u) <= 1e-6)).all(), path
    assert n_loose <= 1e-2 * n_all, (n_loose, n_all)


@pytest.mark.parametrize("kind", ["db l2 b1", "e2e"])
def test_train_step_matches_jax(xl, kind):
    """One fp32 DB step on block 1 with the l2 loss (its units and the
    periphery) and one e2e step, from the same params and draws: the loss,
    the grad norm, the AdamW moments (every grad leaf of ``block_loss`` and
    ``e2e_loss``, clipped) and the updated params within 1e-4 of JAX's
    ``core.training`` (as ``_step_close`` holds them)."""
    jdbm, jparams, tdbm, _ = _with_loss(xl, "l2")
    tokens = _tokens(jdbm.cfg, S=12, seed=5)
    tcfg = TC.TrainConfig(**dataclasses.asdict(TCFG))
    params = _fresh(xl)
    rng = jax.random.PRNGKey(30)
    if kind == "e2e":
        j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                                precision="fp32")
        t_init, t_step = TT.make_e2e_train_step(tdbm, tcfg,
                                                precision="fp32")
        kw = {}
    else:
        j_init, j_step = JT.make_db_train_step(jdbm, 1, TCFG, impl="auto",
                                               precision="fp32")
        t_init, t_step = TT.make_db_train_step(tdbm, 1, tcfg,
                                               precision="fp32")
        sigma, eps = _draws(jdbm, 1, rng, tokens.shape[1])
        kw = {"sigma": sigma, "eps": eps}
    jp2, jopt2, jloss, jm = j_step(jparams, j_init(jparams),
                                   jnp.asarray(tokens), rng)
    params, opt2, loss, tm = t_step(params, t_init(params), t(tokens), **kw)
    close(loss, jloss, GRAD_TOL)
    close(tm["grad_norm"], jm["grad_norm"], GRAD_TOL)
    _step_close(params, opt2, jparams, jp2, jopt2,
                None if kind == "e2e" else tdbm.ranges[1])
    if kind != "e2e":
        assert "l2" in jm and "l2" in tm
        size = tdbm.ranges[1][1]
        assert opt2.mu["units"]["mlstm"]["cell"]["wq"].shape[0] == size


def test_concat_config_routes_to_two_pass():
    """A ``DBConfig(causal_mode="concat")`` routes the family to two-pass,
    as JAX's ``_needs_two_pass`` does; the dense-cache ``prefill`` mode
    runs, returning the unit's final states in ``init_cache``'s layout."""
    db = JC.DBConfig(num_blocks=2, causal_mode="concat")
    jdbm = JDBM(JC.reduced(JC.get_config("xlstm-125m"), n_layers=4), db)
    tdbm = TDBM(TC.reduced(TC.get_config("xlstm-125m"), n_layers=4),
                TC.DBConfig(**dataclasses.asdict(db)))
    assert tdbm.causal_mode == jdbm.causal_mode == "two_pass"
    params = tdbm.init(torch.Generator().manual_seed(0))
    ctx = tdbm.make_ctx(params, 4, "prefill")
    _, states = tdbm.model.apply_units(params, torch.zeros(1, 4, 256), 0, 1,
                                       ctx)
    want = tdbm.model.init_cache(1, 4, size=1, device="cpu")
    assert [t.shape for t in TKVC.cache_tensors(states)] == \
        [t.shape for t in TKVC.cache_tensors(want)]


@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_train_cli_trains_the_xlstm(mode, capsys):
    """``python -m repro_torch.launch.train --arch xlstm-125m --mode db|e2e
    --device cpu --steps 2`` (reduced) trains with finite losses."""
    TTRAIN.main(["--arch", "xlstm-125m", "--mode", mode, "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "arch=xlstm-125m" in out
    assert f"[{mode}] 2 steps" in out and "done" in out
    first, last = re.search(r"first loss (\S+), last (\S+)", out).groups()
    assert np.isfinite(float(first)) and np.isfinite(float(last))
