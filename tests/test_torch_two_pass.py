"""PyTorch port: two-pass DiffusionBlocks training and the l2 (score
matching) loss against the JAX package on the CPU.

The fused AdaLN kernels (ln-modulate, gate-residual) and the EDM-loss
kernels: each plain version of the port (what its wrapper runs on a CPU
tensor) against the Pallas kernel in interpret mode, values and VJPs, with
JAX tiles of 64 rows so S = 130 covers a padded tile, and the (B, d)
vectors passed as strided column slices of a (B, 6d) head output, as the
model passes them. Tolerances: fp32 values 1e-5, fp32 gradients 1e-4; bf16
outputs within one bf16 rounding (2^-7 relative) of JAX's.

Then the two-pass path: ``two_pass_mask`` and ``attend`` under it, one
``tlayer_two_pass`` (reduced olmo-1b, non-parametric LN, and reduced
stablelm-1.6b, LayerNorm), ``block_loss`` in two_pass x {ce, l2} and
concat x l2, and one fp32 ``make_db_train_step`` per block for two_pass + l2
on reduced olmo-1b (loss, params and AdamW moments within 1e-4). JAX runs
``impl="kernels"`` (Pallas in interpret mode); σ and ε are drawn on the JAX
side the way ``block_loss`` draws them and handed to the port.
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
from repro.kernels import edm_loss as JEDM
from repro.kernels import fused_adaln as JAD
from repro.models import common as JCOM
from repro.nn import attention as JA
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.kernels import edm_loss as TEDM
from repro_torch.kernels import fused_adaln as TAD
from repro_torch.models import common as TCOM
from repro_torch.nn import attention as TA
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)
B, D = 2, 64
JBLK = 64                      # JAX tile rows: S=130 leaves a padded tile
BF16_REL = 2.0 ** -7


def close(got, want, atol, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _stream(rs, shape, dtype):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    x = rs.randn(*shape).astype(np.float32)
    if dtype == "bf16":
        x = _bf16(x)
        return jnp.asarray(x, jnp.bfloat16), t(x).bfloat16()
    return jnp.asarray(x), t(x)


def _slices(rs, n, scale=0.1, d=D):
    """n (B, d) column slices of one (B, 6d) head output: JAX copies, torch
    strided views (row stride 6d) of one leaf that takes gradients."""
    heads = (scale * rs.randn(B, 6 * d)).astype(np.float32)
    th = t(heads).requires_grad_()
    js = [jnp.asarray(heads[:, i * d:(i + 1) * d]) for i in range(n)]
    ts = [th[:, i * d:(i + 1) * d] for i in range(n)]
    assert all(x.stride() == (6 * d, 1) for x in ts)
    return js, ts, th


def _grads_of_slices(th, n, d=D):
    return [th.grad[:, i * d:(i + 1) * d] for i in range(n)]


def _tol(dtype):
    """(value atol, value rtol, grad atol, grad rtol)."""
    if dtype == "bf16":
        return 1e-5, BF16_REL, 1e-4, BF16_REL
    return 1e-5, 1e-5, 1e-4, 1e-4


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

# widths: the reduced models' 64, DiT-S/2's 384 (a row of 96 fp32 vectors:
# 3 warps), and 68, a multiple of 4 but not of 8 (8-byte bf16 vectors)
WIDTHS = [D, 384, 68]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [16, 130])
def test_ln_modulate_matches_pallas(S, dtype, d):
    rs = np.random.RandomState(S + d - D)
    jx, tx = _stream(rs, (B, S, d), dtype)
    (jsc, jsh), (tsc, tsh), th = _slices(rs, 2, d=d)
    jg, tg = _stream(rs, (B, S, d), dtype)
    f = lambda x, sc, sh: JAD.fused_ln_modulate(  # noqa: E731
        x, sc, sh, block_rows=JBLK, interpret=True)
    out_j, vjp = jax.vjp(f, jx, jsc, jsh)
    dx_j, dsc_j, dsh_j = vjp(jg)
    tx.requires_grad_()
    out_t = TAD.ln_modulate(tx, tsc, tsh)
    assert out_t.dtype == tx.dtype
    out_t.backward(tg)
    va, vr, ga, gr = _tol(dtype)
    close(out_t, out_j, va, vr)
    assert tx.grad.dtype == tx.dtype
    close(tx.grad, dx_j, ga, gr)
    dsc_t, dsh_t = _grads_of_slices(th, 2, d)
    close(dsc_t, dsc_j, ga, 1e-4)
    close(dsh_t, dsh_j, ga, 1e-4)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [16, 130])
def test_gate_residual_grads_match_pallas(S, dtype, d):
    rs = np.random.RandomState(100 + S + d - D)
    jr, tr = _stream(rs, (B, S, d), dtype)
    jb, tb = _stream(rs, (B, S, d), dtype)
    (jgate,), (tgate,), th = _slices(rs, 1, d=d)
    jg, tg = _stream(rs, (B, S, d), dtype)
    f = lambda r, b_, g_: JAD.fused_gate_residual(  # noqa: E731
        r, b_, g_, block_rows=JBLK, interpret=True)
    out_j, vjp = jax.vjp(f, jr, jb, jgate)
    dr_j, db_j, dg_j = vjp(jg)
    tr.requires_grad_()
    tb.requires_grad_()
    out_t = TAD.gate_residual(tr, tb, tgate)
    out_t.backward(tg)
    va, vr, ga, gr = _tol(dtype)
    close(out_t, out_j, va, vr)
    close(tr.grad, dr_j, 0, 0)            # d res is the cotangent itself
    close(tb.grad, db_j, ga, gr)
    close(_grads_of_slices(th, 1, d)[0], dg_j, ga, 1e-4)


@pytest.mark.parametrize("S", [16, 130])
def test_edm_loss_matches_pallas(S):
    rs = np.random.RandomState(200 + S)
    f, z, y = (rs.randn(B, S, D).astype(np.float32) for _ in range(3))
    sig = np.array([0.3, 2.0], np.float32)
    nt = -(-S // min(JBLK, S))
    gp = rs.randn(B, nt).astype(np.float32)
    jf = lambda f_, z_, y_: JEDM.edm_loss_partials(  # noqa: E731
        f_, z_, y_, jnp.asarray(sig), 0.5, block_rows=JBLK, interpret=True)
    part_j, vjp = jax.vjp(jf, *map(jnp.asarray, (f, z, y)))
    grads_j = vjp(jnp.asarray(gp))
    tf, tz, ty = (t(a).requires_grad_() for a in (f, z, y))
    part_t = TEDM.edm_loss_partials(tf, tz, ty, t(sig), 0.5,
                                    block_rows=JBLK)
    assert tuple(part_t.shape) == tuple(part_j.shape) == (B, nt)
    close(part_t, part_j, 1e-5, 1e-5)
    part_t.backward(t(gp))
    for got, want in zip((tf.grad, tz.grad, ty.grad), grads_j):
        close(got, want, 1e-4, 1e-4)
    # the scalar loss (default 256-row tiles) and its gradients
    loss_j, grads_j = jax.value_and_grad(
        lambda a, b_, c: JEDM.edm_loss(a, b_, c, jnp.asarray(sig), 0.5,
                                       interpret=True),
        argnums=(0, 1, 2))(*map(jnp.asarray, (f, z, y)))
    tf, tz, ty = (t(a).requires_grad_() for a in (f, z, y))
    loss_t = TEDM.edm_loss(tf, tz, ty, t(sig), 0.5)
    close(loss_t, loss_j, 1e-5, 1e-5)
    loss_t.backward()
    for got, want in zip((tf.grad, tz.grad, ty.grad), grads_j):
        close(got, want, 1e-4, 1e-4)


def test_edm_coeffs_match_the_pallas_module():
    sig = np.array([0.002, 0.3, 2.0, 80.0], np.float32)
    cs_j, co_j = JEDM._coeffs(jnp.asarray(sig), 0.5)
    cs_t, co_t = TEDM._coeffs(t(sig), 0.5)
    close(cs_t, cs_j[:, 0], 0, 1e-6)
    close(co_t, co_j[:, 0], 0, 1e-6)


def test_fused_backwards_run_the_plain_bwd_functions(monkeypatch):
    """On CPU tensors each autograd.Function's backward calls its plain
    backward once (never autograd through the forward); gradients reach
    res, branch and gate, and d res is the incoming cotangent itself."""
    calls = []
    for mod, name in ((TAD, "gate_residual_bwd_ref"),
                      (TAD, "ln_modulate_bwd_ref"),
                      (TEDM, "edm_loss_bwd_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    rs = np.random.RandomState(7)
    res, br, x = (t(rs.randn(B, 5, D).astype(np.float32)).requires_grad_()
                  for _ in range(3))
    _, (gate, sc, sh), th = _slices(rs, 3)
    out = TAD.gate_residual(res, br, gate)
    assert type(out.grad_fn).__name__ == "_GateResidualBackward"
    g = torch.randn(B, 5, D)
    d_res, d_br, d_gate = torch.autograd.grad(out, (res, br, gate), g)
    assert d_res.data_ptr() == g.data_ptr()
    assert d_br.abs().sum() > 0 and d_gate.abs().sum() > 0
    y = TAD.ln_modulate(x, sc, sh)
    assert type(y.grad_fn).__name__ == "_LnModulateBackward"
    y.sum().backward()
    loss = TEDM.edm_loss(res, br, x, torch.tensor([0.5, 1.0]), 0.5)
    loss.backward()
    assert calls == ["gate_residual_bwd_ref", "ln_modulate_bwd_ref",
                     "edm_loss_bwd_ref"]


# ---------------------------------------------------------------------------
# The two-pass model path
# ---------------------------------------------------------------------------

SEQ = 16
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
ARCHS = {"olmo-1b": JC.reduced(JC.get_config("olmo-1b"), n_layers=4,
                               d_model=D, n_heads=4),
         "stablelm-1.6b": JC.reduced(JC.get_config("stablelm-1.6b"),
                                     n_layers=4, d_model=D, n_heads=4)}


def _models(arch, **db_kw):
    cfg = ARCHS[arch]
    db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1, **db_kw)
    return JDBM(cfg, db), TDBM(TC.ModelConfig(**dataclasses.asdict(cfg)),
                               TC.DBConfig(**dataclasses.asdict(db)))


@functools.cache
def _tree(arch):
    """The JAX init as numpy, AdaLN heads and norm gains randomised (at init
    they are the identity and would test nothing). Read-only for callers."""
    jdbm, _ = _models(arch)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        for k, v in lay[ln].items():
            base = 1.0 if k == "g" else 0.0
            lay[ln][k] = (base + 0.1 * rs.randn(*v.shape)).astype(np.float32)
    return tree


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def _tokens(cfg):
    return np.random.RandomState(1).randint(0, cfg.vocab_size, (B, SEQ))


def draws(jdbm, b, rng):
    """σ (B,1,1) and ε (B,S,d) as ``block_loss`` draws them from ``rng``."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, SEQ, jdbm.cfg.d_model), jnp.float32)
    return t(sigma), t(eps)


def test_two_pass_mask_and_attend_match_jax():
    S = SEQ
    jm, tm = JCOM.two_pass_mask(S), TCOM.two_pass_mask(S)
    assert tm.kernel_mask == jm.kernel_mask == ("two_pass", None, S)
    qpos, kpos = np.arange(S), np.arange(2 * S)
    np.testing.assert_array_equal(
        tm(t(qpos), t(kpos)).numpy(),
        np.asarray(jm(jnp.asarray(qpos), jnp.asarray(kpos))))
    rs = np.random.RandomState(4)
    q = rs.randn(B, S, 4, 16).astype(np.float32)
    k = rs.randn(B, 2 * S, 4, 16).astype(np.float32)
    v = rs.randn(B, 2 * S, 4, 16).astype(np.float32)
    do = rs.randn(B, S, 4, 16).astype(np.float32)
    f = lambda q_, k_, v_: JA.attend(  # noqa: E731
        q_, k_, v_, mask_mod=jm, qpos=jnp.asarray(qpos),
        kpos=jnp.asarray(kpos), impl="naive")
    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    for impl in ("kernels", "ref"):
        tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
        got = TA.attend(tq, tk, tv, mask_mod=tm, qpos=t(qpos), kpos=t(kpos),
                        impl=impl)
        close(got, want, 1e-5, 1e-5)
        got.backward(t(do))
        for g, w in zip((tq.grad, tk.grad, tv.grad), grads):
            close(g, w, 1e-4, 1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tlayer_two_pass_matches_jax(arch):
    jdbm, tdbm = _models(arch, causal_mode="two_pass")
    tree = _tree(arch)
    cfg = jdbm.cfg
    rs = np.random.RandomState(5)
    hc, hn = (rs.randn(B, SEQ, D).astype(np.float32) for _ in range(2))
    sigma = np.array([0.3, 2.0], np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), tree["layers"])
    tp = jax.tree_util.tree_map(lambda a: t(a[1]), tree["layers"])
    jctx = JCOM.LayerCtx(cfg=cfg, mode="train", positions=jnp.arange(SEQ),
                         impl="kernels")
    jctx.cond = jdbm.model.cond(jparams(tree), jnp.log(sigma))
    tctx = TCOM.LayerCtx(cfg=tdbm.cfg, mode="train",
                         positions=torch.arange(SEQ), impl="kernels")
    tctx.cond = tdbm.model.cond(tparams(tdbm, tree), t(np.log(sigma)))
    wc, wn, _ = JCOM.tlayer_two_pass(jp, jnp.asarray(hc), jnp.asarray(hn),
                                     jctx)
    for impl in ("kernels", "ref"):
        tctx.impl = impl
        gc, gn = TCOM.tlayer_two_pass(tp, t(hc), t(hn), tctx)
        close(gc, wc, 1e-4, 1e-4)
        close(gn, wn, 1e-4, 1e-4)


@pytest.mark.parametrize("mode,loss", [("two_pass", "ce"),
                                       ("two_pass", "l2"), ("concat", "l2")])
def test_block_loss_variants_match_jax(mode, loss):
    """The two-pass and l2 variants: loss and the block's gradients
    (through the kernels' plain versions) against JAX's kernels path."""
    jdbm, tdbm = _models("olmo-1b", causal_mode=mode, loss=loss)
    tree = _tree("olmo-1b")
    tokens = _tokens(jdbm.cfg)
    rng = jax.random.PRNGKey(10)
    jl = lambda p: jdbm.block_loss(p, 1, jnp.asarray(tokens), rng,  # noqa: E731
                                   impl="kernels")
    (want, jm), jg = jax.value_and_grad(jl, has_aux=True)(jparams(tree))
    sigma, eps = draws(jdbm, 1, rng)
    params = tparams(tdbm, tree)
    leaves = [x.requires_grad_() for _, x in tree_items(params)]
    got, tm = tdbm.block_loss(params, 1, t(tokens), sigma=sigma, eps=eps)
    assert loss in tm and loss in jm
    close(got, want, 1e-4, 1e-4)
    close(tm["sigma_mean"], jm["sigma_mean"], 1e-6, 1e-6)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for (path, _), g in zip(tree_items(params), grads):
        w = want_g[path]
        if g is None:
            assert not np.any(w), path
        else:
            close(g, w, 1e-4, 1e-4)


def _jax_state_np(state):
    return jax.tree_util.tree_map(np.asarray, (state.mu, state.nu))


def _assert_tree_close(got_np, want_np):
    want = dict(tree_items(want_np))
    got = dict(tree_items(got_np))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path], 1e-4, 1e-4)


@pytest.mark.parametrize("b", [0, 1])
def test_two_pass_l2_train_step_matches_jax(b):
    """One fp32 two-pass l2 step per block from shared params and draws:
    loss, the updated params and the AdamW moments within 1e-4 of JAX's
    ``make_db_train_step(impl="kernels")``; no grad or moment outside the
    block and the periphery, and the other block's units untouched."""
    jdbm, tdbm = _models("olmo-1b", causal_mode="two_pass", loss="l2")
    tree = _tree("olmo-1b")
    tokens = _tokens(jdbm.cfg)
    rng = jax.random.PRNGKey(20 + b)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="kernels",
                                           precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens), rng)

    params = tparams(tdbm, tree)
    before = {p: x.clone() for p, x in tree_items(params)}
    t_init, t_step = TT.make_db_train_step(tdbm, b, TCFG, precision="fp32")
    sigma, eps = draws(jdbm, b, rng)
    params2, opt2, loss, m = t_step(params, t_init(params), t(tokens),
                                    sigma=sigma, eps=eps)
    assert params2 is params and "l2" in m
    close(loss, jloss, 1e-4, 1e-4)
    _assert_tree_close(params_to_numpy(params),
                       jax.tree_util.tree_map(np.asarray, jp2))
    mu, nu = _jax_state_np(jopt2)
    _assert_tree_close(params_to_numpy(opt2.mu), mu)
    _assert_tree_close(params_to_numpy(opt2.nu), nu)

    start, size = tdbm.ranges[b]
    for path, x in tree_items(opt2.mu["layers"]):
        assert x.shape[0] == size, path
    for path, x in tree_items(params):
        assert x.grad is None and not x.requires_grad, path
        if path[0] == "layers":
            outside = torch.ones(x.shape[0], dtype=torch.bool)
            outside[start:start + size] = False
            assert torch.equal(x[outside], before[path][outside]), path


@pytest.mark.parametrize("loss", ["ce", "l2"])
def test_train_db_two_pass_on_cpu(loss):
    """``train_db`` carries the two-pass modes through a ``DBConfig``:
    finite losses, one block per iteration."""
    _, tdbm = _models("olmo-1b", causal_mode="two_pass", loss=loss)
    params = tparams(tdbm, _tree("olmo-1b"))
    data = iter([_tokens(tdbm.cfg)] * 2)
    tcfg = TC.TrainConfig(steps=2, warmup_steps=1, lr=1e-3, log_every=0)
    params, hist = TT.train_db(tdbm, tcfg, data,
                               torch.Generator().manual_seed(0),
                               params=params)
    assert [h[0] for h in hist] == [0, 1]
    assert all(np.isfinite(h[2]) and h[1] in (0, 1) for h in hist)
