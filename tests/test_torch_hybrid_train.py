"""PyTorch port: the hybrid family's (zamba2) training path against the JAX
package on the CPU.

``repro_torch.nn.ssm``'s training half (``_chunk_scan``, ``mamba2_fwd``,
``mamba2_two_pass``) and ``HybridModel``'s (the uncached ``apply_units`` in
the train mode, ``apply_units_two_pass``), on numpy-seeded inputs and
bridged params (``tests/test_torch_hybrid.py``'s ``TINY_HYBRID``: 2 units of
2 Mamba layers, d 32, chunk 8; and ``reduced(zamba2-7b)``: 2 units of 1, d
256, chunk 16; AdaLN heads and norm gains randomised). The attention of the
shared block runs the flash kernels' plain versions (CPU tensors).

Held to JAX within 1e-4 (absolute and relative), values and gradients:
the scan (strict or not, with and without an initial state, S not a
multiple of the chunk), ``mamba2_fwd`` and ``mamba2_two_pass`` at chunks 8
and 16, ``block_loss`` (two-pass, the CE and l2 losses) of every block with
σ and ε drawn on the JAX side, ``e2e_loss``, and one DB train step per block
(loss, params and AdamW moments). Where JAX's scan gives non-finite
gradients (chunks of 64 at S 128: ``src/repro/nn/ssm.py:111-112`` takes
``exp`` of the masked entries above the diagonal, which overflow), the
port's are finite and agree within 1e-4 with a reference built from JAX's
own ``mamba2_decode_step`` run token by token: the clean stream step by
step, and each noisy token as one decode step from the clean state before
it. The training CLI runs the hybrid reduced on the CPU in both modes.
``block_loss`` and ``e2e_loss`` are held in
``tests/test_torch_hybrid_block_loss.py``, which imports this file's
helpers: two files, so that ``--dist loadfile`` runs them on two workers.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import REDUCED, TINY_HYBRID, hybrid_models

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.nn import init as JI
from repro.nn import ssm as JSSM
from repro_torch import configs as TC
from repro_torch.bridge import params_to_numpy
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import train as TTRAIN
from repro_torch.nn import ssm as TSSM
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)
TOL = 1e-4
B = 2
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny():
    return hybrid_models(TINY_HYBRID)


@pytest.fixture(scope="module")
def reduced():
    return hybrid_models(REDUCED)


# ---------------------------------------------------------------------------
# The chunked scan and the Mamba2 layer
# ---------------------------------------------------------------------------

def _scan_inputs(S, seed, dt_scale):
    rs = np.random.RandomState(seed)
    H, P, N = 3, 4, 5
    return {"x": rs.randn(B, S, H, P), "dt": dt_scale * np.abs(
        rs.randn(B, S, H)), "a_log": rs.uniform(-1, 1, H),
            "Bmat": rs.randn(B, S, N), "Cmat": rs.randn(B, S, N),
            "h0": rs.randn(B, H, P, N)}


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("chunk,S", [(8, 37), (16, 40)])
def test_chunk_scan_matches_jax(chunk, S, strict, with_h0):
    """y and h_final, and the gradients of every input under random
    cotangents, within 1e-4 of JAX's ``_chunk_scan``; S is padded to the
    chunk (small dt, so the initial state still reaches h_final)."""
    inp = {k: v.astype(np.float32)
           for k, v in _scan_inputs(S, chunk + S, 0.05).items()}
    names = [k for k in inp if with_h0 or k != "h0"]
    rs = np.random.RandomState(1)
    gy = rs.randn(*inp["x"].shape).astype(np.float32)
    gh = rs.randn(*inp["h0"].shape).astype(np.float32)

    def jfn(*args):
        kw = dict(zip(names, args))
        return JSSM._chunk_scan(kw["x"], kw["dt"], kw["a_log"], kw["Bmat"],
                                kw["Cmat"], chunk, kw.get("h0"),
                                strict=strict)
    (jy, jh), vjp = jax.vjp(jfn, *(jnp.asarray(inp[k]) for k in names))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    targs = {k: t(inp[k]).requires_grad_() for k in names}
    ty, th = TSSM._chunk_scan(targs["x"], targs["dt"], targs["a_log"],
                              targs["Bmat"], targs["Cmat"], chunk,
                              targs.get("h0"), strict=strict)
    close(ty, jy)
    close(th, jh)
    if with_h0:
        assert float(jnp.abs(jh).max()) > 1e-2     # the state survives
    tgrads = torch.autograd.grad((ty, th), list(targs.values()),
                                 (t(gy), t(gh)))
    for name, g, w in zip(names, tgrads, jgrads):
        close(g, w)


def _mixer(d, cfg, seed):
    """Random Mamba2 params of JAX's init (numpy), d_skip and norm_g
    randomised about their init."""
    spec = JSSM.mamba2_spec(d, cfg)
    tree = jax.tree_util.tree_map(np.asarray, JI.init_params(
        jax.random.PRNGKey(seed), spec))
    rs = np.random.RandomState(seed)
    for k in ("d_skip", "norm_g", "dt_bias"):
        tree[k] = (tree[k] + 0.1 * rs.randn(*tree[k].shape)).astype(
            np.float32)
    return tree


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: t(a).requires_grad_(), tree)


def _leaves(tree):
    return [x for _, x in tree_items(tree)]


SSM_CASES = {"chunk 8": (32, TINY_HYBRID.ssm, 21),
             "chunk 16": (256, REDUCED.ssm, 40)}


def _layer_inputs(d, S, seed):
    """Two input streams (B, S, d) and two output cotangents, those as a
    loss averaged over the B * S tokens hands them back (so a gradient that
    sums over the tokens stays O(1), as in training)."""
    rs = np.random.RandomState(seed)
    u = [rs.randn(B, S, d).astype(np.float32) for _ in range(2)]
    g = [(rs.randn(B, S, d) / (B * S)).astype(np.float32) for _ in range(2)]
    return (*u, *g)


def _grads_close(jgrads_tree, tgrads, tree):
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads_tree)))
    for (path, _), g in zip(tree_items(tree), tgrads):
        close(g, want[path])


@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_mamba2_fwd_matches_jax(case):
    """``mamba2_fwd``: out and the final state, and the gradients of every
    param and of the input, within 1e-4 of JAX's."""
    d, cfg, S = SSM_CASES[case]
    tree = _mixer(d, cfg, 5)
    u, _, gy, _ = _layer_inputs(d, S, 6)

    def jfn(p, x):
        return JSSM.mamba2_fwd(p, x, cfg, d)[0]
    jy, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(u))
    jgp, jgu = vjp(jnp.asarray(gy))
    _, jst = JSSM.mamba2_fwd(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(u), cfg, d)
    tp, tu = _torch_tree(tree), t(u).requires_grad_()
    tcfg = TC.SSMConfig(**dataclasses.asdict(cfg))
    ty, tst = TSSM.mamba2_fwd(tp, tu, tcfg, d)
    close(ty, jy)
    close(tst["h"], jst["h"])
    close(tst["conv"], jst["conv"])
    grads = torch.autograd.grad(ty, _leaves(tp) + [tu], t(gy))
    _grads_close(jgp, grads[:-1], tp)
    close(grads[-1], jgu)


@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_mamba2_two_pass_matches_jax(case):
    """``mamba2_two_pass``: both streams and the gradients of every param
    and of both inputs, within 1e-4 of JAX's."""
    d, cfg, S = SSM_CASES[case]
    tree = _mixer(d, cfg, 7)
    uc, un, gc, gn = _layer_inputs(d, S, 8)

    def jfn(p, a, b):
        return JSSM.mamba2_two_pass(p, a, b, cfg, d)
    (jc, jn), vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(uc), jnp.asarray(un))
    jgp, jgc, jgn = vjp((jnp.asarray(gc), jnp.asarray(gn)))
    tp = _torch_tree(tree)
    tc, tn = t(uc).requires_grad_(), t(un).requires_grad_()
    tcfg = TC.SSMConfig(**dataclasses.asdict(cfg))
    yc, yn = TSSM.mamba2_two_pass(tp, tc, tn, tcfg, d)
    close(yc, jc)
    close(yn, jn)
    grads = torch.autograd.grad((yc, yn), _leaves(tp) + [tc, tn],
                                (t(gc), t(gn)))
    _grads_close(jgp, grads[:-2], tp)
    close(grads[-2], jgc)
    close(grads[-1], jgn)


# ---------------------------------------------------------------------------
# The reference's NaN gradients, shown and bounded
# ---------------------------------------------------------------------------

# two chunks of 64: past about 88 in the decay sum of a chunk, JAX's masked
# entries overflow (at chunks of 32 these inputs stay below it)
NAN_CFG = JC.SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                       chunk_size=64)
NAN_D, NAN_S = 64, 128


def _per_token_reference(p, uc, un):
    """(y_clean, y_noisy) from JAX's ``mamba2_decode_step`` a token at a
    time: the clean stream advances the state; noisy token i is one decode
    step from the clean state after tokens < i (App. E.4's two-pass)."""
    st0 = JSSM.mamba2_init_state(uc.shape[0], NAN_CFG, NAN_D)

    def step(st, xs):
        c, n = xs
        yn, _ = JSSM.mamba2_decode_step(p, n[:, None], NAN_CFG, NAN_D, st)
        yc, st = JSSM.mamba2_decode_step(p, c[:, None], NAN_CFG, NAN_D, st)
        return st, (yc[:, 0], yn[:, 0])
    _, (yc, yn) = jax.lax.scan(step, st0, (uc.transpose(1, 0, 2),
                                           un.transpose(1, 0, 2)))
    return yc.transpose(1, 0, 2), yn.transpose(1, 0, 2)


def _finite(tree) -> bool:
    return all(bool(jnp.isfinite(x).all())
               for x in jax.tree_util.tree_leaves(tree))


def test_reference_nan_gradients_shown_and_bounded():
    """At a chunk of 64 over S 128 (d 64, head_dim 16, d_state 16, JAX's
    random init) JAX's ``mamba2_fwd`` and ``mamba2_two_pass`` give finite
    outputs but non-finite gradients (``src/repro/nn/ssm.py:111-112``); the
    port's gradients are finite, and its outputs and gradients agree within
    1e-4 with the per-token reference from JAX's ``mamba2_decode_step``."""
    tree = jax.tree_util.tree_map(np.asarray, JI.init_params(
        jax.random.PRNGKey(0), JSSM.mamba2_spec(NAN_D, NAN_CFG)))
    uc, un, gc, gn = _layer_inputs(NAN_D, NAN_S, 9)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    juc, jun, jgc, jgn = map(jnp.asarray, (uc, un, gc, gn))

    def loss(ys):
        return jnp.sum(ys[0] * jgc) + jnp.sum(ys[1] * jgn)
    # JAX's chunked forms: finite values, non-finite gradients
    fwd = lambda p: JSSM.mamba2_fwd(p, juc, NAN_CFG, NAN_D)[0]  # noqa: E731
    two = lambda p: JSSM.mamba2_two_pass(  # noqa: E731
        p, juc, jun, NAN_CFG, NAN_D)
    assert _finite(fwd(jp)) and _finite(two(jp))
    assert not _finite(jax.grad(lambda p: jnp.sum(fwd(p) * jgc))(jp))
    assert not _finite(jax.grad(lambda p: loss(two(p)))(jp))
    # the per-token reference: finite, and the port matches it
    (rc, rn), vjp = jax.vjp(lambda p, a, b: _per_token_reference(p, a, b),
                            jp, juc, jun)
    rgp, rgc, rgn = vjp((jgc, jgn))
    assert _finite((rgp, rgc, rgn))
    tcfg = TC.SSMConfig(**dataclasses.asdict(NAN_CFG))
    for name in ("fwd", "two_pass"):
        tp = _torch_tree(tree)
        tc, tn = t(uc).requires_grad_(), t(un).requires_grad_()
        if name == "fwd":
            ys = (TSSM.mamba2_fwd(tp, tc, tcfg, NAN_D)[0],)
            outs, cots, wants = ys, (t(gc),), (rc,)
            inputs = [tc]
        else:
            ys = TSSM.mamba2_two_pass(tp, tc, tn, tcfg, NAN_D)
            outs, cots, wants = ys, (t(gc), t(gn)), (rc, rn)
            inputs = [tc, tn]
        for y, w in zip(outs, wants):
            close(y, w)
        grads = torch.autograd.grad(outs, _leaves(tp) + inputs, cots)
        assert all(torch.isfinite(g).all() for g in grads), name
        if name == "two_pass":
            _grads_close(rgp, grads[:-2], tp)
            close(grads[-2], rgc)
            close(grads[-1], rgn)
        else:
            # the clean stream alone: the reference's gradient of y_clean
            (_, vjp_c) = jax.vjp(
                lambda p, a: _per_token_reference(p, a, a)[0], jp, juc)
            cgp, cgc = vjp_c(jgc)
            _grads_close(cgp, grads[:-1], tp)
            close(grads[-1], cgc)


# ---------------------------------------------------------------------------
# The model: train steps, CLI (block_loss and e2e_loss: the other file)
# ---------------------------------------------------------------------------

def _tokens(cfg, S=12, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _draws(jdbm, b, rng, S):
    """σ (B, 1, 1) and ε (B, S, d) as JAX's ``block_loss`` draws them."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, S, jdbm.cfg.d_model), jnp.float32)
    return t(sigma), t(eps)


def _assert_tree_close(got_np, want_np):
    want = dict(tree_items(want_np))
    got = dict(tree_items(got_np))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path])


@pytest.mark.parametrize("b", [0, 1])
def test_db_train_step_matches_jax(tiny, b):
    """One fp32 ``make_db_train_step`` on block b from shared params and
    draws: the loss, the updated params and the AdamW moments within 1e-4
    of JAX's; the moments cover the block's units, ``shared`` and the
    periphery."""
    from repro_torch.bridge import params_from_jax
    jdbm, jparams, tdbm, _ = tiny
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = _tokens(jdbm.cfg)
    rng = jax.random.PRNGKey(20 + b)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="auto",
                                           precision="fp32")
    jp2, jopt2, jloss, _ = j_step(jparams, j_init(jparams),
                                  jnp.asarray(tokens), rng)
    params = params_from_jax(tree, "cpu", tdbm.model.spec)
    t_init, t_step = TT.make_db_train_step(tdbm, b, TC.TrainConfig(
        **dataclasses.asdict(TCFG)), precision="fp32")
    sigma, eps = _draws(jdbm, b, rng, tokens.shape[1])
    params, opt2, loss, _ = t_step(params, t_init(params), t(tokens),
                                   sigma=sigma, eps=eps)
    close(loss, jloss)
    _assert_tree_close(params_to_numpy(params),
                       jax.tree_util.tree_map(np.asarray, jp2))
    _assert_tree_close(params_to_numpy(opt2.mu),
                       jax.tree_util.tree_map(np.asarray, jopt2.mu))
    _assert_tree_close(params_to_numpy(opt2.nu),
                       jax.tree_util.tree_map(np.asarray, jopt2.nu))
    start, size = tdbm.ranges[b]
    assert opt2.mu["units"]["mamba"]["mixer"]["a_log"].shape[0] == size
    assert "shared" in opt2.mu


@pytest.mark.parametrize("n_units,blocks", [(8, 4), (27, 4), (2, 1)])
def test_block_ranges_match_jax(n_units, blocks):
    """The hybrid's block partition (``ranges``) at chip_smoke's depth cut
    (8 units in 4 blocks), at full depth (27 units) and at the 2-unit
    check: JAX's, and the route two-pass."""
    cfg = dataclasses.replace(JC.get_config("zamba2-7b"),
                              n_layers=3 * n_units)
    db = JC.DBConfig(num_blocks=blocks, overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    tdbm = TDBM(tcfg, TC.DBConfig(**dataclasses.asdict(db)))
    assert tdbm.model.n_units == n_units
    assert [tuple(r) for r in tdbm.ranges] == [tuple(r) for r in jdbm.ranges]
    assert tdbm.causal_mode == "two_pass"


def test_train_db_takes_two_steps(tiny):
    """``train_db`` on the hybrid (every block's AdamW state made up front):
    two iterations, finite losses."""
    from repro_torch.bridge import params_from_jax
    _, jparams, tdbm, _ = tiny
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu", tdbm.model.spec)
    data = iter([_tokens(tdbm.cfg, seed=s) for s in (2, 3)])
    tcfg = TC.TrainConfig(steps=2, warmup_steps=1, lr=1e-3, log_every=0)
    params, hist = TT.train_db(tdbm, tcfg, data,
                               torch.Generator().manual_seed(0),
                               params=params)
    assert [h[0] for h in hist] == [0, 1]
    assert all(np.isfinite(h[2]) and h[1] in (0, 1) for h in hist)


@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_train_cli_trains_the_hybrid(mode, capsys):
    """``python -m repro_torch.launch.train --arch zamba2-7b --mode db|e2e
    --device cpu --steps 2`` (reduced) trains with finite losses."""
    TTRAIN.main(["--arch", "zamba2-7b", "--mode", mode, "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"[{mode}] 2 steps" in out and "done" in out
    first, last = re.search(r"first loss (\S+), last (\S+)", out).groups()
    assert np.isfinite(float(first)) and np.isfinite(float(last))
