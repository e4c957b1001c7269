"""PyTorch port: the DiT (§5.2) and recurrent-depth (§5.5) adapters against
the JAX package on the CPU.

Reduced DiT-S/2 (4 layers, d=64, 4 heads of 16, 8 tokens of 16 dims,
``DIT_DB``: 3 blocks of 2/1/1 layers) and reduced Huginn (core 2 layers,
prelude 2, coda 2, d=64, vocab 64, K=4, bptt_k=2). The JAX init is bridged to
torch with the zero-initialised AdaLN heads, norm gains and the DiT's
``out_proj`` randomised (at init they are the identity or zero and would
test nothing). The random draws JAX makes inside (σ, ε, the initial
states) are made on the JAX side the way it makes them and handed to the
port. The port runs ``impl="kernels"`` (its wrappers take their plain
versions on CPU tensors) and, where stated, ``impl="ref"``. Tolerance 1e-4
(atol and rtol) under fp32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as JPAPER
from repro.core import edm as JEDM
from repro.core import partition as JP
from repro.core import training as JT
from repro.core.dit import DiTDiffusionBlocks as JDiT
from repro.core.recurrent import RecurrentDepthModel as JRec
from repro.data.synthetic import MixtureImagesContinuous as JMix
from repro.nn import layers as JL
from repro.optim import apply_updates
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import paper as TPAPER
from repro_torch.core import dit as TDIT
from repro_torch.core import edm as TEDM
from repro_torch.core import partition as TP
from repro_torch.core import recurrent as TREC
from repro_torch.core import training as TT
from repro_torch.data import MixtureImagesContinuous as TMix
from repro_torch.nn import layers as TL
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
B, T_TOK, DD = 2, 8, 16
TCFG = TC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


def _port_cfgs(cfg, db):
    return (TC.ModelConfig(**dataclasses.asdict(cfg)),
            TC.DBConfig(**dataclasses.asdict(db)))


def _randomise(tree, stacks, rs):
    """AdaLN heads and norm params of every layer in ``stacks`` random."""
    for name in stacks:
        lay = tree[name]
        if "adaln" in lay:
            for k in ("w", "b"):
                lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                                   ).astype(np.float32)
        for ln in ("ln1", "ln2"):
            for k, v in lay[ln].items():
                base = 1.0 if k == "g" else 0.0
                lay[ln][k] = (base + 0.1 * rs.randn(*v.shape)
                              ).astype(np.float32)
    return tree


def _tree_close(got_np, want_np):
    want = dict(tree_items(want_np))
    got = dict(tree_items(got_np))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path])


def _grads_close(params, grads, jgrads):
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want[path]), path
        else:
            close(g, want[path])


# ---------------------------------------------------------------------------
# Configs, partition helpers, data, linear
# ---------------------------------------------------------------------------

def test_paper_configs_equal_jax():
    names = [n for n in dir(JPAPER) if n.isupper()]
    assert names and sorted(names) == sorted(n for n in dir(TPAPER)
                                             if n.isupper())
    for n in names:
        j, p = getattr(JPAPER, n), getattr(TPAPER, n)
        if dataclasses.is_dataclass(j):
            assert dataclasses.asdict(j) == dataclasses.asdict(p), n
        else:
            assert j == p, n


@pytest.mark.parametrize("db", [JPAPER.DIT_DB, JPAPER.HUGINN_DB,
                                JPAPER.VIT_DB])
@pytest.mark.parametrize("steps", [1, 7, 18, 32])
def test_sampling_schedule_and_block_of_sigma_equal_jax(db, steps):
    tdb = _port_cfgs(JPAPER.DIT_S2, db)[1]
    sj, st = JP.sampling_schedule(db, steps), TP.sampling_schedule(tdb, steps)
    np.testing.assert_array_equal(st, sj)
    for s in list(sj) + [db.sigma_min, db.sigma_max, 1.0]:
        assert TP.block_of_sigma(tdb, float(s)) == \
            JP.block_of_sigma(db, float(s))


def test_mixture_images_bit_equal():
    kw = dict(n_tokens=T_TOK, dim=DD, n_modes=4, seed=3)
    jm, tm = JMix(**kw), TMix(**kw)
    np.testing.assert_array_equal(tm.modes, jm.modes)
    xj, kj = jm.sample(np.random.RandomState(1), 32)
    xt, kt = tm.sample(np.random.RandomState(1), 32)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(tm.mode_assignment(xt),
                                  jm.mode_assignment(xj))
    assert tm.fidelity(xt) == jm.fidelity(xj)
    assert next(tm.iterator(4))[0].tobytes() == \
        next(jm.iterator(4))[0].tobytes()


@pytest.mark.parametrize("sigma_to", [0.7, 0.0])
@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_sampler_step_matches_jax_combine_and_step(impl, sigma_to):
    """One sampler step σ_from → σ_to (the chain's last, to 0, included)
    equals JAX's ``denoise_combine`` + ``euler_step`` (D itself at 0)."""
    rs = np.random.RandomState(5)
    z, f = (rs.randn(3, 7, DD).astype(np.float32) for _ in range(2))
    sigma_from = 2.5
    d_hat = JEDM.denoise_combine(jnp.asarray(z), jnp.asarray(f),
                                 jnp.full((3, 1, 1), sigma_from), 0.5)
    want = d_hat if sigma_to == 0 else JEDM.euler_step(
        jnp.asarray(z), d_hat, sigma_from, sigma_to)
    got = TEDM.sampler_step(t(z), t(f), sigma_from, sigma_to, 0.5, impl)
    close(got, want, atol=1e-6, rtol=1e-6)


def test_linear_matches_jax():
    rs = np.random.RandomState(0)
    spec_j, spec_t = ({k: dataclasses.asdict(v) for k, v in
                       L.linear_spec(8, 5, bias=True).items()}
                      for L in (JL, TL))
    assert spec_t == spec_j
    w, b = rs.randn(8, 5).astype(np.float32), rs.randn(5).astype(np.float32)
    x = rs.randn(3, 8).astype(np.float32)
    want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x))
    close(TL.linear({"w": t(w), "b": t(b)}, t(x)), want)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

DIT_CFG = dataclasses.replace(JPAPER.DIT_S2, n_layers=4, d_model=64,
                              n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256)


@functools.cache
def _dit():
    jdit = JDiT(DIT_CFG, JPAPER.DIT_DB, data_dim=DD, n_tokens=T_TOK)
    tdit = TDIT.DiTDiffusionBlocks(*_port_cfgs(DIT_CFG, JPAPER.DIT_DB),
                                   data_dim=DD, n_tokens=T_TOK)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdit.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    _randomise(tree, ["layers"], rs)
    tree["out_proj"]["w"] = (0.1 * rs.randn(*tree["out_proj"]["w"].shape)
                             ).astype(np.float32)
    return jdit, tdit, tree


def _dit_params():
    jdit, tdit, tree = _dit()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, "cpu", tdit.spec))


def _y():
    return JMix(n_tokens=T_TOK, dim=DD, seed=3).sample(
        np.random.RandomState(1), B)[0]


def _dit_draws(jdit, b, y, rng):
    """σ and ε as the JAX ``block_loss`` draws them from ``rng``."""
    r_s, r_e = jax.random.split(rng)
    q_lo, q_hi = JP.block_qrange(jdit.db, b)
    sigma = JEDM.sample_sigma_in_qrange(r_s, (B, 1, 1), jdit.db, q_lo, q_hi)
    eps = jax.random.normal(r_e, y.shape, jnp.float32)
    return t(sigma), t(eps)


def test_dit_bridge_and_spec():
    jdit, tdit, tree = _dit()
    params = params_from_jax(tree, "cpu", tdit.spec)
    assert sorted(params) == ["cond", "final_norm", "in_proj", "layers",
                              "out_proj", "pos"]
    assert tdit.ranges == jdit.ranges == [(0, 2), (2, 1), (3, 1)]
    for path, x in tree_items(params):
        if path[0] == "layers":
            assert x.shape[0] == DIT_CFG.n_layers, path


@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_dit_denoise_matches_jax(impl):
    jdit, tdit, _ = _dit()
    jp, tp = _dit_params()
    rs = np.random.RandomState(5)
    z = rs.randn(B, T_TOK, DD).astype(np.float32)
    sig = np.array([0.3, 12.0], np.float32).reshape(B, 1, 1)
    for start, size in jdit.ranges + [(0, DIT_CFG.n_layers)]:
        want = jdit.denoise(jp, jnp.asarray(z), jnp.asarray(sig), start,
                            size)
        got = tdit.denoise(tp, t(z), t(sig), start, size, impl)
        close(got, want)
    close(tdit.d_hat(tp, t(z), t(sig), 1, impl),
          jdit.d_hat(jp, jnp.asarray(z), jnp.asarray(sig), 1))


@pytest.mark.parametrize("b", [0, 1, 2, "e2e"])
def test_dit_losses_and_grads_match_jax(b):
    """block_loss per block and e2e_loss: values and every param's gradient
    (the block's layers and the periphery; zero elsewhere)."""
    jdit, tdit, _ = _dit()
    jp, tp = _dit_params()
    y = _y()
    rng = jax.random.PRNGKey(10)
    if b == "e2e":
        jl = lambda p: jdit.e2e_loss(p, jnp.asarray(y), rng)[0]  # noqa: E731
        sigma, eps = _dit_draws(jdit, 0, y, rng)
        tl = lambda p: tdit.e2e_loss(p, t(y), sigma=sigma,  # noqa: E731
                                     eps=eps)
    else:
        jl = lambda p: jdit.block_loss(p, b, jnp.asarray(y),  # noqa: E731
                                       rng)[0]
        sigma, eps = _dit_draws(jdit, b, y, rng)
        tl = lambda p: tdit.block_loss(p, b, t(y), sigma=sigma,  # noqa: E731
                                       eps=eps)
    want, jg = jax.value_and_grad(jl)(jp)
    leaves = [x.requires_grad_() for _, x in tree_items(tp)]
    got, metrics = tl(tp)
    assert "l2" in metrics
    close(got, want)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    _grads_close(tp, grads, jg)


def test_dit_loss_ref_equals_kernels_path():
    jdit, tdit, _ = _dit()
    _, tp = _dit_params()
    y = _y()
    sigma, eps = _dit_draws(jdit, 1, y, jax.random.PRNGKey(11))
    lk = tdit.block_loss(tp, 1, t(y), sigma=sigma, eps=eps)[0]
    lr = tdit.block_loss(tp, 1, t(y), sigma=sigma, eps=eps, impl="ref")[0]
    close(lk, lr, 1e-6, 1e-6)


@pytest.mark.parametrize("blockwise", [True, False])
@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_dit_sample_matches_jax(blockwise, impl):
    """Euler sampling from JAX's z0 (σ_max · normal(rng)): samples and the
    layer-evaluation count."""
    jdit, tdit, _ = _dit()
    jp, tp = _dit_params()
    rng = jax.random.PRNGKey(9)
    steps = 6
    want, evals_j = jdit.sample(jp, rng, B, num_steps=steps,
                                blockwise=blockwise)
    z0 = jdit.db.sigma_max * jax.random.normal(rng, (B, T_TOK, DD))
    got, evals_t = tdit.sample(tp, B, steps, blockwise, z0=t(z0), impl=impl)
    sched = TP.sampling_schedule(tdit.db, steps)[:-1]
    expect = sum(tdit.ranges[TP.block_of_sigma(tdit.db, float(s))][1]
                 for s in sched) if blockwise else steps * DIT_CFG.n_layers
    assert evals_t == evals_j == expect
    close(got, want)


def test_dit_db_step_matches_jax_adamw_on_the_block_view():
    """One DiT DB step on block 0 through the port's block view: the view's
    params and AdamW moments within 1e-4 of ``repro.optim.adamw`` (through
    JAX's ``make_optimizer``) applied to JAX's gradients of that view; the
    other blocks' layers untouched, moments only for the view."""
    jdit, tdit, _ = _dit()
    jp, tp = _dit_params()
    y = _y()
    b = 0
    start, size = jdit.ranges[b]
    rng = jax.random.PRNGKey(12)
    jl, jg = jax.value_and_grad(
        lambda p: jdit.block_loss(p, b, jnp.asarray(y), rng)[0])(jp)
    jview = JT.extract_block_view(jp, start, size)
    opt_init, opt_update = JT.make_optimizer(TCFG)
    upd, jst, _ = opt_update(JT.extract_block_view(jg, start, size),
                             opt_init(jview), jview)
    jview2 = apply_updates(jview, upd)

    before = {p: x.clone() for p, x in tree_items(tp)}
    init, step = TDIT.make_db_step(tdit, b, TCFG)
    sigma, eps = _dit_draws(jdit, b, y, rng)
    tp2, opt, loss, m = step(tp, init(tp), t(y), sigma=sigma, eps=eps)
    assert tp2 is tp and "l2" in m and "grad_norm" in m
    close(loss, jl)
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    _tree_close(params_to_numpy(TT.extract_block_view(tp, start, size)),
                np_(jview2))
    _tree_close(params_to_numpy(opt.mu), np_(jst.mu))
    _tree_close(params_to_numpy(opt.nu), np_(jst.nu))
    for path, x in tree_items(opt.mu["layers"]):
        assert x.shape[0] == size, path
    for path, x in tree_items(tp):
        assert x.grad is None and not x.requires_grad, path
        if path[0] == "layers":
            assert torch.equal(x[start + size:],
                               before[path][start + size:]), path


@pytest.mark.parametrize("blockwise", [True, False])
def test_dit_train_loop_on_cpu(blockwise):
    """The Table 2 loop: finite losses; a block per step (blockwise) or the
    full stack."""
    _, tdit, _ = _dit()
    _, tp = _dit_params()
    mix = TMix(n_tokens=T_TOK, dim=DD, seed=3)
    data = (x for x, _ in mix.iterator(B))
    tcfg = TC.TrainConfig(steps=3, warmup_steps=1, lr=1e-3, log_every=0)
    tp, hist = TDIT.train(tdit, tcfg, data, torch.Generator().manual_seed(0),
                          params=tp, blockwise=blockwise)
    assert [h[0] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h[2]) for h in hist)
    assert all((h[1] in (0, 1, 2)) if blockwise else h[1] == -1
               for h in hist)


# ---------------------------------------------------------------------------
# Recurrent depth (Huginn)
# ---------------------------------------------------------------------------

REC_CFG = dataclasses.replace(JPAPER.HUGINN, n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
                              vocab_size=64)
K_REC, BPTT, S_REC = 4, 2, 8


@functools.cache
def _rec():
    jm = JRec(REC_CFG, JPAPER.HUGINN_DB, recurrence=K_REC, bptt_k=BPTT)
    tm = TREC.RecurrentDepthModel(*_port_cfgs(REC_CFG, JPAPER.HUGINN_DB),
                                  recurrence=K_REC, bptt_k=BPTT)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    _randomise(tree, ["prelude", "core", "coda"], np.random.RandomState(4))
    return jm, tm, tree


def _rec_params():
    jm, tm, tree = _rec()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, "cpu", tm.spec))


def _tokens():
    return np.random.RandomState(2).randint(0, REC_CFG.vocab_size,
                                            (B, S_REC))


def test_recurrent_bridge_carries_every_stack():
    jm, tm, tree = _rec()
    params = params_from_jax(tree, "cpu", tm.spec)
    for name, n in (("prelude", 2), ("core", 2), ("coda", 2)):
        for path, x in tree_items(params[name]):
            assert x.shape[0] == n, (name, path)
    assert dict(tree_items(jax.tree_util.tree_map(np.shape, tree))) == \
        {p: tuple(x.shape) for p, x in tree_items(params)}


@pytest.mark.parametrize("loss", ["baseline_loss", "db_loss"])
def test_recurrent_losses_and_grads_match_jax(loss):
    jm, tm, _ = _rec()
    jp, tp = _rec_params()
    tokens = _tokens()
    rng = jax.random.PRNGKey(13)
    want, jg = jax.value_and_grad(
        lambda p: getattr(jm, loss)(p, jnp.asarray(tokens), rng)[0])(jp)
    e_shape = (B, S_REC, REC_CFG.d_model)
    if loss == "baseline_loss":
        draws = {"s0": t(jm.db.sigma_data * jax.random.normal(
            rng, e_shape, jnp.float32))}
    else:
        r_s, r_e = jax.random.split(rng)
        q_lo = float(JP.q_of_sigma(jm.db.sigma_min, jm.db))
        q_hi = float(JP.q_of_sigma(jm.db.sigma_max, jm.db))
        draws = {"sigma": t(JEDM.sample_sigma_in_qrange(
                     r_s, (B, 1, 1), jm.db, q_lo, q_hi)),
                 "eps": t(jax.random.normal(r_e, e_shape, jnp.float32))}
    leaves = [x.requires_grad_() for _, x in tree_items(tp)]
    got, metrics = getattr(tm, loss)(tp, t(tokens), **draws)
    assert "ce" in metrics
    close(got, want)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    _grads_close(tp, grads, jg)


@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_recurrent_generate_logits_matches_jax(impl):
    """K Euler steps from JAX's z0 (σ_max · normal(PRNGKey(0)))."""
    jm, tm, _ = _rec()
    jp, tp = _rec_params()
    tokens = _tokens()
    want = jm.db_generate_logits(jp, jnp.asarray(tokens))
    z0 = jm.db.sigma_max * jax.random.normal(
        jax.random.PRNGKey(0), (B, S_REC, REC_CFG.d_model), jnp.float32)
    got = tm.db_generate_logits(tp, t(tokens), z0=t(z0), impl=impl)
    assert tuple(got.shape) == (B, S_REC, REC_CFG.vocab_size)
    close(got, want)


@pytest.mark.parametrize("loss", ["baseline_loss", "db_loss"])
def test_recurrent_train_loop_on_cpu(loss):
    """The Table 5 loop: every param trained, finite losses."""
    _, tm, _ = _rec()
    _, tp = _rec_params()
    before = {p: x.clone() for p, x in tree_items(tp)}
    data = iter([_tokens()] * 2)
    tcfg = TC.TrainConfig(steps=2, warmup_steps=1, lr=1e-3, log_every=0)
    tp, hist = TREC.train(tm, getattr(tm, loss), tcfg, data,
                          torch.Generator().manual_seed(0), params=tp)
    assert [h[0] for h in hist] == [0, 1]
    assert all(np.isfinite(h[1]) for h in hist)
    moved = {p[0] for p, x in tree_items(tp) if not torch.equal(x, before[p])}
    assert moved >= {"prelude", "core", "coda", "adapter", "head", "embed"}
