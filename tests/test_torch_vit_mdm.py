"""PyTorch port: the ViT (§5.1) and masked-diffusion (§5.3) adapters against
the JAX package on the CPU.

Reduced ViT (4 layers, d=64, 2 heads of 32 — VIT_CIFAR's head dim, the
fp32 attention kernels' hd-32 case —, 10 classes, 8x8x3 images in patches
of 4, so 6 tokens; ``VIT_DB``: 3 blocks) and reduced MDM (4 layers, d=128,
2 heads of 64, vocab 32 with [MASK] = 31, 16 tokens; ``MDM_DB``: 3 blocks).
The JAX init is bridged to torch with the zero-initialised AdaLN heads and
the norm params randomised. The random draws JAX makes inside (σ, ε, z0, t,
the mask and unmask uniforms, the Gumbel noise of the categorical samples)
are made on the JAX side the way it makes them and handed to the port. The
port runs ``impl="kernels"`` (its wrappers take their plain versions on CPU
tensors) and, where stated, ``impl="ref"``. Tolerance 1e-4 (atol and rtol)
under fp32; sampled tokens identical.
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
from repro.core.masked import MaskedDiffusionBlocks as JMDM
from repro.core.vit import ViTDiffusionBlocks as JViT
from repro.data.synthetic import GaussianMixtureImages as JGMI
from repro.data.synthetic import MarkovLM as JMarkov
from repro.optim import apply_updates
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import masked as TMASK
from repro_torch.core import training as TT
from repro_torch.core import vit as TVIT
from repro_torch.data import GaussianMixtureImages as TGMI
from repro_torch.data import MarkovLM as TMarkov
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_adaln as AD
from repro_torch.models import build_model
from repro_torch.models.transformer import DecoderModel
from repro_torch.nn.init import tree_items
from test_torch_adapters import (_grads_close, _port_cfgs, _randomise,
                                 _tree_close, close, t)

torch.set_num_threads(1)
TCFG = TC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
np_ = functools.partial(jax.tree_util.tree_map, np.asarray)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_gaussian_mixture_images_bit_equal():
    kw = dict(num_classes=10, image_size=8, noise_scale=2.0, seed=3)
    jg, tg = JGMI(**kw), TGMI(**kw)
    np.testing.assert_array_equal(tg.means, jg.means)
    xj, yj = jg.sample(np.random.RandomState(1), 16)
    xt, yt = tg.sample(np.random.RandomState(1), 16)
    assert xt.tobytes() == xj.tobytes() and xt.dtype == xj.dtype
    np.testing.assert_array_equal(yt, yj)
    (xj, yj), (xt, yt) = next(jg.iterator(4)), next(tg.iterator(4))
    assert xt.tobytes() == xj.tobytes()
    np.testing.assert_array_equal(yt, yj)


def test_markov_lm_evaluation_equal_jax():
    jm, tm = JMarkov(vocab_size=31, seed=4), TMarkov(vocab_size=31, seed=4)
    x = tm.sample(np.random.RandomState(2), 4, 32)
    np.testing.assert_array_equal(x, jm.sample(np.random.RandomState(2), 4,
                                               32))
    assert tm.log_likelihood(x) == jm.log_likelihood(x)
    assert tm.transition_accuracy(x) == jm.transition_accuracy(x)
    noisy = np.random.RandomState(3).randint(0, 31, (4, 32))
    assert tm.transition_accuracy(noisy) == jm.transition_accuracy(noisy)
    assert tm.log_likelihood(noisy) == jm.log_likelihood(noisy)


def test_build_model_builds_the_dense_decoder_and_refuses_the_rest():
    cfg, db = _port_cfgs(MDM_CFG, JPAPER.MDM_DB)
    model = build_model(cfg, db)
    assert isinstance(model, DecoderModel) and model.n_units == 4
    assert "cond" in model.spec and "adaln" in model.spec["layers"]
    assert "cond" not in build_model(cfg).spec
    # every family now builds (the ssm one as ``XLSTMModel``); the dense
    # decoder itself still refuses another family's config
    with pytest.raises(NotImplementedError, match="family 'ssm'"):
        DecoderModel(dataclasses.replace(cfg, family="ssm"), db)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

VIT_CFG = dataclasses.replace(JPAPER.VIT_CIFAR, n_layers=4, d_model=64,
                              n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
                              vocab_size=10)
IMG, PATCH, BV = 8, 4, 3


@functools.cache
def _vit():
    jv = JViT(VIT_CFG, JPAPER.VIT_DB, image_size=IMG, patch=PATCH)
    tv = TVIT.ViTDiffusionBlocks(*_port_cfgs(VIT_CFG, JPAPER.VIT_DB),
                                 image_size=IMG, patch=PATCH)
    tree = np_(jv.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    _randomise(tree, ["layers"], rs)
    tree["final_norm"]["g"] = (1 + 0.1 * rs.randn(VIT_CFG.d_model)
                               ).astype(np.float32)
    return jv, tv, tree


def _vit_params():
    jv, tv, tree = _vit()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, "cpu", tv.spec))


def _images():
    x, y = JGMI(num_classes=10, image_size=IMG, seed=5).sample(
        np.random.RandomState(1), BV)
    return x, y


def _vit_draws(jv, b, rng):
    """σ and ε as the JAX ``block_loss`` draws them from ``rng``."""
    r_s, r_e = jax.random.split(rng)
    sigma = JEDM.sample_sigma_in_qrange(r_s, (BV, 1, 1), jv.db,
                                        *JP.block_qrange(jv.db, b))
    eps = jax.random.normal(r_e, (BV, 1, VIT_CFG.d_model), jnp.float32)
    return {"sigma": t(sigma), "eps": t(eps)}


def test_vit_bridge_and_spec():
    jv, tv, tree = _vit()
    params = params_from_jax(tree, "cpu", tv.spec)
    assert sorted(params) == ["cls", "cond", "final_norm", "head",
                              "label_emb", "layers", "patch", "pos"]
    assert tv.ranges == jv.ranges == [(0, 2), (2, 1), (3, 1)]
    assert tv.n_patches == jv.n_patches == 4
    assert dict(tree_items(jax.tree_util.tree_map(np.shape, tree))) == \
        {p: tuple(x.shape) for p, x in tree_items(params)}


def test_vit_tokens_match_jax():
    jv, tv, _ = _vit()
    jp, tp = _vit_params()
    x, _ = _images()
    z = np.random.RandomState(6).randn(BV, 1, VIT_CFG.d_model).astype(
        np.float32)
    np.testing.assert_array_equal(tv.patchify(t(x)).numpy(),
                                  np.asarray(jv.patchify(jnp.asarray(x))))
    close(tv.tokens(tp, t(x), t(z)),
          jv.tokens(jp, jnp.asarray(x), jnp.asarray(z)))
    close(tv.label_table(tp), jv.label_table(jp))


@pytest.mark.parametrize("b", [0, 1, 2, "e2e"])
def test_vit_losses_and_grads_match_jax(b):
    """block_loss per block and e2e_loss: values and every param's gradient
    (the block's layers and the periphery; zero elsewhere)."""
    jv, tv, _ = _vit()
    jp, tp = _vit_params()
    x, y = _images()
    rng = jax.random.PRNGKey(10)
    if b == "e2e":
        jl = lambda p: jv.e2e_loss(p, jnp.asarray(x),  # noqa: E731
                                   jnp.asarray(y), rng)[0]
        tl = lambda p: tv.e2e_loss(p, t(x), t(y))  # noqa: E731
    else:
        jl = lambda p: jv.block_loss(p, b, jnp.asarray(x),  # noqa: E731
                                     jnp.asarray(y), rng)[0]
        draws = _vit_draws(jv, b, rng)
        tl = lambda p: tv.block_loss(p, b, t(x), t(y),  # noqa: E731
                                     **draws)
    want, jg = jax.value_and_grad(jl)(jp)
    leaves = [x.requires_grad_() for _, x in tree_items(tp)]
    got, metrics = tl(tp)
    assert "ce" in metrics
    close(got, want)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    _grads_close(tp, grads, jg)


def test_vit_loss_ref_equals_kernels_path():
    jv, tv, _ = _vit()
    _, tp = _vit_params()
    x, y = _images()
    draws = _vit_draws(jv, 1, jax.random.PRNGKey(11))
    lk = tv.block_loss(tp, 1, t(x), t(y), **draws)[0]
    lr = tv.block_loss(tp, 1, t(x), t(y), **draws, impl="ref")[0]
    close(lk, lr, 1e-6, 1e-6)


@pytest.mark.parametrize("steps", [None, 5])
@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_vit_predict_matches_jax(impl, steps):
    """The Euler chain from JAX's z0 (σ_max · normal(rng)): classes
    identical, logits within 1e-4; and ``predict_e2e``."""
    jv, tv, _ = _vit()
    jp, tp = _vit_params()
    x, _ = _images()
    rng = jax.random.PRNGKey(7)
    want_c, want = jv.predict(jp, jnp.asarray(x), rng, num_steps=steps)
    z0 = jv.db.sigma_max * jax.random.normal(rng, (BV, 1, VIT_CFG.d_model))
    got_c, got = tv.predict(tp, t(x), steps, z0=t(z0), impl=impl)
    close(got, want)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    want_c, want = jv.predict_e2e(jp, jnp.asarray(x))
    got_c, got = tv.predict_e2e(tp, t(x), impl=impl)
    close(got, want)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert TVIT.accuracy(got_c, np.asarray(want_c)) == 1.0


def _record_calls(monkeypatch):
    """The kernel wrappers the path calls (their plain versions on the
    CPU), by name, with the attention tensors' head dims and whether each
    takes the fp32 kernels' 16-byte copies."""
    seen = []
    for mod, name in ((FA, "flash_attention_fwd"),
                      (FA, "flash_attention_bwd_dq"),
                      (FA, "flash_attention_bwd_dkv"),
                      (AD, "gate_residual_fwd"), (AD, "gate_residual_bwd"),
                      (AD, "ln_modulate_fwd"), (AD, "euler_fwd")):
        fn = getattr(mod, name)

        def record(*args, _fn=fn, _name=name, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)
                       and a.ndim == 4]
            seen.append((_name, {a.shape[-1] for a in tensors},
                         all(FA.tc_aligned(a.data_ptr(), a.stride(), 4)
                             for a in tensors)))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, record)
    return seen


def _counts(seen):
    out = {}
    for name, _, _ in seen:
        out[name] = out.get(name, 0) + 1
    return out


def test_vit_paths_call_the_hd32_attention_kernels_only(monkeypatch):
    """A DB step on block 0 (2 layers) calls the attention forward, dq and
    dk/dv once a layer at hd 32 on views the fp32 kernels copy in 16-byte
    chunks, and no AdaLN kernel (the label token's ``cond_mask``); an e2e
    step 4 of each; ``predict`` one forward a layer evaluation and one
    Euler step a step."""
    jv, tv, _ = _vit()
    _, tp = _vit_params()
    x, y = _images()
    seen = _record_calls(monkeypatch)
    init, step = TVIT.make_db_step(tv, 0, TCFG)
    step(tp, init(tp), t(x), t(y), **_vit_draws(jv, 0,
                                                jax.random.PRNGKey(1)))
    attn = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
    assert _counts(seen) == {n: 2 for n in attn}
    assert all(hd == {32} and aligned for _, hd, aligned in seen)
    seen.clear()
    init, step = TVIT.make_e2e_step(tv, TCFG)
    step(tp, init(tp), t(x), t(y))
    assert _counts(seen) == {n: 4 for n in attn}
    seen.clear()
    tv.predict(tp, t(x), 5, generator=torch.Generator().manual_seed(0))
    evals = sum(tv.ranges[JP.block_of_sigma(jv.db, float(s))][1]
                for s in JP.sampling_schedule(jv.db, 5)[:-1])
    assert _counts(seen) == {"flash_attention_fwd": evals, "euler_fwd": 5}


def test_vit_db_step_matches_jax_adamw_on_the_block_view():
    """One ViT DB step on block 0 through the port's block view: the view's
    params and AdamW moments within 1e-4 of ``repro.optim.adamw`` (through
    JAX's ``make_optimizer``) applied to JAX's gradients of that view; the
    other blocks' layers untouched, moments only for the view."""
    jv, tv, _ = _vit()
    jp, tp = _vit_params()
    x, y = _images()
    b = 0
    start, size = jv.ranges[b]
    rng = jax.random.PRNGKey(12)
    jl, jg = jax.value_and_grad(lambda p: jv.block_loss(
        p, b, jnp.asarray(x), jnp.asarray(y), rng)[0])(jp)
    jview = JT.extract_block_view(jp, start, size)
    opt_init, opt_update = JT.make_optimizer(TCFG)
    upd, jst, _ = opt_update(JT.extract_block_view(jg, start, size),
                             opt_init(jview), jview)
    jview2 = apply_updates(jview, upd)

    before = {p: x.clone() for p, x in tree_items(tp)}
    init, step = TVIT.make_db_step(tv, b, TCFG)
    tp2, opt, loss, m = step(tp, init(tp), t(x), t(y),
                             **_vit_draws(jv, b, rng))
    assert tp2 is tp and "ce" in m and "grad_norm" in m
    close(loss, jl)
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
def test_vit_train_loop_on_cpu(blockwise):
    """The Table 1 loop (DB and e2e): finite losses; a block per step
    (blockwise) or the full stack; the trained params move."""
    _, tv, _ = _vit()
    _, tp = _vit_params()
    before = {p: x.clone() for p, x in tree_items(tp)}
    data = TGMI(num_classes=10, image_size=IMG, seed=5).iterator(BV)
    tcfg = TC.TrainConfig(steps=3, warmup_steps=1, lr=1e-3, log_every=0)
    tp, hist = TVIT.train(tv, tcfg, data, torch.Generator().manual_seed(0),
                          params=tp, blockwise=blockwise)
    assert [h[0] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h[2]) for h in hist)
    assert all((h[1] in (0, 1, 2)) if blockwise else h[1] == -1
               for h in hist)
    moved = {p[0] for p, x in tree_items(tp) if not torch.equal(x, before[p])}
    assert moved >= {"layers", "patch", "pos", "head"}


# ---------------------------------------------------------------------------
# Masked diffusion
# ---------------------------------------------------------------------------

MDM_CFG = dataclasses.replace(JPAPER.MDM, n_layers=4, d_model=128,
                              n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256)
BM, SM = 2, 16


@functools.cache
def _mdm():
    jm = JMDM(MDM_CFG, JPAPER.MDM_DB)
    tm = TMASK.MaskedDiffusionBlocks(*_port_cfgs(MDM_CFG, JPAPER.MDM_DB))
    tree = np_(jm.init(jax.random.PRNGKey(2)))
    rs = np.random.RandomState(4)
    _randomise(tree, ["layers"], rs)
    return jm, tm, tree


def _mdm_params():
    jm, tm, tree = _mdm()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, "cpu", tm.spec))


def _text():
    return JMarkov(vocab_size=31, seed=4).sample(np.random.RandomState(1),
                                                 BM, SM)


def _mdm_draws(jm, b, rng):
    """t (before its 1e-3 floor) and the mask uniforms as the JAX
    ``block_loss`` draws them from ``rng``."""
    r_t, r_m = jax.random.split(rng)
    lo, hi = jm.t_range(b)
    return {"t": t(jax.random.uniform(r_t, (BM, 1), minval=lo, maxval=hi)),
            "u": t(jax.random.uniform(r_m, (BM, SM)))}


def test_mdm_partition_equals_jax():
    jm, tm, tree = _mdm()
    assert tm.ranges == jm.ranges and tm.mask_id == jm.mask_id == 31
    for b in range(3):
        assert tm.t_range(b) == jm.t_range(b)
    for x in list(np.linspace(0, 1, 41)) + [1e-3, 1 / 3, 2 / 3]:
        assert tm.block_of_t(float(x)) == jm.block_of_t(float(x))
    params = params_from_jax(tree, "cpu", tm.spec)
    assert dict(tree_items(jax.tree_util.tree_map(np.shape, tree))) == \
        {p: tuple(x.shape) for p, x in tree_items(params)}


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 50, 64, 100, 127, 200])
def test_mdm_sampler_times_equal_jnp_linspace(n):
    assert TMASK.sampler_times(n).tobytes() == \
        np.asarray(jnp.linspace(1.0, 0.0, n + 1)).tobytes()


@pytest.mark.parametrize("b", [0, 1, 2, "e2e"])
def test_mdm_losses_and_grads_match_jax(b):
    """Eq. (13) per block and the e2e loss: values and every param's
    gradient, from JAX's t and mask draws."""
    jm, tm, _ = _mdm()
    jp, tp = _mdm_params()
    x = _text()
    rng = jax.random.PRNGKey(20)
    if b == "e2e":
        jl = lambda p: jm.e2e_loss(p, jnp.asarray(x), rng)[0]  # noqa: E731
        draws = _mdm_draws(jm, 0, rng)
        tl = lambda p: tm.e2e_loss(p, t(x), **draws)  # noqa: E731
    else:
        jl = lambda p: jm.block_loss(p, b, jnp.asarray(x),  # noqa: E731
                                     rng)[0]
        draws = _mdm_draws(jm, b, rng)
        tl = lambda p: tm.block_loss(p, b, t(x), **draws)  # noqa: E731
    want, jg = jax.value_and_grad(jl)(jp)
    leaves = [x.requires_grad_() for _, x in tree_items(tp)]
    got, metrics = tl(tp)
    assert {"ce", "mask_rate"} <= set(metrics)
    assert float(metrics["mask_rate"]) > 0
    close(got, want)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    _grads_close(tp, grads, jg)


def test_mdm_loss_ref_equals_kernels_path():
    jm, tm, _ = _mdm()
    _, tp = _mdm_params()
    draws = _mdm_draws(jm, 0, jax.random.PRNGKey(21))
    lk = tm.block_loss(tp, 0, t(_text()), **draws)[0]
    lr = tm.block_loss(tp, 0, t(_text()), **draws, impl="ref")[0]
    close(lk, lr, 1e-6, 1e-6)


@pytest.mark.parametrize("blockwise", [True, False])
def test_mdm_nelbo_bpc_matches_jax(blockwise):
    """The Monte-Carlo NELBO in bits/char from JAX's draws of every
    (sample, block)."""
    jm, tm, _ = _mdm()
    jp, tp = _mdm_params()
    x = _text()
    rng = jax.random.PRNGKey(5)
    want = jm.nelbo_bpc(jp, jnp.asarray(x), rng, n_samples=2,
                        blockwise=blockwise)
    draws = []
    for _ in range(2):
        for b in range(jm.db.num_blocks if blockwise else 1):
            rng, r = jax.random.split(rng)
            d = _mdm_draws(jm, b, r)
            draws.append((d["t"], d["u"]))
    got = tm.nelbo_bpc(tp, t(x), n_samples=2, blockwise=blockwise,
                       draws=draws)
    close(got, want)


def _jax_generate(jm, jp, rng, n):
    """JAX's ``generate`` step by step with its own keys: the Gumbel noise
    and unmask uniforms it draws, the tokens, and the number of sampled
    positions whose top-two margin (of logits + gumbel, or of the final
    greedy logits) is below 1e-4."""
    x = jnp.full((BM, SM), jm.mask_id, jnp.int32)
    ts = jnp.linspace(1.0, 0.0, n + 1)
    gs, us, near = [], [], 0

    def margins(scores):
        top2 = np.sort(np.asarray(scores), -1)[..., -2:]
        return top2[..., 1] - top2[..., 0]

    for i in range(n):
        t_now, t_next = float(ts[i]), float(ts[i + 1])
        start, size = jm.ranges[jm.block_of_t(max(t_now, 1e-3))]
        rng, r_c, r_u = jax.random.split(rng, 3)
        logits, _ = jm._forward(jp, x, jnp.full((BM,), max(t_now, 1e-3)),
                                start, size)
        logits = logits.astype(jnp.float32)
        g = jax.random.gumbel(r_c, logits.shape, jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(jax.random.categorical(r_c, logits)),
            np.asarray(jnp.argmax(logits + g, -1)))
        u = jax.random.uniform(r_u, x.shape)
        p_unmask = (t_now - t_next) / max(t_now, 1e-6)
        unmask = (u < p_unmask) & (x == jm.mask_id)
        near += int((np.asarray(unmask) & (margins(logits + g) < 1e-4)).sum())
        x = jnp.where(unmask, jnp.argmax(logits + g, -1), x)
        gs.append(t(g))
        us.append(t(u))
    start, size = jm.ranges[jm.db.num_blocks - 1]
    logits, _ = jm._forward(jp, x, jnp.full((BM,), 1e-3), start, size)
    left = np.asarray(x == jm.mask_id)
    near += int((left & (margins(logits) < 1e-4)).sum())
    x = jnp.where(left, jnp.argmax(logits, -1), x)
    return np.asarray(x), gs, us, near


@pytest.mark.parametrize("n", [6, 16])
def test_mdm_generate_matches_jax(n):
    """Iterative demasking from JAX's Gumbel noise and unmask uniforms:
    tokens identical to ``repro.core.masked.generate``'s. Positions whose
    top-two margin under JAX is below 1e-4 (where the two sides' 1e-6
    differences in the logits could pick another token) are counted and
    printed."""
    jm, tm, _ = _mdm()
    jp, tp = _mdm_params()
    rng = jax.random.PRNGKey(6)
    want = np.asarray(jm.generate(jp, rng, BM, SM, num_steps=n))
    replay, gs, us, near = _jax_generate(jm, jp, rng, n)
    np.testing.assert_array_equal(replay, want)
    print(f"generate, {n} steps: {near} sampled positions with a top-two "
          "margin below 1e-4 under JAX")
    got = tm.generate(tp, BM, SM, n, gumbel_noise=gs, u=us)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mdm_paths_call_the_gate_residual_kernels(monkeypatch):
    """A DB step over a block of 2 layers calls the attention kernels once
    a layer at hd 64 on 16-byte-copy views and the gate-residual forward and
    backward twice a layer (the t embedding on every position, no
    ``cond_mask``), never ln-modulate (parametric LayerNorm); ``generate``
    one attention and two gate-residual forwards a layer evaluation."""
    jm, tm, _ = _mdm()
    _, tp = _mdm_params()
    seen = _record_calls(monkeypatch)
    init, step = TMASK.make_db_step(tm, 0, TCFG)
    step(tp, init(tp), t(_text()), **_mdm_draws(jm, 0,
                                                jax.random.PRNGKey(3)))
    assert _counts(seen) == {"flash_attention_fwd": 2,
                             "flash_attention_bwd_dq": 2,
                             "flash_attention_bwd_dkv": 2,
                             "gate_residual_fwd": 4, "gate_residual_bwd": 4}
    assert all(aligned for _, _, aligned in seen)
    assert {hd for _, hds, _ in seen for hd in hds} == {64}
    seen.clear()
    tm.generate(tp, BM, SM, 4, generator=torch.Generator().manual_seed(0))
    evals = sum(tm.ranges[tm.block_of_t(max(float(s), 1e-3))][1]
                for s in TMASK.sampler_times(4)[:-1]) + tm.ranges[-1][1]
    assert _counts(seen) == {"flash_attention_fwd": evals,
                             "gate_residual_fwd": 2 * evals}


def test_mdm_db_step_matches_jax_adamw_on_the_block_view():
    """One MDM DB step on block 1 through the port's block view against
    ``repro.optim.adamw`` on JAX's gradients of that view (params and
    moments within 1e-4); the other blocks' layers untouched."""
    jm, tm, _ = _mdm()
    jp, tp = _mdm_params()
    x = _text()
    b = 1
    start, size = jm.ranges[b]
    rng = jax.random.PRNGKey(22)
    jl, jg = jax.value_and_grad(
        lambda p: jm.block_loss(p, b, jnp.asarray(x), rng)[0])(jp)
    jview = JT.extract_block_view(jp, start, size)
    opt_init, opt_update = JT.make_optimizer(TCFG)
    upd, jst, _ = opt_update(JT.extract_block_view(jg, start, size),
                             opt_init(jview), jview)
    jview2 = apply_updates(jview, upd)

    before = {p: x.clone() for p, x in tree_items(tp)}
    init, step = TMASK.make_db_step(tm, b, TCFG)
    tp2, opt, loss, m = step(tp, init(tp), t(x), **_mdm_draws(jm, b, rng))
    assert tp2 is tp and "grad_norm" in m
    close(loss, jl)
    _tree_close(params_to_numpy(TT.extract_block_view(tp, start, size)),
                np_(jview2))
    _tree_close(params_to_numpy(opt.mu), np_(jst.mu))
    _tree_close(params_to_numpy(opt.nu), np_(jst.nu))
    for path, x in tree_items(tp):
        if path[0] == "layers":
            assert torch.equal(x[:start], before[path][:start]), path
            assert torch.equal(x[start + size:],
                               before[path][start + size:]), path


@pytest.mark.parametrize("blockwise", [True, False])
def test_mdm_train_loop_on_cpu(blockwise):
    """The Table 3 loop: finite losses, a block per step or the full stack,
    then the evaluation (bpc, a generation) of the result."""
    _, tm, _ = _mdm()
    _, tp = _mdm_params()
    lm = TMarkov(vocab_size=31, seed=4)
    tcfg = TC.TrainConfig(steps=3, warmup_steps=1, lr=1e-3, log_every=0)
    gen = torch.Generator().manual_seed(0)
    tp, hist = TMASK.train(tm, tcfg, lm.iterator(BM, SM), gen, params=tp,
                           blockwise=blockwise)
    assert [h[0] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h[2]) for h in hist)
    assert all((h[1] in (0, 1, 2)) if blockwise else h[1] == -1
               for h in hist)
    bpc = float(tm.nelbo_bpc(tp, t(_text()), gen, 2, blockwise))
    assert np.isfinite(bpc) and bpc > 0
    x = tm.generate(tp, BM, SM, 4, generator=gen)
    assert x.shape == (BM, SM) and x.dtype == torch.long
    assert 0 <= int(x.min()) and int(x.max()) <= tm.mask_id
