"""PyTorch port: the VLM's training (llama-3.2-vision-11b's ``VLMModel``
in ``train`` and two-pass) against the JAX package on the CPU.

``reduced(llama-3.2-vision-11b)`` with 4 layers: 2 superblocks of 1 self
layer and 1 cross layer, d = 256, 4 heads of 64 on 1 KV head (the
published 32:8), 16 image tokens, vocabulary 512; 2 blocks of 1
superblock. The JAX init is bridged to the port (``params_from_jax``: the
``units/self`` stack (units, k_self, ...) and ``units/cross`` with
``xgate``) with the AdaLN heads and the RMSNorm gains randomised and the
cross gates opened (``xgate`` is 0 at init: tanh(0) = 0 would leave the
cross layers out of every loss and gradient). Image embeddings and tokens
come from numpy seeds; σ and ε are drawn on the JAX side the way
``block_loss`` draws them and handed to the port. The port runs
``impl="kernels"``, whose wrappers take their plain versions on CPU
tensors (the cross-attention through the ``full`` kind at Sq != Sk, 4
query heads on 1 KV head); JAX runs its plain path (``impl="auto"``).
Tolerance 1e-4 (atol and rtol) on losses, gradients, moments and updated
params, all fp32; 2e-2 on the bf16 cross layer.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gqa_train import _assert_step_close

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.models import common as JCOM
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.models import common as TCOM
from repro_torch.nn.init import tree_items, tree_map

torch.set_num_threads(1)
TOL = 1e-4
ARCH = "llama-3.2-vision-11b"
CFG = dataclasses.replace(JC.reduced(JC.get_config(ARCH)), n_layers=4)
T_CFG = dataclasses.replace(TC.reduced(TC.get_config(ARCH)), n_layers=4)
B, SEQ = 2, 12
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def test_reduced_config_keeps_the_vlm_under_test():
    assert dataclasses.asdict(T_CFG) == dataclasses.asdict(CFG)
    assert (CFG.n_heads, CFG.n_kv_heads, CFG.head_dim) == (4, 1, 64)
    assert (CFG.cross_attn_every, CFG.n_image_tokens) == (2, 16)
    _, tdbm = _models()
    assert (tdbm.model.n_units, tdbm.model.k_self) == (2, 1)
    assert tdbm.ranges == [(0, 1), (1, 1)]


def _models(mode="concat", loss="ce"):
    db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1, causal_mode=mode,
                     loss=loss)
    return JDBM(CFG, db), TDBM(T_CFG, TC.DBConfig(**dataclasses.asdict(db)))


@functools.cache
def _tree():
    """The JAX init as numpy, AdaLN heads and norm gains randomised and
    the cross gates opened. Read-only for callers."""
    jdbm, _ = _models()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    for part in ("self", "cross"):
        lay = tree["units"][part]
        for k in ("w", "b"):
            lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                               ).astype(np.float32)
        for ln in ("ln1", "ln2"):
            lay[ln]["g"] = (1.0 + 0.1 * rs.randn(*lay[ln]["g"].shape)
                            ).astype(np.float32)
    x = tree["units"]["cross"]["xgate"]
    tree["units"]["cross"]["xgate"] = (0.8 + 0.2 * rs.randn(*x.shape)
                                       ).astype(np.float32)
    return tree


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def _tokens():
    return np.random.RandomState(1).randint(0, CFG.vocab_size, (B, SEQ))


def images(seed):
    """(B, n_image_tokens, d) fp32 patch embeddings."""
    return np.random.RandomState(seed).randn(
        B, CFG.n_image_tokens, CFG.d_model).astype(np.float32)


def draws(jdbm, b, rng):
    """σ (B,1,1) and ε (B,S,d) as ``block_loss`` draws them from ``rng``."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, SEQ, CFG.d_model), jnp.float32)
    return t(sigma), t(eps)


# ---------------------------------------------------------------------------
# The cross layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", ["fp32", "bf16_stream_fp32_images"])
def test_cross_layer_train_mode_matches_jax(dtypes):
    """``tlayer_apply(cross=True)`` in ``train``: q from the text stream
    (12 tokens), k and v from the images (16 tokens), no rope, unmasked
    (the kernels' ``full`` kind at Sq != Sk, 4 query heads on 1 KV head),
    the tanh gate, then the σ-gate; on the first unit's cross params under
    a σ conditioning. fp32: the output and the gradients of the stream, the
    images and every cross param within 1e-4 of JAX's. A bf16 stream over
    fp32 images (the bf16 policy with ``conditioning_pool``'s images): the
    output bf16 in both packages, within 2e-2 of JAX's."""
    jdbm, tdbm = _models()
    tree = _tree()
    cross = jax.tree_util.tree_map(lambda a: a[0], tree["units"]["cross"])
    rs = np.random.RandomState(4)
    x = rs.randn(B, SEQ, CFG.d_model).astype(np.float32)
    mem = images(5)
    dout = rs.randn(B, SEQ, CFG.d_model).astype(np.float32)
    log_sigma = np.log(np.array([0.3, 1.7], np.float32))
    bf = dtypes != "fp32"

    def jf(p, x_, m_):
        ctx = JCOM.LayerCtx(cfg=CFG, mode="train",
                            positions=jnp.arange(SEQ), kv_x=m_,
                            kv_positions=jnp.arange(CFG.n_image_tokens),
                            impl="auto")
        ctx.cond = jdbm.model.cond(jparams(tree), jnp.asarray(log_sigma))
        return JCOM.tlayer_apply(p, x_, ctx, cross=True)[0]
    @jax.jit
    def jvg(p, x_, m_, dout_):
        out, vjp = jax.vjp(jf, p, x_, m_)
        return out, vjp(dout_.astype(out.dtype))
    jx = jnp.asarray(x, jnp.bfloat16 if bf else jnp.float32)
    want, (jg, jgx, jgm) = jvg(jparams(cross), jx, jnp.asarray(mem),
                               jnp.asarray(dout))

    params = tparams(tdbm, tree)
    tp = tree_map(lambda _, v: v[0], params["units"]["cross"])
    leaves = [v.requires_grad_() for _, v in tree_items(tp)]
    tx = t(x).to(torch.bfloat16 if bf else torch.float32).requires_grad_()
    tm = t(mem).requires_grad_()
    ctx = TCOM.LayerCtx(cfg=T_CFG, mode="train", positions=torch.arange(SEQ),
                        kv_x=tm, kv_positions=torch.arange(
                            CFG.n_image_tokens), impl="kernels")
    ctx.cond = tdbm.model.cond(params, t(log_sigma))
    got, _ = TCOM.tlayer_apply(tp, tx, ctx, cross=True)
    assert got.dtype == tx.dtype
    assert str(want.dtype) == ("bfloat16" if bf else "float32")
    if bf:
        close(got, np.asarray(want, np.float32), 2e-2)
        return
    close(got, want)
    grads = torch.autograd.grad(got, leaves + [tx, tm], t(dout))
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for (path, _), g in zip(tree_items(tp), grads):
        close(g, want_g[path])
    close(grads[-2], jgx)
    close(grads[-1], jgm)


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 0),
                                         ("two_pass", "l2", 1)])
def test_block_loss_and_grads_match_jax(mode, loss, b):
    """``block_loss(aux_inputs={"image_embs": ...})`` under concat x CE
    (block 0) and two_pass x l2 (block 1; both streams through the cross
    layer, σ-modulated, as JAX's): the loss and the gradient of every param
    within 1e-4 of JAX's (None where the block does not read it, as JAX's
    zeros), the cross layer's ``xgate``, ``wk`` and ``wv`` among them,
    nonzero."""
    jdbm, tdbm = _models(mode, loss)
    tree, tokens, mem = _tree(), _tokens(), images(8)
    rng = jax.random.PRNGKey(10 + b)
    jl = lambda p: jdbm.block_loss(  # noqa: E731
        p, b, jnp.asarray(tokens), rng,
        aux_inputs={"image_embs": jnp.asarray(mem)})
    (want, jm), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jparams(tree))
    sigma, eps = draws(jdbm, b, rng)
    params = tparams(tdbm, tree)
    leaves = [x.requires_grad_() for _, x in tree_items(params)]
    got, tm = tdbm.block_loss(params, b, t(tokens), sigma=sigma, eps=eps,
                              aux_inputs={"image_embs": t(mem)})
    close(got, want)
    close(tm["aux"], jm["aux"])
    grads = dict(zip((p for p, _ in tree_items(params)),
                     torch.autograd.grad(got, leaves, allow_unused=True)))
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for path, g in grads.items():
        if g is None:
            assert not np.any(want_g[path]), path
        else:
            close(g, want_g[path])
    for path in (("units", "cross", "xgate"),
                 ("units", "cross", "attn", "wk"),
                 ("units", "cross", "attn", "wv")):
        g = grads[path][b]
        assert g.abs().max() > 0, path
        close(g, want_g[path][b])


@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 1),
                                         ("two_pass", "l2", 0)])
def test_db_train_step_matches_jax(mode, loss, b):
    """One fp32 DB step with images (concat x CE on block 1, two_pass x l2
    on block 0): loss, AdamW moments and updated params within 1e-4 of
    JAX's (as ``_assert_step_close`` holds them); the other block's
    superblock untouched, and no moment exists for it."""
    jdbm, tdbm = _models(mode, loss)
    tree, tokens, mem = _tree(), _tokens(), images(9)
    rng = jax.random.PRNGKey(20 + b)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="auto",
                                           precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens), rng,
                                  {"image_embs": jnp.asarray(mem)})
    params = tparams(tdbm, tree)
    before = {p: x.clone() for p, x in tree_items(params)}
    t_init, t_step = TT.make_db_train_step(tdbm, b, TCFG, precision="fp32")
    sigma, eps = draws(jdbm, b, rng)
    _, opt2, loss_, _ = t_step(params, t_init(params), t(tokens), sigma=sigma,
                               eps=eps, aux_inputs={"image_embs": t(mem)})
    close(loss_, jloss)
    _assert_step_close(_unit_rows(params), _unit_rows(opt2),
                       _unit_rows(jp2), _unit_rows(jopt2), tdbm.ranges[b])
    for path, x in tree_items(opt2.mu["units"]):
        assert x.shape[0] == 1, path
    other = 1 - b
    for path, x in tree_items(params):
        if path[0] == "units":
            assert torch.equal(x[other], before[path][other]), path


def _unit_rows(tree):
    """``tree`` (params, or an AdamW state) with ``units`` renamed
    ``layers`` (the stacked axis ``_assert_step_close`` slices)."""
    if hasattr(tree, "mu"):
        return types.SimpleNamespace(mu=_unit_rows(tree.mu),
                                     nu=_unit_rows(tree.nu))
    return {("layers" if k == "units" else k): v for k, v in tree.items()}


def test_e2e_train_step_matches_jax():
    """One fp32 end-to-end step over both superblocks with images: loss,
    moments and updated params within 1e-4 of JAX's."""
    jdbm, tdbm = _models()
    tree, tokens, mem = _tree(), _tokens(), images(10)
    j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                            precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens),
                                  jax.random.PRNGKey(0),
                                  {"image_embs": jnp.asarray(mem)})
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_e2e_train_step(tdbm, TCFG, precision="fp32")
    params, opt2, loss_, m = t_step(params, t_init(params), t(tokens),
                                    aux_inputs={"image_embs": t(mem)})
    close(loss_, jloss)
    assert float(m["aux"]) == 0.0
    _assert_step_close(_unit_rows(params), _unit_rows(opt2),
                       _unit_rows(jp2), _unit_rows(jopt2))


def test_training_without_images_raises():
    """The cross layer needs the images on the training path, as JAX's."""
    _, tdbm = _models()
    params = tparams(tdbm, _tree())
    with pytest.raises(ValueError, match="no conditioning memory"):
        tdbm.block_loss(params, 0, t(_tokens()), torch.Generator())
    with pytest.raises(ValueError, match="no conditioning memory"):
        tdbm.e2e_loss(params, t(_tokens()))
