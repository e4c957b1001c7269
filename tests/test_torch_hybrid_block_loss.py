"""PyTorch port: the hybrid family's (zamba2) training losses against the
JAX package on the CPU: ``block_loss`` (routed to two-pass, the CE and l2
losses) of every block with σ and ε drawn on the JAX side, and
``e2e_loss``, on ``tests/test_torch_hybrid_train.py``'s models and helpers
(``TINY_HYBRID`` and ``reduced(zamba2-7b)``, bridged params with the AdaLN
heads and norm gains randomised). Values and gradients within 1e-4
(absolute and relative). A file of its own, so that ``--dist loadfile``
runs it beside the other half of the hybrid's training tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid_train import (  # noqa: F401 (fixtures)
    _draws, _tokens, close, reduced, t, tiny)

from repro_torch import configs as TC
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)


def _grads_match(loss, params, jgrads):
    leaves = [x for _, x in tree_items(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want[path]), path
        else:
            close(g, want[path])


def _with_grad(params):
    for _, x in tree_items(params):
        x.requires_grad_()
    return params


@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("loss", ["ce", "l2"])
@pytest.mark.parametrize("which", ["tiny", "reduced"])
def test_block_loss_matches_jax(which, loss, b, request):
    """``block_loss`` of block b, routed to two-pass: the loss and every
    param's gradient (zero outside the block's units and the periphery)
    within 1e-4 of JAX's, on JAX's σ and ε."""
    jdbm, jparams, tdbm, tparams = request.getfixturevalue(which)
    if loss == "l2":
        db = dataclasses.replace(jdbm.db, loss="l2")
        jdbm = type(jdbm)(jdbm.cfg, db)
        tdbm = type(tdbm)(tdbm.cfg, TC.DBConfig(**dataclasses.asdict(db)))
    assert tdbm.causal_mode == jdbm.causal_mode == "two_pass"
    tokens = _tokens(jdbm.cfg)
    rng = jax.random.PRNGKey(10 + b)
    jl = lambda p: jdbm.block_loss(p, b, jnp.asarray(tokens),  # noqa: E731
                                   rng, impl="auto")
    (want, jm), jg = jax.value_and_grad(jl, has_aux=True)(jparams)
    sigma, eps = _draws(jdbm, b, rng, tokens.shape[1])
    params = _with_grad(tparams)
    try:
        got, tm = tdbm.block_loss(params, b, t(tokens), sigma=sigma,
                                  eps=eps)
        assert loss in tm and loss in jm
        close(got, want)
        _grads_match(got, params, jg)
    finally:
        for _, x in tree_items(params):
            x.requires_grad_(False)


@pytest.mark.parametrize("which", ["tiny", "reduced"])
def test_e2e_loss_matches_jax(which, request):
    """``e2e_loss`` over every unit (the uncached ``apply_units`` in the
    train mode): loss and every param's gradient within 1e-4 of JAX's."""
    jdbm, jparams, tdbm, tparams = request.getfixturevalue(which)
    tokens = _tokens(jdbm.cfg, S=13)
    jl = lambda p: jdbm.e2e_loss(p, jnp.asarray(tokens),  # noqa: E731
                                 impl="auto")
    (want, _), jg = jax.value_and_grad(jl, has_aux=True)(jparams)
    params = _with_grad(tparams)
    try:
        got, _ = tdbm.e2e_loss(params, t(tokens))
        close(got, want)
        _grads_match(got, params, jg)
    finally:
        for _, x in tree_items(params):
            x.requires_grad_(False)
