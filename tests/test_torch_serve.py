"""PyTorch port: the whole serving slice against the JAX package on the CPU.

``repro_torch.launch.serve.generate`` (the port's main path: chunked
prefill, then denoise → sample → commit, every kernel wrapper running its
plain version on CPU tensors) against ``repro.launch.serve.generate``
(``impl="auto"``) on bridged params with randomised AdaLN heads and norm
gains. The JAX engine draws each step's initial z inside its decode scan;
the test replays that split chain (``serve.py`` decode body, then
``blocks.serve_step_paged`` and ``denoise_next_token``) and hands the draws
to the port as numpy.

Under fp32 the greedy tokens are identical and the prefilled page pools
agree to 1e-4; under bf16 the first generated step's logits agree within
5e-2 · max|logit| (bf16 rounds at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import precision as JPREC
from repro.core import DiffusionBlocksModel as JDBM
from repro.launch import serve as JS
from repro.nn import cache as JKVC
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import serve as TS
from repro_torch.nn import cache as TKVC

# small tensors: one torch thread is as fast, and the suite's xdist workers
# share the cores with JAX
torch.set_num_threads(1)

TINY = JC.ModelConfig(name="tiny-decode", family="dense", n_layers=6,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=32)
REDUCED = JC.reduced(JC.get_config("stablelm-1.6b"))
CFGS = {"tiny": TINY, "stablelm_reduced": REDUCED}
B, S0, MAX_NEW, CHUNK = 3, 9, 5, 4
SEED_RNG = 7


def models(cfg, blocks=3, seed=0):
    db = JC.DBConfig(num_blocks=min(blocks, cfg.n_layers), overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        for k, base in (("g", 1.0), ("b", 0.0)):
            if k in lay[ln]:
                lay[ln][k] = (base + 0.1 * rs.randn(*lay[ln][k].shape)
                              ).astype(np.float32)
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    tdbm = TDBM(tcfg, TC.DBConfig(**dataclasses.asdict(db)))
    return (jdbm, jax.tree_util.tree_map(jnp.asarray, tree), tdbm,
            params_from_jax(tree, "cpu", tdbm.model.spec))


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    return (CFGS[request.param],) + models(CFGS[request.param])


def jax_z_draws(n, d, sigma_max):
    """The initial z of each of the JAX engine's n decode steps."""
    rng, zs = jax.random.PRNGKey(SEED_RNG), []
    for _ in range(n):
        rng, rs = jax.random.split(rng)             # serve.py decode body
        r_noise, _ = jax.random.split(rs)           # blocks.py serve_step
        zs.append(np.asarray(sigma_max * jax.random.normal(r_noise,
                                                           (B, 1, d))))
    return np.stack(zs)


def jax_gumbel_draws(n, vocab):
    """The categorical's Gumbel noise of each of the JAX engine's n decode
    steps (``jax.random.categorical`` is argmax(logits + gumbel))."""
    rng, gs = jax.random.PRNGKey(SEED_RNG), []
    for _ in range(n):
        rng, rs = jax.random.split(rng)             # serve.py decode body
        _, r_samp = jax.random.split(rs)            # blocks.py serve_step
        gs.append(np.asarray(jax.random.gumbel(r_samp, (B, vocab),
                                               jnp.float32)))
    return np.stack(gs)


def _prompts(cfg, ragged):
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, cfg.vocab_size, size=(B, S0)).astype(np.int32)
    plens = np.array([S0, 4, 6], np.int32) if ragged else None
    return prompts, plens


def _prefill(jdbm, jparams, tdbm, tparams, prompts, plens, precision):
    """Both engines' chunked prefill from empty pools; returns the pools and
    the slots' lengths."""
    pps = JKVC.pages_for(S0 + MAX_NEW, JKVC.DEFAULT_PAGE_SIZE)
    pl = np.full((B,), S0, np.int32) if plens is None else plens
    jeng = JS.get_engine(jdbm, precision=precision, chunk_size=CHUNK)
    jkv = jdbm.model.init_paged_cache(B, 1 + B * pps,
                                      JKVC.DEFAULT_PAGE_SIZE, jeng.pol)
    jtable = JKVC.identity_page_table(B, pps)
    jkv, jlens = jeng.run_prefill(jparams, jkv, jtable,
                                  jnp.zeros((B,), jnp.int32),
                                  jnp.asarray(prompts), jnp.asarray(pl))
    teng = TS.get_engine(tdbm, precision=precision, chunk_size=CHUNK)
    tkv = tdbm.model.init_paged_cache(B, 1 + B * pps, TKVC.DEFAULT_PAGE_SIZE,
                                      teng.pol, device="cpu")
    ttable = TKVC.identity_page_table(B, pps, device="cpu")
    tkv, tlens = teng.run_prefill(tparams, tkv, ttable,
                                  torch.zeros((B,), dtype=torch.int32),
                                  torch.from_numpy(prompts).long(),
                                  torch.from_numpy(pl))
    return (jkv, jtable, jlens), (tkv, ttable, tlens)


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_fp32_matches_jax(pair, ragged):
    cfg, jdbm, jparams, tdbm, tparams = pair
    prompts, plens = _prompts(cfg, ragged)
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), MAX_NEW,
                        rng=jax.random.PRNGKey(SEED_RNG),
                        prompt_lengths=plens, precision="fp32",
                        chunk_size=CHUNK)
    z0 = jax_z_draws(MAX_NEW, cfg.d_model, jdbm.db.sigma_max)
    eng = TS.get_engine(tdbm, precision="fp32", chunk_size=CHUNK)
    n_disp, n_pre = eng.dispatches, eng.prefill_steps
    out_t = TS.generate(tdbm, tparams, prompts, MAX_NEW,
                        prompt_lengths=plens, precision="fp32",
                        chunk_size=CHUNK, z0=torch.from_numpy(z0))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert eng.dispatches - n_disp == 2
    assert eng.prefill_steps - n_pre == -(-S0 // CHUNK)

    (jkv, _, jlens), (tkv, _, tlens) = _prefill(
        jdbm, jparams, tdbm, tparams, prompts, plens, "fp32")
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    for name in ("k", "v"):      # page 0 is the trash page
        np.testing.assert_allclose(getattr(tkv, name)[:, 1:].numpy(),
                                   np.asarray(getattr(jkv, name))[:, 1:],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("top_k", [0, 8])
def test_generate_sampled_matches_jax(pair, top_k):
    """Temperature 0.8: the static engine samples as JAX's categorical does,
    on JAX's Gumbel noise."""
    cfg, jdbm, jparams, tdbm, tparams = pair
    prompts, plens = _prompts(cfg, ragged=True)
    kw = dict(prompt_lengths=plens, temperature=0.8, top_k=top_k,
              precision="fp32", chunk_size=CHUNK)
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), MAX_NEW,
                        rng=jax.random.PRNGKey(SEED_RNG), **kw)
    out_t = TS.generate(
        tdbm, tparams, prompts, MAX_NEW,
        z0=jax_z_draws(MAX_NEW, cfg.d_model, jdbm.db.sigma_max),
        noise=jax_gumbel_draws(MAX_NEW, cfg.vocab_size), **kw)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_first_step_logits_bf16(pair):
    cfg, jdbm, jparams, tdbm, tparams = pair
    prompts, plens = _prompts(cfg, ragged=True)
    (jkv, jtable, jlens), (tkv, ttable, tlens) = _prefill(
        jdbm, jparams, tdbm, tparams, prompts, plens, "bf16")
    assert jkv.k.dtype == jnp.bfloat16 and tkv.k.dtype == torch.bfloat16
    rng, rs = jax.random.split(jax.random.PRNGKey(SEED_RNG))
    r_noise, _ = jax.random.split(rs)
    ctx = jdbm._paged_ctx(jparams, jlens, jtable, None, JPREC.BF16, "auto")
    d = jdbm.denoise_next_token(jparams, jkv, None, r_noise, ctx)
    logits_j = np.asarray(jdbm.model.logits(jparams, d)[:, 0], np.float32)
    z0 = jax_z_draws(1, cfg.d_model, jdbm.db.sigma_max)[0]
    _, _, _, logits_t = tdbm.serve_step_paged(
        tparams, tkv, ttable, tlens, z0=torch.from_numpy(z0),
        precision="bf16", return_logits=True)
    err = np.abs(logits_t.numpy() - logits_j).max()
    assert err <= 5e-2 * np.abs(logits_j).max(), err


def test_serve_cli_runs_on_cpu(capsys):
    TS.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
             "--max-new", "2", "--ragged"])
    out = capsys.readouterr().out
    assert "generated 2x2 tokens" in out and "dispatches=2" in out


def test_sampling_without_noise_raises(pair):
    tdbm = pair[3]
    logits = torch.zeros((B, tdbm.cfg.vocab_size))
    assert tdbm.sample_token(logits).tolist() == [0] * B
    with pytest.raises(ValueError, match="Gumbel"):
        tdbm.sample_token(logits, temperature=0.8)


def test_engine_rejects_unknown_impl(pair):
    tdbm = pair[3]
    with pytest.raises(ValueError, match="impl"):
        TS.DecodeEngine(tdbm, impl="auto")
