"""PyTorch port: the audio family (whisper-small's ``EncDecModel``) against
the JAX package on the CPU.

``reduced(whisper-small)``: 2 encoder and 2 decoder layers, d = 256, 4
heads of 64, 32 audio frames, vocabulary 512; 2 blocks of 1 decoder layer.
The JAX init is bridged to the port (``params_from_jax``: the stacked
``encoder`` and ``layers`` axes and ``enc_norm``) with the AdaLN heads and
the norm gains randomised (at init they are the identity and would test
nothing). Audio embeddings and tokens come from numpy seeds; σ and ε are
drawn on the JAX side the way ``block_loss`` draws them and handed to the
port, and the serving draws are JAX's (``JaxDraws``). The port runs
``impl="kernels"``, whose wrappers take their plain versions on CPU
tensors (the cross-attention through the ``full`` kind at Sq != Sk); JAX
runs its plain path (``impl="auto"``), and its Pallas kernels (interpret
mode) for ``attention_fwd(kv_x=...)``. Tolerance 1e-4 (atol and rtol) on
values, gradients (the encoder's included), moments and updated params,
all fp32; greedy tokens and the batcher's logs must be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws
from test_torch_gqa_train import _assert_step_close

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import training as JT
from repro.launch import serve as JS
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core import training as TT
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import router as TR
from repro_torch.launch import serve as TS
from repro_torch.models import build_model
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL
from repro_torch.nn.init import tree_items, tree_map
from repro_torch.parallel import engine as TPE

torch.set_num_threads(1)
TOL = 1e-4
ARCH = "whisper-small"
CFG = JC.reduced(JC.get_config(ARCH))
B, SEQ = 2, 16
TCFG = JC.TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
CB_KW = dict(num_slots=2, max_prompt=12, max_len=24, seg_len=3, page_size=4,
             chunk_size=4, precision="fp32")
SEED = 11
WAIT_S = 30.0


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def _models(mode="concat", loss="ce"):
    db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1, causal_mode=mode,
                     loss=loss)
    return JDBM(CFG, db), TDBM(TC.ModelConfig(**dataclasses.asdict(CFG)),
                               TC.DBConfig(**dataclasses.asdict(db)))


@functools.cache
def _tree():
    """The JAX init as numpy, AdaLN heads and norm gains (decoder and
    encoder) randomised. Read-only for callers."""
    jdbm, _ = _models()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for part, lns in ((lay, ("ln1", "lnx", "ln2")),
                      (tree["encoder"], ("ln1", "ln2")),
                      (tree, ("enc_norm",))):
        for ln in lns:
            for k, base in (("g", 1.0), ("b", 0.0)):
                x = part[ln][k]
                part[ln][k] = (base + 0.1 * rs.randn(*x.shape)).astype(
                    np.float32)
    return tree


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def _tokens():
    return np.random.RandomState(1).randint(0, CFG.vocab_size, (B, SEQ))


def audio(seed=4, n=None, batch=None):
    """(n frames, d) fp32 embeddings, or (batch, n, d)."""
    n = CFG.n_audio_frames if n is None else n
    shape = (n, CFG.d_model) if batch is None else (batch, n, CFG.d_model)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def draws(jdbm, b, rng):
    """σ (B,1,1) and ε (B,S,d) as ``block_loss`` draws them from ``rng``."""
    r_sig, r_eps = jax.random.split(rng)
    sigma = jdbm.sample_block_sigma(r_sig, (B, 1, 1), b)
    eps = jax.random.normal(r_eps, (B, SEQ, CFG.d_model), jnp.float32)
    return t(sigma), t(eps)


# ---------------------------------------------------------------------------
# The model, its bridge, the positions and the encoder
# ---------------------------------------------------------------------------

def test_build_model_bridges_the_encdec_tree():
    """``build_model`` builds ``EncDecModel`` for the audio family, whose
    spec has exactly JAX's leaves and shapes: ``encoder`` stacked
    (n_encoder_layers, ...), ``enc_norm``, ``layers`` (n_layers, ...) with
    ``xattn`` and ``lnx``; every value crosses unchanged. The xLSTM builds
    and routes to two-pass DB training; the MoE builds."""
    jdbm, tdbm = _models()
    assert type(tdbm.model).__name__ == "EncDecModel"
    assert type(build_model(TC.get_config(ARCH))).__name__ == "EncDecModel"
    tree = _tree()
    params = tparams(tdbm, tree)
    got = dict(tree_items(params))
    want = dict(tree_items(tree))
    assert sorted(got) == sorted(want)
    for path, x in want.items():
        np.testing.assert_array_equal(got[path].numpy(), x)
    assert params["encoder"]["attn"]["wq"].shape[0] == CFG.n_encoder_layers
    assert params["layers"]["xattn"]["wk"].shape[0] == CFG.n_layers
    m = tdbm.model
    assert (m.max_cond_tokens, m.paged_state_axes, m.cond_padding_safe) == (
        CFG.n_audio_frames, {"cross": 1}, False)
    spec = m.aux_input_specs(3)["audio_embs"]
    assert spec.shape == (3, CFG.n_audio_frames, CFG.d_model)
    xl = TDBM(TC.reduced(TC.get_config("xlstm-125m")),
              TC.DBConfig(num_blocks=1))
    assert type(xl.model).__name__ == "XLSTMModel"
    assert xl.causal_mode == "two_pass"
    assert TDBM(TC.reduced(TC.get_config("phi3.5-moe-42b-a6.6b")),
                TC.DBConfig(num_blocks=1)).model.is_moe


@pytest.mark.parametrize("what", ["table_1500", "table_32", "at"])
def test_sinusoidal_positions_match_jax(what):
    """The fp32 tables equal JAX's within one rounding of the angle
    (position x frequency, at most 1499 rad: ulp 1.2e-4) plus 2e-7: XLA's
    fp32 ``exp``, ``sin`` and ``cos`` and torch's differ in the last place,
    so the tables are not bit-equal (exp differs in 43 of whisper's 384
    frequencies by one ulp, which a position multiplies)."""
    d = 768 if what != "table_32" else CFG.d_model
    if what == "at":
        pos = np.array([[0, 5, 1499], [7, 3, 100]])
        want = np.asarray(JL.sinusoidal_at(jnp.asarray(pos), d))
        got = TL.sinusoidal_at(t(pos), d).numpy()
        top = pos[..., None]
    else:
        S = 1500 if what == "table_1500" else CFG.n_audio_frames
        want = np.asarray(JL.sinusoidal_positions(S, d))
        got = TL.sinusoidal_positions(S, d).numpy()
        top = np.arange(S)[:, None]
    assert got.dtype == want.dtype == np.float32
    bound = 2 * np.spacing(np.float32(np.maximum(top, 1))) + 2e-7
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("dtypes", ["fp32", "bf16_stream_fp32_memory"])
def test_attention_fwd_over_kv_x_matches_jax(dtypes):
    """``attention_fwd(kv_x=...)``: q from x (12 tokens), k and v from the
    memory (32 frames), no rope though ``rope_theta`` is set, unmasked (the
    kernels' ``full`` kind at Sq != Sk); the output and the gradients of x,
    the memory and the weights within 1e-4 of JAX's through its Pallas
    kernels. Under a bf16 stream over an fp32 memory k and v are fp32 (as
    JAX promotes), the output bf16, within one bf16 rounding."""
    rs = np.random.RandomState(5)
    dims = (4, 4, 64, 10000.0)
    d = 256
    x = rs.randn(2, 12, d).astype(np.float32)
    mem = rs.randn(2, 32, d).astype(np.float32)
    p = {k: (0.05 * rs.randn(*s)).astype(np.float32) for k, s in (
        ("wq", (d, 256)), ("wk", (d, 256)), ("wv", (d, 256)),
        ("wo", (256, d)))}
    do = rs.randn(2, 12, d).astype(np.float32)
    bf = dtypes != "fp32"
    jx = jnp.asarray(x, jnp.bfloat16) if bf else jnp.asarray(x)

    def jf(x_, m_, p_):
        out, (k, v) = JA.attention_fwd(
            p_, x_, JA.AttnDims(*dims), positions=jnp.arange(12),
            mask_mod=None, kv_x=m_, kv_positions=jnp.arange(32),
            impl="kernels")
        return out, k
    (want, wk), vjp = jax.vjp(jf, jx, jnp.asarray(mem),
                              jax.tree_util.tree_map(jnp.asarray, p))
    tx = t(x).to(torch.bfloat16 if bf else torch.float32).requires_grad_()
    tm = t(mem).requires_grad_()
    tp = {k: t(v).requires_grad_() for k, v in p.items()}
    got, (k, _) = TA.attention_fwd(
        tp, tx, TA.AttnDims(*dims), positions=torch.arange(12),
        mask_mod=None, kv_x=tm, kv_positions=torch.arange(32),
        impl="kernels")
    assert got.dtype == tx.dtype and k.dtype == torch.float32
    assert str(want.dtype) == ("bfloat16" if bf else "float32")
    assert str(wk.dtype) == "float32"
    tol = 2e-2 if bf else TOL
    close(got, np.asarray(want, np.float32), tol)
    close(k, wk, tol)
    if bf:
        return
    grads = vjp((jnp.asarray(do), jnp.zeros_like(wk)))
    got.backward(t(do))
    close(tx.grad, grads[0])
    close(tm.grad, grads[1])
    for name in p:
        close(tp[name].grad, grads[2][name])


@pytest.mark.parametrize("stream", ["fp32", "bf16_weights_fp32_audio",
                                    "bf16"])
def test_encode_matches_jax(stream):
    """``encode`` (sinusoidal positions, the encoder's bidirectional layers
    through the ``full`` kind, ``enc_norm``) in audio_embs' dtype, as JAX's:
    fp32 audio over fp32 weights (values and the gradients of the audio and
    of every encoder param within 1e-4), fp32 audio over bf16 weights (the
    bf16 policy's cast: the encoder stays fp32, within 1e-4) and bf16 audio
    (a bf16 stream, within 3e-2)."""
    jdbm, tdbm = _models()
    tree = _tree()
    x = audio(6, batch=2)
    cast = stream != "fp32"
    jp = jparams(tree)
    tp = tparams(tdbm, tree)
    if cast:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = tree_map(lambda _, v: v.to(torch.bfloat16), tp)
    adt = (jnp.bfloat16, torch.bfloat16) if stream == "bf16" else (
        jnp.float32, torch.float32)
    ja = jnp.asarray(x, adt[0])

    def jf(p_, a_):
        return jdbm.model.encode_conditioning(p_, {"audio_embs": a_})
    want, vjp = jax.vjp(jf, jp, ja)
    ta = t(x).to(adt[1]).requires_grad_()
    leaves = [v.requires_grad_() for _, v in tree_items(tp["encoder"])]
    got = tdbm.model.encode_conditioning(tp, {"audio_embs": ta})
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    assert got.shape == (2, CFG.n_audio_frames, CFG.d_model)
    if stream == "bf16":
        close(got, np.asarray(want, np.float32), 3e-2)
        return
    close(got, want)
    if cast:
        return
    do = np.random.RandomState(7).randn(*got.shape).astype(np.float32)
    jg, jga = vjp(jnp.asarray(do))
    grads = torch.autograd.grad(got, leaves + [ta], t(do))
    close(grads[-1], jga)
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                    jg["encoder"])))
    for (path, _), g in zip(tree_items(tp["encoder"]), grads[:-1]):
        close(g, want_g[path])


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,loss,b", [("concat", "ce", 0),
                                         ("two_pass", "l2", 1)])
def test_block_loss_and_grads_match_jax(mode, loss, b):
    """``block_loss(aux_inputs={"audio_embs": ...})`` under concat x CE
    (block 0) and two_pass x l2 (block 1): the loss and the gradient of
    every param (the encoder's and ``enc_norm``'s included; None where the
    block does not read it, as JAX's zeros) within 1e-4 of JAX's."""
    jdbm, tdbm = _models(mode, loss)
    tree, tokens, mem = _tree(), _tokens(), audio(8, batch=B)
    rng = jax.random.PRNGKey(10 + b)
    jl = lambda p: jdbm.block_loss(  # noqa: E731
        p, b, jnp.asarray(tokens), rng,
        aux_inputs={"audio_embs": jnp.asarray(mem)})
    (want, _), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jparams(tree))
    sigma, eps = draws(jdbm, b, rng)
    params = tparams(tdbm, tree)
    leaves = [x.requires_grad_() for _, x in tree_items(params)]
    got, _ = tdbm.block_loss(params, b, t(tokens), sigma=sigma, eps=eps,
                             aux_inputs={"audio_embs": t(mem)})
    close(got, want)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    want_g = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    seen = set()
    for (path, _), g in zip(tree_items(params), grads):
        if g is None:
            assert not np.any(want_g[path]), path
        else:
            close(g, want_g[path])
            seen.add(path[0])
    assert {"encoder", "enc_norm", "layers", "embed"} <= seen


def test_db_train_step_matches_jax():
    """One fp32 concat x CE DB step of block 1 with audio: loss, moments and
    updated params within 1e-4 of JAX's (as ``_assert_step_close`` holds
    them); the encoder and ``enc_norm`` are trained as periphery, block 0's
    layers untouched."""
    jdbm, tdbm = _models()
    tree, tokens, mem = _tree(), _tokens(), audio(9, batch=B)
    b, rng = 1, jax.random.PRNGKey(21)
    j_init, j_step = JT.make_db_train_step(jdbm, b, TCFG, impl="auto",
                                           precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens), rng,
                                  {"audio_embs": jnp.asarray(mem)})
    params = tparams(tdbm, tree)
    before = {p: x.clone() for p, x in tree_items(params)}
    t_init, t_step = TT.make_db_train_step(tdbm, b, TCFG, precision="fp32")
    sigma, eps = draws(jdbm, b, rng)
    _, opt2, loss_, _ = t_step(params, t_init(params), t(tokens), sigma=sigma,
                               eps=eps, aux_inputs={"audio_embs": t(mem)})
    close(loss_, jloss)
    _assert_step_close(params, opt2, jp2, jopt2, tdbm.ranges[b])
    assert "encoder" in opt2.mu and "enc_norm" in opt2.mu
    assert not torch.equal(params["encoder"]["attn"]["wq"],
                           before[("encoder", "attn", "wq")])
    assert torch.equal(params["layers"]["attn"]["wq"][0],
                       before[("layers", "attn", "wq")][0])


def test_e2e_train_step_matches_jax():
    """One fp32 end-to-end step with audio (the decoder's tokens at their
    sinusoidal positions): loss, moments and updated params within 1e-4 of
    JAX's."""
    jdbm, tdbm = _models()
    tree, tokens, mem = _tree(), _tokens(), audio(10, batch=B)
    j_init, j_step = JT.make_e2e_train_step(jdbm, TCFG, impl="auto",
                                            precision="fp32")
    jp = jparams(tree)
    jp2, jopt2, jloss, _ = j_step(jp, j_init(jp), jnp.asarray(tokens),
                                  jax.random.PRNGKey(0),
                                  {"audio_embs": jnp.asarray(mem)})
    params = tparams(tdbm, tree)
    t_init, t_step = TT.make_e2e_train_step(tdbm, TCFG, precision="fp32")
    params, opt2, loss_, _ = t_step(params, t_init(params), t(tokens),
                                    aux_inputs={"audio_embs": t(mem)})
    close(loss_, jloss)
    _assert_step_close(params, opt2, jp2, jopt2)


def test_refusals_without_audio_and_in_the_block_parallel_engine():
    """The cross layer needs a memory on the training path; the
    block-parallel engine refuses modality conditioning, as JAX's does."""
    _, tdbm = _models()
    params = tparams(tdbm, _tree())
    with pytest.raises(ValueError, match="no conditioning memory"):
        tdbm.block_loss(params, 0, t(_tokens()), torch.Generator())
    with pytest.raises(NotImplementedError, match="block-parallel"):
        TPE.train_db_parallel(tdbm, TC.TrainConfig(steps=1), iter([]),
                              torch.Generator(), params=params,
                              aux_fn=lambda tokens: None)


# ---------------------------------------------------------------------------
# Serving: the static engine, the batcher, the router
# ---------------------------------------------------------------------------

@functools.cache
def serve_pair():
    jdbm, tdbm = _models()
    tree = _tree()
    return jdbm, jparams(tree), tdbm, tparams(tdbm, tree)


def test_static_engine_greedy_matches_jax():
    """``DecodeEngine.generate(aux_inputs={"audio_embs": (3, 32, d)})``:
    every slot's audio block written before prefill (chunked, ragged
    prompts at their own positions); fp32 greedy tokens identical to JAX's
    engine, and the audio changes them (the port without audio). A ragged ``cond_lengths`` is
    refused for this family, as JAX refuses it."""
    jdbm, jparams_, tdbm, tparams_ = serve_pair()
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, CFG.vocab_size, size=(3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    aux = {"audio_embs": audio(12, batch=3)}
    z = JaxDraws(7, 3, tdbm.cfg, jdbm.db.sigma_max)(5)[0]
    want = JS.generate(jdbm, jparams_, jnp.asarray(prompts), 5,
                       rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                       precision="fp32", chunk_size=4,
                       aux_inputs={k: jnp.asarray(v) for k, v in aux.items()})
    outs = [TS.generate(tdbm, tparams_, prompts, 5, prompt_lengths=plens,
                        precision="fp32", chunk_size=4, z0=z, aux_inputs=a)
            for a in (aux, None)]
    np.testing.assert_array_equal(outs[0].numpy(), np.asarray(want))
    assert not torch.equal(*outs)
    with pytest.raises(ValueError, match="ragged cond_lengths"):
        TS.generate(tdbm, tparams_, prompts, 2, precision="fp32", z0=z[:2],
                    aux_inputs=aux, cond_lengths=np.array([32, 5, 0]))


def audio_reqs(n=5, seed=5):
    """Prompts of 4-10 tokens with ragged audio (32, 20, none, 9, 32
    frames)."""
    rs = np.random.RandomState(seed)
    frames = [32, 20, None, 9, 32]
    return [(rs.randint(0, CFG.vocab_size, size=rs.randint(4, 11)), 5,
             None if frames[i % 5] is None else {
                 "audio_embs": audio(30 + i, frames[i % 5])})
            for i in range(n)]


def test_batcher_logs_match_jax_for_ragged_audio():
    """Requests with ragged audio (each encoded alone at admission at its
    own frame count, its block written in place) and one without share
    the batcher's 2 slots: per-step logs (slots, counters, free list,
    refcounts, ``cond_lengths``) and greedy tokens identical to JAX's
    batcher under its draws."""
    from test_torch_continuous import state
    pair = serve_pair()
    jdbm, jp, tdbm, tp = pair
    cbs = (JS.ContinuousBatcher(jdbm, jp, **CB_KW),
           TS.ContinuousBatcher(tdbm, tp, **CB_KW))
    cbs[1].draw_segment = JaxDraws(SEED, CB_KW["num_slots"], tdbm.cfg,
                                   tdbm.db.sigma_max)
    logs, outs = ([], []), ({}, {})
    for i, cb in enumerate(cbs):
        for p, n, aux in audio_reqs():
            cb.submit(np.asarray(p, np.int32 if i == 0 else np.int64), n,
                      aux_inputs=aux)
        rng, steps = jax.random.PRNGKey(SEED), 0
        while cb.has_work():
            if i == 0:
                rng, fin = cb.step(rng)
            else:
                fin = cb.step()
            logs[i].append((state(cb, fin), cb.cond_lengths.tolist()))
            outs[i].update({r.rid: list(r.out) for r in fin})
            steps += 1
            assert steps < 200, "scheduler failed to converge"
    assert logs[0] == logs[1]
    assert outs[0] == outs[1] and len(outs[1]) == 5
    assert {20, 9} <= {c for _, cl in logs[1] for c in cl}


def test_router_migrates_an_audio_slot():
    """Audio requests one at a time through the port's ``DisaggRouter`` (1
    prefill + 1 decode worker, page handoff): each migration carries the
    audio block in its payload's dense leaves, and the tokens equal JAX's
    unified run of the same requests."""
    from test_torch_disagg import pool_whole, wait_for
    jdbm, jp, tdbm, tp = serve_pair()
    reqs = [r for r in audio_reqs(4, seed=7) if r[2] is not None][:2]
    cb = JS.ContinuousBatcher(jdbm, jp, **CB_KW)
    rng, want = jax.random.PRNGKey(SEED), []
    for p, n, aux in reqs:
        cb.submit(np.asarray(p, np.int32), n, aux_inputs=aux)
        fin = []
        while cb.has_work():
            rng, f = cb.step(rng, strict=False)
            fin.extend(f)
        want.append(list(fin[0].out))
    router = TR.DisaggRouter(tdbm, tp, n_prefill=1, n_decode=1,
                             handoff="pages", **CB_KW)
    router.decode_workers[0].cb.draw_segment = JaxDraws(
        SEED, CB_KW["num_slots"], tdbm.cfg, tdbm.db.sigma_max)
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.start()
    got = []
    try:
        for p, n, aux in reqs:
            rid = router.submit(p, n, aux_inputs=aux)
            wait_for(lambda: rid in done, f"router request {rid}", WAIT_S)
            assert done[rid].error is None, done[rid].error
            got.append(list(done[rid].out))
    finally:
        router.stop(WAIT_S)
    pool_whole(router)
    assert got == want
    assert router.stats()["migrations"] >= 2


def test_serve_cli_conditioned_whisper(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    whisper-small --blocks 1 --conditioned --scheduler continuous`` serves
    its queue with audio drawn from the pool."""
    TS.main(["--device", "cpu", "--arch", ARCH, "--blocks", "1",
             "--conditioned", "--scheduler", "continuous", "--prompt-len",
             "8", "--max-new", "3", "--requests", "3", "--num-slots", "2",
             "--seg-len", "2", "--page-size", "4", "--cond-pool", "2"])
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
