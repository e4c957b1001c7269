"""PyTorch port: the VLM family and conditioned serving against the JAX
package on the CPU.

``repro_torch.models.transformer.VLMModel`` (superblocks of self layers and
one tanh-gated cross-attention layer over per-slot image blocks) and the
``aux_inputs`` path through the static engine, ``ContinuousBatcher``,
``SharedPagePool``, ``DisaggRouter`` and ``InferenceServer``, against
``repro``'s on bridged params of ``TINY_VLM`` (``tests/test_disagg.py``'s,
the cross gate opened to 2 so conditioning moves the argmax, the AdaLN
heads randomised) and of ``reduced(llama-3.2-vision-11b)`` (GQA: 4 query
heads on 1 KV head), fp32. JAX draws each step's z inside its scan; the
port is handed the same draws (``JaxDraws``). Greedy tokens must be
bit-equal to JAX's, values within 1e-5; an unconditioned slot's cross term
is exactly 0. The JAX side runs only unified batchers and the static
engine (one compiled program per shape); the port's router and server are
held to JAX's unified runs.

Every wait is bounded and fails instead of hanging.
"""
import argparse
import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.launch import serve as JS
from repro.models import common as JCM
from repro.nn import attention as JA
from repro.nn import cache as JKVC
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import router as TR
from repro_torch.launch import serve as TS
from repro_torch.launch import server as TSV
from repro_torch.models import common as TCM
from repro_torch.nn import attention as TA
from repro_torch.nn import cache as TKVC

torch.set_num_threads(1)

TINY_VLM = JC.ModelConfig(name="tiny-disagg-vlm", family="vlm", n_layers=4,
                          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=32, cross_attn_every=2,
                          n_image_tokens=4)
GQA_VLM = JC.reduced(JC.get_config("llama-3.2-vision-11b"))
CB_KW = dict(num_slots=2, max_prompt=12, max_len=24, seg_len=3, page_size=4,
             chunk_size=4, precision="fp32")
SEED = 11
WAIT_S = 30.0
HOST = "127.0.0.1"


def vlm_models(cfg, blocks):
    """JAX's model and params (the cross gate opened, the AdaLN heads
    randomised) and the port's on the same params."""
    db = JC.DBConfig(num_blocks=blocks, overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    for part in ("self", "cross"):
        ad = tree["units"][part]["adaln"]
        for k in ("w", "b"):
            ad[k] = (0.02 * rs.randn(*ad[k].shape)).astype(np.float32)
    xg = tree["units"]["cross"]["xgate"]
    tree["units"]["cross"]["xgate"] = np.full_like(xg, 2.0)
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    tdbm = TDBM(tcfg, TC.DBConfig(**dataclasses.asdict(db)))
    return (jdbm, jax.tree_util.tree_map(jnp.asarray, tree), tdbm,
            params_from_jax(tree, "cpu", tdbm.model.spec))


@pytest.fixture(scope="module")
def tiny():
    return vlm_models(TINY_VLM, 2)


@pytest.fixture(scope="module")
def gqa():
    return vlm_models(GQA_VLM, 1)


def image(cfg, seed=3, n=None):
    n = cfg.n_image_tokens if n is None else n
    return {"image_embs": (4.0 * np.random.RandomState(seed).randn(
        n, cfg.d_model)).astype(np.float32)}


def draws(pair, seed=SEED, num_slots=CB_KW["num_slots"]):
    return JaxDraws(seed, num_slots, pair[2].cfg, pair[2].db.sigma_max)


# ---------------------------------------------------------------------------
# The model, its bridge and the conditioning primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "gqa"])
def test_bridge_carries_the_vlm_tree(which, request):
    """The JAX tree crosses unchanged: ``units/self`` stacked (n_units,
    k_self, ...), ``units/cross`` (n_units, ...) with ``xgate``, and the
    port's spec has exactly JAX's leaves and shapes."""
    jdbm, jparams, tdbm, tparams = request.getfixturevalue(which)
    jl = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
          jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tl = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                tl[path + f"['{k}']"] = v.numpy()
    walk(tparams, "")
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(jl[k], tl[k])
    m = tdbm.model
    assert type(m).__name__ == "VLMModel"
    assert (m.n_units, m.k_self) == (jdbm.model.n_units, jdbm.model.k_self)
    cfg = tdbm.cfg
    assert tparams["units"]["self"]["attn"]["wq"].shape[:2] == (
        m.n_units, m.k_self)
    assert tparams["units"]["cross"]["xgate"].shape == (m.n_units, 1)
    assert m.max_cond_tokens == cfg.n_image_tokens
    assert m.paged_state_axes == {"cross": 1}
    spec = m.aux_input_specs(3)["image_embs"]
    assert spec.shape == (3, cfg.n_image_tokens, cfg.d_model)
    assert spec.device.type == "meta"


@pytest.mark.parametrize("case", ["ragged", "zero"])
def test_cross_attend_matches_jax(case):
    """``cross_attend`` on the same inputs as JAX's: within 1e-5 for every
    slot, and a slot with length 0 is exactly 0 with no NaN (JAX's floored
    max, zeroed weights and 1e-30 sum; ``torch.softmax`` of an all-masked
    row would be NaN). G = 4 query heads a KV head."""
    rs = np.random.RandomState(0)
    B, S, H, KV, hd, Sk = 4, 3, 8, 2, 16, 7
    q = rs.randn(B, S, H, hd).astype(np.float32)
    k = rs.randn(B, Sk, KV, hd).astype(np.float32)
    v = rs.randn(B, Sk, KV, hd).astype(np.float32)
    lens = (np.array([7, 3, 0, 1], np.int32) if case == "ragged"
            else np.zeros(B, np.int32))
    want = np.asarray(JKVC.cross_attend(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(lens)))
    got = TKVC.cross_attend(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for b in np.nonzero(lens == 0)[0]:
        assert (got[b] == 0).all()


@pytest.mark.parametrize("slot", [None, 1])
def test_write_cross_block_matches_jax(tiny, slot):
    """One slot's block and all slots' blocks, written in place, equal
    JAX's functional write within 1e-5; a shorter image zeroes the row's
    tail (a recycled slot never reads its previous occupant's)."""
    jdbm, jparams, tdbm, tparams = tiny
    cfg, n = tdbm.cfg, TINY_VLM.n_image_tokens
    dims = JA.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.rope_theta)
    B = 1 if slot is not None else 3
    cond = np.random.RandomState(5).randn(B, n - 1, cfg.d_model).astype(
        np.float32)
    jcache = jdbm.model.init_paged_cache(3, 5, 4, "fp32")["cross"]
    jcache = jax.tree_util.tree_map(lambda x: x + 7.0, jcache)
    want = JCM.write_cross_block(jcache, jparams["units"]["cross"]["attn"],
                                 jnp.asarray(cond), dims, n, slot)
    tcache = tdbm.model.init_paged_cache(3, 5, 4, "fp32", device="cpu")
    for t in tcache["cross"].values():
        t.fill_(7.0)
    ptrs = TKVC.pool_ptrs(tcache)
    tdbm.model.set_conditioning(tparams, tcache, torch.from_numpy(cond),
                                slot)
    assert TKVC.pool_ptrs(tcache) == ptrs
    for name in ("k", "v"):
        got = tcache["cross"][name].numpy()
        np.testing.assert_allclose(got, np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5)
        rows = slice(None) if slot is None else slot
        assert (got[:, rows, n - 1:] == 0).all()


def test_conditioning_fingerprint_matches_jax():
    """The same int as JAX's for the same inputs (sha256 over the sorted
    keys, shapes and float32 bytes), 0 for none, and distinct images
    differ; a torch tensor hashes as its numpy twin."""
    a, b = image(TINY_VLM, 3), image(TINY_VLM, 4)
    for aux in (a, b, {**a, "z_extra": np.ones((2, 3), np.float64)}, None,
                {}):
        assert (TKVC.conditioning_fingerprint(aux)
                == JKVC.conditioning_fingerprint(aux))
    assert TKVC.conditioning_fingerprint(None) == 0
    assert (TKVC.conditioning_fingerprint(a)
            != TKVC.conditioning_fingerprint(b))
    assert TKVC.conditioning_fingerprint(
        {"image_embs": torch.from_numpy(a["image_embs"])}) == \
        TKVC.conditioning_fingerprint(a)


def test_families_still_refused_and_training_raises(tiny):
    """The xLSTM builds and routes to two-pass DB training; the
    MoE builds (the hybrid since its serving port, the audio family since
    its own, the xLSTM since its serving port:
    ``tests/test_torch_hybrid.py``, ``tests/test_torch_audio.py``,
    ``tests/test_torch_moe.py``, ``tests/test_torch_xlstm.py``). The VLM's train mode runs: a unit over 4
    text tokens attends the images in ``ctx.kv_x`` (and raises without
    them; ``tests/test_torch_vlm_train.py`` holds its training to JAX's).
    ``attention_fwd(kv_x=...)``, the attention its cross layers train
    through, matches JAX's on the VLM's cross weights: 4 text tokens over 6
    image tokens, unmasked, no rope; the output and the gradients of x and
    the memory within 1e-5."""
    xl = TDBM(TC.reduced(TC.get_config("xlstm-125m")),
              TC.DBConfig(num_blocks=1))
    assert type(xl.model).__name__ == "XLSTMModel"
    assert xl.causal_mode == "two_pass"
    moe = TDBM(TC.reduced(TC.get_config("phi3.5-moe-42b-a6.6b")),
               TC.DBConfig(num_blocks=1))
    assert moe.model.is_moe and "moe" in moe.model.spec["layers"]
    jdbm, jparams, tdbm, tparams = tiny
    ctx = tdbm.make_ctx(tparams, 4, "train")
    with pytest.raises(ValueError, match="no conditioning memory"):
        tdbm.model.apply_units(tparams, torch.zeros(1, 4, 32), 0, 1, ctx)
    ctx = tdbm.make_ctx(tparams, 4, "train", aux_inputs={
        "image_embs": torch.ones(1, 6, 32)})
    h, cache = tdbm.model.apply_units(tparams, torch.ones(1, 4, 32), 0, 1,
                                      ctx)
    assert h.shape == (1, 4, 32) and cache is None
    assert torch.isfinite(h).all()
    rs = np.random.RandomState(8)
    x = rs.randn(2, 4, 32).astype(np.float32)
    mem = rs.randn(2, 6, 32).astype(np.float32)
    do = rs.randn(2, 4, 32).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["units"]["cross"]["attn"])

    def jf(x_, m_):
        return JA.attention_fwd(jp, x_, JA.AttnDims(2, 2, 16, 10000.0),
                                positions=jnp.arange(4), mask_mod=None,
                                kv_x=m_, kv_positions=jnp.arange(6))[0]
    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(mem))
    gx, gm = vjp(jnp.asarray(do))
    tx = torch.from_numpy(x).requires_grad_()
    tm = torch.from_numpy(mem).requires_grad_()
    got = TA.attention_fwd(
        {k: v[0] for k, v in tparams["units"]["cross"]["attn"].items()}, tx,
        TA.AttnDims(2, 2, 16, 10000.0), positions=torch.arange(4),
        mask_mod=None, kv_x=tm, kv_positions=torch.arange(6))[0]
    got.backward(torch.from_numpy(do))
    for g, w in ((got, want), (tx.grad, gx), (tm.grad, gm)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The static engine
# ---------------------------------------------------------------------------

def static_run(pair, aux, cond_lengths=None, max_new=5):
    """Both engines over the same 3 ragged prompts, fp32, chunked prefill,
    from JAX's key 7. Returns (JAX's tokens, the port's)."""
    jdbm, jparams, tdbm, tparams = pair
    cfg = tdbm.cfg
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, cfg.vocab_size, size=(3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    jaux = None if aux is None else {k: jnp.asarray(v)
                                     for k, v in aux.items()}
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), max_new,
                        rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                        precision="fp32", chunk_size=4, aux_inputs=jaux,
                        cond_lengths=cond_lengths)
    z = JaxDraws(7, 3, cfg, jdbm.db.sigma_max)(max_new)[0]
    out_t = TS.generate(tdbm, tparams, prompts, max_new,
                        prompt_lengths=plens, precision="fp32",
                        chunk_size=4, z0=z, aux_inputs=aux,
                        cond_lengths=cond_lengths)
    return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("which", ["tiny", "gqa"])
def test_static_engine_conditioned_matches_jax(which, request):
    """``DecodeEngine.generate(aux_inputs=)``: every slot's block written
    before prefill; greedy fp32 tokens bit-equal to JAX's engine with the
    image, with ragged ``cond_lengths`` and without an image, and the image
    changes the tokens."""
    pair = request.getfixturevalue(which)
    cfg = pair[2].cfg
    imgs = np.stack([image(cfg, s)["image_embs"] for s in (3, 4, 5)])
    aux = {"image_embs": imgs}
    runs = {"image": static_run(pair, aux),
            "ragged": static_run(pair, aux, np.array(
                [cfg.n_image_tokens, 2, 0], np.int32)),
            "none": static_run(pair, None)}
    for name, (want, got) in runs.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert not np.array_equal(runs["image"][1], runs["none"][1])
    # a slot whose valid length is 0 decodes as an unconditioned one
    np.testing.assert_array_equal(runs["ragged"][1][2], runs["none"][1][2])


def test_static_engine_refuses_what_jax_refuses(tiny):
    _, _, tdbm, tparams = tiny
    with pytest.raises(ValueError, match="not understood"):
        TS.generate(tdbm, tparams, np.zeros((1, 4), np.int64), 2,
                    precision="fp32", aux_inputs={"audio_embs":
                                                  np.zeros((1, 4, 32))})


# ---------------------------------------------------------------------------
# The continuous batcher
# ---------------------------------------------------------------------------

def step_both(pair, reqs, *, seed=SEED, preempt=None, **kw):
    """``reqs`` [(prompt, max_new, aux)] submitted at once to JAX's batcher
    and the port's (the port fed JAX's draws), stepped in turn; ``preempt``
    {step: slot} forces a preemption of that slot's request before the
    step. Asserts equal per-step logs (slots, counters, free list,
    refcounts, ``cond_lengths``) and tokens. Returns (the port's batcher,
    {rid: tokens})."""
    from test_torch_continuous import state
    jdbm, jparams, tdbm, tparams = pair
    kw = {**CB_KW, **kw}
    cbs = (JS.ContinuousBatcher(jdbm, jparams, **kw),
           TS.ContinuousBatcher(tdbm, tparams, **kw))
    cbs[1].draw_segment = draws(pair, seed, kw["num_slots"])
    logs, outs = ([], []), ({}, {})
    for i, cb in enumerate(cbs):
        for p, n, aux in reqs:
            cb.submit(np.asarray(p, np.int32 if i == 0 else np.int64), n,
                      aux_inputs=aux)
        rng, step = jax.random.PRNGKey(seed), 0
        while cb.has_work():
            victim = cb.slot_req[(preempt or {}).get(step, 0)]
            if step in (preempt or {}) and victim is not None:
                cb.preempt(victim.rid)
            if i == 0:
                rng, fin = cb.step(rng)
            else:
                fin = cb.step()
            logs[i].append((state(cb, fin), cb.cond_lengths.tolist()))
            outs[i].update({r.rid: list(r.out) for r in fin})
            step += 1
            assert step < 200, "scheduler failed to converge"
    assert logs[0] == logs[1]
    assert outs[0] == outs[1]
    tcb = cbs[1]
    assert len(tcb.free_pages) + len(tcb.page_refs) == tcb.total_pages - 1
    assert not tcb.cond_lengths.any()
    return tcb, outs[1]


def mixed_reqs(cfg, n=5, seed=5):
    rs = np.random.RandomState(seed)
    auxes = [image(cfg, 3), None, image(cfg, 4, cfg.n_image_tokens - 1),
             None, image(cfg, 3)]
    return [(rs.randint(0, cfg.vocab_size, size=rs.randint(4, 11)), 5,
             auxes[i % len(auxes)]) for i in range(n)]


@pytest.mark.parametrize("which", ["tiny", "gqa"])
def test_batcher_mixes_conditioned_slots_as_jax(which, request):
    """Conditioned (full and shorter images) and unconditioned requests
    share the batcher's slots: per-step logs and greedy tokens equal to
    JAX's batcher under its draws, and conditioning changes the tokens."""
    pair = request.getfixturevalue(which)
    reqs = mixed_reqs(pair[2].cfg)
    _, got = step_both(pair, reqs)
    _, bare = step_both(pair, [(p, n, None) for p, n, _ in reqs[:1]])
    assert got[0] != bare[0], "conditioning must change the tokens"


def test_prefix_cache_keeps_images_apart(tiny):
    """The prefix-cache differential of ``tests/test_prefill.py``: the same
    text under another image shares no page and decodes otherwise, the
    same text and image shares and decodes the same, unconditioned text
    never matches a conditioned trie; each run equal to JAX's."""
    cfg = TINY_VLM
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, size=9)
    a, b = image(cfg, 3), image(cfg, 4)
    seq = [(prompt, 6, a), (prompt, 6, b), (prompt, 6, a), (prompt, 6, None)]
    jdbm, jparams, tdbm, tparams = tiny
    kw = dict(CB_KW, prefix_cache=True)
    jcb = JS.ContinuousBatcher(jdbm, jparams, **kw)
    tcb = TS.ContinuousBatcher(tdbm, tparams, **kw)
    got = []
    for p, n, aux in seq:
        jcb.submit(np.asarray(p, np.int32), n, aux_inputs=aux)
        (jr,) = jcb.run(jax.random.PRNGKey(3))
        tcb.draw_segment = draws(tiny, 3)
        tcb.submit(p, n, aux_inputs=aux)
        (tr,) = tcb.run()
        assert (tr.out, tr.shared_tokens) == (jr.out, jr.shared_tokens)
        got.append(tr)
    assert got[1].shared_tokens == 0 and got[1].out != got[0].out
    assert got[2].shared_tokens > 0 and got[2].out == got[0].out
    assert got[3].shared_tokens == 0
    assert tcb.prefix.hits == jcb.prefix.hits


@pytest.mark.parametrize("at", [1, 3])
def test_preemption_carries_the_image_block(tiny, at):
    """A conditioned request preempted mid-prefill (step 1) or mid-decode
    (step 3): the spill carries its image row (``paged_state_axes``) and
    ``cond_length``, so it resumes bit-identically to the run without the
    preemption, and every step logs as JAX's."""
    prompt = (np.arange(1, 9) * 5) % TINY_VLM.vocab_size
    reqs = [(prompt, 8, image(TINY_VLM))]
    kw = dict(num_slots=1)
    _, base = step_both(tiny, reqs, **kw)
    cb, got = step_both(tiny, reqs, preempt={at: 0}, **kw)
    assert cb.preemptions >= 1 and cb.restores == cb.preemptions
    assert got == base


def test_spill_restore_onto_other_pages(tiny):
    """``spill_slot``/``restore_slot`` on the VLM cache: the pages land at
    other ids, the image row comes back bit for bit into another slot, and
    no other slot's row or page moves."""
    _, _, tdbm, _ = tiny
    kv = tdbm.model.init_paged_cache(2, 9, 4, "fp32", device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in TKVC.cache_tensors(kv):
        t.copy_(torch.randn(t.shape, generator=g))
    before = [t.clone() for t in TKVC.cache_tensors(kv)]
    axes = tdbm.model.paged_state_axes
    spilled = TKVC.spill_slot(kv, 1, [1, 2, 3], axes)
    spilled = TKVC.SpilledSlot.from_bytes(spilled.to_bytes())
    TKVC.restore_slot(kv, 0, [5, 7, 4], spilled, axes)
    ck, cv, pages = TKVC.cache_tensors(kv)[:3]
    for name, t, b in (("k", ck, before[0]), ("v", cv, before[1])):
        assert torch.equal(t[:, 0], b[:, 1]), name
        assert torch.equal(t[:, 1], b[:, 1]), name
    assert torch.equal(pages[..., [5, 7, 4], :, :, :],
                       before[2][..., [1, 2, 3], :, :, :])
    keep = [p for p in range(9) if p not in (5, 7, 4)]
    assert torch.equal(pages[..., keep, :, :, :],
                       before[2][..., keep, :, :, :])


def _spill(side, pair, prompt, aux, seed):
    """One package's batcher runs 3 steps of a conditioned request, then
    spills it: (request, wire bytes, the draw state to resume from)."""
    if side == "jax":
        cb = JS.ContinuousBatcher(pair[0], pair[1], **dict(CB_KW,
                                                           num_slots=1))
        cb.submit(np.asarray(prompt, np.int32), 8, aux_inputs=aux)
        rng = jax.random.PRNGKey(SEED)
        for _ in range(3):
            rng, f = cb.step(rng, strict=False)
            assert not f
    else:
        cb = TS.ContinuousBatcher(pair[2], pair[3], **dict(CB_KW,
                                                           num_slots=1))
        cb.draw_segment = draws(pair, SEED, 1)
        cb.submit(prompt, 8, aux_inputs=aux)
        for _ in range(3):
            assert not cb.step(strict=False)
        rng = cb.draw_segment.rng
    with cb._pool_lock:
        req = cb._spill_slot(0)
    assert req.spill_meta["cond_length"] == TINY_VLM.n_image_tokens
    assert len(cb.free_pages) == cb.total_pages - 1
    return req, req.spilled.to_bytes(), rng


def _restore(side, pair, req, raw, rng):
    """The other package restores the bytes into a bigger pool with a
    rotated free list (other pages) and runs to the end: the tokens."""
    mod, kvc, i = ((JS, JKVC, 0) if side == "jax" else (TS, TKVC, 2))
    cb = mod.ContinuousBatcher(pair[i], pair[i + 1], **dict(
        CB_KW, num_slots=1, total_pages=12))
    cb.free_pages = cb.free_pages[5:] + cb.free_pages[:5]
    moved = mod.Request(req.rid, np.asarray(
        req.prompt, np.int32 if side == "jax" else np.int64), req.max_new)
    moved.out = list(req.out)
    moved.spilled = kvc.SpilledSlot.from_bytes(raw)
    moved.spill_meta = dict(req.spill_meta)
    cb.submit_request(moved)
    if side == "port":
        cb.draw_segment = draws(pair, 0, 1)
        cb.draw_segment.rng = rng
    fin = []
    for _ in range(64):
        if not cb.has_work():
            break
        if side == "jax":
            rng, f = cb.step(rng, strict=False)
        else:
            f = cb.step(strict=False)
        fin.extend(f)
    assert len(cb.free_pages) + len(cb.page_refs) == cb.total_pages - 1
    (r,) = fin
    return list(r.out)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_spilled_vlm_slot_crosses_packages(tiny, src, dst):
    """A conditioned VLM slot spilled mid-decode by one package (its pages
    and its image row, bf16-free fp32 here) restores from the wire bytes
    into the other's pool and finishes with the tokens of JAX's
    uninterrupted run."""
    prompt = (np.arange(1, 9) * 5 % TINY_VLM.vocab_size).astype(np.int64)
    aux = image(TINY_VLM)
    jcb = JS.ContinuousBatcher(tiny[0], tiny[1], **dict(CB_KW, num_slots=1))
    jcb.submit(np.asarray(prompt, np.int32), 8, aux_inputs=aux)
    (want,) = jcb.run(jax.random.PRNGKey(SEED))
    req, raw, rng = _spill(src, tiny, prompt, aux, SEED)
    assert 0 < len(req.out) < 8
    assert _restore(dst, tiny, req, raw, rng) == want.out


# ---------------------------------------------------------------------------
# The shared pool, the router and the server
# ---------------------------------------------------------------------------

def test_shared_pool_grafts_paged_leaves_only(tiny):
    """Batchers on one ``SharedPagePool`` share the VLM's paged leaves (the
    same tensors) and keep their own image blocks: ``pool_ptrs`` agree on
    the pages and differ on the cross blocks; a different page size is
    refused."""
    _, _, tdbm, tparams = tiny
    pool = TS.SharedPagePool(13)
    a, b = (TS.ContinuousBatcher(tdbm, tparams, shared_pool=pool, **CB_KW)
            for _ in range(2))
    pa, pb = (TKVC.paged_leaves(c.kv) for c in (a, b))
    assert pa[0] is pb[0] is TKVC.paged_leaves(pool.kv)[0]
    assert pa[0].k.shape[2] == 13
    cross = [c.kv["cross"]["k"] for c in (a, b)]
    assert cross[0].data_ptr() != cross[1].data_ptr()
    assert cross[0].shape[1] == CB_KW["num_slots"]
    ptrs = [TKVC.pool_ptrs(c.kv) for c in (a, b)]
    assert ptrs[0][2:] == ptrs[1][2:] and ptrs[0][:2] != ptrs[1][:2]
    with pytest.raises(ValueError, match="same model"):
        TS.ContinuousBatcher(tdbm, tparams, shared_pool=pool,
                             **dict(CB_KW, page_size=2))


def jax_unified(pair, reqs, seed=SEED):
    """JAX's ground truth: each request alone on one unified batcher, one
    key carried across the sequence."""
    cb = JS.ContinuousBatcher(pair[0], pair[1], **CB_KW)
    rng, outs = jax.random.PRNGKey(seed), []
    for p, n, aux in reqs:
        cb.submit(np.asarray(p, np.int32), n, aux_inputs=aux)
        fin = []
        while cb.has_work():
            rng, f = cb.step(rng, strict=False)
            fin.extend(f)
        assert len(fin) == 1 and fin[0].error is None, fin
        outs.append(list(fin[0].out))
    return outs


def router_reqs(cfg):
    rs = np.random.RandomState(7)
    return [(rs.randint(0, cfg.vocab_size, size=n), 8, image(cfg, s))
            for n, s in ((9, 3), (6, 4))]


@pytest.mark.parametrize("handoff", ["copy", "pages"])
def test_router_migrates_conditioned_requests(tiny, handoff):
    """Conditioned requests one at a time through the port's
    ``DisaggRouter`` (1 prefill + 1 decode worker; decode0 fed JAX's
    draws): each migration carries the image row in its payload's dense
    leaves, and the tokens equal JAX's unified run, which the images
    change."""
    from test_torch_disagg import pool_whole, wait_for
    reqs = router_reqs(TINY_VLM)
    base = jax_unified(tiny, reqs)
    assert base != jax_unified(tiny, [(p, n, None) for p, n, _ in reqs])
    router = TR.DisaggRouter(tiny[2], tiny[3], n_prefill=1, n_decode=1,
                             handoff=handoff, **CB_KW)
    router.decode_workers[0].cb.draw_segment = draws(tiny)
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.start()
    outs = []
    try:
        for p, n, aux in reqs:
            rid = router.submit(p, n, aux_inputs=aux)
            wait_for(lambda: rid in done, f"router request {rid}", WAIT_S)
            assert done[rid].error is None, done[rid].error
            outs.append(list(done[rid].out))
    finally:
        router.stop(WAIT_S)
    pool_whole(router)
    assert outs == base
    stats = router.stats()
    assert stats["migrations"] >= 2 and stats["re_prefills"] == 0, stats
    with pytest.raises(ValueError, match="exceed"):
        router.submit([1, 2], 2, aux_inputs=image(TINY_VLM, 3, 5))


def test_server_serves_a_conditioned_request(tiny):
    """Over HTTP, a request naming a registered image streams the tokens
    of JAX's unified run of the same request; an unknown ``aux`` is a 400
    that lists the registered names."""
    prompt = np.random.RandomState(9).randint(0, TINY_VLM.vocab_size, 7)
    aux = image(TINY_VLM, 6)
    (want,) = jax_unified(tiny, [(prompt, 6, aux)])
    cb = TS.ContinuousBatcher(tiny[2], tiny[3], **CB_KW)
    cb.draw_segment = draws(tiny)

    async def main():
        srv = TSV.InferenceServer(cb, aux_registry={"cond0": aux,
                                                    "cond1": image(
                                                        TINY_VLM, 7)})
        await srv.start()
        try:
            ok = await asyncio.wait_for(TSV.stream_generate(
                HOST, srv.port, prompt, 6, aux="cond0"), WAIT_S)
            bad = await asyncio.wait_for(TSV.stream_generate(
                HOST, srv.port, prompt, 6, aux="cond9"), WAIT_S)
            return ok, bad
        finally:
            await srv.aclose()

    ok, bad = asyncio.run(main())
    assert ok["ids"] == want
    assert bad["status"] == 400
    assert "['cond0', 'cond1']" in bad["final"]["error"]


def test_serve_cli_conditioned_continuous(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    llama-3.2-vision-11b --blocks 1 --conditioned --scheduler continuous``
    serves its queue, images drawn from the pool, with prefix sharing."""
    TS.main(["--device", "cpu", "--arch", "llama-3.2-vision-11b",
             "--blocks", "1", "--conditioned", "--scheduler", "continuous",
             "--prompt-len", "8", "--max-new", "3", "--requests", "4",
             "--num-slots", "2", "--seg-len", "2", "--page-size", "4",
             "--prefix-cache", "--cond-pool", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests / 12 tokens" in out
    assert "prefix cache:" in out
