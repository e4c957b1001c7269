"""PyTorch port: the hybrid family (zamba2) served against the JAX package
on the CPU.

``repro_torch.models.hybrid.HybridModel`` (units of Mamba2 layers and one
application of a shared attention + MLP block, per-slot fp32 Mamba state
beside the shared block's paged KV) and ``repro_torch.nn.ssm``, on bridged
params of ``tests/test_disagg.py``'s ``TINY_HYBRID`` (2 units of 2 Mamba
layers, d 32) and of ``reduced(zamba2-7b)`` (2 units of 1, d 256, hd 64,
window 64), the AdaLN heads and norm gains randomised, fp32 unless a test
says otherwise. JAX draws each step's z inside its scan; the port is handed
the same draws (``JaxDraws``).

Held to JAX: ``_causal_conv`` and ``mamba2_decode_step`` within 1e-5; the
chunk mode (``mamba2_chunk_step``: in_proj, conv, norm and out_proj over
the whole chunk, the recurrence in its closed form) against the literal
``chunk_token_scan`` and against JAX's ``commit_prompt_chunk`` within 1e-4
on every unit's pages and state, uniform and ragged; greedy tokens of the
static engine (past the window) and of the continuous batcher, with its
per-step scheduling logs, bit-equal to JAX's. In the port alone: a probe
leaves the state bit-unchanged, inactive slots hold theirs, spill and
restore through the wire bytes are exact on bf16 and int8 pools, and the
prefix cache and the shared pool refuse the family.

Every wait is bounded and fails instead of hanging.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws, state

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import blocks as JB
from repro.launch import serve as JS
from repro.models import common as JCM
from repro.nn import cache as JKVC
from repro.nn import ssm as JSSM
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core import blocks as TB
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import router as TR
from repro_torch.launch import serve as TS
from repro_torch.models import common as TCM
from repro_torch.nn import cache as TKVC
from repro_torch.nn import ssm as TSSM

torch.set_num_threads(1)

TINY_HYBRID = JC.ModelConfig(name="tiny-disagg-hybrid", family="hybrid",
                             n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
                             d_ff=64, vocab_size=32, attn_every=2,
                             ssm=JC.SSMConfig(d_state=8, d_conv=4, expand=2,
                                              head_dim=16, chunk_size=8))
REDUCED = JC.reduced(JC.get_config("zamba2-7b"))
CB_KW = dict(num_slots=2, max_prompt=12, max_len=24, seg_len=3, page_size=4,
             chunk_size=4, precision="fp32")
SEED = 11
WAIT_S = 30.0


def hybrid_models(cfg, blocks=2):
    """JAX's model and params (AdaLN heads and norm gains randomised) and
    the port's on the same params."""
    db = JC.DBConfig(num_blocks=blocks, overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    for lay in (tree["units"]["mamba"], tree["shared"]):
        for k in ("w", "b"):
            lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                               ).astype(np.float32)
    for lay, norms in ((tree["units"]["mamba"], ("ln",)),
                       (tree["shared"], ("ln1", "ln2"))):
        for ln in norms:
            lay[ln]["g"] = (1.0 + 0.1 * rs.randn(*lay[ln]["g"].shape)
                            ).astype(np.float32)
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    tdbm = TDBM(tcfg, TC.DBConfig(**dataclasses.asdict(db)))
    return (jdbm, jax.tree_util.tree_map(jnp.asarray, tree), tdbm,
            params_from_jax(tree, "cpu", tdbm.model.spec))


@pytest.fixture(scope="module")
def tiny():
    return hybrid_models(TINY_HYBRID)


@pytest.fixture(scope="module")
def reduced():
    return hybrid_models(REDUCED)


def draws(pair, seed=SEED, num_slots=CB_KW["num_slots"]):
    return JaxDraws(seed, num_slots, pair[2].cfg, pair[2].db.sigma_max)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# The model, its bridge and the Mamba2 primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "reduced"])
def test_bridge_carries_the_hybrid_tree(which, request):
    """The JAX tree crosses unchanged (``units/mamba`` stacked (n_units,
    inner, ...), ``shared`` unstacked), and ``build_model`` gives a
    ``HybridModel`` with JAX's units and slot axis."""
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
    assert type(m).__name__ == "HybridModel"
    assert (m.n_units, m.inner) == (jdbm.model.n_units, jdbm.model.inner)
    assert tparams["units"]["mamba"]["mixer"]["a_log"].shape[:2] == (
        m.n_units, m.inner)
    assert tparams["shared"]["attn"]["wq"].ndim == 2
    assert m.paged_state_axes == {"mamba": 2}
    assert not m.kv_carries_all_state and m.max_cond_tokens == 0


def test_causal_mode_matches_jax():
    """``DiffusionBlocksModel.causal_mode`` is JAX's for every arch: the
    recurrent families are routed to two-pass whatever ``DBConfig`` says;
    ``_needs_two_pass`` agrees on the archs the port cannot build yet."""
    for arch in JC.list_archs():
        jcfg = JC.reduced(JC.get_config(arch))
        tcfg = TC.reduced(TC.get_config(arch))
        assert TB._needs_two_pass(tcfg) == JB._needs_two_pass(jcfg), arch
        for mode in ("concat", "two_pass"):
            jdb = JC.DBConfig(num_blocks=1, causal_mode=mode)
            try:
                tdbm = TDBM(tcfg, TC.DBConfig(num_blocks=1,
                                              causal_mode=mode))
            except NotImplementedError:
                assert tcfg.family in ("ssm", "audio"), arch
                continue
            assert tdbm.causal_mode == JDBM(jcfg, jdb).causal_mode, arch


@pytest.mark.parametrize("policy", ["fp32", "bf16", "bf16_kvint8",
                                    "fp32_kvint8"])
def test_state_dtypes_match_jax(policy):
    """``Policy.state_for`` and ``cast_stream`` give JAX's dtypes for every
    family: the recurrent families' states and streams stay fp32 under the
    bf16 policies."""
    from repro import precision as JP
    from repro_torch import precision as TP
    jp, tp = JP.get_policy(policy), TP.get_policy(policy)
    x = np.ones((2, 3), np.float32)
    for fam in (None, "dense", "hybrid", "ssm", "vlm"):
        want = jnp.dtype(jp.state_for(fam)).name
        assert str(tp.state_for(fam)).replace("torch.", "") == want
        jx = JP.cast_stream(policy, jnp.asarray(x), fam)
        tx = TP.cast_stream(policy, torch.from_numpy(x), fam)
        assert str(tx.dtype).replace("torch.", "") == jx.dtype.name


def _mixer(pair, unit=0, j=0):
    """(JAX's, the port's) params of one Mamba2 mixer."""
    jm = jax.tree_util.tree_map(lambda x: x[unit, j],
                                pair[1]["units"]["mamba"]["mixer"])
    tm = {k: ({kk: vv[unit, j] for kk, vv in v.items()}
              if isinstance(v, dict) else v[unit, j])
          for k, v in pair[3]["units"]["mamba"]["mixer"].items()}
    return jm, tm


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(reduced, with_prev):
    jm, tm = _mixer(reduced)
    rs = np.random.RandomState(1)
    ch = tm["conv_w"].shape[1]
    u = rs.randn(3, 5, ch).astype(np.float32)
    prev = rs.randn(3, 3, ch).astype(np.float32) if with_prev else None
    jo, jh = JSSM._causal_conv(jnp.asarray(u), jm["conv_w"], jm["conv_b"],
                               None if prev is None else jnp.asarray(prev))
    to, th = TSSM._causal_conv(torch.from_numpy(u), tm["conv_w"],
                               tm["conv_b"],
                               None if prev is None else torch.from_numpy(
                                   prev))
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=1e-5, atol=1e-5)


def _random_state(cfg, B, rs):
    st = TSSM.mamba2_init_state(B, cfg.ssm, cfg.d_model, device="cpu")
    return {k: torch.from_numpy(rs.randn(*t.shape).astype(np.float32))
            for k, t in st.items()}


def test_decode_step_matches_jax(reduced):
    """One token through ``mamba2_decode_step`` from a random state: the
    output and both state leaves within 1e-5 of JAX's; the input state is
    not modified."""
    jm, tm = _mixer(reduced)
    cfg = reduced[2].cfg
    rs = np.random.RandomState(2)
    u = rs.randn(3, 1, cfg.d_model).astype(np.float32)
    st = _random_state(cfg, 3, rs)
    keep = {k: t.clone() for k, t in st.items()}
    jo, js = JSSM.mamba2_decode_step(
        jm, jnp.asarray(u), cfg.ssm, cfg.d_model,
        {k: jnp.asarray(t.numpy()) for k, t in st.items()})
    to, ts = TSSM.mamba2_decode_step(tm, torch.from_numpy(u), cfg.ssm,
                                     cfg.d_model, st)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(st[k], keep[k])


@pytest.mark.parametrize("n_valid", [[6, 6, 6], [6, 2, 0]])
def test_chunk_step_matches_the_token_scan(reduced, n_valid):
    """The hoisted chunk step against the port's literal
    ``chunk_token_scan`` over ``mamba2_decode_step`` and JAX's: the valid
    tokens' outputs and the final states within 1e-4; a slot with
    ``n_valid`` 0 keeps its state bit for bit."""
    jm, tm = _mixer(reduced)
    cfg = reduced[2].cfg
    rs = np.random.RandomState(4)
    u = rs.randn(3, 6, cfg.d_model).astype(np.float32)
    st = _random_state(cfg, 3, rs)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    got_y, got = TSSM.mamba2_chunk_step(tm, torch.from_numpy(u), cfg.ssm,
                                        cfg.d_model, st, nv)
    lit_y, lit = TCM.chunk_token_scan(
        lambda x, s: TSSM.mamba2_decode_step(tm, x, cfg.ssm, cfg.d_model, s),
        torch.from_numpy(u), st, nv)
    jy, js = JCM.chunk_token_scan(
        lambda x, s: JSSM.mamba2_decode_step(jm, x, cfg.ssm, cfg.d_model, s),
        jnp.asarray(u), {k: jnp.asarray(t.numpy()) for k, t in st.items()},
        jnp.asarray(n_valid, jnp.int32))
    for b, n in enumerate(n_valid):
        for want in (_np(lit_y), np.asarray(jy)):
            np.testing.assert_allclose(_np(got_y[b, :n]), want[b, :n],
                                       rtol=1e-4, atol=1e-4)
        for k in ("h", "conv"):
            for want in (_np(lit[k]), np.asarray(js[k])):
                np.testing.assert_allclose(_np(got[k][b]), want[b],
                                           rtol=1e-4, atol=1e-4)
            if n == 0:
                assert torch.equal(got[k][b], st[k][b])


def _prefill(side, pair, prompts, plens, *, chunked, psz=4, chunk=4,
             extra=4):
    """The prefill of ``tests/test_prefill.py``'s ``_prefill_both_ways``
    on one package: per-token commits or ``commit_prompt_chunk`` steps
    over a fresh fp32 pool. Returns (the cache, lengths) as numpy trees."""
    B, S0 = prompts.shape
    pps = JKVC.pages_for(S0 + extra, psz)
    if side == "jax":
        dbm, params = pair[0], pair[1]
        kv = dbm.model.init_paged_cache(B, 1 + B * pps, psz, "fp32")
        table = JKVC.identity_page_table(B, pps)
        lens = jnp.zeros((B,), jnp.int32)
        pr, pl = jnp.asarray(prompts), jnp.asarray(plens)
    else:
        dbm, params = pair[2], pair[3]
        kv = dbm.model.init_paged_cache(B, 1 + B * pps, psz, "fp32",
                                        device="cpu")
        table = TKVC.identity_page_table(B, pps, device="cpu")
        lens = torch.zeros((B,), dtype=torch.int32)
        pr = torch.from_numpy(prompts.astype(np.int64))
        pl = torch.from_numpy(plens)
    if not chunked:
        for t in range(S0):
            kv, lens = dbm.commit_prompt_token(
                params, kv, table, lens, pr[:, t:t + 1], active=t < pl,
                precision="fp32", impl="auto" if side == "jax" else "kernels")
    else:
        for _ in range(-(-S0 // chunk)):
            if side == "jax":
                idx = lens[:, None] + jnp.arange(chunk)
                tok = jnp.take_along_axis(pr, jnp.clip(idx, 0, S0 - 1), 1)
                nv = jnp.clip(pl - lens, 0, chunk)
                kw = dict(impl="auto")
            else:
                idx = lens[:, None].long() + torch.arange(chunk)
                tok = torch.gather(pr, 1, idx.clamp(0, S0 - 1))
                nv = torch.clamp(pl - lens, 0, chunk).to(torch.int32)
                kw = dict(impl="kernels")
            kv, lens = dbm.commit_prompt_chunk(params, kv, table, lens, tok,
                                               n_valid=nv, precision="fp32",
                                               **kw)
    return _cache_numpy(kv), np.asarray(lens)


def _cache_numpy(kv):
    """{"h", "conv", "k", "v"}: the Mamba rows and the pages but the trash
    page, of either package's cache."""
    sk = kv["shared_kv"]
    return {"h": np.asarray(kv["mamba"]["h"], np.float32),
            "conv": np.asarray(kv["mamba"]["conv"], np.float32),
            "k": np.asarray(sk.k, np.float32)[:, 1:],
            "v": np.asarray(sk.v, np.float32)[:, 1:]}


@pytest.mark.parametrize("ragged", [False, True])
def test_chunk_commit_matches_jax_and_per_token(reduced, ragged):
    """The hybrid case of ``tests/test_prefill.py``'s chunk-vs-per-token
    check, both packages: the port's chunked prefill within 1e-4 of JAX's
    chunked prefill and of its own per-token commits, on every unit's pages
    and Mamba rows; lengths equal."""
    rs = np.random.RandomState(1)
    prompts = rs.randint(0, REDUCED.vocab_size, (3, 7)).astype(np.int32)
    plens = (np.array([7, 3, 5], np.int32) if ragged
             else np.full((3,), 7, np.int32))
    got, lg = _prefill("port", reduced, prompts, plens, chunked=True)
    tok, lt = _prefill("port", reduced, prompts, plens, chunked=False)
    want, lj = _prefill("jax", reduced, prompts, plens, chunked=True)
    np.testing.assert_array_equal(lg, lj)
    np.testing.assert_array_equal(lg, lt)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], tok[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _decode_ctx(tdbm, B, pps, lens, active=None, commit=True):
    from repro_torch.models.common import LayerCtx
    return LayerCtx(cfg=tdbm.cfg, mode="decode", precision=None,
                    impl="kernels", lengths=lens,
                    page_table=TKVC.identity_page_table(B, pps,
                                                        device="cpu"),
                    active=active, commit=commit)


def test_probe_holds_state_and_commit_holds_inactive(tiny):
    """A denoising probe (``commit=False``) leaves every Mamba row and page
    bit-unchanged; a commit under ``active`` advances the active slots'
    rows and leaves the inactive slot's bit-unchanged, all in place (the
    storage a CUDA graph holds)."""
    _, _, tdbm, tparams = tiny
    B, pps, d = 3, 3, tdbm.cfg.d_model
    kv = tdbm.model.init_paged_cache(B, 1 + B * pps, 4, "fp32", device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in TKVC.cache_tensors(kv):
        t.copy_(torch.randn(t.shape, generator=g))
    ptrs = TKVC.pool_ptrs(kv)
    lens = torch.tensor([2, 5, 7], dtype=torch.int32)
    before = [t.clone() for t in TKVC.cache_tensors(kv)]
    h = torch.randn(B, 1, d, generator=g)
    ctx = _decode_ctx(tdbm, B, pps, lens, commit=False)
    ctx.cond = tdbm.model.cond(tparams, torch.zeros(B))
    tdbm.model.apply_units(tparams, h, 0, tdbm.model.n_units, ctx, kv)
    assert all(torch.equal(a, b)
               for a, b in zip(TKVC.cache_tensors(kv), before))
    active = torch.tensor([True, False, True])
    ctx = _decode_ctx(tdbm, B, pps, lens, active=active)
    tdbm.model.apply_units(tparams, h, 0, tdbm.model.n_units, ctx, kv)
    assert TKVC.pool_ptrs(kv) == ptrs
    for name in ("h", "conv"):
        now, was = kv["mamba"][name], before[["conv", "h"].index(name)]
        assert torch.equal(now[:, :, 1], was[:, :, 1]), name
        for s in (0, 2):
            assert not torch.equal(now[:, :, s], was[:, :, s]), name


@pytest.mark.parametrize("policy,kv_dtype", [("bf16", torch.bfloat16),
                                             ("bf16_kvint8", torch.int8),
                                             ("fp32", torch.float32)])
def test_paged_cache_states_stay_fp32(tiny, policy, kv_dtype):
    """``init_paged_cache``: the shared block's pages in the policy's KV
    dtype, the Mamba rows fp32 under every policy (``state_for``), shaped
    (units, inner, slots, ...) as JAX's; ``cache_batch`` reads the slots."""
    jdbm, _, tdbm, _ = tiny
    kv = tdbm.model.init_paged_cache(3, 5, 4, policy, device="cpu")
    jkv = jdbm.model.init_paged_cache(3, 5, 4, policy)
    assert kv["shared_kv"].k.dtype == kv_dtype
    assert kv["shared_kv"].quantized == (kv_dtype == torch.int8)
    for k in ("h", "conv"):
        assert kv["mamba"][k].dtype == torch.float32
        assert tuple(kv["mamba"][k].shape) == jkv["mamba"][k].shape
    assert tuple(kv["shared_kv"].k.shape) == jkv["shared_kv"].k.shape
    assert tdbm.model.cache_batch(kv) == 3


def test_reset_paged_slots_on_axis_2(tiny):
    """The hybrid case of ``tests/test_decode.py``'s reset test: the masked
    slot's Mamba rows (axis 2) go back to the init state (zero), the other
    slot's stay, the pages are untouched, all in place."""
    _, _, tdbm, _ = tiny
    kv = tdbm.model.init_paged_cache(2, 4, 4, "bf16", device="cpu")
    for t in TKVC.cache_tensors(kv):
        t.fill_(1)
    ptrs = TKVC.pool_ptrs(kv)
    out = tdbm.model.reset_paged_slots(kv, torch.tensor([False, True]))
    assert out is kv and TKVC.pool_ptrs(kv) == ptrs
    for t in kv["mamba"].values():
        assert (t[:, :, 1] == 0).all() and (t[:, :, 0] == 1).all()
    assert (kv["shared_kv"].k == 1).all() and (kv["shared_kv"].v == 1).all()


# ---------------------------------------------------------------------------
# The static engine and the continuous batcher
# ---------------------------------------------------------------------------

def test_static_engine_matches_jax_past_the_window(reduced):
    """The zamba case of ``tests/test_decode.py``'s engine check: greedy
    fp32 tokens of ``generate`` bit-equal to JAX's engine, ragged prompts,
    with prompt + new past the reduced window of 64 (the shared block's
    paged attends drop the oldest keys)."""
    jdbm, jparams, tdbm, tparams = reduced
    cfg = tdbm.cfg
    assert cfg.sliding_window == 64
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, cfg.vocab_size, size=(3, 64)).astype(np.int32)
    plens = np.array([64, 23, 58], np.int32)
    max_new = 6
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), max_new,
                        rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                        precision="fp32", chunk_size=16)
    z = JaxDraws(7, 3, cfg, jdbm.db.sigma_max)(max_new)[0]
    out_t = TS.generate(tdbm, tparams, prompts, max_new,
                        prompt_lengths=plens, precision="fp32",
                        chunk_size=16, z0=z)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert int(plens.max()) + max_new > cfg.sliding_window


def step_both(pair, reqs, *, seed=SEED, preempt=None, **kw):
    """``reqs`` [(prompt, max_new)] submitted at once to JAX's batcher and
    the port's (the port fed JAX's draws), stepped in turn; ``preempt``
    {step: slot} preempts that slot's request before the step. Asserts
    equal per-step logs and tokens. Returns (the port's batcher, {rid:
    tokens})."""
    jdbm, jparams, tdbm, tparams = pair
    kw = {**CB_KW, **kw}
    cbs = (JS.ContinuousBatcher(jdbm, jparams, **kw),
           TS.ContinuousBatcher(tdbm, tparams, **kw))
    cbs[1].draw_segment = draws(pair, seed, kw["num_slots"])
    logs, outs = ([], []), ({}, {})
    for i, cb in enumerate(cbs):
        for p, n in reqs:
            cb.submit(np.asarray(p, np.int32 if i == 0 else np.int64), n)
        rng, step = jax.random.PRNGKey(seed), 0
        while cb.has_work():
            victim = cb.slot_req[(preempt or {}).get(step, 0)]
            if step in (preempt or {}) and victim is not None:
                cb.preempt(victim.rid)
            if i == 0:
                rng, fin = cb.step(rng)
            else:
                fin = cb.step()
            logs[i].append(state(cb, fin))
            outs[i].update({r.rid: list(r.out) for r in fin})
            step += 1
            assert step < 200, "scheduler failed to converge"
    assert logs[0] == logs[1]
    assert outs[0] == outs[1]
    tcb = cbs[1]
    assert len(tcb.free_pages) + len(tcb.page_refs) == tcb.total_pages - 1
    return tcb, outs[1]


def queue(cfg, n=5, seed=5):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, cfg.vocab_size, size=rs.randint(3, 12)), 5)
            for _ in range(n)]


@pytest.mark.parametrize("which", ["tiny", "reduced"])
def test_batcher_matches_jax(which, request):
    """Five ragged requests over two slots (slots recycled, each recycled
    slot's Mamba rows reset at admission): per-step scheduling logs and
    greedy tokens equal to JAX's batcher under its draws."""
    pair = request.getfixturevalue(which)
    cb, _ = step_both(pair, queue(pair[2].cfg))
    assert cb.ingest_dispatches > 0 and cb.decode_dispatches > 0


@pytest.mark.parametrize("at", [1, 3])
def test_preemption_spills_the_mamba_rows(tiny, at):
    """A request preempted mid-prefill (step 1) or mid-decode (step 3):
    the spill carries its Mamba rows (``paged_state_axes``) beside its
    pages, so it resumes bit-identically to the run without the
    preemption, and every step logs as JAX's."""
    prompt = (np.arange(1, 10) * 5) % TINY_HYBRID.vocab_size
    reqs = [(prompt, 8)]
    _, base = step_both(tiny, reqs, num_slots=1)
    cb, got = step_both(tiny, reqs, preempt={at: 0}, num_slots=1)
    assert cb.preemptions >= 1 and cb.restores == cb.preemptions
    assert got == base


def test_slot_reuse_does_not_leak_state(reduced):
    """``tests/test_decode.py``'s slot-reuse check on the hybrid: serve
    [p1, p2] and [p1', p2] through ONE slot (same lengths, other tokens);
    p2's greedy output is the same, and equal to p2 served alone with the
    draws it saw, so neither the Mamba rows nor the pages of the first
    occupant leak into the second."""
    _, _, tdbm, tparams = reduced
    rs = np.random.RandomState(3)
    p1, p1b, p2 = (rs.randint(0, REDUCED.vocab_size, 9) for _ in range(3))
    kw = dict(CB_KW, num_slots=1, max_len=32)
    outs = []
    for first in (p1, p1b, None):
        cb = TS.ContinuousBatcher(tdbm, tparams, **kw)
        cb.draw_segment = draws(reduced, SEED, 1)
        if first is None:          # p2 alone, after the same draws
            cb.draw_segment(3 * cb.seg_len)
        else:
            cb.submit(first, 9)
        cb.submit(p2, 9)
        outs.append([list(r.out) for r in cb.run()])
    assert outs[0][0] != outs[1][0]
    assert outs[0][1] == outs[1][1] == outs[2][-1]


def _run_port(pair, prompt, kv_precision, *, spill_after=None, seed=SEED):
    """One request on a one-slot port batcher (bf16 pages or int8, fp32
    Mamba rows). With ``spill_after`` steps, the slot is spilled, its
    snapshot crosses the wire bytes and is restored into a second batcher
    with a bigger pool and a rotated free list. Returns the tokens."""
    _, _, tdbm, tparams = pair
    kw = dict(CB_KW, num_slots=1, precision=kv_precision)
    src = TS.ContinuousBatcher(tdbm, tparams, **kw)
    src.draw_segment = draws(pair, seed, 1)
    src.submit(prompt, 8)
    if spill_after is None:
        (r,) = src.run()
        return list(r.out)
    for _ in range(spill_after):
        assert not src.step(strict=False)
    with src._pool_lock:
        req = src._spill_slot(0)
    assert 0 < len(req.out) < 8, req.out
    assert len(src.free_pages) == src.total_pages - 1, "pages leaked"
    raw = req.spilled.to_bytes()
    req.spilled = TKVC.SpilledSlot.from_bytes(raw)
    paged = [e for e in req.spilled.data if isinstance(e, tuple)]
    dense = [e for e in req.spilled.data if not isinstance(e, tuple)]
    assert len(paged) == 1 and len(paged[0]) == (
        4 if kv_precision == "bf16_kvint8" else 2)
    assert [e.dtype for e in dense] == [torch.float32] * 2   # conv, h
    dst = TS.ContinuousBatcher(tdbm, tparams, **dict(
        kw, total_pages=src.total_pages + 6))
    dst.free_pages = dst.free_pages[5:] + dst.free_pages[:5]
    dst.draw_segment = draws(pair, 0, 1)
    dst.draw_segment.rng = src.draw_segment.rng
    dst.submit_request(req)
    fin = []
    for _ in range(64):
        if not dst.has_work():
            break
        fin.extend(dst.step(strict=False))
    assert len(fin) == 1 and fin[0].error is None and dst.restores == 1
    assert len(dst.free_pages) == dst.total_pages - 1 and not dst.page_refs
    return list(fin[0].out)


@pytest.mark.parametrize("precision", ["bf16", "bf16_kvint8"])
def test_spill_restore_across_pools_is_exact(tiny, precision):
    """The hybrid cases of ``tests/test_disagg.py``'s round trip: spill
    (pages + Mamba rows) -> ``to_bytes`` -> ``from_bytes`` -> restore into
    another batcher's other pages, bf16 and int8 pools: the tokens are
    bit-identical to an uninterrupted run."""
    prompt = (np.arange(1, 9) * 5 % TINY_HYBRID.vocab_size).astype(np.int64)
    base = _run_port(tiny, prompt, precision)
    assert _run_port(tiny, prompt, precision, spill_after=3) == base


def test_spilled_hybrid_slot_crosses_packages(tiny):
    """JAX's batcher spills a hybrid slot mid-decode (its pages and fp32
    Mamba rows in JAX's wire format); the port restores the bytes into its
    own pool and finishes with the tokens of JAX's uninterrupted run."""
    jdbm, jparams, tdbm, tparams = tiny
    prompt = (np.arange(1, 9) * 5 % TINY_HYBRID.vocab_size).astype(np.int32)
    kw = dict(CB_KW, num_slots=1)
    jcb = JS.ContinuousBatcher(jdbm, jparams, **kw)
    jcb.submit(prompt, 8)
    (want,) = jcb.run(jax.random.PRNGKey(SEED))
    src = JS.ContinuousBatcher(jdbm, jparams, **kw)
    src.submit(prompt, 8)
    rng = jax.random.PRNGKey(SEED)
    for _ in range(3):
        rng, f = src.step(rng, strict=False)
        assert not f
    with src._pool_lock:
        req = src._spill_slot(0)
    dst = TS.ContinuousBatcher(tdbm, tparams, **dict(kw, total_pages=14))
    dst.free_pages = dst.free_pages[5:] + dst.free_pages[:5]
    moved = TS.Request(req.rid, np.asarray(req.prompt, np.int64),
                       req.max_new)
    moved.out = list(req.out)
    moved.spilled = TKVC.SpilledSlot.from_bytes(req.spilled.to_bytes())
    moved.spill_meta = dict(length=req.spill_meta["length"])
    dst.draw_segment = draws(tiny, 0, 1)
    dst.draw_segment.rng = rng
    dst.submit_request(moved)
    fin = []
    for _ in range(64):
        if not dst.has_work():
            break
        fin.extend(dst.step(strict=False))
    assert [list(r.out) for r in fin] == [want.out]


def test_prefix_cache_and_shared_pool_refuse_the_hybrid(tiny):
    """Per-slot recurrent state is not paged, so prefix sharing and a
    ``SharedPagePool`` (and with it the router's ``handoff="pages"``) are
    refused, as JAX refuses them."""
    _, _, tdbm, tparams = tiny
    with pytest.raises(ValueError, match="prefix_cache=True is unsound"):
        TS.ContinuousBatcher(tdbm, tparams, prefix_cache=True, **CB_KW)
    with pytest.raises(ValueError, match="shares paged KV only"):
        TS.SharedPagePool(13).join(tdbm, "fp32", 4, torch.device("cpu"), 2)
    with pytest.raises(ValueError):
        TR.DisaggRouter(tdbm, tparams, n_prefill=1, n_decode=1,
                        handoff="pages", **CB_KW)


def test_router_copy_handoff_equals_unified(tiny):
    """``handoff="copy"`` keeps a pool per worker, so it serves the hybrid:
    two requests one at a time through 1 prefill + 1 decode worker
    (decode0 fed JAX's draws), each migration carrying the Mamba rows,
    equal to JAX's unified run."""
    from test_torch_disagg import pool_whole, wait_for
    jdbm, jparams, tdbm, tparams = tiny
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(0, TINY_HYBRID.vocab_size, size=n), 8)
            for n in (9, 6)]
    cb = JS.ContinuousBatcher(jdbm, jparams, **CB_KW)
    rng, base = jax.random.PRNGKey(SEED), []
    for p, n in reqs:
        cb.submit(np.asarray(p, np.int32), n)
        fin = []
        while cb.has_work():
            rng, f = cb.step(rng, strict=False)
            fin.extend(f)
        base.append(list(fin[0].out))
    router = TR.DisaggRouter(tdbm, tparams, n_prefill=1, n_decode=1,
                             handoff="copy", **CB_KW)
    router.decode_workers[0].cb.draw_segment = draws(tiny)
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.start()
    outs = []
    try:
        for p, n in reqs:
            rid = router.submit(p, n)
            wait_for(lambda: rid in done, f"router request {rid}", WAIT_S)
            assert done[rid].error is None, done[rid].error
            outs.append(list(done[rid].out))
    finally:
        router.stop(WAIT_S)
    pool_whole(router)
    assert outs == base
    assert router.stats()["migrations"] >= 2


def test_serve_cli_hybrid_continuous(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch zamba2-7b
    --scheduler continuous`` serves its queue; ``--prefix-cache`` is
    refused for the family."""
    argv = ["--device", "cpu", "--arch", "zamba2-7b", "--blocks", "2",
            "--scheduler", "continuous", "--prompt-len", "8", "--max-new",
            "3", "--requests", "3", "--num-slots", "2", "--seg-len", "2",
            "--page-size", "4", "--ragged"]
    TS.main(argv)
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unsound"):
        TS.main(argv + ["--prefix-cache"])


def test_server_streams_a_hybrid_request(tiny):
    """Over HTTP (``InferenceServer`` over the hybrid's batcher), a request
    streams the tokens of JAX's unified run of the same request."""
    import asyncio
    from repro_torch.launch import server as TSV
    jdbm, jparams, tdbm, tparams = tiny
    prompt = np.random.RandomState(9).randint(0, TINY_HYBRID.vocab_size, 7)
    jcb = JS.ContinuousBatcher(jdbm, jparams, **CB_KW)
    jcb.submit(np.asarray(prompt, np.int32), 6)
    (want,) = jcb.run(jax.random.PRNGKey(SEED))
    cb = TS.ContinuousBatcher(tdbm, tparams, **CB_KW)
    cb.draw_segment = draws(tiny)

    async def main():
        srv = TSV.InferenceServer(cb)
        await srv.start()
        try:
            return await asyncio.wait_for(TSV.stream_generate(
                "127.0.0.1", srv.port, prompt, 6), WAIT_S)
        finally:
            await srv.aclose()

    assert asyncio.run(main())["ids"] == want.out
