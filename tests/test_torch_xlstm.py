"""PyTorch port: the xLSTM family (xlstm-125m) served against the JAX package
on the CPU.

``repro_torch.models.ssm_model.XLSTMModel`` (units of one sLSTM and one
mLSTM block, per-slot fp32 state and no pages) and ``repro_torch.nn.xlstm``
(the cells' decode steps), on bridged params of ``reduced(xlstm-125m)`` cut
to 4 layers (2 units in 2 blocks, d 256, 4 heads: mLSTM head dim 128,
sLSTM head dim 64), the AdaLN heads, norms and gate biases randomised,
fp32. JAX draws each step's z inside its scan; the port is handed the same
draws (``JaxDraws``).

Held to JAX: ``mlstm_decode_step`` and ``slstm_decode_step`` over 8 steps
from the init state, outputs and every state leaf within 1e-5;
``XLSTMModel.apply_units`` in ``decode`` (a σ-conditioned probe; a commit
with an inactive slot) and in ``prefill_chunk`` (ragged ``n_valid``), h and
state within 1e-4; chunked against per-token commits within 1e-4;
``reset_paged_slots`` (init values, not zero) exactly; greedy tokens of the
static engine and of the batcher, with its per-step scheduling logs,
bit-equal; a slot spilled by JAX's batcher restored by the port's. In the
port alone: a probe leaves the state bit-unchanged and in place, slot reuse
leaks nothing, the prefix cache and the shared pool refuse the family,
the dense-cache ``prefill`` mode's states equal the decode steps' token
chain (the whole dense path against JAX: ``tests/test_torch_dense.py``;
training: ``tests/test_torch_xlstm_train.py``).

Every wait is bounded and fails instead of hanging.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws
from test_torch_hybrid import CB_KW, SEED, WAIT_S, draws, queue, step_both

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.launch import serve as JS
from repro.models import common as JCM
from repro.nn import cache as JKVC
from repro.nn import xlstm as JX
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import router as TR
from repro_torch.launch import serve as TS
from repro_torch.models import common as TCM
from repro_torch.models.model_api import build_model
from repro_torch.models.ssm_model import XLSTMModel, _block_apply
from repro_torch.nn import cache as TKVC
from repro_torch.nn import xlstm as TX
from repro_torch.nn.init import tree_items

torch.set_num_threads(1)

ARCH = "xlstm-125m"
REDUCED = JC.reduced(JC.get_config(ARCH), n_layers=4)
KINDS = ("slstm", "mlstm")


def xlstm_models(cfg=REDUCED, blocks=2):
    """JAX's model and params (the AdaLN heads, the norms' gains and
    biases, the cells' norm gains and gate biases randomised; they init to
    identity or zero) and the port's on the same params."""
    db = JC.DBConfig(num_blocks=blocks, overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)

    def rnd(x, scale, mean=0.0):
        return (mean + scale * rs.randn(*x.shape)).astype(np.float32)
    for kind in KINDS:
        u = tree["units"][kind]
        for k in ("w", "b"):
            u["adaln"][k] = rnd(u["adaln"][k], 0.02)
        u["ln"]["g"] = rnd(u["ln"]["g"], 0.1, 1.0)
        u["ln"]["b"] = rnd(u["ln"]["b"], 0.1)
        u["cell"]["norm_g"] = rnd(u["cell"]["norm_g"], 0.1, 1.0)
        bias = "b" if kind == "slstm" else "bif"
        u["cell"][bias] = rnd(u["cell"][bias], 0.5)
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    tdbm = TDBM(tcfg, TC.DBConfig(**dataclasses.asdict(db)))
    return (jdbm, jax.tree_util.tree_map(jnp.asarray, tree), tdbm,
            params_from_jax(tree, "cpu", tdbm.model.spec))


@pytest.fixture(scope="module")
def xl():
    return xlstm_models()


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _cell(pair, kind, unit=0):
    """(JAX's, the port's) params of one cell."""
    j = jax.tree_util.tree_map(lambda x: x[unit],
                               pair[1]["units"][kind]["cell"])
    t = {k: ({kk: vv[unit] for kk, vv in v.items()}
             if isinstance(v, dict) else v[unit])
         for k, v in pair[3]["units"][kind]["cell"].items()}
    return j, t


def _leaves_np(cache):
    """A cache's tensors as fp32 numpy in flatten order: the port's through
    ``cache_tensors``, JAX's through ``tree_leaves``."""
    leaves = jax.tree_util.tree_leaves(cache)
    if torch.is_tensor(leaves[0]):
        return [_np(t) for t in TKVC.cache_tensors(cache)]
    return [np.asarray(x, np.float32) for x in leaves]


# ---------------------------------------------------------------------------
# The model, its bridge and the cells
# ---------------------------------------------------------------------------

def test_bridge_and_build_model_take_the_xlstm(xl):
    """The JAX tree crosses unchanged (``units/slstm`` and ``units/mlstm``
    stacked (n_units, ...)); ``build_model`` gives an ``XLSTMModel`` with
    JAX's units; at full width the spec is JAX's leaf for leaf (0.1915 B
    params)."""
    jdbm, jparams, tdbm, tparams = xl
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {"".join(f"['{k}']" for k in path): x.numpy()
           for path, x in tree_items(tparams)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    m = tdbm.model
    assert isinstance(m, XLSTMModel) and m.n_units == jdbm.model.n_units == 2
    assert m.paged_state_axes == {"slstm": 1, "mlstm": 1}
    assert not m.kv_carries_all_state and m.max_cond_tokens == 0
    assert tdbm.causal_mode == jdbm.causal_mode == "two_pass"
    full_t = TDBM(TC.get_config(ARCH), TC.DEFAULT_DB).model
    full_j = JDBM(JC.get_config(ARCH), JC.DEFAULT_DB).model
    shapes_j = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    full_j.abstract_params(jnp.float32))[0]}
    shapes_t = {"".join(f"['{k}']" for k in path): tuple(s.shape)
                for path, s in tree_items(full_t.spec)}
    assert shapes_t == shapes_j
    assert round(sum(int(np.prod(s)) for s in shapes_t.values()) / 1e9,
                 4) == 0.1915
    assert isinstance(build_model(TC.get_config(ARCH)), XLSTMModel)


@pytest.mark.parametrize("kind", KINDS)
def test_cell_decode_steps_match_jax(xl, kind):
    """Eight tokens through the cell's decode step from its init state:
    every output and every state leaf within 1e-5 of JAX's (each package
    carrying its own state); the init states equal JAX's bit for bit, and
    the input state is never modified."""
    cfg = xl[2].cfg
    jp, tp = _cell(xl, kind)
    B, H, d = 3, cfg.n_heads, cfg.d_model
    d_in = int(cfg.xlstm.proj_factor * d)
    if kind == "mlstm":
        js = JX.mlstm_init_state(B, H, d_in)
        ts = TX.mlstm_init_state(B, H, d_in, device="cpu")
        jstep, tstep = JX.mlstm_decode_step, TX.mlstm_decode_step
    else:
        js = JX.slstm_init_state(B, H, d)
        ts = TX.slstm_init_state(B, H, d, device="cpu")
        jstep, tstep = JX.slstm_decode_step, TX.slstm_decode_step
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    xs = np.random.RandomState(2).randn(8, B, 1, d).astype(np.float32)
    for t, x in enumerate(xs):
        keep = [s.clone() for s in ts]
        jy, js = jstep(jp, jnp.asarray(x), H, cfg.xlstm, js)
        ty, new = tstep(tp, torch.from_numpy(x), H, cfg.xlstm, ts)
        assert all(torch.equal(a, b) for a, b in zip(ts, keep))
        ts = new
        _close(ty, jy, 1e-5, f"{kind} out, step {t}")
        for i, (a, b) in enumerate(zip(ts, js)):
            _close(a, b, 1e-5, f"{kind} state leaf {i}, step {t}")


def _random_cache(pair, B, rs):
    """(the port's serving cache, JAX's) of B slots holding the same random
    state (finite stabilizers, positive sLSTM n)."""
    tdbm = pair[2]
    kv = tdbm.model.init_paged_cache(B, 1, 4, "fp32", device="cpu")
    for kind in KINDS:
        for i, t in enumerate(kv[kind]):
            x = rs.randn(*t.shape).astype(np.float32)
            if kind == "slstm" and i == 2:
                x = np.abs(x) + 0.5
            t.copy_(torch.from_numpy(x))
    # copies: on the CPU ``jnp.asarray`` may share the numpy buffer, which
    # the port then writes in place while JAX's dispatch is still queued
    jkv = {k: tuple(jnp.array(t.numpy(), copy=True) for t in kv[k])
           for k in KINDS}
    return kv, jkv


def _ctxs(pair, mode, B, **kw):
    jdbm, jparams, tdbm, tparams = pair
    jkw = {k: (None if v is None else jnp.asarray(np.asarray(v)))
           for k, v in kw.items() if k != "commit"}
    tkw = {k: (None if v is None else torch.as_tensor(np.asarray(v)))
           for k, v in kw.items() if k != "commit"}
    jctx = JCM.LayerCtx(cfg=jdbm.cfg, mode=mode, **jkw)
    tctx = TCM.LayerCtx(cfg=tdbm.cfg, mode=mode, impl="kernels", **tkw)
    if "commit" in kw:
        jctx.commit = tctx.commit = kw["commit"]
    return jctx, tctx


@pytest.mark.parametrize("commit", [False, True])
def test_apply_units_decode_matches_jax(xl, commit):
    """Both units over one token a slot from a random state: a
    σ-conditioned probe (``commit=False``: every slot's state bit-unchanged)
    or a commit with slot 1 inactive and the stream restarted at each
    block's first unit (its state bit-unchanged, the others advanced). h
    and every state leaf within 1e-4 of JAX's ``apply_units``; the cache
    keeps its storage (a CUDA graph holds its addresses)."""
    jdbm, jparams, tdbm, tparams = xl
    B, d = 3, tdbm.cfg.d_model
    rs = np.random.RandomState(5)
    kv, jkv = _random_cache(xl, B, rs)
    before = [t.clone() for t in TKVC.cache_tensors(kv)]
    ptrs = TKVC.pool_ptrs(kv)
    h = rs.randn(B, 1, d).astype(np.float32)
    active = np.array([True, False, True])
    jctx, tctx = _ctxs(xl, "decode", B, commit=commit,
                       active=active if commit else None)
    reset = [True, True] if commit else None
    if not commit:
        log_sig = np.log(np.array([0.3, 2.0, 9.0], np.float32))
        jctx.cond = jdbm.model.cond(jparams, jnp.asarray(log_sig))
        tctx.cond = tdbm.model.cond(tparams, torch.from_numpy(log_sig))
    jh, jnew, _ = jdbm.model.apply_units(
        jparams, jnp.asarray(h), 0, 2, jctx, jkv,
        None if reset is None else jnp.asarray(reset))
    th, _ = tdbm.model.apply_units(tparams, torch.from_numpy(h), 0, 2, tctx,
                                   kv, reset)
    _close(th, jh, 1e-4, "h")
    for i, (a, b) in enumerate(zip(_leaves_np(kv), _leaves_np(jnew))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"leaf {i}")
    assert TKVC.pool_ptrs(kv) == ptrs
    for now, was in zip(TKVC.cache_tensors(kv), before):
        if not commit:
            assert torch.equal(now, was)
        else:
            assert torch.equal(now[:, 1], was[:, 1])
            assert not torch.equal(now[:, 0], was[:, 0])


def test_apply_units_prefill_chunk_matches_jax(xl):
    """A 5-token chunk through both units with ragged ``n_valid`` (5, 2,
    0): the valid tokens' h and every state leaf within 1e-4 of JAX's
    ``prefill_chunk``; the slot with no valid token keeps its state bit
    for bit."""
    jdbm, jparams, tdbm, tparams = xl
    B, d = 3, tdbm.cfg.d_model
    rs = np.random.RandomState(6)
    kv, jkv = _random_cache(xl, B, rs)
    before = [t.clone() for t in TKVC.cache_tensors(kv)]
    h = rs.randn(B, 5, d).astype(np.float32)
    nv = np.array([5, 2, 0], np.int32)
    jctx, tctx = _ctxs(xl, "prefill_chunk", B, n_valid=nv)
    jh, jnew, _ = jdbm.model.apply_units(jparams, jnp.asarray(h), 0, 2, jctx,
                                         jkv, jnp.asarray([True, True]))
    th, _ = tdbm.model.apply_units(tparams, torch.from_numpy(h), 0, 2, tctx,
                                   kv, [True, True])
    for b, n in enumerate(nv):
        _close(th[b, :n], np.asarray(jh)[b, :n], 1e-4, f"h of slot {b}")
    for i, (a, b) in enumerate(zip(_leaves_np(kv), _leaves_np(jnew))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"leaf {i}")
    for now, was in zip(TKVC.cache_tensors(kv), before):
        assert torch.equal(now[:, 2], was[:, 2])


def _prefill(side, pair, prompts, plens, *, chunked, chunk=4):
    """Per-token commits or ``commit_prompt_chunk`` steps over a fresh fp32
    cache on one package. Returns (the state leaves, lengths) as numpy."""
    B, S0 = prompts.shape
    if side == "jax":
        dbm, params = pair[0], pair[1]
        kv = dbm.model.init_paged_cache(B, 1 + B * 4, 4, "fp32")
        table = JKVC.identity_page_table(B, 4)
        lens = jnp.zeros((B,), jnp.int32)
        pr, pl = jnp.asarray(prompts), jnp.asarray(plens)
        kw = dict(impl="auto")
    else:
        dbm, params = pair[2], pair[3]
        kv = dbm.model.init_paged_cache(B, 1 + B * 4, 4, "fp32",
                                        device="cpu")
        table = TKVC.identity_page_table(B, 4, device="cpu")
        lens = torch.zeros((B,), dtype=torch.int32)
        pr = torch.from_numpy(prompts.astype(np.int64))
        pl = torch.from_numpy(plens)
        kw = dict(impl="kernels")
    if not chunked:
        for t in range(S0):
            kv, lens = dbm.commit_prompt_token(
                params, kv, table, lens, pr[:, t:t + 1], active=t < pl,
                precision="fp32", **kw)
    for _ in range(-(-S0 // chunk) if chunked else 0):
        if side == "jax":
            idx = lens[:, None] + jnp.arange(chunk)
            tok = jnp.take_along_axis(pr, jnp.clip(idx, 0, S0 - 1), 1)
            nv = jnp.clip(pl - lens, 0, chunk)
        else:
            idx = lens[:, None].long() + torch.arange(chunk)
            tok = torch.gather(pr, 1, idx.clamp(0, S0 - 1))
            nv = torch.clamp(pl - lens, 0, chunk).to(torch.int32)
        kv, lens = dbm.commit_prompt_chunk(params, kv, table, lens, tok,
                                           n_valid=nv, precision="fp32",
                                           **kw)
    return _leaves_np(kv), np.asarray(lens)


@pytest.mark.parametrize("ragged", [False, True])
def test_chunk_commit_matches_jax_and_per_token(xl, ragged):
    """The xLSTM case of ``tests/test_prefill.py``'s chunk-vs-per-token
    check, both packages: the port's chunked prefill within 1e-4 of JAX's
    chunked prefill and of its own per-token commits, on every unit's
    state; lengths equal."""
    rs = np.random.RandomState(1)
    prompts = rs.randint(0, REDUCED.vocab_size, (3, 7)).astype(np.int32)
    plens = (np.array([7, 3, 5], np.int32) if ragged
             else np.full((3,), 7, np.int32))
    got, lg = _prefill("port", xl, prompts, plens, chunked=True)
    tok, lt = _prefill("port", xl, prompts, plens, chunked=False)
    want, lj = _prefill("jax", xl, prompts, plens, chunked=True)
    np.testing.assert_array_equal(lg, lj)
    np.testing.assert_array_equal(lg, lt)
    assert len(got) == len(want) == 7
    for i in range(len(got)):
        for other in (want, tok):
            np.testing.assert_allclose(got[i], other[i], rtol=1e-4,
                                       atol=1e-4, err_msg=f"leaf {i}")


def test_paged_cache_and_reset_match_jax(xl):
    """``init_paged_cache``: JAX's leaves, shapes and values, fp32 under
    every policy, no pages. ``reset_paged_slots`` (the xLSTM case of
    ``tests/test_decode.py``'s reset test): the masked slots go back to the
    init values (m -1e30, the sLSTM's n 1e-6), the other slot keeps its
    state, as JAX's reset; in place."""
    jdbm, _, tdbm, _ = xl
    for policy in ("bf16", "fp32", "bf16_kvint8"):
        kv = tdbm.model.init_paged_cache(3, 4, 4, policy, device="cpu")
        jkv = jdbm.model.init_paged_cache(3, 4, 4, policy)
        assert not TKVC.paged_leaves(kv)
        assert tdbm.model.cache_batch(kv) == 3
        for a, b in zip(TKVC.cache_tensors(kv),
                        jax.tree_util.tree_leaves(jkv)):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for t in TKVC.cache_tensors(kv):
        t.add_(1.0)
    dirty = [t.clone() for t in TKVC.cache_tensors(kv)]
    ptrs = TKVC.pool_ptrs(kv)
    mask = np.array([True, False, True])
    out = tdbm.model.reset_paged_slots(kv, torch.from_numpy(mask))
    jout = jdbm.model.reset_paged_slots(
        jax.tree_util.tree_map(lambda x: x + 1.0, jkv), jnp.asarray(mask))
    assert out is kv and TKVC.pool_ptrs(kv) == ptrs
    for got, want, was in zip(TKVC.cache_tensors(kv),
                              jax.tree_util.tree_leaves(jout), dirty):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got[:, 1], was[:, 1])
    assert (kv["mlstm"][2][:, 0] == -1e30).all()
    assert (kv["slstm"][3][:, 2] == -1e30).all()
    assert (kv["slstm"][2][:, 0] == np.float32(1e-6)).all()


# ---------------------------------------------------------------------------
# The static engine, the continuous batcher, the server and the router
# ---------------------------------------------------------------------------

def test_static_engine_matches_jax(xl):
    """The xLSTM case of ``tests/test_decode.py``'s engine check: greedy
    fp32 tokens of ``generate`` over ragged prompts, chunked prefill,
    bit-equal to JAX's engine."""
    jdbm, jparams, tdbm, tparams = xl
    cfg = tdbm.cfg
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    plens = np.array([12, 5, 9], np.int32)
    max_new = 6
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), max_new,
                        rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                        precision="fp32", chunk_size=4)
    z = JaxDraws(7, 3, cfg, jdbm.db.sigma_max)(max_new)[0]
    out_t = TS.generate(tdbm, tparams, prompts, max_new,
                        prompt_lengths=plens, precision="fp32",
                        chunk_size=4, z0=z)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_batcher_matches_jax(xl):
    """Five ragged requests over two slots (slots recycled, each recycled
    slot reset to the init state at admission): per-step scheduling logs
    and greedy tokens equal to JAX's batcher under its draws; the
    ``kv_stats`` the health route reports are JAX's (no KV dtype)."""
    cb, _ = step_both(xl, queue(xl[2].cfg))
    assert cb.ingest_dispatches > 0 and cb.decode_dispatches > 0
    jcb = JS.ContinuousBatcher(xl[0], xl[1], **CB_KW)
    assert cb.kv_stats() == jcb.kv_stats()
    assert cb.kv_stats()["kv_dtype"] is None


@pytest.mark.parametrize("at", [1, 3])
def test_preemption_spills_the_state(xl, at):
    """A request preempted mid-prefill (step 1) or mid-decode (step 3):
    the spill carries its state rows (``paged_state_axes``), so it resumes
    bit-identically to the run without the preemption, and every step logs
    as JAX's."""
    prompt = (np.arange(1, 10) * 5) % REDUCED.vocab_size
    reqs = [(prompt, 8)]
    _, base = step_both(xl, reqs, num_slots=1)
    cb, got = step_both(xl, reqs, preempt={at: 0}, num_slots=1)
    assert cb.preemptions >= 1 and cb.restores == cb.preemptions
    assert got == base


def test_slot_reuse_does_not_leak_state(xl):
    """``tests/test_decode.py``'s slot-reuse check: serve [p1, p2] and
    [p1', p2] through ONE slot (same lengths, other tokens); p2's greedy
    output is the same, and equal to p2 served alone with the draws it
    saw, so the first occupant's state does not leak into the second."""
    _, _, tdbm, tparams = xl
    rs = np.random.RandomState(3)
    p1, p1b, p2 = (rs.randint(0, REDUCED.vocab_size, 9) for _ in range(3))
    kw = dict(CB_KW, num_slots=1, max_len=32)
    outs = []
    for first in (p1, p1b, None):
        cb = TS.ContinuousBatcher(tdbm, tparams, **kw)
        cb.draw_segment = draws(xl, SEED, 1)
        if first is None:          # p2 alone, after the same draws
            cb.draw_segment(3 * cb.seg_len)
        else:
            cb.submit(first, 9)
        cb.submit(p2, 9)
        outs.append([list(r.out) for r in cb.run()])
    assert outs[0][0] != outs[1][0]
    assert outs[0][1] == outs[1][1] == outs[2][-1]


def test_spilled_slot_crosses_packages(xl):
    """JAX's batcher spills a slot mid-decode (its state rows in JAX's wire
    format, tuples flattened in JAX's order); the port restores the bytes
    and finishes with the tokens of JAX's uninterrupted run. The port's
    own spill at the same step holds the same rows, leaf by leaf, within
    1e-4."""
    jdbm, jparams, tdbm, tparams = xl
    prompt = (np.arange(1, 9) * 5 % REDUCED.vocab_size).astype(np.int32)
    kw = dict(CB_KW, num_slots=1)
    jcb = JS.ContinuousBatcher(jdbm, jparams, **kw)
    jcb.submit(prompt, 8)
    (want,) = jcb.run(jax.random.PRNGKey(SEED))
    src = JS.ContinuousBatcher(jdbm, jparams, **kw)
    src.submit(prompt, 8)
    mine = TS.ContinuousBatcher(tdbm, tparams, **kw)
    mine.draw_segment = draws(xl, SEED, 1)
    mine.submit(prompt.astype(np.int64), 8)
    rng = jax.random.PRNGKey(SEED)
    for _ in range(3):
        rng, f = src.step(rng, strict=False)
        assert not f and not mine.step(strict=False)
    with src._pool_lock:
        req = src._spill_slot(0)
    with mine._pool_lock:
        own = mine._spill_slot(0)
    moved = TS.Request(req.rid, np.asarray(req.prompt, np.int64),
                       req.max_new)
    moved.out = list(req.out)
    moved.spilled = TKVC.SpilledSlot.from_bytes(req.spilled.to_bytes())
    moved.spill_meta = dict(length=req.spill_meta["length"])
    assert len(moved.spilled.data) == len(own.spilled.data) == 7
    for i, (a, b) in enumerate(zip(moved.spilled.data, own.spilled.data)):
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"leaf {i}")
    dst = TS.ContinuousBatcher(tdbm, tparams, **dict(kw, total_pages=14))
    dst.free_pages = dst.free_pages[5:] + dst.free_pages[:5]
    dst.draw_segment = draws(xl, 0, 1)
    dst.draw_segment.rng = rng
    dst.submit_request(moved)
    fin = []
    for _ in range(64):
        if not dst.has_work():
            break
        fin.extend(dst.step(strict=False))
    assert [list(r.out) for r in fin] == [want.out]
    assert dst.restores == 1


def test_prefix_cache_and_shared_pool_refuse_the_xlstm(xl):
    """The xLSTM case of ``tests/test_prefill.py``'s refusal: per-slot
    recurrent state is not paged, so prefix sharing and a
    ``SharedPagePool`` (and with it the router's ``handoff="pages"``) are
    refused, as JAX refuses them."""
    _, _, tdbm, tparams = xl
    with pytest.raises(ValueError, match="prefix_cache=True is unsound"):
        TS.ContinuousBatcher(tdbm, tparams, prefix_cache=True, **CB_KW)
    with pytest.raises(ValueError, match="shares paged KV only"):
        TS.SharedPagePool(13).join(tdbm, "fp32", 4, torch.device("cpu"), 2)
    with pytest.raises(ValueError):
        TR.DisaggRouter(tdbm, tparams, n_prefill=1, n_decode=1,
                        handoff="pages", **CB_KW)


def test_router_copy_handoff_equals_unified(xl):
    """``handoff="copy"`` keeps a pool per worker, so it serves the xLSTM:
    two requests one at a time through 1 prefill + 1 decode worker
    (decode0 fed JAX's draws), each migration carrying the state rows,
    equal to JAX's unified run."""
    from test_torch_disagg import pool_whole, wait_for
    jdbm, jparams, tdbm, tparams = xl
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(0, REDUCED.vocab_size, size=n), 8) for n in (9, 6)]
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
    router.decode_workers[0].cb.draw_segment = draws(xl)
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


def test_server_streams_an_xlstm_request(xl):
    """Over HTTP (``InferenceServer`` over the xLSTM's batcher), a request
    streams the tokens of JAX's unified run of the same request, and
    ``/v1/health`` reports no KV dtype."""
    from repro_torch.launch import server as TSV
    jdbm, jparams, tdbm, tparams = xl
    prompt = np.random.RandomState(9).randint(0, REDUCED.vocab_size, 7)
    jcb = JS.ContinuousBatcher(jdbm, jparams, **CB_KW)
    jcb.submit(np.asarray(prompt, np.int32), 6)
    (want,) = jcb.run(jax.random.PRNGKey(SEED))
    cb = TS.ContinuousBatcher(tdbm, tparams, **CB_KW)
    cb.draw_segment = draws(xl)

    async def main():
        srv = TSV.InferenceServer(cb)
        await srv.start()
        try:
            r = await asyncio.wait_for(TSV.stream_generate(
                "127.0.0.1", srv.port, prompt, 6), WAIT_S)
            health = await asyncio.wait_for(TSV.request_json(
                "127.0.0.1", srv.port, "GET", "/v1/health"), WAIT_S)
            return r, health
        finally:
            await srv.aclose()

    r, (code, health) = asyncio.run(main())
    assert r["ids"] == want.out
    assert code == 200 and health["kv_dtype"] is None


def test_serve_cli_xlstm(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch xlstm-125m``
    serves through the static engine and the continuous batcher;
    ``--prefix-cache`` is refused for the family."""
    base = ["--device", "cpu", "--arch", ARCH, "--prompt-len", "8",
            "--max-new", "3", "--page-size", "4", "--ragged"]
    TS.main(base + ["--batch", "2"])
    assert "[static] xlstm-125m on cpu: generated 2x3" in (
        capsys.readouterr().out)
    cont = base + ["--scheduler", "continuous", "--requests", "3",
                   "--num-slots", "2", "--seg-len", "2"]
    TS.main(cont)
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unsound"):
        TS.main(cont + ["--prefix-cache"])


def test_training_raises_naming_a63b(xl):
    """The dense-cache ``prefill`` mode runs the sequence forms
    (``slstm_fwd``, ``mlstm_fwd(return_state=True)``): the uncached
    ``apply_units`` returns each unit's final states, stacked as
    ``init_cache`` lays them out, and its output; both equal the decode
    steps' token chain from the init state within 1e-4. A block alone
    returns its final state in that mode."""
    _, _, tdbm, tparams = xl
    B_, S_ = 2, 8
    ctx = tdbm.make_ctx(tparams, S_, "prefill", precision="fp32")
    h = torch.randn(B_, S_, REDUCED.d_model,
                    generator=torch.Generator().manual_seed(0))
    out, states = tdbm.model.apply_units(tparams, h, 0, 1, ctx)
    chain = tdbm.model.init_cache(B_, S_, torch.float32, size=1,
                                  device="cpu")
    dctx = tdbm.make_ctx(tparams, 1, "decode", precision="fp32")
    ys = [tdbm.model.apply_units(tparams, h[:, t:t + 1], 0, 1, dctx,
                                 chain)[0] for t in range(S_)]
    _close(out, _np(torch.cat(ys, dim=1)), 1e-4, "output")
    for got, want in zip(_leaves_np(states), _leaves_np(chain)):
        assert got.shape == want.shape
        _close(torch.from_numpy(got), want, 1e-4, "state")
    unit = tdbm.model.unit_params(tparams)[0]
    for kind in KINDS:
        y, st = _block_apply(unit[kind], h, ctx, kind)
        assert y.shape == h.shape and isinstance(st, tuple)
