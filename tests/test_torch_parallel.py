"""PyTorch port: the round-robin block-parallel engine, the anomaly guard,
fault injection, the data pipeline and checkpoints against the JAX package
on the CPU.

TINY8 (8 layers, d 64, 4 heads, vocab 64) in 4 blocks of 2, fp32, as the JAX
engine tests size it, the JAX init bridged to torch with the AdaLN heads and
norm gains randomised. The JAX engine draws each block's σ and ε from its
per-block key inside ``block_loss``; ``jax_draws`` replays that split and
hands them to the port (``draws=``). Losses, grad norms, params and both
moment sets agree within 1e-4 (atol and rtol); what the port decides on its
own (skips, views, schedules, cursors, files) is compared exactly.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.configs import DBConfig as JDBConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import edm as JE
from repro.core import partition as JP
from repro.core.training import GuardConfig as JGuard
from repro.core.training import make_db_train_step as j_make_db_step
from repro.data import HostDataLoader as JLoader
from repro.data import MarkovLM as JMarkovLM
from repro.data import MarkovStream as JStream
from repro.data import arithmetic_stream as j_arith
from repro.data import tokenizer as JTok
from repro.launch.faults import FaultInjector as JFaults
from repro.optim import apply_updates as j_apply
from repro.parallel import BlockParallelTrainer as JTrainer
from repro_torch import checkpoint as TCK
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.core.training import GuardConfig as TGuard
from repro_torch.core.training import make_db_train_step as t_make_db_step
from repro_torch.data import HostDataLoader as TLoader
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import MarkovStream as TStream
from repro_torch.data import arithmetic_stream as t_arith
from repro_torch.data import tokenizer as TTok
from repro_torch.launch.faults import FaultInjector as TFaults
from repro_torch.launch.faults import make_injector
from repro_torch.nn.init import tree_items, tree_map
from repro_torch.optim import AdamWState
from repro_torch.parallel import (BlockParallelTrainer, block_view,
                                  merge_params, split_periphery,
                                  stack_block_views)
from repro_torch.parallel.engine import _split_optimizer

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
TINY8 = JModelConfig(name="tiny8", family="dense", n_layers=8, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64)
B = 4
BATCH, SEQ = 4, 16
POLICIES = ("replicate+psum-mean", "owner-broadcast", "freeze-after-warmup")


def tcfg(steps=8, torch_side=False, **kw):
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("seq_len", SEQ)
    kw.setdefault("lr", 2e-3)
    kw.setdefault("warmup_steps", 2)
    kw.setdefault("log_every", 0)
    return (TC.TrainConfig if torch_side else JTrainConfig)(steps=steps, **kw)


def make_models(cfg=TINY8, seed=0):
    """(jax dbm, numpy param tree, torch dbm)."""
    db = JDBConfig(num_blocks=B, overlap_gamma=0.05)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        lay[ln]["g"] = (1.0 + 0.1 * rs.randn(*lay[ln]["g"].shape)
                        ).astype(np.float32)
    tdbm = TDBM(TC.ModelConfig(**dataclasses.asdict(cfg)),
                TC.DBConfig(**dataclasses.asdict(db)))
    return jdbm, tree, tdbm


@pytest.fixture(scope="module")
def models():
    return make_models()


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tdbm, tree):
    return params_from_jax(tree, "cpu", tdbm.model.spec)


def tokens_np(i=0, cfg=TINY8):
    return next(JMarkovLM(vocab_size=cfg.vocab_size, seed=7).stream(
        BATCH, SEQ, start_batch=i))


def block_draws(jdbm, key, b):
    """σ (Bsz,1,1) and ε (Bsz,S,d) as the JAX engine's ``block_loss`` draws
    them for block b from its key."""
    qr = jnp.asarray(JP.block_qranges(jdbm.db))
    r_sig, r_eps = jax.random.split(key)
    sigma = JE.sample_sigma_in_qrange(r_sig, (BATCH, 1, 1), jdbm.db,
                                      qr[b, 0], qr[b, 1])
    eps = jax.random.normal(r_eps, (BATCH, SEQ, jdbm.cfg.d_model),
                            jnp.float32)
    return (torch.from_numpy(np.array(sigma)),
            torch.from_numpy(np.array(eps)))


def jax_draws(jdbm, keys):
    return [block_draws(jdbm, keys[b], b) for b in range(len(keys))]


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def tree_close(got, want, atol=ATOL, rtol=RTOL):
    g = dict(TCK.ckpt._items(got))
    w = dict(JCK.ckpt._flatten(want))
    assert sorted(g) == sorted(w)
    for k in w:
        close(g[k], w[k], atol, rtol)


def clone(tree):
    return tree_map(lambda _, x: x.clone(), tree)


# ---------------------------------------------------------------------------
# the engine against JAX's round-robin engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_engine_step_matches_jax(models, policy):
    """One engine step per policy from shared params and draws: per-block
    losses and grad norms, the stacks, the periphery and both moment sets
    (and the step counters) within 1e-4 of JAX's."""
    jdbm, tree, tdbm = models
    tokens = tokens_np(1)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jtr = JTrainer(jdbm, tcfg(), periphery=policy, devices=jax.devices()[:1])
    assert jtr.mode == "round_robin"
    js, jl, jg = jtr.step(jtr.init_state(jparams(tree)), jnp.asarray(tokens),
                          keys)
    ttr = BlockParallelTrainer(tdbm, tcfg(torch_side=True), periphery=policy)
    params = tparams(tdbm, tree)
    ts, tl, tg = ttr.step(ttr.init_state(params), tokens,
                          draws=jax_draws(jdbm, keys))
    close(tl, jl)
    close(tg, jg)
    tree_close(ts.stacks, js.stacks)
    tree_close(ts.periph, js.periph)
    tree_close(ts.stack_opt, js.stack_opt)
    tree_close(ts.periph_opt, js.periph_opt)
    assert ts.stack_opt.step.tolist() == [1] * B
    # the stacks are views: the update landed in the masters
    full = ttr.full_params(ts)
    assert full["layers"]["attn"]["wq"].data_ptr() == \
        params["layers"]["attn"]["wq"].data_ptr()
    tree_close(full, jtr.full_params(js))


def test_owner_broadcast_rule(models):
    """owner-broadcast: the periphery update is exactly one AdamW step on
    the OWNER block's (clipped) periphery grads — bit for bit in the port
    (the non-owners add nothing), within 1e-4 of the same rule computed
    in JAX."""
    jdbm, tree, tdbm = models
    tokens = tokens_np(1)
    key = jax.random.PRNGKey(9)
    keys = jnp.stack([key] * B)
    cfg = tcfg(torch_side=True)
    ttr = BlockParallelTrainer(tdbm, cfg, periphery="owner-broadcast")
    s1, _, _ = ttr.step(ttr.init_state(tparams(tdbm, tree)), tokens,
                        draws=jax_draws(jdbm, keys))

    owner = B - 1
    sigma, eps = block_draws(jdbm, key, owner)
    ref = tparams(tdbm, tree)
    ref_tr = BlockParallelTrainer(tdbm, cfg)
    stacks = stack_block_views(ref, tdbm.ranges)
    _, periph = split_periphery(ref)
    _, grads, _ = ref_tr._block_grads(
        {k: tree_map(lambda _, x: x[owner], v) for k, v in stacks.items()},
        periph, owner, torch.from_numpy(tokens), None, (sigma, eps), 1.0)
    opt_init, opt_update = _split_optimizer(cfg)
    opt_update({k: grads[k] for k in periph}, opt_init(periph), periph)
    for (path, got), (_, want) in zip(tree_items(s1.periph),
                                      tree_items(periph)):
        assert torch.equal(got, want), path

    # the same rule in JAX (its own engine meets it to fp32 rounding)
    from repro.core.training import extract_block_view
    from repro.optim import clip_by_global_norm
    from repro.parallel.engine import _split_optimizer as j_split
    jp = jparams(tree)
    start, size = jdbm.ranges[owner]
    view = extract_block_view(jp, start, size)
    g = jax.grad(lambda v: jdbm.block_loss(
        v, owner, jnp.asarray(tokens), key, unit_range=(0, size))[0])(view)
    g, _ = clip_by_global_norm(g, cfg.grad_clip)
    jper = {k: v for k, v in jp.items() if k not in ("layers", "units")}
    o_init, o_upd = j_split(tcfg())
    upd, _, _ = o_upd({k: g[k] for k in jper}, o_init(jper), jper)
    tree_close(s1.periph, j_apply(jper, upd))


def test_freeze_after_warmup_stops_periphery(models):
    _, tree, tdbm = models
    tr = BlockParallelTrainer(tdbm, tcfg(torch_side=True),
                              periphery="freeze-after-warmup",
                              freeze_steps=1)
    state = tr.init_state(tparams(tdbm, tree))
    gen = torch.Generator().manual_seed(1)
    p0 = clone(state.periph)
    s1, _, _ = tr.step(state, tokens_np(0), gen)
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(s1.periph), tree_items(p0)))
    p1, st1 = clone(s1.periph), clone(s1.stacks)
    s2, _, _ = tr.step(s1, tokens_np(1), gen)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(s2.periph), tree_items(p1)))
    assert int(s2.periph_opt.step) == 1
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(s2.stacks), tree_items(st1)))


def test_periphery_lr_scale_compensates_update_cadence():
    """With ``lr_scale=B`` the periphery optimizer's first update is
    B * sched(B) / sched(1) times the unscaled one."""
    from repro_torch.optim import warmup_cosine
    cfg = tcfg(steps=32, torch_side=True)
    ups = []
    for scale in (1.0, float(B)):
        init, upd = _split_optimizer(cfg, lr_scale=scale)
        p = {"w": torch.zeros(4)}                # the update itself
        upd({"w": torch.full((4,), 0.5)}, init(p), p)
        ups.append(p["w"])
    sched = warmup_cosine(cfg.lr, cfg.warmup_steps, cfg.steps)
    close(ups[1] / ups[0], np.full(4, B * sched(B) / sched(1)), 0, 1e-5)
    tr = BlockParallelTrainer(make_models()[2], cfg,
                              periphery_lr_scale="auto")
    assert tr.periphery_lr_scale == float(B)


def test_stacked_views_round_trip(models):
    _, tree, tdbm = models
    params = tparams(tdbm, tree)
    before = clone(params)
    stacks, periph = stack_block_views(params, tdbm.ranges), \
        split_periphery(params)[1]
    wq = stacks["layers"]["attn"]["wq"]
    assert wq.shape[:2] == (B, 2) and \
        wq.data_ptr() == params["layers"]["attn"]["wq"].data_ptr()
    assert merge_params(params, stacks, periph, tdbm.ranges) is params
    for (path, a), (_, b) in zip(tree_items(params), tree_items(before)):
        assert torch.equal(a, b), path
    # a perturbed copy of one block's slice lands there and nowhere else
    victim = 2
    moved = {k: tree_map(lambda _, x: x.clone(), v) for k, v in
             stacks.items()}
    for _, x in tree_items(moved):
        x[victim] += 1.0
    merge_params(params, moved, periph, tdbm.ranges)
    for path, x in tree_items(params["layers"]):
        old = dict(tree_items(before["layers"]))[path]
        for b, (start, size) in enumerate(tdbm.ranges):
            want = old[start:start + size] + (1.0 if b == victim else 0.0)
            assert torch.equal(x[start:start + size], want), (path, b)
    view = block_view(stacks, periph, 1)
    assert view["embed"] is periph["embed"]
    assert view["layers"]["attn"]["wq"].shape[0] == 2


def test_unequal_blocks_and_devices_rejected():
    cfg = dataclasses.replace(TINY8, name="tiny6", n_layers=6)
    tdbm6 = TDBM(TC.ModelConfig(**dataclasses.asdict(cfg)),
                 TC.DBConfig(num_blocks=4))
    with pytest.raises(ValueError, match="equal-sized"):
        BlockParallelTrainer(tdbm6, tcfg(torch_side=True))
    # more than one device and no process group: the mesh runs one process
    # a device, so the refusal names the torchrun launch
    with pytest.raises(ValueError, match="torch.distributed.run "
                       "--nproc-per-node 2"):
        BlockParallelTrainer(make_models()[2], tcfg(torch_side=True),
                             devices=["cpu", "cpu"])


def test_grad_nan_skips_only_its_block(models):
    """A NaN loss_mult on one block: that block's stack, moments and step
    counter stay bit-unchanged, every other block's new state is bit-equal
    to the clean step's, and the periphery moves from the survivors (its
    mean renormalised by B/3, within 1e-4 of JAX's)."""
    jdbm, tree, tdbm = models
    victim = 1
    tokens = tokens_np(0)
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    draws = jax_draws(jdbm, keys)

    def run(mult):
        tr = BlockParallelTrainer(tdbm, tcfg(torch_side=True))
        state = tr.init_state(tparams(tdbm, tree))
        state, losses, _ = tr.step(state, tokens, draws=draws,
                                   loss_mult=mult)
        return tr, state, losses

    tr_c, clean, _ = run(None)
    mult = np.ones(B, np.float32)
    mult[victim] = np.nan
    tr_n, nand, losses = run(mult)
    assert not np.isfinite(float(losses[victim]))
    assert not tr_n.last_ok[victim] and tr_n.anomalies[victim] == 1
    assert all(tr_n.last_ok[b] for b in range(B) if b != victim)
    assert float(tr_n.guard_ewma[victim]) == -1.0
    tr0 = BlockParallelTrainer(tdbm, tcfg(torch_side=True))
    init = tr0.init_state(tparams(tdbm, tree))
    for b in range(B):
        s_n, o_n = tr_n.block_trees(nand, b)
        ref = tr0.block_trees(init, b) if b == victim \
            else tr_c.block_trees(clean, b)
        assert TCK.tree_digest(s_n) == TCK.tree_digest(ref[0]), b
        assert TCK.tree_digest(o_n) == TCK.tree_digest(ref[1]), b
        assert int(o_n.step) == (0 if b == victim else 1)

    jtr = JTrainer(jdbm, tcfg(), devices=jax.devices()[:1])
    js, _, _ = jtr.step(jtr.init_state(jparams(tree)), jnp.asarray(tokens),
                        keys, loss_mult=mult)
    tree_close(nand.periph, js.periph)
    tree_close(nand.stack_opt, js.stack_opt)


# ---------------------------------------------------------------------------
# the guard and the guarded DB step
# ---------------------------------------------------------------------------

GUARD_TABLE = [
    # (loss, gnorm, ewma, active)
    (2.0, 1.0, -1.0, True), (2.0, 1.0, 1.5, True), (30.0, 1.0, 1.5, True),
    (13.9, 1.0, 1.5, True), (14.1, 1.0, 1.5, True), (np.nan, 1.0, 1.5, True),
    (2.0, np.inf, 1.5, True), (2.0, 1.0, 1.5, False),
    (0.37, 0.2, 0.41, True), (5.0, 3.0, 0.0, True), (-np.inf, 1.0, 2.0, True),
    (3.3, 1.0, -1.0, False)]


@pytest.mark.parametrize("cfg", [dict(), dict(spike_factor=2.0, margin=0.5,
                                              ewma_decay=0.7)])
def test_guard_classify_matches_jax(cfg):
    jg, tg = JGuard(**cfg), TGuard(**cfg)
    for loss, gn, ew, act in GUARD_TABLE:
        jok, jew = jg.classify(jnp.float32(loss), jnp.float32(gn),
                               jnp.float32(ew), act)
        tok, tew = tg.classify(torch.tensor(loss, dtype=torch.float32),
                               torch.tensor(gn, dtype=torch.float32),
                               torch.tensor(ew, dtype=torch.float32), act)
        assert bool(tok) == bool(jok), (loss, gn, ew, act)
        assert np.float32(tew) == np.float32(jew) or (
            np.isnan(float(tew)) and np.isnan(float(jew))), (loss, ew)


def test_guarded_db_step_matches_jax_and_skips(models):
    jdbm, tree, tdbm = models
    tokens = tokens_np(0)
    rng = jax.random.PRNGKey(3)
    r_sig, r_eps = jax.random.split(rng)
    sigma = torch.from_numpy(np.array(jdbm.sample_block_sigma(
        r_sig, (BATCH, 1, 1), 0)))
    eps = torch.from_numpy(np.array(jax.random.normal(
        r_eps, (BATCH, SEQ, TINY8.d_model), jnp.float32)))
    j_init, j_step = j_make_db_step(jdbm, 0, tcfg(), guard=JGuard())
    jp = jparams(tree)
    jp1, jo1, je1, jl1, jm1 = j_step(jp, j_init(jp), jnp.float32(-1.0),
                                     jnp.asarray(tokens), rng)
    t_init, t_step = t_make_db_step(tdbm, 0, tcfg(torch_side=True),
                                    guard=TGuard())
    params = tparams(tdbm, tree)
    opt0 = t_init(params)
    p1, o1, e1, l1, m1 = t_step(params, opt0, -1.0, torch.from_numpy(tokens),
                                sigma=sigma, eps=eps)
    assert bool(m1["ok"]) and bool(jm1["ok"])
    close(l1, jl1)
    close(e1, je1)
    tree_close(p1, jp1)
    tree_close(o1, jo1)
    # NaN: params, moments, step counter and EWMA all untouched
    before = TCK.tree_digest(p1), TCK.tree_digest(o1)
    _, o2, e2, l2, m2 = t_step(p1, o1, e1, torch.from_numpy(tokens),
                               sigma=sigma, eps=eps, loss_mult=float("nan"))
    assert not bool(m2["ok"]) and not np.isfinite(float(l2))
    assert (TCK.tree_digest(p1), TCK.tree_digest(o2)) == before
    assert int(o2.step) == 1 and float(e2) == float(e1)


# ---------------------------------------------------------------------------
# fault injection, data
# ---------------------------------------------------------------------------

FAULT_SPECS = [
    {"grad_nan": {"p": 0.3}, "pod_die": {"p": 0.1, "start": 3}},
    {"alloc_exhaust": {"every": 3, "stop": 10}, "ckpt_corrupt": {"at": [2, 5]}},
    {"data_stall": {"p": 0.5, "sleep": 0.0}, "a": {"every": 1, "start": 2,
                                                     "stop": 4}}]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", range(len(FAULT_SPECS)))
def test_fault_injector_fires_as_jax(spec, seed):
    specs = FAULT_SPECS[spec]
    j, t = JFaults(specs, seed), TFaults(specs, seed)
    order = np.random.RandomState(spec).choice(sorted(specs) + ["nope"], 60)
    assert [j.fire(h) for h in order] == [t.fire(h) for h in order]
    assert j.stats() == t.stats()
    with pytest.raises(ValueError, match="exactly one"):
        TFaults({"x": {"p": 0.1, "every": 2}})
    assert make_injector(None) is None and make_injector({}) is None


def test_markov_stream_and_loader_cursors_match_jax():
    jlm, tlm = JMarkovLM(vocab_size=64, seed=7), TMarkovLM(vocab_size=64,
                                                            seed=7)
    js, ts = jlm.stream(4, 12, seed=3), tlm.stream(4, 12, seed=3)
    for _ in range(3):
        assert np.array_equal(next(js), next(ts))
    assert js.cursor() == ts.cursor()
    # a cursor written by either package resumes in the other, mid-epoch
    cur = json.loads(json.dumps(js.cursor()))
    assert np.array_equal(next(JStream.from_cursor(cur)),
                          next(TStream.from_cursor(cur)))
    assert np.array_equal(next(TStream.from_cursor(cur)), next(js))
    # the loader's cursor is the CONSUMER position, not the prefetch one
    jl = JLoader(jlm.stream(4, 12, seed=3), prefetch=3)
    tl = TLoader(tlm.stream(4, 12, seed=3), prefetch=3, device="cpu")
    try:
        for _ in range(2):
            a, b = next(jl), next(tl)
            assert isinstance(b, torch.Tensor) and b.dtype == torch.int64
            assert np.array_equal(np.asarray(a), b.numpy())
        assert jl.cursor() == tl.cursor()
        assert tl.cursor()["batches"] == 2
        resumed = TStream.from_cursor(tl.cursor())
        assert np.array_equal(next(resumed), next(tl).numpy())
    finally:
        jl.close()
        tl.close()
    # host slicing, batches of several arrays, no cursor
    h = TLoader(iter([(np.arange(8), np.ones((8, 2)))]), host_id=1,
                num_hosts=2)
    x, y = next(h)
    assert x.tolist() == [4, 5, 6, 7] and tuple(y.shape) == (4, 2)
    assert h.cursor() is None
    h.close()
    assert np.array_equal(j_arith(3, 9, 17, 5), t_arith(3, 9, 17, 5))
    for cls in ("ByteTokenizer", "Text8Tokenizer"):
        jt, tt = getattr(JTok, cls)(), getattr(TTok, cls)()
        s = "hello World 42"
        assert np.array_equal(jt.encode(s), tt.encode(s))
        assert jt.decode(jt.encode(s)) == tt.decode(tt.encode(s))


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def test_generation_loads_across_packages(models, tmp_path):
    """A generation written by ``repro.checkpoint`` loads in the port
    bit-equal (bf16 leaves included), and the other way round; manifests
    and checksums verify in both."""
    _, tree, tdbm = models
    params = tparams(tdbm, tree)
    opt = AdamWState(torch.tensor(3, dtype=torch.int32),
                     tree_map(lambda _, x: x * 0.5, params),
                     tree_map(lambda _, x: x * x, params))
    mixed = {"w": torch.randn(3, 5).to(torch.bfloat16),
             "n": [torch.arange(4, dtype=torch.int32)]}
    trees = {"params": params, "params.opt": opt, "mixed": mixed}
    tm = TCK.CheckpointManager(str(tmp_path / "t"), keep=2)
    g = tm.save(trees, {"it": 5})
    jm = JCK.CheckpointManager(str(tmp_path / "t"), keep=2)
    assert jm.verify(g) and jm.latest_good_generation() == g
    jt = jax.tree_util.tree_map(
        jnp.asarray, {"params": params_to_numpy(params),
                      "params.opt": _jax_opt(opt),
                      "mixed": {"w": np.zeros((3, 5), np.float32),
                                "n": [np.zeros(4, np.int32)]}})
    jt["mixed"]["w"] = jt["mixed"]["w"].astype(jnp.bfloat16)
    loaded, manifest = jm.load_latest(jt)
    assert manifest["state"] == {"it": 5}
    for name in trees:
        assert JCK.tree_digest(loaded[name]) == TCK.tree_digest(trees[name])
    # and back: JAX writes, the port loads
    g2 = jm.save(loaded, {"it": 6})
    back, m2 = tm.load_latest(
        {k: TCK.ckpt._rebuild(v, lambda _, x: torch.zeros_like(x))
         for k, v in trees.items()})
    assert m2["generation"] == g2 and m2["state"] == {"it": 6}
    for name in trees:
        assert TCK.tree_digest(back[name]) == TCK.tree_digest(trees[name])
    assert back["mixed"]["w"].dtype == torch.bfloat16


def _jax_opt(opt):
    from repro.optim.adamw import AdamWState as JState
    return JState(np.asarray(opt.step.numpy()), params_to_numpy(opt.mu),
                  params_to_numpy(opt.nu))


def test_flat_per_block_layout_across_packages(models, tmp_path):
    """``save_checkpoint``'s flat per-block layout (block_NN.npz,
    block_NN.opt.npz, periphery.opt.npz) written by JAX's engine restores
    bit-equal in the port's, and the other way round."""
    jdbm, tree, tdbm = models
    tokens = tokens_np(0)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jtr = JTrainer(jdbm, tcfg(), devices=jax.devices()[:1])
    js, _, _ = jtr.step(jtr.init_state(jparams(tree)), jnp.asarray(tokens),
                        keys)
    jtr.save_checkpoint(js, str(tmp_path / "j"), step=B)
    for b in range(B):
        assert (tmp_path / "j" / f"block_{b:02d}.opt.npz").exists()
    ttr = BlockParallelTrainer(tdbm, tcfg(torch_side=True))
    fresh = make_models(seed=99)
    ts = ttr.restore(tparams(tdbm, fresh[1]), str(tmp_path / "j"))
    assert TCK.tree_digest(ttr.full_params(ts)) == \
        JCK.tree_digest(jtr.full_params(js))
    assert TCK.tree_digest(ts.stack_opt) == JCK.tree_digest(js.stack_opt)
    assert TCK.tree_digest(ts.periph_opt) == JCK.tree_digest(js.periph_opt)
    meta = TCK.load_metadata(str(tmp_path / "j" / "block_01.npz"))
    assert meta == {"block": 1, "start": 2, "size": 2, "step": B}

    ts, _, _ = ttr.step(ts, tokens_np(1), torch.Generator().manual_seed(0))
    ttr.save_checkpoint(ts, str(tmp_path / "t"), step=2 * B)
    js2 = jtr.restore(jdbm.init(jax.random.PRNGKey(5)), str(tmp_path / "t"))
    assert JCK.tree_digest(jtr.full_params(js2)) == \
        TCK.tree_digest(ttr.full_params(ts))
    assert JCK.tree_digest(js2.stack_opt) == TCK.tree_digest(ts.stack_opt)
    assert JCK.tree_digest(js2.periph_opt) == TCK.tree_digest(ts.periph_opt)


def test_truncated_file_raises_and_manager_falls_back(tmp_path):
    w = {"w": torch.arange(8, dtype=torch.float32)}
    path = str(tmp_path / "flat" / "x.npz")
    TCK.save_pytree(path, w)
    assert not [f for f in os.listdir(tmp_path / "flat") if ".tmp" in f]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(TCK.CheckpointCorrupt, match="x.npz"):
        TCK.load_pytree(path, w)
    faults = TFaults({"ckpt_corrupt": {"at": [2]}}, seed=0)
    mgr = TCK.CheckpointManager(str(tmp_path / "m"), keep=3, faults=faults)
    g1 = mgr.save({"state": w}, {"it": 1})
    g2 = mgr.save({"state": {"w": w["w"] + 1}}, {"it": 2})   # torn
    assert mgr.verify(g1) and not mgr.verify(g2)
    logs = []
    trees, manifest = mgr.load_latest(
        {"state": {"w": torch.zeros(8)}}, log=logs.append)
    assert manifest["generation"] == g1 and manifest["state"]["it"] == 1
    assert torch.equal(trees["state"]["w"], w["w"])
    assert any("falling back" in s for s in logs)
    assert mgr.latest_good_generation() == g1
    for g in (3, 4):
        mgr.save({"state": w}, {"it": g})
    assert mgr.generations() == [2, 3, 4]       # pruned to keep=3
