"""PyTorch port: the ``TrainRunner`` supervisor against JAX's on the CPU, its
kill-then-resume parity, and the training CLI's supervised flags.

The models and draws are ``test_torch_parallel``'s (TINY8, 4 blocks, fp32).
JAX's runner splits its key once per batch (block-parallel: one key per
block) or once per step (db: the block and the block's key); its key at a
batch or step is a function of that index alone, restarts and resumes
included, so ``JaxRunnerDraws`` replays the chain and hands each index's
draws to the port's runner (``draws=``). Under the same fault spec the
counters, heartbeats and the history's block order are equal, and the
losses agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import (BATCH, SEQ, TINY8, jax_draws, jparams,
                                 make_models, tcfg, tparams, tree_close)

from repro import checkpoint as JCK
from repro.core.training import GuardConfig as JGuard
from repro.data import MarkovLM as JMarkovLM
from repro.data import MarkovStream as JStream
from repro.launch.faults import FaultInjector as JFaults
from repro.launch.trainrunner import TrainRunner as JRunner
from repro_torch import checkpoint as TCK
from repro_torch.core.training import GuardConfig as TGuard
from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
from repro_torch.launch import train as TLT
from repro_torch.launch.faults import FaultInjector as TFaults
from repro_torch.launch.trainrunner import TrainFailed, TrainRunner

torch.set_num_threads(1)
B = 4


@pytest.fixture(scope="module")
def models():
    return make_models()


class JaxRunnerDraws:
    """The draws JAX's ``TrainRunner`` makes from ``PRNGKey(seed)``, by
    batch (block-parallel) or step (db) index."""

    def __init__(self, jdbm, seed, n, mode):
        rng = jax.random.PRNGKey(seed)
        rng, _ = jax.random.split(rng)              # the runner's init key
        self.out = []
        for _ in range(n):
            if mode == "block-parallel":
                rng, rs = jax.random.split(rng)
                self.out.append(jax_draws(jdbm, jax.random.split(rs, B)))
            else:
                rng, rb, rs = jax.random.split(rng, 3)
                b = int(jax.random.randint(rb, (), 0, B))
                r_sig, r_eps = jax.random.split(rs)
                sigma = jdbm.sample_block_sigma(r_sig, (BATCH, 1, 1), b)
                eps = jax.random.normal(r_eps, (BATCH, SEQ, TINY8.d_model),
                                        jnp.float32)
                self.out.append((b, torch.from_numpy(np.array(sigma)),
                                 torch.from_numpy(np.array(eps))))

    def __call__(self, i):
        return self.out[i]


def j_data(cur):
    lm = JMarkovLM(vocab_size=TINY8.vocab_size, seed=7)
    return lm.stream(BATCH, SEQ) if cur is None else JStream.from_cursor(cur)


def t_data(cur):
    lm = MarkovLM(vocab_size=TINY8.vocab_size, seed=7)
    src = lm.stream(BATCH, SEQ) if cur is None else MarkovStream.from_cursor(
        cur)
    return HostDataLoader(src, device="cpu")


def both(models, tmp_path, mode, steps, *, spec=None, seed=0, train_kw=None,
         resume_after=None, **kw):
    """Run JAX's and the port's runner under the same fault spec (a fresh
    injector each) and return (jax runner, port runner, jax history, port
    history). ``resume_after``: a second runner on the same directory then
    resumes (no faults), and its history is returned instead."""
    jdbm, tree, tdbm = models
    n = steps if mode == "db" else -(-steps // B)
    draws = JaxRunnerDraws(jdbm, seed, n + 2, mode)
    out = []
    for side in ("jax", "torch"):
        d = tmp_path / side

        def runner(faults):
            common = dict(mode=mode, ckpt_dir=str(d), faults=faults,
                          log=lambda *a: None, **kw)
            if side == "jax":
                if "guard" in common:
                    common["guard"] = JGuard(**common["guard"])
                return JRunner(jdbm, tcfg(steps), devices=jax.devices()[:1],
                               **common)
            if "guard" in common:
                common["guard"] = TGuard(**common["guard"])
            return TrainRunner(tdbm, tcfg(steps, torch_side=True),
                               draws=draws, **common)

        faults = None if spec is None else (JFaults if side == "jax"
                                            else TFaults)(spec, seed=0)
        r = runner(faults)
        if side == "jax":
            _, hist = r.train(j_data, jax.random.PRNGKey(seed),
                              params=jparams(tree), **(train_kw or {}))
        else:
            _, hist = r.train(t_data, torch.Generator().manual_seed(seed),
                              params=tparams(tdbm, tree), **(train_kw or {}))
        if resume_after is not None:
            r = runner(None)
            if side == "jax":
                _, hist = r.train(j_data, jax.random.PRNGKey(seed),
                                  params=jparams(tree), resume=True)
            else:
                _, hist = r.train(t_data, torch.Generator().manual_seed(seed),
                                  params=tparams(tdbm, tree), resume=True)
        out.append((r, hist))
    (jr, jh), (tr, th) = out
    assert tr.counters == jr.counters
    assert tr.heartbeats == jr.heartbeats
    assert [(i, b) for i, b, _ in th] == [(i, b) for i, b, _ in jh]
    np.testing.assert_allclose([x for _, _, x in th], [x for _, _, x in jh],
                               atol=1e-4, rtol=1e-4)
    return jr, tr, jh, th


def test_streak_rewind_matches_jax(models, tmp_path):
    """grad_nan pinned to block 1 for two consecutive batches with
    rewind_after=2: block 1 alone goes back to generation 1 (its initial
    state, bit for bit), the others keep training, as in JAX."""
    victim = 1
    jr, tr, _, _ = both(models, tmp_path, "block-parallel", 4 * B,
                        spec={"grad_nan": {"at": [3, 4], "block": victim}},
                        guard={"rewind_after": 2}, ckpt_every=100)
    assert tr.counters["rewinds"] == 1 and tr.counters["nan_injected"] == 2
    mgr = TCK.CheckpointManager(str(tmp_path / "torch"))
    gen = mgr.latest_good_generation()
    s, o = tr.trainer.block_trees(tr.state, victim)
    assert TCK.tree_digest(s) == TCK.tree_digest(
        mgr.load_tree(gen, f"block_{victim:02d}", s))
    assert int(o.step) == 0
    tree_close(tr.trainer.full_params(tr.state),
               jr.trainer.full_params(jr.state))
    tree_close(tr.state.stack_opt, jr.state.stack_opt)


def test_pod_death_readoption_matches_jax(models, tmp_path):
    jr, tr, _, th = both(models, tmp_path, "block-parallel", 5 * B,
                         spec={"pod_die": {"at": [3]}}, ckpt_every=2,
                         pod_restart_after=2)
    c = tr.counters
    assert (c["pod_deaths"], c["degraded_batches"], c["readoptions"]) == \
        (1, 2, 1)
    assert np.isfinite([x for _, _, x in th]).all()
    assert all(tr.heartbeats[b] == 4 for b in range(B))
    assert tr.state.stack_opt.step.tolist() == \
        [int(s) for s in np.asarray(jr.state.stack_opt.step)]
    tree_close(tr.trainer.full_params(tr.state),
               jr.trainer.full_params(jr.state))
    tree_close(tr.state.periph_opt, jr.state.periph_opt)


def test_db_bounded_restart_matches_jax(models, tmp_path):
    _, tr, _, th = both(models, tmp_path, "db", 8,
                        spec={"pod_die": {"at": [5]}}, ckpt_every=3,
                        max_restarts=2)
    assert tr.counters["restarts"] == 1 and len(th) == 8 + 1
    _, _, tdbm = models
    r = TrainRunner(tdbm, tcfg(8, torch_side=True), mode="db",
                    ckpt_dir=str(tmp_path / "x"), ckpt_every=3,
                    faults=TFaults({"pod_die": {"every": 2}}, seed=0),
                    max_restarts=2, log=lambda *a: None)
    with pytest.raises(TrainFailed, match="budget"):
        r.train(t_data, torch.Generator().manual_seed(0))


def test_resume_past_corrupted_generation_matches_jax(models, tmp_path):
    """db mode: the generation written at it=6 is torn; the run halts at
    it=7; a resume falls back to it=3's generation and completes — the same
    replay as JAX's."""
    _, tr, _, th = both(models, tmp_path, "db", 8,
                        spec={"ckpt_corrupt": {"at": [3]}}, ckpt_every=3,
                        train_kw={"halt_after": 7}, resume_after=True)
    assert [i for i, _, _ in th] == list(range(3, 8))
    mgr = TCK.CheckpointManager(str(tmp_path / "torch"))
    assert all(mgr.verify(g) for g in mgr.generations()[-2:])


@pytest.mark.parametrize("mode", ["block-parallel", "db"])
def test_kill_then_resume_is_bit_identical(models, tmp_path, mode):
    """A run killed after batch/step 2 (no final checkpoint) and resumed
    from its checkpoints ends bit-equal to the uninterrupted run: params,
    moments, step counters, guard state and the replayed history. The draws
    come from the generator, whose state the manifest carries."""
    _, tree, tdbm = models
    steps = 4 * B if mode == "block-parallel" else 7

    def run(d, faults=True, **kw):
        r = TrainRunner(tdbm, tcfg(steps, torch_side=True), mode=mode,
                        ckpt_dir=str(d), ckpt_every=2, log=lambda *a: None,
                        faults=TFaults({"grad_nan": {"at": [1]}}) if faults
                        else None)
        params = tparams(tdbm, tree)
        _, hist = r.train(t_data, torch.Generator().manual_seed(4),
                          params=params, **kw)
        return r, params, hist

    r_clean, p_clean, h_clean = run(tmp_path / "clean")
    run(tmp_path / "kill", halt_after=3)
    r_res, p_res, h_res = run(tmp_path / "kill", faults=False, resume=True)
    assert TCK.tree_digest(p_clean) == TCK.tree_digest(p_res)
    if mode == "block-parallel":
        for part in ("stack_opt", "periph_opt"):
            assert TCK.tree_digest(getattr(r_clean.state, part)) == \
                TCK.tree_digest(getattr(r_res.state, part))
        assert r_clean.trainer.guard_state() == r_res.trainer.guard_state()
        assert h_res == h_clean[2 * B:]
    else:
        assert TCK.tree_digest(r_clean.opt_states) == \
            TCK.tree_digest(r_res.opt_states)
        assert r_clean.ewma == r_res.ewma
        assert h_res == h_clean[2:]
    assert r_clean.heartbeats == r_res.heartbeats


def test_parallel_generation_loads_in_jax(models, tmp_path):
    """The port's block-parallel generation (per-block stacks and moments,
    the periphery and its moments) loads in JAX's runner layout bit-equal,
    and its manifest carries JAX's state keys. The rng words are the
    port's generator state, which JAX does not read."""
    jdbm, tree, tdbm = models
    r = TrainRunner(tdbm, tcfg(2 * B, torch_side=True),
                    mode="block-parallel", ckpt_dir=str(tmp_path),
                    ckpt_every=1, log=lambda *a: None,
                    draws=JaxRunnerDraws(jdbm, 0, 2, "block-parallel"))
    r.train(t_data, torch.Generator().manual_seed(0),
            params=tparams(tdbm, tree), halt_after=1)
    from repro.parallel import BlockParallelTrainer as JTrainer
    jr = JRunner(jdbm, tcfg(2 * B), mode="block-parallel",
                 devices=jax.devices()[:1], log=lambda *a: None)
    jt = JTrainer(jdbm, tcfg(2 * B), devices=jax.devices()[:1])
    trees, manifest = JCK.CheckpointManager(str(tmp_path)).load_latest(
        jr._parallel_trees(jt, jt.init_state(jparams(tree))))
    st = manifest["state"]
    assert sorted(st) == sorted(["mode", "engine", "policy", "batch", "it",
                                 "rng", "data_cursor", "guard",
                                 "heartbeats", "counters"])
    assert (st["batch"], st["it"], st["engine"]) == (1, B, "round_robin")
    assert st["data_cursor"]["batches"] == 1
    for b in range(B):
        s, o = r.trainer.block_trees(r.state, b)
        assert JCK.tree_digest(trees[f"block_{b:02d}"]) == \
            TCK.tree_digest(s)
        assert JCK.tree_digest(trees[f"block_{b:02d}.opt"]) == \
            TCK.tree_digest(o)
    assert JCK.tree_digest(trees["periphery"]) == \
        TCK.tree_digest(r.state.periph)
    assert JCK.tree_digest(trees["periphery.opt"]) == \
        TCK.tree_digest(r.state.periph_opt)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_supervised_flags(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--block-parallel", "--supervise",
            "--ckpt-dir", ck, "--faults", '{"grad_nan": {"at": [2]}}',
            "--steps", "8", "--batch", "2", "--seq", "8"]
    TLT.main(base + ["--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "mode=block-parallel" in out and "done" in out
    assert '"nan_injected": 1' in out
    gens = TCK.CheckpointManager(ck).generations()
    assert len(gens) == 3                      # 1 + batches 2 and 4
    TLT.main(base + ["--resume"])
    out = capsys.readouterr().out
    assert f"resumed generation {gens[-1]} at batch 4" in out
    # db mode under the supervisor: pod_die is a restart
    TLT.main(["--device", "cpu", "--faults", '{"pod_die": {"at": [3]}}',
              "--ckpt-dir", str(tmp_path / "db"), "--ckpt-every", "2",
              "--steps", "4", "--batch", "2", "--seq", "8"])
    assert '"restarts": 1' in capsys.readouterr().out
    # plain runs save per-block checkpoints at the end
    for extra in (["--block-parallel"], []):
        d = tmp_path / f"plain{len(extra)}"
        TLT.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "8", "--ckpt-dir", str(d)] + extra)
        assert (d / "block_01.npz").exists()
    assert (tmp_path / "plain1" / "periphery.opt.npz").exists()
    with pytest.raises(SystemExit, match="--supervise covers"):
        TLT.main(["--device", "cpu", "--supervise", "--mode", "e2e"])


def test_train_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        TLT.main(["--block-parallel", "--supervise", "--ckpt-dir",
                  str(tmp_path), "--steps", "8"])
