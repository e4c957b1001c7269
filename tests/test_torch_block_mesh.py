"""PyTorch port: the pod-per-block engine (``BlockParallelTrainer`` in its
``shard_map`` mode) over a (pod, data) mesh of 4 gloo ranks on the CPU,
against the JAX package; the runner under the mesh; the training CLI under
``torch.distributed.run``; and the hybrid under the round-robin engine.

TINY8 (8 layers, d 64, 4 heads, vocab 64), fp32, the JAX init bridged to
torch (``test_torch_parallel``'s models). The ranks are subprocesses that
import no JAX (``tests/torch_mesh_worker.py``); they meet on a ``file://``
store under the test's temporary directory, with a 60 s timeout on every
collective, and one spawned group runs every mesh check of this file (the
fixture ``ranks``): 4 blocks make a (4, 1) mesh, 2 blocks a (2, 2) one.

Held within 1e-4 (atol and rtol): the (4, 1) mesh's step per policy
against JAX's round-robin engine, and the (2, 2) mesh's against JAX's
``shard_map`` engine on 4 host devices (a subprocess: the only check of the
``data`` mean), both from JAX's draws; the runner under the mesh against
JAX's through a pod death with orphan passes and re-adoption and a
streak rewind. Against the port's own round-robin engine within 1e-6 (the
periphery mean's summation order is the only difference): a NaN block, an
inactive block and a frozen periphery, the victims bit-unchanged. Exact:
the periphery's digest on every rank after every step, counters,
heartbeats, a killed and resumed mesh run against an uninterrupted one,
and a mesh generation read by JAX's ``CheckpointManager``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import (BATCH, POLICIES, SEQ, TINY8, close,
                                 jax_draws, jparams, make_models, tcfg,
                                 tparams, tree_close)
from test_torch_trainrunner import JaxRunnerDraws
from torch_mesh_worker import spawn

from repro import checkpoint as JCK
from repro.configs import DBConfig as JDBConfig
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import edm as JE
from repro.core import partition as JP
from repro.data import MarkovLM as JMarkovLM
from repro.launch.trainrunner import TrainRunner as JRunner
from repro.parallel import BlockParallelTrainer as JTrainer
from repro_torch import checkpoint as TCK
from repro_torch import configs as TC
from repro_torch.core import partition as TP
from repro_torch.launch import train as TLT
from repro_torch.nn.init import tree_items
from repro_torch.optim import warmup_cosine
from repro_torch.parallel import BlockParallelTrainer
from repro_torch.sharding import check_world

torch.set_num_threads(1)
B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the runner's fault spec: block 0's pod dies in batch 1 and is re-adopted
# in batch 3 (orphan passes in batches 1 and 2), and block 2's loss is NaN
# in batches 3 and 4, which rewinds it (rewind_after 2)
RUNNER_SPEC = {"pod_die": {"at": [2]}, "grad_nan": {"at": [4, 5], "block": 2}}
RUNNER_BATCHES = 6


def _model(tree, blocks=B):
    return {"cfg": dataclasses.asdict(TINY8), "params": tree,
            "db": dataclasses.asdict(JDBConfig(num_blocks=blocks,
                                               overlap_gamma=0.05))}


def _np(draws):
    return [tuple(x.numpy() for x in d) for d in draws]


def data_draws(jdbm, keys, data):
    """Each block's full-batch (σ, ε) as JAX's shard_map engine draws them:
    data shard d from ``fold_in(key_b, d)`` over its rows."""
    qr = jnp.asarray(JP.block_qranges(jdbm.db))
    n = BATCH // data
    out = []
    for b, key in enumerate(keys):
        sig, eps = [], []
        for d in range(data):
            r_sig, r_eps = jax.random.split(jax.random.fold_in(key, d))
            sig.append(np.array(JE.sample_sigma_in_qrange(
                r_sig, (n, 1, 1), jdbm.db, qr[b, 0], qr[b, 1])))
            eps.append(np.array(jax.random.normal(
                r_eps, (n, SEQ, jdbm.cfg.d_model), jnp.float32)))
        out.append((np.concatenate(sig), np.concatenate(eps)))
    return out


JAX_SUBPROCESS = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import DBConfig
    from repro.configs.base import ModelConfig, TrainConfig
    from repro.core import DiffusionBlocksModel
    from repro.core.training import GuardConfig
    from repro.data import MarkovLM, MarkovStream
    from repro.launch.faults import FaultInjector
    from repro.launch.trainrunner import TrainRunner
    from repro.parallel import BlockParallelTrainer
    inp = pickle.load(open(sys.argv[1], "rb"))
    cfg = ModelConfig(**inp["cfg"])
    params = lambda: jax.tree_util.tree_map(jnp.asarray, inp["params"])
    dbm = DiffusionBlocksModel(cfg, DBConfig(**inp["db"]))
    tr = BlockParallelTrainer(dbm, TrainConfig(**inp["tcfg"]),
                              devices=jax.devices()[:4])
    assert tr.mode == "shard_map", tr.mode
    s, l, g = tr.step(tr.init_state(params()), jnp.asarray(inp["tokens"]),
                      jnp.asarray(inp["keys"]))
    arrays = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    out = dict(mesh=dict(tr.mesh.shape), **arrays(dict(
        losses=l, gnorms=g, params=tr.full_params(s), stack_opt=s.stack_opt,
        periph_opt=s.periph_opt)))
    # the round-robin runner under the fault spec, on one device
    ri = inp["runner"]
    rdbm = DiffusionBlocksModel(cfg, DBConfig(**ri["db"]))
    jr = TrainRunner(rdbm, TrainConfig(**ri["tcfg"]), mode="block-parallel",
                     devices=jax.devices()[:1], ckpt_dir=ri["ckpt_dir"],
                     ckpt_every=2, pod_restart_after=2,
                     guard=GuardConfig(rewind_after=2), log=lambda *a: None,
                     faults=FaultInjector(ri["spec"], seed=0))
    batch, seq = ri["data"]
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    data = (lambda cur: lm.stream(batch, seq) if cur is None
            else MarkovStream.from_cursor(cur))
    _, hist = jr.train(data, jax.random.PRNGKey(0), params=params())
    out["runner"] = dict(
        history=[(int(i), int(b), float(x)) for i, b, x in hist],
        counters=dict(jr.counters), heartbeats=dict(jr.heartbeats),
        streak=[int(x) for x in jr.trainer.anomaly_streak],
        **arrays(dict(params=jr.trainer.full_params(jr.state),
                      stack_opt=jr.state.stack_opt,
                      periph_opt=jr.state.periph_opt)))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def models():
    return make_models()


def mesh_jobs(jdbm, jdbm2, tree, tmp, tokens, keys, keys2):
    """The ranks' jobs, each with JAX's draws, and their inputs."""
    tc = dataclasses.asdict(tcfg(torch_side=True))
    lm = JMarkovLM(vocab_size=TINY8.vocab_size, seed=7)
    inp = {"tokens": tokens, "keys": keys, "draws": jax_draws(jdbm, keys)}
    tasks = [(f"policy {p}", {"kind": "steps", "model": _model(tree),
                              "tcfg": tc, "policy": p,
                              "steps": [{"tokens": tokens,
                                         "draws": _np(inp["draws"])}]})
             for p in POLICIES]

    inp["draws2"] = data_draws(jdbm2, keys2, data=2)
    tasks.append(("data mean", {
        "kind": "steps", "model": _model(tree, 2), "tcfg": tc,
        "policy": POLICIES[0],
        "steps": [{"tokens": tokens, "draws": inp["draws2"]}]}))

    # the guard, an inactive block and a frozen periphery, each one step
    # from the shared params
    inp["guard_steps"] = []
    for i, kw in enumerate(({"loss_mult": [1, 1, np.nan, 1]},
                            {"active": [1, 0, 1, 1]},
                            {"update_periphery": False})):
        ks = jax.random.split(jax.random.PRNGKey(20 + i), B)
        inp["guard_steps"].append(dict(
            tokens=np.asarray(next(lm.stream(BATCH, SEQ,
                                             start_batch=2 + i))),
            draws=_np(jax_draws(jdbm, ks)), **kw))
        tasks.append((f"guard {i}", {"kind": "steps", "model": _model(tree),
                                     "tcfg": tc, "policy": POLICIES[0],
                                     "steps": inp["guard_steps"][-1:]}))

    # the runner: faults against JAX's runner (JAX's draws by batch), and a
    # kill and resume against an uninterrupted run (a seeded generator)
    steps = RUNNER_BATCHES * B
    inp["runner_draws"] = JaxRunnerDraws(jdbm, 0, RUNNER_BATCHES + 1,
                                         "block-parallel")
    runner = {"kind": "runner", "model": _model(tree),
              "tcfg": dataclasses.asdict(tcfg(steps, torch_side=True)),
              "data": (BATCH, SEQ, TINY8.vocab_size)}
    tasks.append(("faults", {**runner, "faults": RUNNER_SPEC,
                             "draws": [_np(d) for d in
                                       inp["runner_draws"].out],
                             "kwargs": dict(
                                 ckpt_dir=str(tmp / "faults"), ckpt_every=2,
                                 pod_restart_after=2,
                                 guard={"rewind_after": 2})}))
    kr = {**runner, "tcfg": dataclasses.asdict(tcfg(4 * B,
                                                    torch_side=True)),
          "faults": {"grad_nan": {"at": [1]}}, "seed": 4}
    for name, d, extra in (("clean", "clean", {}),
                           ("killed", "kill", {"halt_after": 3}),
                           ("resumed", "kill", {"resume": True,
                                                "faults": None})):
        tasks.append((name, {**kr, **extra, "kwargs": dict(
            ckpt_dir=str(tmp / d), ckpt_every=2)}))
    return inp, tasks


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """One group of 4 ranks runs every mesh job; beside it, one subprocess
    with 4 host devices runs JAX's (2, 2) shard_map step and JAX's
    round-robin runner, and this process JAX's round-robin step per
    policy. Returns (the jobs' inputs and the policy references, each
    rank's results, the subprocess's results)."""
    jdbm, tree, _ = models
    tmp = tmp_path_factory.mktemp("mesh")
    tokens = np.asarray(next(JMarkovLM(vocab_size=TINY8.vocab_size,
                                       seed=7).stream(BATCH, SEQ,
                                                      start_batch=1)))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    # the (2, 2) mesh: 2 blocks of 4 layers, each data shard's own draws
    jdbm2 = JDBM(TINY8, JDBConfig(num_blocks=2, overlap_gamma=0.05))
    keys2 = jax.random.split(jax.random.PRNGKey(11), 2)
    # JAX's subprocess first: it is the longest of the three streams
    jin = {"cfg": dataclasses.asdict(TINY8), "params": tree,
           "db": dataclasses.asdict(jdbm2.db),
           "tcfg": dataclasses.asdict(tcfg()), "tokens": tokens,
           "keys": np.asarray(keys2),
           "runner": {"db": dataclasses.asdict(jdbm.db),
                      "tcfg": dataclasses.asdict(tcfg(RUNNER_BATCHES * B)),
                      "spec": RUNNER_SPEC, "data": (BATCH, SEQ),
                      "ckpt_dir": str(tmp / "jax")}}
    with open(tmp / "jax_in.pkl", "wb") as f:
        pickle.dump(jin, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SUBPROCESS, str(tmp / "jax_in.pkl"),
         str(tmp / "jax_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        inp, tasks = mesh_jobs(jdbm, jdbm2, tree, tmp, tokens, keys, keys2)
        jref = {}

        def jax_round_robin():
            """JAX's round-robin step per policy, while the ranks work."""
            for p in POLICIES:
                jtr = JTrainer(jdbm, tcfg(), periphery=p,
                               devices=jax.devices()[:1])
                jref[p] = (jtr, *jtr.step(jtr.init_state(jparams(tree)),
                                          jnp.asarray(tokens), keys))

        res = spawn({"device": "cpu", "backend": "gloo", "tasks": tasks},
                    tmp / "ranks", meanwhile=jax_round_robin)
        log, _ = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log[-4000:]
    with open(tmp / "jax_out.pkl", "rb") as f:
        jout = pickle.load(f)
    inp["tmp"], inp["jax"] = tmp, jref
    return inp, res, jout


def state_close(got, js, jtr, atol=1e-4, rtol=1e-4):
    """A rank's gathered state against a JAX engine state."""
    tree_close(got["params"], jtr.full_params(js), atol, rtol)
    tree_close(got["stack_opt"], js.stack_opt, atol, rtol)
    tree_close(got["periph_opt"], js.periph_opt, atol, rtol)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_mesh_step_matches_jax_round_robin(ranks, policy):
    """A (4, 1) mesh, one step per policy from shared params and JAX's
    draws: losses, grad norms, stacks, periphery, both moment sets and step
    counters within 1e-4 of JAX's round-robin engine, on every rank."""
    inp, res, _ = ranks
    jtr, js, jl, jg = inp["jax"][policy]
    for r, out in enumerate(res):
        got = out[f"policy {policy}"]
        assert got["mesh"] == {"pod": B, "data": 1}
        assert got["mesh_device"] == "cpu"     # the device the group got
        assert got["blocks"] == (r,)
        step = got["steps"][0]
        close(step["losses"], jl)
        close(step["gnorms"], jg)
        state_close(step, js, jtr)
        assert step["stack_opt"].step.tolist() == [1] * B


def test_data_mean_matches_jax_shard_map(ranks):
    """A (2, 2) mesh (2 blocks, 2 data shards each): each data shard's
    draws from ``fold_in(key_b, d)``; the grads and loss averaged over the
    data group match JAX's ``shard_map`` engine on 4 host devices within
    1e-4."""
    _, res, jout = ranks
    assert jout["mesh"] == {"pod": 2, "data": 2}
    for r, out in enumerate(res):
        got = out["data mean"]
        assert got["mesh"] == {"pod": 2, "data": 2}
        assert got["blocks"] == (r // 2,)
        step = got["steps"][0]
        close(step["losses"], jout["losses"])
        close(step["gnorms"], jout["gnorms"])
        tree_close(step["params"], jout["params"])
        tree_close(step["stack_opt"], jout["stack_opt"])
        tree_close(step["periph_opt"], jout["periph_opt"])


def test_periphery_bit_equal_on_every_rank(ranks):
    """After every step of every job the periphery and its AdamW state have
    one digest on all 4 ranks, and so do the gathered states."""
    _, res, _ = ranks
    for name, got in res[0].items():
        steps = got["steps"] if "steps" in got else [got]
        for i, step in enumerate(steps):
            for r in range(1, len(res)):
                other = res[r][name]
                other = other["steps"][i] if "steps" in other else other
                assert other["periph_digest"] == step["periph_digest"], \
                    (name, i, r)
                for part in ("params", "stack_opt", "periph_opt"):
                    assert TCK.tree_digest(other[part]) == \
                        TCK.tree_digest(step[part]), (name, i, r, part)


def test_guard_inactive_and_frozen_match_round_robin(models, ranks):
    """One step each from the shared params, with a NaN loss on block 2,
    with block 1 inactive, and with ``update_periphery=False``, against the
    port's round-robin engine from the same draws: the skipped block's
    stack, moments and counter bit-unchanged, the frozen periphery
    bit-unchanged, every other block's stack and moments bit-equal to the
    round robin's, and the rest within 1e-6 (the periphery mean's
    summation order)."""
    _, tree, tdbm = models
    inp, res, _ = ranks
    for i, st in enumerate(inp["guard_steps"]):
        skipped = {0: 2, 1: 1}.get(i)
        tr = BlockParallelTrainer(tdbm, tcfg(torch_side=True))
        state = tr.init_state(tparams(tdbm, tree))
        before = {"params": clone(tr.full_params(state)),
                  "stack_opt": clone(state.stack_opt),
                  "periph_opt": clone(state.periph_opt)}
        kw = {k: st[k] for k in ("loss_mult", "active", "update_periphery")
              if k in st}
        state, losses, gnorms = tr.step(
            state, st["tokens"], draws=[tuple(map(torch.from_numpy, d))
                                        for d in st["draws"]], **kw)
        g = res[0][f"guard {i}"]["steps"][0]
        # an inactive block did not fail: only the NaN block is not ok
        assert g["last_ok"].tolist() == tr.last_ok.tolist() == \
            [k != skipped or i != 0 for k in range(B)]
        np.testing.assert_array_equal(g["anomalies"], tr.anomalies)
        close(g["losses"], losses, 1e-6, 1e-6)
        close(g["gnorms"], gnorms, 1e-6, 1e-6)
        close(g["ewma"], tr.guard_ewma, 1e-6, 1e-6)
        tree_close(g["params"], tr.full_params(state), 1e-6, 1e-6)
        tree_close(g["stack_opt"], state.stack_opt, 1e-6, 1e-6)
        tree_close(g["periph_opt"], state.periph_opt, 1e-6, 1e-6)
        assert TCK.tree_digest(g["params"]["layers"]) == \
            TCK.tree_digest(tr.full_params(state)["layers"])
        for part in ("mu", "nu"):
            assert TCK.tree_digest(getattr(g["stack_opt"], part)) == \
                TCK.tree_digest(getattr(state.stack_opt, part))
        u = tr.u
        for (path, a), (_, b) in zip(tree_items(g["params"]["layers"]),
                                     tree_items(before["params"]["layers"])):
            assert [torch.equal(a[k * u:(k + 1) * u], b[k * u:(k + 1) * u])
                    for k in range(B)] == [k == skipped for k in range(B)]
        for part in ("mu", "nu"):
            for (_, a), (_, b) in zip(
                    tree_items(getattr(g["stack_opt"], part)),
                    tree_items(getattr(before["stack_opt"], part))):
                assert [torch.equal(a[k], b[k]) for k in range(B)] == \
                    [k == skipped for k in range(B)]
        assert g["stack_opt"].step.tolist() == \
            [int(k != skipped) for k in range(B)]
        frozen = i == 2
        assert (TCK.tree_digest(_periph(g["params"]))
                == TCK.tree_digest(_periph(before["params"]))) == frozen
        assert int(g["periph_opt"].step) == int(not frozen)


def clone(tree):
    return TCK.ckpt._rebuild(tree, lambda _, x: x.detach().clone())


def _periph(params):
    return {k: v for k, v in params.items() if k not in ("layers", "units")}


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_runner_faults_match_jax(ranks):
    """``RUNNER_SPEC`` under the mesh against JAX's round-robin runner from
    the same draws: a pod death with orphan passes on rank 0 and a
    re-adoption, a streak rewind; counters and heartbeats exact, the
    history's losses, the params and every moment within 1e-4."""
    _, res, jout = ranks
    jr = jout["runner"]
    c = jr["counters"]
    assert (c["pod_deaths"], c["degraded_batches"], c["readoptions"],
            c["rewinds"], c["nan_injected"]) == (1, 2, 1, 1, 2)
    for out in res:
        got = out["faults"]
        assert got["counters"] == jr["counters"]
        assert got["heartbeats"] == jr["heartbeats"]
        assert [(i, b) for i, b, _ in got["history"]] == \
            [(i, b) for i, b, _ in jr["history"]]
        np.testing.assert_allclose([x for _, _, x in got["history"]],
                                   [x for _, _, x in jr["history"]],
                                   atol=1e-4, rtol=1e-4)
        assert got["guard"]["streak"] == jr["streak"]
        assert got["stack_opt"].step.tolist() == \
            jr["stack_opt"].step.tolist()
        for part in ("params", "stack_opt", "periph_opt"):
            tree_close(got[part], jr[part])


def test_runner_kill_then_resume_is_bit_identical(ranks):
    """A mesh run killed after batch 3 (no final checkpoint) and resumed
    ends bit-equal to the uninterrupted mesh run: params, every moment and
    step counter, guard state, heartbeats and the replayed history. The
    draws come from each rank's generator replica."""
    _, res, _ = ranks
    for out in res:
        clean, resumed = out["clean"], out["resumed"]
        for part in ("params", "stack_opt", "periph_opt"):
            assert TCK.tree_digest(clean[part]) == \
                TCK.tree_digest(resumed[part]), part
        assert clean["guard"] == resumed["guard"]
        assert clean["heartbeats"] == resumed["heartbeats"]
        assert resumed["history"] == clean["history"][2 * B:]
        # batch 1's NaN block compares as its string
        assert repr(out["killed"]["history"]) == \
            repr(clean["history"][:3 * B])


def test_mesh_generation_loads_in_jax(models, ranks):
    """The faults run's last generation, written by rank 0 from blocks
    broadcast by their owners, loads in JAX's ``CheckpointManager``
    bit-equal to the mesh's final state."""
    jdbm, tree, _ = models
    inp, res, _ = ranks
    got = res[0]["faults"]
    jr = JRunner(jdbm, tcfg(2 * B), mode="block-parallel",
                 devices=jax.devices()[:1], log=lambda *a: None)
    jt = JTrainer(jdbm, tcfg(2 * B), devices=jax.devices()[:1])
    trees, manifest = JCK.CheckpointManager(
        str(inp["tmp"] / "faults")).load_latest(
        jr._parallel_trees(jt, jt.init_state(jparams(tree))))
    st = manifest["state"]
    assert (st["engine"], st["batch"]) == ("shard_map", RUNNER_BATCHES)
    u = 8 // B
    from repro_torch.optim import AdamWState
    for b in range(B):
        stack = {"layers": {k: _slice(v, b, u) for k, v in
                            got["params"]["layers"].items()}}
        assert JCK.tree_digest(trees[f"block_{b:02d}"]) == \
            TCK.tree_digest(stack)
        so = got["stack_opt"]
        opt = AdamWState(so.step[b], _index(so.mu, b), _index(so.nu, b))
        assert JCK.tree_digest(trees[f"block_{b:02d}.opt"]) == \
            TCK.tree_digest(opt)
    assert JCK.tree_digest(trees["periphery"]) == \
        TCK.tree_digest(_periph(got["params"]))
    assert JCK.tree_digest(trees["periphery.opt"]) == \
        TCK.tree_digest(got["periph_opt"])


def _slice(tree, b, u):
    if isinstance(tree, dict):
        return {k: _slice(v, b, u) for k, v in tree.items()}
    return tree[b * u:(b + 1) * u]


def _index(tree, b):
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


# ---------------------------------------------------------------------------
# the CLI, the refusals, the q-ranges
# ---------------------------------------------------------------------------

def test_cli_under_torchrun(tmp_path):
    """``launch.train --block-parallel --supervise`` on 4 gloo ranks under
    ``torch.distributed.run``: rank 0 prints the mesh (reduced stablelm has
    2 blocks: 2 pods of 2 data shards) and the supervisor's counters, the
    generations are written, and every rank ends with 0."""
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--dist-backend", "gloo", "--block-parallel",
         "--supervise", "--ckpt-dir", str(ck), "--ckpt-every", "2",
         "--faults", '{"grad_nan": {"at": [2]}}', "--steps", "8",
         "--batch", "4", "--seq", "8"],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "block-parallel mode=shard_map mesh={'pod': 2, 'data': 2}" \
        in out.stdout
    assert out.stdout.count("done") == 1
    assert '"nan_injected": 1' in out.stdout
    assert len(TCK.CheckpointManager(str(ck)).generations()) == 3


@pytest.mark.parametrize("world", [2, 6])
def test_world_size_refused(world):
    """W = 2 < B = 4 and W = 6 (not a multiple of 4) are refused with both
    numbers: idle ranks would hide a misconfigured launch."""
    with pytest.raises(ValueError, match=f"over {world} processes needs a "
                       f"multiple of the 4 blocks"):
        check_world(4, world)
    assert check_world(4, 8) == 2


def test_cli_refuses_a_world_the_blocks_do_not_divide(monkeypatch):
    """Under torchrun the CLI refuses before it joins a process group."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="over 3 processes needs a multiple "
                       "of the 2 blocks"):
        TLT.main(["--device", "cpu", "--block-parallel", "--steps", "2"])
    with pytest.raises(SystemExit, match="only --block-parallel"):
        TLT.main(["--device", "cpu", "--steps", "2"])


def test_block_qranges_match_jax(models):
    jdbm, _, tdbm = models
    for db in (jdbm.db, dataclasses.replace(jdbm.db, num_blocks=7,
                                            overlap_gamma=0.0)):
        got = TP.block_qranges(TC.DBConfig(**dataclasses.asdict(db)))
        want = JP.block_qranges(db)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the hybrid under the round-robin engine
# ---------------------------------------------------------------------------

def test_hybrid_round_robin_matches_jax():
    """``reduced(zamba2-7b)`` (2 units in 2 blocks) through the round-robin
    engine, one step against JAX's round-robin engine from JAX's draws:
    losses, grad norms, params and both moment sets within 1e-4."""
    from test_torch_hybrid import REDUCED, hybrid_models
    jdbm, jp, tdbm, tp = hybrid_models(REDUCED)
    tokens = np.asarray(next(JMarkovLM(vocab_size=REDUCED.vocab_size,
                                       seed=7).stream(2, 16)))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jtr = JTrainer(jdbm, tcfg(batch_size=2, seq_len=16),
                   devices=jax.devices()[:1])
    js, jl, jg = jtr.step(jtr.init_state(jp), jnp.asarray(tokens), keys)
    qr = jnp.asarray(JP.block_qranges(jdbm.db))
    draws = []
    for b in range(2):
        r_sig, r_eps = jax.random.split(keys[b])
        draws.append((torch.from_numpy(np.array(JE.sample_sigma_in_qrange(
            r_sig, (2, 1, 1), jdbm.db, qr[b, 0], qr[b, 1]))),
            torch.from_numpy(np.array(jax.random.normal(
                r_eps, (2, 16, REDUCED.d_model), jnp.float32)))))
    tr = BlockParallelTrainer(tdbm, tcfg(batch_size=2, seq_len=16,
                                         torch_side=True))
    jp1 = dict(tree_items(jax.tree_util.tree_map(np.asarray, jp)))
    ts, tl, tg = tr.step(tr.init_state(tp), tokens, draws=draws)
    close(tl, jl)
    close(tg, jg)
    tree_close(ts.stack_opt, js.stack_opt)
    tree_close(ts.periph_opt, js.periph_opt)
    # the params within 1e-4 but where the grad g is below 1e-7 and not 0:
    # the first update lr g / (|g| + eps), eps 1e-8, turns an fp32 rounding
    # gap of 1e-9 in g into up to lr there, so those elements are held to
    # the update's form on each side (tests/test_torch_xlstm_train.py's
    # ``_step_close``): at most lr, with the sign of that side's own g
    cfg = tcfg()
    lr = warmup_cosine(cfg.lr, cfg.warmup_steps, cfg.steps)(1)
    b1, wd = cfg.b1, cfg.weight_decay

    def grads(stack_mu, periph_mu):
        return {**dict(tree_items({k: jax.tree_util.tree_map(
            lambda x: np.asarray(x).reshape(-1, *np.shape(x)[2:]), v)
            for k, v in stack_mu.items()})), **dict(tree_items(
                jax.tree_util.tree_map(np.asarray, periph_mu)))}
    jg_all = grads(js.stack_opt.mu, js.periph_opt.mu)
    tg_all = grads(ts.stack_opt.mu, ts.periph_opt.mu)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                  jtr.full_params(js))))
    n_loose = 0
    for path, x in tree_items(tr.full_params(ts)):
        got, g = x.detach().numpy(), jg_all[path] / (1 - b1)
        loose = (g != 0) & (np.abs(g) < 1e-7)
        n_loose += int(loose.sum())
        close(got[~loose], want[path][~loose])
        for p2, gs in ((got, tg_all[path] / (1 - b1)), (want[path], g)):
            u = (jp1[path] * (1 - lr * wd) - p2)[loose]
            assert (np.abs(u) <= lr * (1 + 1e-3)).all(), path
            assert ((np.sign(u) == np.sign(gs[loose]))
                    | (np.abs(u) <= 1e-6)).all(), path
    assert n_loose <= 1e-2 * sum(v.size for v in want.values())
