"""One rank of a pod-per-block mesh, for the tests that spawn them
(``tests/test_torch_block_mesh.py`` on the CPU, ``tests/test_torch_gpu.py``
on the card). It imports torch and ``repro_torch`` only, so that a spawned
rank never imports JAX.

    python tests/torch_mesh_worker.py RANK WORLD STORE JOB OUT

The ranks meet on the ``file://`` store STORE (no TCP port) with a 60 s
timeout on every collective. JOB is a file the test wrote with
``torch.save``: ``device``, ``backend`` and ``tasks``, a list of (name,
task) run in order. Each rank writes ``OUT/rank{RANK}.pt``: {name: the
task's result}. A task is

  ``steps``   a ``BlockParallelTrainer`` over the model ``task["model"]``
              (ModelConfig and DBConfig fields, and a numpy params tree),
              then engine steps; after each, this rank's periphery digest
              and the whole state gathered from the owners;
  ``runner``  a ``TrainRunner`` under the mesh (its kwargs, fault spec,
              draws by batch or a seeded generator, ``halt_after``,
              ``resume``): its history, counters, heartbeats, guard state
              and the final state gathered.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import checkpoint as TCK  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.blocks import DiffusionBlocksModel  # noqa: E402
from repro_torch.core.training import GuardConfig  # noqa: E402
from repro_torch.data import (HostDataLoader, MarkovLM,  # noqa: E402
                              MarkovStream)
from repro_torch.launch.faults import FaultInjector  # noqa: E402
from repro_torch.launch.trainrunner import TrainRunner  # noqa: E402
from repro_torch.nn.init import tree_items, tree_map  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.parallel import BlockParallelTrainer  # noqa: E402
from repro_torch.parallel import dist as D  # noqa: E402

TIMEOUT_S = 60


def build(model: dict, device):
    dbm = DiffusionBlocksModel(TC.ModelConfig(**model["cfg"]),
                               TC.DBConfig(**model["db"]))
    return dbm, params_from_jax(model["params"], device, dbm.model.spec)


def gather(tr: BlockParallelTrainer, state) -> dict:
    """The whole state on every rank, cloned: params, the blocks' moments
    and step counters stacked (B, ...), the periphery's AdamW state."""
    opts = [tr.block_trees(state, b)[1] for b in range(tr.B)]

    def stacked(part):
        return tree_map(lambda path, _: torch.stack([
            dict(tree_items(getattr(o, part)))[path] for o in opts]).cpu(),
            getattr(opts[0], part))
    return {"params": tree_map(lambda _, x: x.detach().cpu().clone(),
                               tr.full_params(state)),
            "stack_opt": AdamWState(torch.stack([o.step for o in opts]),
                                    stacked("mu"), stacked("nu")),
            "periph_opt": AdamWState(*[
                tree_map(lambda _, x: x.cpu().clone(), t)
                for t in state.periph_opt])}


def digest(tree) -> str:
    return TCK.tree_digest(tree)


def run_steps(task: dict, device) -> dict:
    dbm, params = build(task["model"], device)
    tr = BlockParallelTrainer(dbm, TC.TrainConfig(**task["tcfg"]),
                              periphery=task["policy"],
                              precision=task.get("precision"),
                              impl=task.get("impl", "kernels"))
    if tr.mode != "shard_map":
        raise RuntimeError(f"engine mode {tr.mode}")
    state = tr.init_state(params)
    del params
    out = {"mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.mesh.shape)),
           "mesh_device": tr.mesh.device_type, "blocks": tr.blocks,
           "steps": []}
    for st in task["steps"]:
        draws = [tuple(torch.as_tensor(x, device=device) for x in d)
                 for d in st["draws"]]
        state, losses, gnorms = tr.step(
            state, torch.as_tensor(st["tokens"]), draws=draws,
            loss_mult=st.get("loss_mult"), active=st.get("active"),
            update_periphery=st.get("update_periphery", True))
        out["steps"].append({
            "losses": losses.clone(), "gnorms": gnorms.clone(),
            "last_ok": tr.last_ok.copy(), "anomalies": tr.anomalies.copy(),
            "ewma": tr.guard_ewma.clone(),
            "periph_digest": digest(state.periph),
            "periph_opt_digest": digest(state.periph_opt),
            **gather(tr, state)})
    return out


def run_runner(task: dict, device) -> dict:
    dbm, params = build(task["model"], device)
    kw = dict(task["kwargs"])
    if "guard" in kw:
        kw["guard"] = GuardConfig(**kw["guard"])
    draws = task.get("draws")
    if draws is not None:
        draws = [[tuple(torch.as_tensor(x) for x in d) for d in bt]
                 for bt in draws]
    faults = task.get("faults")
    r = TrainRunner(dbm, TC.TrainConfig(**task["tcfg"]),
                    mode="block-parallel",
                    faults=FaultInjector(faults, seed=0) if faults else None,
                    draws=None if draws is None else draws.__getitem__,
                    log=lambda *a: None, **kw)
    batch, seq, vocab = task["data"]

    def make_data(cur):
        src = (MarkovLM(vocab_size=vocab, seed=7).stream(batch, seq)
               if cur is None else MarkovStream.from_cursor(cur))
        return HostDataLoader(src, device=device)

    gen = torch.Generator(device=device).manual_seed(task.get("seed", 0))
    _, hist = r.train(make_data, gen, params=params,
                      halt_after=task.get("halt_after"),
                      resume=task.get("resume", False))
    if r.trainer.mode != "shard_map":
        raise RuntimeError(f"engine mode {r.trainer.mode}")
    return {"history": hist, "counters": dict(r.counters),
            "heartbeats": dict(r.heartbeats),
            "guard": r.trainer.guard_state(),
            "periph_digest": digest(r.state.periph),
            **gather(r.trainer, r.state)}


TASKS = {"steps": run_steps, "runner": run_runner}


def main(rank: int, world: int, store: str, job_path: str, out: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    device = torch.device(job.get("device", "cpu"))
    D.init(device, job.get("backend", "gloo"), init_method=f"file://{store}",
           rank=rank, world_size=world, timeout_s=TIMEOUT_S)
    try:
        res = {name: TASKS[task["kind"]](task, device)
               for name, task in job["tasks"]}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(job: dict, tmp, world: int = 4, timeout_s: float = 240.0,
          meanwhile=None) -> list:
    """Run ``job`` on ``world`` ranks (subprocesses of this interpreter) and
    return each rank's results; any rank's failure, or the whole group
    outliving ``timeout_s``, kills every rank and raises. ``meanwhile()``,
    if given, runs in this process while the ranks work."""
    import subprocess
    import time
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(job, tmp / "job.pt")
    store = tmp / "store"
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(store),
         str(tmp / "job.pt"), str(tmp)], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        if meanwhile is not None:
            meanwhile()
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            r = failed[0]
            raise RuntimeError(
                f"ranks {failed} failed; rank {r} exited "
                f"{procs[r].returncode}:\n"
                f"{(tmp / f'rank{r}.log').read_text()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
