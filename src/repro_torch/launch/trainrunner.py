"""Fault-tolerant supervised training loop (port of
``repro.launch.trainrunner``).

``TrainRunner`` wraps the block-cycling sequential trainer (``mode="db"``)
and the block-parallel engine (``mode="block-parallel"``, round-robin on one
device) in one supervision loop that owns

  * crash-consistent CHECKPOINTS — a ``repro_torch.checkpoint
    .CheckpointManager`` generation every ``ckpt_every`` batches (parallel) /
    steps (db), whose manifest carries the step, the generator state, the
    data-loader cursor, the guard counters and heartbeats, and the periphery
    policy, so ``resume=True`` continues BIT-IDENTICALLY to an uninterrupted
    run (same params, same optimizer moments and step counters, same
    batches, same draws);
  * per-block ANOMALY REWIND — when a block's guard streak reaches
    ``GuardConfig.rewind_after`` consecutive anomalies, ONLY that block's
    params + optimizer moments are restored from the last good generation
    (the shared periphery and every other block are untouched — the paper's
    §3 independence result as a fault boundary);
  * HEARTBEATS — per-block last-clean-update markers (batch index), the
    signal that distinguishes "one block is being skipped every step" from
    "training is healthy";
  * FAULT INJECTION — a shared ``repro_torch.launch.faults.FaultInjector``
    consulted at the training hook points (``pod_die``, ``grad_nan``,
    ``data_stall``; ``ckpt_corrupt`` fires inside the manager).

Pod death semantics differ by mode, as in JAX:

  block-parallel   the victim block's pod (and the device copy of its state)
                   is lost: the block rewinds to its last checkpoint
                   generation and DEGRADES to the orphan path — each batch
                   runs one engine pass for the survivors plus one orphan
                   pass (``update_periphery=False``, so the survivors' pass
                   stays the single periphery writer). A round-robin engine
                   IS the orphan path. Under the mesh (``shard_map``) rank
                   0 holds a one-device round-robin sibling with the
                   orphan's state: it runs the orphan's pass on the full
                   batch after the survivors' mesh step and broadcasts the
                   guard outcome; the dead pod's ranks run nothing for it.
                   When the pod revives after ``pod_restart_after`` batches
                   the block is re-adopted (under the mesh rank 0
                   broadcasts its stack, moments and step counter to the
                   pod's ranks).
  db               there is no pod to lose a block to — ``pod_die`` is
                   simulated PROCESS death: the runner restarts from the
                   latest good generation (bounded by ``max_restarts``,
                   then ``TrainFailed``).

``halt_after`` stops the run abruptly at a batch/step index WITHOUT a final
checkpoint — kill semantics. Work since the last cadence checkpoint is lost
and deterministically replayed on ``resume=True``.

The random draws come from the ``torch.Generator`` passed to ``train``
(its state is in every manifest), or, with ``draws``, from a function of the
batch index (block-parallel: ``draws(bt) -> [(sigma, eps)] * B``) or step
index (db: ``draws(it) -> (block, sigma, eps)``), so that tests can feed
another package's draws. Degraded, the survivors' draws come first, then
the orphans'.

Under the mesh every rank runs this loop in step: rank 0 gathers each
generation (every block broadcast from its owner into host tensors) and
writes it while the others wait; a resume reads the latest generation on
every rank, each taking its own block and the periphery; the generator
states, replicas seeded alike, are checked equal on every rank at each save
and resume.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, copy_into,
                                    rng_from_json, rng_to_json)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.core.training import (STACK_KEYS, GuardConfig, _tokens,
                                       extract_block_view, make_db_train_step)
from repro_torch.launch.faults import PodDied
from repro_torch.nn.init import tree_items, tree_map
from repro_torch.optim import AdamWState
from repro_torch.parallel import dist as D
from repro_torch.parallel.engine import BlockParallelTrainer
from repro_torch.parallel.state import BlockParallelState


class TrainFailed(RuntimeError):
    """The supervisor exhausted its restart budget, or had no checkpoint to
    restart/resume from."""


def _bname(b: int) -> str:
    return f"block_{b:02d}"


def _device(state: BlockParallelState) -> torch.device:
    return next(iter(tree_items(state.periph)))[1].device


class TrainRunner:
    """Supervised training driver; see module docstring.

    ``make_data`` (passed to :meth:`train`) is ``cursor -> iterator``: called
    with ``None`` for a fresh stream and with a manifest cursor on resume /
    restart (``repro_torch.data.MarkovStream.from_cursor``, wrapped in a
    ``HostDataLoader``, is the canonical implementation). ``ckpt_every``
    counts batches in block-parallel mode and steps in db mode.
    """

    def __init__(self, dbm: DiffusionBlocksModel, tcfg: TrainConfig,
                 mode: str = "db", *, periphery: str = "replicate+psum-mean",
                 impl: str = "kernels", precision=None,
                 periphery_lr_scale=None,
                 guard: Optional[GuardConfig] = None, devices=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 5,
                 keep: int = 3, faults=None, max_restarts: int = 3,
                 pod_restart_after: int = 2, draws: Optional[Callable] = None,
                 log: Callable = print):
        if mode not in ("db", "block-parallel"):
            raise ValueError(f"unknown TrainRunner mode {mode!r}")
        self.dbm, self.tcfg, self.mode = dbm, tcfg, mode
        self.periphery, self.impl, self.precision = periphery, impl, precision
        self.periphery_lr_scale = periphery_lr_scale
        self.guard = GuardConfig() if guard is None else guard
        self.devices = devices
        self.ckpt_every = max(1, int(ckpt_every))
        self.faults = faults
        self.max_restarts = int(max_restarts)
        self.pod_restart_after = int(pod_restart_after)
        self.draws = draws
        self.log = log
        self.manager = (CheckpointManager(ckpt_dir, keep=keep, faults=faults)
                        if ckpt_dir else None)
        self.counters = {"pod_deaths": 0, "readoptions": 0, "rewinds": 0,
                         "restarts": 0, "data_stalls": 0, "nan_injected": 0,
                         "degraded_batches": 0, "ckpt_saves": 0}
        self.heartbeats: Dict[int, int] = {}
        # handles populated by train() for tests and the chip smoke run
        self.trainer: Optional[BlockParallelTrainer] = None
        self.state: Optional[BlockParallelState] = None
        # rank 0 under the mesh: orphaned block -> (sibling, its state)
        self._orphans: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    def train(self, make_data: Callable, generator: torch.Generator,
              params=None, resume: bool = False,
              halt_after: Optional[int] = None):
        """Run to ``tcfg.steps`` (or ``halt_after``); returns
        ``(params, history)`` with the same history convention as
        ``train_db`` / ``BlockParallelTrainer.train``. ``params`` (made from
        ``generator`` when None) is trained in place."""
        if resume and self.manager is None:
            raise TrainFailed("resume=True requires a ckpt_dir")
        if params is None:
            params = self.dbm.init(generator)
        if self.mode == "block-parallel":
            return self._train_parallel(make_data, generator, params, resume,
                                        halt_after)
        return self._train_db(make_data, generator, params, resume,
                              halt_after)

    def stats(self) -> dict:
        out = {"counters": dict(self.counters),
               "heartbeats": {str(k): int(v)
                              for k, v in sorted(self.heartbeats.items())}}
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out

    # ------------------------------------------------------------------
    def _maybe_stall(self) -> None:
        """``data_stall`` hook around the data fetch (counted)."""
        f = self.faults
        if f is None:
            return
        before = f.fired.get("data_stall", 0)
        f.maybe_sleep("data_stall")
        if f.fired.get("data_stall", 0) > before:
            self.counters["data_stalls"] += 1

    @staticmethod
    def _cursor(data):
        return data.cursor() if hasattr(data, "cursor") else None

    def _heartbeats_json(self) -> dict:
        return {str(k): int(v) for k, v in self.heartbeats.items()}

    # ==================================================================
    # block-parallel mode
    # ==================================================================
    @staticmethod
    def _local_trees(trainer: BlockParallelTrainer, state):
        """name -> live tree of the blocks this process holds and the
        periphery: resume templates (and, round robin, a generation)."""
        trees = {}
        for b in trainer.blocks:
            s, o = trainer.local_trees(state, b)
            trees[_bname(b)] = s
            trees[_bname(b) + ".opt"] = o
        trees["periphery"] = state.periph
        trees["periphery.opt"] = state.periph_opt
        return trees

    @staticmethod
    def _parallel_trees(trainer: BlockParallelTrainer, state):
        """A generation's trees. Under the mesh a collective: each block is
        broadcast from its owner and moved to rank 0's host as it arrives;
        the other ranks get {}."""
        if trainer.mesh is None:
            return TrainRunner._local_trees(trainer, state)
        trees = {}
        for b in range(trainer.B):
            s, o = trainer.block_trees(state, b)
            if trainer.rank == 0:
                trees[_bname(b)] = tree_map(lambda _, x: x.cpu(), s)
                trees[_bname(b) + ".opt"] = AdamWState(*[
                    tree_map(lambda _, x: x.cpu(), t) for t in o])
        if trainer.rank == 0:
            trees["periphery"] = state.periph
            trees["periphery.opt"] = state.periph_opt
        return trees

    @staticmethod
    def _same_generator(trainer, generator, what: str) -> None:
        if trainer.mesh is not None:
            D.check_same(generator.get_state(), f"the generator state {what}")

    def _save_parallel(self, trainer, state, bt, it, generator, data) -> None:
        st = {"mode": "block-parallel", "engine": trainer.mode,
              "policy": trainer.policy, "batch": int(bt), "it": int(it),
              "rng": rng_to_json(generator),
              "data_cursor": self._cursor(data),
              "guard": trainer.guard_state(),
              "heartbeats": self._heartbeats_json(),
              "counters": dict(self.counters)}
        self._same_generator(trainer, generator, f"at batch {bt}")
        trees = self._parallel_trees(trainer, state)
        if trainer.rank == 0:
            gen = self.manager.save(trees, st)
            self.log(f"[runner] checkpoint generation {gen} at batch {bt}")
        del trees
        if trainer.mesh is not None:
            D.barrier()
        self.counters["ckpt_saves"] += 1

    def _rewind_block(self, trainer, state, b: int, why: str):
        """Restore ONE block's stack + optimizer moments from the latest good
        generation (periphery and other blocks untouched): on the ranks
        that hold it, or on rank 0's sibling while it is orphaned."""
        gen = self.manager.latest_good_generation() if self.manager else None
        if gen is None:
            trainer.anomaly_streak[b] = 0
            self.log(f"[runner] {why}; no checkpoint generation to rewind "
                     f"block {b} — keeping current state")
            return state
        holder, hstate = self._orphans.get(b, (trainer, state))
        if holder.holds(b):
            stack_t, opt_t = holder.local_trees(hstate, b)
            holder.write_block(
                hstate, b,
                self.manager.load_tree(gen, _bname(b), stack_t, "cpu"),
                self.manager.load_tree(gen, _bname(b) + ".opt", opt_t, "cpu"))
        trainer.anomaly_streak[b] = 0
        trainer.guard_ewma[b] = -1.0
        self.log(f"[runner] {why}; block {b} rewound to generation {gen}")
        return state

    def _orphan(self, trainer, state, v: int) -> None:
        """Under the mesh, rank 0 takes orphaned block ``v`` (just rewound)
        into a one-device round-robin sibling that holds it alone."""
        if trainer.mesh is None:
            return
        stack, opt = trainer.block_trees(state, v)
        if trainer.rank != 0:
            return
        sib = BlockParallelTrainer(
            self.dbm, self.tcfg, periphery=self.periphery, impl=self.impl,
            precision=self.precision,
            periphery_lr_scale=self.periphery_lr_scale, guard=self.guard,
            devices=[_device(state)], blocks=(v,))

        def one(_, x):
            return x.unsqueeze(0).clone()
        self._orphans[v] = (sib, BlockParallelState(
            tree_map(one, stack), state.periph,
            AdamWState(opt.step.reshape(1).clone(), tree_map(one, opt.mu),
                       tree_map(one, opt.nu)), state.periph_opt))
        self.log(f"[runner] rank 0 carries orphaned block {v}")

    def _readopt(self, trainer, state, v: int) -> None:
        """Under the mesh, rank 0 broadcasts its sibling's stack, moments and
        step counter of block ``v`` back to pod ``v``'s ranks."""
        if trainer.mesh is None:
            return
        trees = None
        if trainer.rank == 0:
            sib, sstate = self._orphans.pop(v)
            trees = sib.local_trees(sstate, v)
        got = trainer.broadcast_block(state, v, trees, 0)
        if trainer.rank == 0 and trainer.holds(v):
            copy_into(trainer.local_trees(state, v), got)

    def _orphan_pass(self, trainer, state, tokens, generator, m, kw):
        """The orphans' pass (after the survivors' step): (state, losses
        (B,), last_ok (B,)) for the orphaned blocks ``m``, their guard
        state merged into ``trainer``."""
        if trainer.mesh is None:
            state, l2, _ = trainer.step(state, tokens, generator, active=m,
                                        update_periphery=False, **kw)
            return state, l2, trainer.last_ok.copy()
        B = trainer.B
        l2 = torch.full((B,), float("nan"))
        ok = np.zeros(B, bool)
        tokens = _tokens(tokens, _device(state))
        for v in np.nonzero(m)[0].tolist():
            draws = kw["draws"]
            if draws is None:         # every rank draws: generators in step
                draws = [None] * B
                draws[v] = trainer.dbm.draw_block(generator, tokens, v)
            out = torch.zeros(6, dtype=torch.float64)
            if trainer.rank == 0:
                sib, sstate = self._orphans[v]
                sib.guard_ewma = trainer.guard_ewma.clone()
                sib.anomaly_streak = trainer.anomaly_streak.copy()
                sib.anomalies = trainer.anomalies.copy()
                act = np.zeros(B, bool)
                act[v] = True
                sstate, lv, gv = sib.step(sstate, tokens, draws=draws,
                                          loss_mult=kw["loss_mult"],
                                          active=act, update_periphery=False)
                self._orphans[v] = (sib, sstate)
                out[:] = torch.tensor([
                    float(lv[v]), float(gv[v]), float(sib.last_ok[v]),
                    float(sib.guard_ewma[v]), float(sib.anomaly_streak[v]),
                    float(sib.anomalies[v])], dtype=torch.float64)
            D.broadcast(out, 0)
            l2[v], ok[v] = out[0], bool(out[2])
            trainer.guard_ewma[v] = float(out[3])
            trainer.anomaly_streak[v] = int(out[4])
            trainer.anomalies[v] = int(out[5])
        return state, l2, ok

    def _pick_victim(self, B: int, dead) -> Optional[int]:
        start = self.counters["pod_deaths"] % B
        for d in range(B):
            v = (start + d) % B
            if v not in dead:
                return v
        return None

    def _train_parallel(self, make_data, generator, params, resume,
                        halt_after):
        tcfg = self.tcfg
        trainer = BlockParallelTrainer(
            self.dbm, tcfg, periphery=self.periphery, impl=self.impl,
            precision=self.precision,
            periphery_lr_scale=self.periphery_lr_scale, guard=self.guard,
            devices=self.devices)
        B = trainer.B
        state = trainer.init_state(params)
        self._orphans = {}
        start_batch, it, data = 0, 0, None
        if resume:
            live = self._local_trees(trainer, state)
            trees, manifest = self.manager.load_latest(live, log=self.log,
                                                       device="cpu")
            if trees is None:
                raise TrainFailed("resume=True but no loadable generation in "
                                  f"{self.manager.ckpt_dir!r}")
            for name, tree in trees.items():
                copy_into(live[name], tree)
            st = manifest["state"]
            start_batch, it = int(st["batch"]), int(st["it"])
            rng_from_json(generator, st["rng"])
            self._same_generator(trainer, generator, "on resume")
            trainer.set_guard_state(st.get("guard"))
            self.heartbeats = {int(k): int(v)
                               for k, v in st.get("heartbeats", {}).items()}
            if st.get("data_cursor") is not None:
                data = make_data(st["data_cursor"])
            self.log(f"[runner] resumed generation {manifest['generation']} "
                     f"at batch {start_batch}")
        if data is None:
            data = make_data(None)
        if self.manager is not None and not self.manager.generations():
            # generation 0-equivalent: the rewind target before the first
            # cadence checkpoint exists
            self._save_parallel(trainer, state, start_batch, it, generator,
                                data)
        dead_until: Dict[int, int] = {}
        history = []
        batches = math.ceil(tcfg.steps / B)
        bt = start_batch
        while bt < batches:
            # -- pod lifecycle ------------------------------------------
            for b in [b for b, until in sorted(dead_until.items())
                      if bt >= until]:
                del dead_until[b]
                self._readopt(trainer, state, b)
                self.counters["readoptions"] += 1
                self.log(f"[runner] pod {b} recovered at batch {bt}; block "
                         f"re-adopted")
            if self.faults is not None and self.faults.fire("pod_die"):
                v = self._pick_victim(B, dead_until)
                if v is not None:
                    self.counters["pod_deaths"] += 1
                    dead_until[v] = bt + self.pod_restart_after
                    state = self._rewind_block(
                        trainer, state, v,
                        f"pod {v} died at batch {bt} (device state lost)")
                    self._orphan(trainer, state, v)
            # -- fault hooks + data -------------------------------------
            loss_mult = None
            if self.faults is not None and self.faults.fire("grad_nan"):
                # victim: pinned via {"block": b} in the spec, else rotate
                v = self.faults.specs["grad_nan"].get(
                    "block", (self.faults.fired["grad_nan"] - 1) % B)
                loss_mult = np.ones(B, np.float32)
                loss_mult[v] = np.nan
                self.counters["nan_injected"] += 1
                self.log(f"[runner] injected NaN loss for block {v} at "
                         f"batch {bt}")
            self._maybe_stall()
            tokens = next(data)
            draws = None if self.draws is None else self.draws(bt)
            kw = dict(draws=draws, loss_mult=loss_mult)
            # -- advance ------------------------------------------------
            if dead_until:
                m = np.zeros(B, bool)
                m[sorted(dead_until)] = True
                state, losses, _ = trainer.step(
                    state, tokens, generator, active=~m, **kw)
                ok_main = trainer.last_ok.copy()
                # the orphan pass, with the periphery left to the
                # survivors' pass
                state, l2, ok_orphan = self._orphan_pass(
                    trainer, state, tokens, generator, m, kw)
                trainer.last_ok = np.where(m, ok_orphan, ok_main)
                losses = torch.where(torch.from_numpy(m), l2, losses)
                self.counters["degraded_batches"] += 1
            else:
                state, losses, _ = trainer.step(state, tokens, generator,
                                                **kw)
            for b in range(B):
                if trainer.last_ok[b]:
                    self.heartbeats[b] = bt
                if it < tcfg.steps:
                    history.append((it, b, float(losses[b])))
                it += 1
            # -- guard rewind -------------------------------------------
            for b in np.nonzero(
                    trainer.anomaly_streak >= self.guard.rewind_after)[0]:
                state = self._rewind_block(
                    trainer, state, int(b),
                    f"block {int(b)} hit {int(trainer.anomaly_streak[b])} "
                    f"consecutive anomalies")
                self.counters["rewinds"] += 1
            bt += 1
            if tcfg.log_every and (bt - 1) % tcfg.log_every == 0:
                self.log(f"[runner/{trainer.mode}] batch={bt - 1} "
                         f"loss={float(losses.mean()):.4f} "
                         f"dead={sorted(dead_until)}")
            if self.manager is not None and (bt % self.ckpt_every == 0
                                             or bt == batches):
                self._save_parallel(trainer, state, bt, it, generator, data)
            if halt_after is not None and bt >= halt_after:
                self.log(f"[runner] halting at batch {bt} (halt_after; no "
                         f"checkpoint — kill semantics)")
                break
        if hasattr(data, "close"):
            data.close()
        self.trainer, self.state = trainer, state
        return trainer.full_params(state), history

    # ==================================================================
    # db (sequential block-cycling) mode
    # ==================================================================
    def _db_templates(self, params, opts):
        trees = {}
        for b, (start, size) in enumerate(self.dbm.ranges):
            trees[_bname(b)] = extract_block_view(params, start, size)
            trees[_bname(b) + ".opt"] = opts[b]
        return trees

    def _save_db(self, params, opts, it, generator, data, ewma, streak,
                 anomalies) -> None:
        st = {"mode": "db", "it": int(it), "rng": rng_to_json(generator),
              "data_cursor": self._cursor(data),
              "guard": {"ewma": [float(e) for e in ewma],
                        "streak": [int(s) for s in streak],
                        "anomalies": [int(a) for a in anomalies]},
              "heartbeats": self._heartbeats_json(),
              "counters": dict(self.counters)}
        gen = self.manager.save(self._db_templates(params, opts), st)
        self.counters["ckpt_saves"] += 1
        self.log(f"[runner] checkpoint generation {gen} at it={it}")

    def _load_db(self, params, opts):
        """Copy the latest good generation into ``params`` and ``opts`` in
        place; its manifest state, or None when nothing loads. Every block
        view carries the periphery: the last block's is the one kept, as in
        JAX's write-back order."""
        live = self._db_templates(params, opts)
        trees, manifest = self.manager.load_latest(live, log=self.log,
                                                   device="cpu")
        if trees is None:
            return None
        for b in range(self.dbm.num_blocks):
            copy_into(live[_bname(b)], trees[_bname(b)])
            copy_into(opts[b], trees[_bname(b) + ".opt"])
        return manifest["state"]

    def _rewind_db_block(self, params, opt_b, b: int, why: str) -> bool:
        """Restore ONLY block ``b``'s stack slice (+ its private optimizer
        view) from the latest good generation; the shared periphery keeps its
        CURRENT values — other blocks must not observe the rewind."""
        gen = self.manager.latest_good_generation() if self.manager else None
        if gen is None:
            self.log(f"[runner] {why}; no checkpoint generation to rewind "
                     f"block {b} — keeping current state")
            return False
        start, size = self.dbm.ranges[b]
        cur = extract_block_view(params, start, size)
        old = self.manager.load_tree(gen, _bname(b), cur, "cpu")
        copy_into({k: cur[k] for k in STACK_KEYS if k in cur},
                  {k: old[k] for k in STACK_KEYS if k in old})
        copy_into(opt_b, self.manager.load_tree(gen, _bname(b) + ".opt",
                                                opt_b, "cpu"))
        self.log(f"[runner] {why}; block {b} rewound to generation {gen}")
        return True

    def _train_db(self, make_data, generator, params, resume, halt_after):
        dbm, tcfg = self.dbm, self.tcfg
        B = dbm.num_blocks
        dev = generator.device
        steppers, opts = [], []
        for b in range(B):
            io, st = make_db_train_step(dbm, b, tcfg, impl=self.impl,
                                        precision=self.precision,
                                        guard=self.guard)
            steppers.append(st)
            opts.append(io(params))
        ewma = [-1.0] * B
        streak = [0] * B
        anomalies = [0] * B
        it, data, history = 0, None, []

        def restore(st):
            nonlocal ewma, streak, anomalies, it, data
            g = st["guard"]
            ewma = [float(e) for e in g["ewma"]]
            streak = [int(s) for s in g["streak"]]
            anomalies = [int(a) for a in g["anomalies"]]
            it = int(st["it"])
            rng_from_json(generator, st["rng"])
            self.heartbeats = {int(k): int(v)
                               for k, v in st.get("heartbeats", {}).items()}
            if data is not None and hasattr(data, "close"):
                data.close()
            data = make_data(st.get("data_cursor"))

        if resume:
            st = self._load_db(params, opts)
            if st is None:
                raise TrainFailed("resume=True but no loadable generation in "
                                  f"{self.manager.ckpt_dir!r}")
            restore(st)
            self.log(f"[runner] resumed at it={it}")
        if data is None:
            data = make_data(None)
        if self.manager is not None and not self.manager.generations():
            self._save_db(params, opts, it, generator, data, ewma, streak,
                          anomalies)
        while it < tcfg.steps:
            if self.faults is not None:
                try:
                    self.faults.maybe_raise("pod_die", PodDied)
                except PodDied:
                    # db mode has no pod to orphan a block to: pod_die is
                    # simulated PROCESS death → bounded restart from the
                    # latest good generation
                    self.counters["pod_deaths"] += 1
                    self.counters["restarts"] += 1
                    if self.counters["restarts"] > self.max_restarts:
                        raise TrainFailed(
                            f"restart budget exhausted "
                            f"({self.max_restarts})")
                    if self.manager is None:
                        raise TrainFailed(
                            "pod_die fired with no ckpt_dir to restart from")
                    st = self._load_db(params, opts)
                    if st is None:
                        raise TrainFailed("no loadable checkpoint generation")
                    restore(st)
                    self.log(f"[runner] restarted from it={it} (restart "
                             f"{self.counters['restarts']}/"
                             f"{self.max_restarts})")
                    continue
            mult = 1.0
            if self.faults is not None and self.faults.fire("grad_nan"):
                mult = float("nan")
                self.counters["nan_injected"] += 1
                self.log(f"[runner] injected NaN loss at it={it}")
            self._maybe_stall()
            tokens = _tokens(next(data), dev)
            if self.draws is None:
                b = int(torch.randint(0, B, (), generator=generator,
                                      device=dev))
                kw = {}
            else:
                b, sigma, eps = self.draws(it)
                kw = {"sigma": sigma, "eps": eps}
            _, opts[b], e, loss, m = steppers[b](
                params, opts[b], ewma[b], tokens, generator, loss_mult=mult,
                **kw)
            ewma[b] = float(e)
            if bool(m["ok"]):
                streak[b] = 0
                self.heartbeats[b] = it
            else:
                streak[b] += 1
                anomalies[b] += 1
                self.log(f"[runner] anomaly at it={it} block={b} "
                         f"(streak {streak[b]})")
            history.append((it, b, float(loss)))
            if streak[b] >= self.guard.rewind_after:
                if self._rewind_db_block(
                        params, opts[b], b,
                        f"block {b} hit {streak[b]} consecutive anomalies"):
                    ewma[b] = -1.0
                    self.counters["rewinds"] += 1
                streak[b] = 0
            it += 1
            if tcfg.log_every and (it - 1) % tcfg.log_every == 0:
                self.log(f"[runner/db] it={it - 1} block={b} "
                         f"loss={float(loss):.4f}")
            if self.manager is not None and (it % self.ckpt_every == 0
                                             or it == tcfg.steps):
                self._save_db(params, opts, it, generator, data, ewma,
                              streak, anomalies)
            if halt_after is not None and it >= halt_after:
                self.log(f"[runner] halting at it={it} (halt_after; no "
                         f"checkpoint — kill semantics)")
                break
        if hasattr(data, "close"):
            data.close()
        self.opt_states, self.ewma, self.streak = opts, ewma, streak
        return params, history
