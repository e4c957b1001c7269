"""Block-parallel DiffusionBlocks training (port of
``repro.parallel.engine``, in both of its modes).

The paper's §3 independence result says block b's objective never reads
another block's gradients — the only shared state is the periphery
(embeddings / readout / final norm / σ-conditioning). One ``step`` advances
ALL B blocks on one batch, each block with its own AdamW moments and step
counter, then ONE AdamW update of the periphery from the blocks' periphery
gradients, reconciled by the sync policy:

  ``replicate+psum-mean``   every block's clipped periphery gradients,
        averaged (fp32 accumulation) — data-parallel semantics for the shared
        params.
  ``owner-broadcast``       only the OWNER block (B-1, the lowest-noise
        block — the same block whose checkpoint supplies the periphery in
        ``repro_torch.checkpoint.load_blocks``) contributes periphery
        gradients; the others' are not accumulated at all.
  ``freeze-after-warmup``   the mean for the first ``freeze_steps``
        periphery updates, then the periphery stops moving entirely.

Modes, named as JAX names them (the runner's manifest ``engine`` field):

  ``round_robin``  one process: a Python loop over the blocks (one block's
        activations live at a time) and the single periphery copy.
  ``shard_map``    one process per position of a ``(pod, data)`` mesh of
        W = B·data ranks (``repro_torch.sharding.block_parallel_mesh`` over
        the default process group; launch with ``python -m
        torch.distributed.run``). Rank (b, d) holds block b's slice, its
        moments and step counter, and a replica of the periphery and its
        AdamW state. It runs block b's loss on its batch rows, averages the
        grads and loss over its ``data`` group, clips, and updates block b.
        The periphery accumulator and every block's loss, grad norm, guard
        outcome and EWMA then travel in ONE all-reduce over every rank (the
        data rank 0 of each pod writes its block's slot into a zero buffer,
        so each block counts once), and every rank applies the same
        periphery AdamW to the same bits: the periphery stays bit-equal on
        every rank. Against round robin only the periphery mean's summation
        order differs. Whole-model operations (``block_trees``,
        ``full_params``, ``save_checkpoint``) broadcast a block from its
        owner, rank (b, 0), where another rank needs it.

Draws: σ and ε of every active block, in block order, from ``generator``
(under the mesh every rank holds a replica seeded alike, draws every active
block's full-batch σ and ε and keeps its own block's rows, so both modes
consume the same numbers on the same device type), as
``DiffusionBlocksModel.draw_block`` draws them for ``block_loss``; or
``draws[b]``, block b's full-batch pair.

Clipping is hoisted out of the optimizers, as JAX's ``_split_optimizer``
does: each block's FULL view grads (stack + periphery, as the sequential
per-block step clips them) are clipped first, then split between the
block's stack optimizer and the periphery accumulator, and both AdamWs run
with ``grad_clip=None``.

Per-block ANOMALY GUARD (``GuardConfig``): each block's loss and grad norm
are read on the host right after its backward (one sync per block update),
and a non-finite or spiking block calls no update — its stack, moments and
step counter stay bit-unchanged — and adds nothing to the periphery mean,
which is renormalised by ``B / n_ok`` over the surviving blocks (exactly 1.0
when every block is clean, so the clean path is the unguarded engine's).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import precision as precision_mod
from repro_torch.configs.base import TrainConfig
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.core.training import (GuardConfig, _as_leaves, _grads,
                                       _tokens)
from repro_torch.nn.init import tree_items, tree_map
from repro_torch.optim import (AdamWState, adamw, clip_by_global_norm,
                               global_norm, warmup_cosine)
from repro_torch.parallel import dist as D
from repro_torch.parallel.state import (BlockParallelState, split_periphery,
                                        stack_block_views,
                                        uniform_block_size)
from repro_torch.sharding import rules

PERIPHERY_POLICIES = ("replicate+psum-mean", "owner-broadcast",
                      "freeze-after-warmup")
_POLICY_ALIASES = {"mean": "replicate+psum-mean", "psum-mean":
                   "replicate+psum-mean", "owner": "owner-broadcast",
                   "broadcast": "owner-broadcast", "freeze":
                   "freeze-after-warmup"}


def _split_optimizer(tcfg: TrainConfig, lr_scale: float = 1.0):
    """Same AdamW/schedule as ``make_db_train_step``'s, but with clipping
    hoisted out (the engine clips each block's full view grads first).

    ``lr_scale`` compensates the periphery's 1-vs-B update-count gap: the
    sequential trainer applies one periphery AdamW update per BLOCK update
    (B per batch-equivalent), the engine one per BATCH. With ``lr_scale =
    B`` the periphery rate is scaled by B and the warmup/cosine schedule is
    evaluated at the equivalent block-update count."""
    base = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.steps)
    if lr_scale == 1.0:
        lr = base
    else:
        def lr(step: int) -> float:
            return lr_scale * base(step * lr_scale)
    return adamw(lr, tcfg.b1, tcfg.b2, tcfg.eps,
                 weight_decay=tcfg.weight_decay, grad_clip=None)


def _slice(tree, b: int):
    return tree_map(lambda _, x: x[b], tree)


def _leaves(stack, opt: AdamWState) -> List[torch.Tensor]:
    """A block's tensors in a fixed order (what a broadcast moves)."""
    return ([x for _, x in tree_items(stack)] + [opt.step]
            + [x for _, x in tree_items(opt.mu)]
            + [x for _, x in tree_items(opt.nu)])


class _Periphery:
    """The periphery's fp32 gradient accumulator and the per-block step
    outcomes in one flat buffer, so that one all-reduce carries them all:
    the periphery's leaves (``views`` of ``acc``), then ``rows`` of loss,
    grad norm, ok and EWMA (B each) and a presence flag a leaf (a leaf no
    counted block reads gets a None grad, as in the round-robin sum). The
    outcomes are written on the host and ride in the buffer's tail."""

    def __init__(self, periph, B: int, dev: torch.device):
        leaves = list(tree_items(periph))
        self.n = sum(x.numel() for _, x in leaves)
        self.tail = torch.zeros(4 * B + len(leaves))
        self.flat = torch.zeros(self.n + self.tail.numel(),
                                dtype=torch.float32, device=dev)
        self.acc = self.flat[:self.n]
        self.views, self.index, off = {}, {}, 0
        for j, (path, x) in enumerate(leaves):
            self.views[path] = self.acc[off:off + x.numel()].view(x.shape)
            self.index[path] = j
            off += x.numel()
        self.rows = self.tail[:4 * B].view(4, B)
        self.present = self.tail[4 * B:]

    def add(self, grads, w: float) -> None:
        for path, g in tree_items(grads):
            if g is not None:
                self.views[path].add_(g.float(), alpha=w)
                self.present[self.index[path]] = 1.0

    def all_reduce(self) -> None:
        """Sum every rank's buffer (the mesh's one collective a step)."""
        self.flat[self.n:].copy_(self.tail)
        D.all_reduce(self.flat)
        self.tail.copy_(self.flat[self.n:])

    def grads(self, periph):
        return tree_map(lambda path, _: self.views[path]
                        if self.present[self.index[path]] else None, periph)


class BlockParallelTrainer:
    """Trains all B blocks on every batch; see module docstring.

    ``mode`` is ``"shard_map"`` when a process group of W ranks exists (W a
    multiple of B; any other W is refused), else ``"round_robin"``.
    ``devices`` is one device (round robin even under a process group: the
    runner's orphan sibling) or None; the mesh takes one device per process,
    so more devices are refused. ``blocks`` (round robin only) names the
    blocks the state holds, default all: the orphan sibling holds one."""

    def __init__(self, dbm: DiffusionBlocksModel, tcfg: TrainConfig,
                 periphery: str = "replicate+psum-mean",
                 freeze_steps: Optional[int] = None, impl: str = "kernels",
                 devices: Optional[Sequence] = None, precision=None,
                 periphery_lr_scale=None, guard: Optional[GuardConfig] = None,
                 blocks: Optional[Sequence[int]] = None):
        if devices is not None and len(devices) > 1:
            raise ValueError(
                f"block-parallel training over {len(devices)} devices runs "
                f"one process per device: launch it under python -m "
                f"torch.distributed.run --nproc-per-node {len(devices)} (the "
                f"engine then builds its (pod, data) mesh over the ranks); "
                f"devices= takes one device or none")
        self.dbm, self.tcfg, self.impl = dbm, tcfg, impl
        self.precision = precision_mod.get_policy(precision)
        self.policy = _POLICY_ALIASES.get(periphery, periphery)
        if self.policy not in PERIPHERY_POLICIES:
            raise ValueError(f"unknown periphery policy {periphery!r}; "
                             f"one of {PERIPHERY_POLICIES}")
        self.B = dbm.num_blocks
        self.u = uniform_block_size(dbm.ranges)
        self.guard = GuardConfig() if guard is None else guard
        self.guard_ewma = torch.full((self.B,), -1.0, dtype=torch.float32)
        self.anomaly_streak = np.zeros(self.B, np.int64)
        self.anomalies = np.zeros(self.B, np.int64)
        self.last_ok = np.ones(self.B, bool)
        self.freeze_steps = (tcfg.warmup_steps if freeze_steps is None
                             else freeze_steps)
        self.mesh = None if devices is not None else rules.block_parallel_mesh(
            self.B, D.device_type() or "cpu")
        self.mode = "round_robin" if self.mesh is None else "shard_map"
        self.rank, self.data, self.data_rank = 0, 1, 0
        if self.mesh is None:
            self.blocks = tuple(range(self.B) if blocks is None else blocks)
        elif blocks is not None:
            raise ValueError("blocks= names a round-robin engine's blocks; "
                             "under the mesh each rank holds its pod's")
        else:
            pod, self.data_rank = self.mesh.get_coordinate()
            self.blocks, self.data = (pod,), self.mesh.size(1)
            self.data_group = self.mesh.get_group("data")
            self.rank = self.mesh.get_rank()
        if periphery_lr_scale in (None, "none"):
            self.periphery_lr_scale = 1.0
        elif periphery_lr_scale == "auto":
            self.periphery_lr_scale = float(self.B)
        else:
            self.periphery_lr_scale = float(periphery_lr_scale)
        self._opt_init, self._opt_update = _split_optimizer(tcfg)
        self._popt_init, self._popt_update = _split_optimizer(
            tcfg, self.periphery_lr_scale)

    # ------------------------------------------------------------------
    def owner(self, b: int) -> int:
        """The rank that holds block b and speaks for it: (b, 0)."""
        return 0 if self.mesh is None else int(self.mesh.mesh[b, 0])

    def holds(self, b: int) -> bool:
        return b in self.blocks

    def init_state(self, params) -> BlockParallelState:
        """Round robin: stacks and periphery are the masters' own storage
        (views), and the engine trains ``params`` in place. Under the mesh
        the stacks are a copy of this rank's block alone, so the caller may
        drop the other blocks' masters; the periphery stays ``params``'
        own."""
        stacks = stack_block_views(params, self.dbm.ranges)
        if self.mesh is not None:
            b = self.blocks[0]
            stacks = tree_map(lambda _, x: x[b:b + 1].clone(), stacks)
        elif self.blocks != tuple(range(self.B)):
            raise ValueError("init_state builds every block's state; the "
                             "orphan sibling's comes from its block's trees")
        _, periph = split_periphery(params)
        mom = self._opt_init(stacks)
        stack_opt = AdamWState(
            torch.zeros(len(self.blocks), dtype=torch.int32), mom.mu, mom.nu)
        return BlockParallelState(stacks, periph, stack_opt,
                                  self._popt_init(periph))

    def _block_grads(self, stack_b, periph, b, tokens, generator, draw,
                     mult):
        """(loss, clipped grads of block b's full view, pre-clip norm);
        under the mesh the loss and grads are the data group's mean."""
        dbm, pol = self.dbm, self.precision
        view = _as_leaves(tree_map(lambda _, p: p.detach(),
                                   {**periph, **stack_b}))
        sigma, eps = draw if draw is not None else (None, None)
        vc = precision_mod.cast_params_for_compute(pol, view, dbm.cfg.family)
        loss, _ = dbm.block_loss(vc, b, tokens, generator, sigma=sigma,
                                 eps=eps, impl=self.impl,
                                 unit_range=(0, self.u), precision=pol)
        # the grad_nan injection point: NaN in → NaN grads; the usual 1.0 is
        # bit-exact
        loss = loss * mult
        grads = _grads(loss, view)
        loss = loss.detach()
        if self.data > 1:            # JAX's pmean over ``data``
            for _, g in tree_items(grads):
                if g is not None:
                    D.all_reduce(g, self.data_group).div_(self.data)
            loss = D.all_reduce(loss.reshape(1), self.data_group)[0] \
                / self.data
        if self.tcfg.grad_clip is not None:
            scale, gnorm = clip_by_global_norm(grads, self.tcfg.grad_clip)
            for _, g in tree_items(grads):
                if g is not None:
                    g.mul_(scale)
        else:
            gnorm = global_norm(grads)
        return loss, grads, gnorm

    def step(self, state: BlockParallelState, tokens,
             generator: Optional[torch.Generator] = None, *,
             draws: Optional[List[Tuple]] = None, loss_mult=None,
             active=None, update_periphery: bool = True):
        """One batch → one update of EVERY active block. σ and ε of each
        block are drawn from ``generator`` in block order, or given as
        ``draws[b] = (sigma (Bsz,1,1), eps (Bsz,S,d))`` for the full batch.
        Returns (state', per-block losses (B,), grad norms (B,)) as host
        fp32 tensors, the same on every rank (NaN for blocks that did not
        run). The update is in place: ``state'`` holds the same tensors,
        with a new ``periph_opt``.

        ``loss_mult`` (B,) scales each block's loss inside the grad (the
        ``grad_nan`` injection point; default all-ones is bit-neutral).
        ``active`` (B,) masks blocks out entirely (dead pods / orphan-only
        degraded passes): an inactive block is not run — no stack update,
        no periphery contribution, no draws — and its ranks still take part
        in the collectives. ``update_periphery=False`` freezes the
        periphery for this call (the supervisor's orphan passes, so that
        the survivors' pass stays the single periphery writer).

        Guard outcomes land on the trainer: ``last_ok`` (B,) bool,
        cumulative ``anomalies``, consecutive ``anomaly_streak`` (only
        blocks that actually ran are counted), and the per-block loss EWMA
        ``guard_ewma`` advances only on clean steps."""
        B = self.B
        mult = (np.ones(B, np.float32) if loss_mult is None
                else np.asarray(loss_mult, np.float32))
        ran = (np.ones(B, bool) if active is None
               else np.asarray(active, np.float32) > 0)
        stacks, periph, stack_opt, periph_opt = state
        dev = next(iter(tree_items(periph)))[1].device
        tokens = _tokens(tokens, dev)
        n = tokens.shape[0] // self.data
        if n * self.data != tokens.shape[0]:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not "
                             f"split over {self.data} data shards")
        rows = slice(self.data_rank * n, (self.data_rank + 1) * n)
        owner = self.policy == "owner-broadcast"
        weight = [float(b == B - 1) if owner else 1.0 / B for b in range(B)]
        acc = _Periphery(periph, B, dev)
        counted = self.data_rank == 0    # each block's slot written once
        for b in range(B):
            if not ran[b]:
                continue
            draw = (draws[b] if draws is not None
                    else self.dbm.draw_block(generator, tokens, b))
            if b not in self.blocks:
                continue     # another pod's block: its draws are not used
            i = self.blocks.index(b)
            stack_b = _slice(stacks, i)
            loss, grads, gnorm = self._block_grads(
                stack_b, periph, b, tokens[rows], None,
                tuple(x[rows] for x in draw), float(mult[b]))
            host = torch.stack([loss.float(), gnorm.float()]).cpu()
            ok, ewma = self.guard.classify(host[0], host[1],
                                           self.guard_ewma[b])
            if counted:
                acc.rows[:, b] = torch.stack([host[0], host[1],
                                              ok.float(), ewma])
            if bool(ok):                 # else nothing of block b changes
                if counted and weight[b]:
                    acc.add({k: grads[k] for k in periph}, weight[b])
                opt_b = AdamWState(stack_opt.step[i],
                                   _slice(stack_opt.mu, i),
                                   _slice(stack_opt.nu, i))
                new, _ = self._opt_update({k: grads[k] for k in stacks},
                                          opt_b, stack_b)
                stack_opt.step[i] = new.step
            del grads
        if self.mesh is not None:
            acc.all_reduce()
        losses, gnorms, ok_f, ewma = acc.rows
        oks = (ok_f.numpy() > 0) & ran
        keep = torch.from_numpy(ran)
        losses = torch.where(keep, losses, float("nan")).float()
        gnorms = torch.where(keep, gnorms, float("nan")).float()
        self.guard_ewma = torch.where(keep, ewma, self.guard_ewma).float()
        # renormalise the periphery mean over the SURVIVING blocks: B/n_ok
        # is exactly 1.0 when every block is clean; the owner's sum already
        # is the owner's grads
        n_ok = int(oks.sum())
        per_ok = (bool(oks[B - 1]) if owner else n_ok > 0)
        frozen = (self.policy == "freeze-after-warmup"
                  and int(periph_opt.step) >= self.freeze_steps)
        if per_ok and update_periphery and not frozen:
            scale = 1.0 if owner else B / n_ok
            if scale != 1.0:
                acc.acc.mul_(scale)
            periph_opt, _ = self._popt_update(acc.grads(periph), periph_opt,
                                              periph)
        del acc
        bad = ran & ~oks
        self.last_ok = oks | ~ran
        self.anomalies += bad
        self.anomaly_streak = np.where(
            bad, self.anomaly_streak + 1,
            np.where(ran, 0, self.anomaly_streak))
        return (BlockParallelState(stacks, periph, stack_opt, periph_opt),
                losses, gnorms)

    # ------------------------------------------------------------------
    def guard_state(self) -> dict:
        """JSON-serializable guard state (manifest payload)."""
        return {"ewma": [float(x) for x in self.guard_ewma.tolist()],
                "streak": [int(x) for x in self.anomaly_streak],
                "anomalies": [int(x) for x in self.anomalies]}

    def set_guard_state(self, gs: Optional[dict]) -> None:
        if not gs:
            return
        self.guard_ewma = torch.tensor(gs["ewma"], dtype=torch.float32)
        self.anomaly_streak = np.asarray(gs["streak"], np.int64)
        self.anomalies = np.asarray(gs["anomalies"], np.int64)

    def local_trees(self, state: BlockParallelState, b: int):
        """(stack_view, opt_view) of a block this process holds: VIEWS of
        the live state."""
        i = self.blocks.index(b)
        opt = AdamWState(state.stack_opt.step[i],
                         _slice(state.stack_opt.mu, i),
                         _slice(state.stack_opt.nu, i))
        return _slice(state.stacks, i), opt

    def block_trees(self, state: BlockParallelState, b: int):
        """(stack_view, opt_view) for block ``b`` (checkpoint payloads,
        rewind templates). Round robin: VIEWS of the live state; clone them
        to keep them. Under the mesh a collective: every rank calls it, and
        the owner's tensors are broadcast to the ranks that do not hold
        block b (the holders get views, as in round robin)."""
        if self.mesh is None:
            return self.local_trees(state, b)
        return self.broadcast_block(
            state, b, self.local_trees(state, b)
            if self.rank == self.owner(b) else None, self.owner(b))

    def broadcast_block(self, state: BlockParallelState, b: int, trees,
                        src: int):
        """Collective (mesh): rank ``src``'s ``trees``, block b's (stack,
        opt), land in block b's live state on the ranks that hold it, and in
        fresh buffers on the others. Returns what this rank holds after."""
        if self.rank == src:
            got = trees
        elif self.holds(b):
            got = self.local_trees(state, b)
        else:
            own = self.local_trees(state, self.blocks[0])
            got = (tree_map(lambda _, x: torch.empty_like(x), own[0]),
                   AdamWState(*[tree_map(lambda _, x: torch.empty_like(x),
                                         t) for t in own[1]]))
        for x in _leaves(*got):
            D.broadcast(x, src)
        return got

    def write_block(self, state: BlockParallelState, b: int, stack_view,
                    opt_view) -> BlockParallelState:
        """Overwrite ONE block's stacked slice + optimizer moments and step
        counter in place (rewind / pod re-adoption), where this process
        holds it (every rank calls it: the block's guard state is reset on
        all of them) — every other block's state is untouched."""
        from repro_torch.checkpoint import copy_into
        if self.holds(b):
            stack, opt = self.local_trees(state, b)
            copy_into(stack, stack_view)
            copy_into(opt, opt_view)
        self.anomaly_streak[b] = 0
        self.guard_ewma[b] = -1.0
        return state

    # ------------------------------------------------------------------
    def train(self, data_iter, generator: torch.Generator, params=None,
              log=print, ckpt_dir: Optional[str] = None):
        """Counterpart of ``train_db``: ``tcfg.steps`` is the TOTAL budget of
        per-block updates, so the engine runs ceil(steps / B) batches and the
        returned history carries one (it, block, loss) entry per block-update
        — directly comparable to the sequential trajectory (truncated to
        ``steps`` entries)."""
        tcfg = self.tcfg
        if params is None:
            params = self.dbm.init(generator)
        state = self.init_state(params)
        history, it = [], 0
        for bt in range(math.ceil(tcfg.steps / self.B)):
            state, losses, gnorms = self.step(state, next(data_iter),
                                              generator)
            for b in range(self.B):
                if it < tcfg.steps:
                    history.append((it, b, float(losses[b])))
                it += 1
            if tcfg.log_every and bt % tcfg.log_every == 0:
                log(f"[db-par/{self.mode}/{self.policy}] batch={bt} "
                    f"loss={float(losses.mean()):.4f} "
                    f"gn={float(gnorms.mean()):.2f}")
        if ckpt_dir:
            self.save_checkpoint(state, ckpt_dir, step=it)
        return self.full_params(state), history

    # ------------------------------------------------------------------
    def full_params(self, state: BlockParallelState) -> dict:
        """The full params tree. Round robin: each (B, u, ...) stacked leaf
        viewed as the (B·u, ...) master it is a view of, and the periphery
        (no copy). Under the mesh a collective: every block's stack
        broadcast from its owner and concatenated on every rank."""
        if self.mesh is None:
            return {**{k: tree_map(lambda _, x: x.view(
                x.shape[0] * x.shape[1], *x.shape[2:]), v)
                for k, v in state.stacks.items()}, **state.periph}
        own = _slice(state.stacks, 0)
        blocks = []
        for b in range(self.B):
            stack = (own if self.holds(b) else
                     tree_map(lambda _, x: torch.empty_like(x), own))
            for _, x in tree_items(stack):
                D.broadcast(x, self.owner(b))
            blocks.append(stack)
        items = [dict(tree_items(s)) for s in blocks]
        return {**tree_map(lambda path, _: torch.cat(
            [it[path] for it in items]), blocks[0]), **state.periph}

    def save_checkpoint(self, state: BlockParallelState, ckpt_dir: str,
                        step: int = 0):
        """Per-block params + per-block optimizer moments + the periphery
        optimizer (the flat per-block layout) — each block is recoverable
        independently. Under the mesh each block's owner writes its files
        and rank 0 the periphery's; every rank returns once all are
        written."""
        from repro_torch.checkpoint import (save_block_opt, save_block_view,
                                            save_pytree)
        for b in self.blocks:
            if self.data_rank:
                break
            stack, opt = self.local_trees(state, b)
            start, size = self.dbm.ranges[b]
            save_block_view(ckpt_dir, {**state.periph, **stack}, b, start,
                            size, step)
            save_block_opt(ckpt_dir, b, opt, step)
        if self.rank == 0:
            save_pytree(os.path.join(ckpt_dir, "periphery.opt.npz"),
                        state.periph_opt, {"step": step})
        if self.mesh is not None:
            D.barrier()

    def restore(self, params, ckpt_dir: str) -> BlockParallelState:
        """State over ``params`` (overwritten in place) from per-block
        checkpoints; blocks or optimizer files that are missing keep their
        current values / fresh initialization."""
        from repro_torch.checkpoint import (copy_into, load_block_opt,
                                            load_blocks, load_pytree)
        load_blocks(ckpt_dir, params, self.dbm.ranges)
        state = self.init_state(params)
        for b in self.blocks:
            opt_b = self.local_trees(state, b)[1]
            loaded = load_block_opt(ckpt_dir, b, opt_b)
            if loaded is not None:
                copy_into(opt_b, loaded)
        ppath = os.path.join(ckpt_dir, "periphery.opt.npz")
        if os.path.exists(ppath):
            copy_into(state.periph_opt, load_pytree(ppath, state.periph_opt))
        return state


def train_db_parallel(dbm: DiffusionBlocksModel, tcfg: TrainConfig, data_iter,
                      generator: torch.Generator, params=None, log=print,
                      periphery: str = "replicate+psum-mean",
                      devices=None, ckpt_dir: Optional[str] = None,
                      impl: str = "kernels", precision=None,
                      periphery_lr_scale=None, aux_fn=None):
    """Functional wrapper mirroring ``train_db``'s signature. Modality
    conditioning (``aux_fn``) is refused, as JAX's block-parallel route
    refuses it."""
    if aux_fn is not None:
        raise NotImplementedError(
            "aux_fn (modality conditioning) is not supported by the "
            "block-parallel engine yet; train conditioned families with "
            "core.training.make_db_train_step(...)(..., aux_inputs=...)")
    trainer = BlockParallelTrainer(dbm, tcfg, periphery=periphery,
                                   devices=devices, impl=impl,
                                   precision=precision,
                                   periphery_lr_scale=periphery_lr_scale)
    return trainer.train(data_iter, generator, params=params, log=log,
                         ckpt_dir=ckpt_dir)
