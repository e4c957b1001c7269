"""Block-parallel DiffusionBlocks training on one device: the round-robin
engine (port of ``repro.parallel.engine`` in its ``round_robin`` mode).

The paper's §3 independence result says block b's objective never reads
another block's gradients — the only shared state is the periphery
(embeddings / readout / final norm / σ-conditioning). One ``step`` advances
ALL B blocks on one batch: a Python loop over the blocks (one block's
activations live at a time), each block with its own AdamW moments and step
counter, then ONE AdamW update of the single periphery copy from the
blocks' periphery gradients, reconciled by the sync policy:

  ``replicate+psum-mean``   every block's clipped periphery gradients,
        averaged (fp32 accumulation) — data-parallel semantics for the shared
        params.
  ``owner-broadcast``       only the OWNER block (B-1, the lowest-noise
        block — the same block whose checkpoint supplies the periphery in
        ``repro_torch.checkpoint.load_blocks``) contributes periphery
        gradients; the others' are not accumulated at all.
  ``freeze-after-warmup``   the mean for the first ``freeze_steps``
        periphery updates, then the periphery stops moving entirely.

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

On one device the engine is always round-robin. The pod-per-block path
(one block per device, the periphery reduced across them) is not ported:
``devices`` with more than one device raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

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
from repro_torch.parallel.state import (BlockParallelState, split_periphery,
                                        stack_block_views,
                                        uniform_block_size)

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


class BlockParallelTrainer:
    """Trains all B blocks on every batch; see module docstring.

    ``mode`` is always ``"round_robin"``. ``devices`` is accepted for the
    JAX signature: None or one device (the params' own)."""

    def __init__(self, dbm: DiffusionBlocksModel, tcfg: TrainConfig,
                 periphery: str = "replicate+psum-mean",
                 freeze_steps: Optional[int] = None, impl: str = "kernels",
                 devices: Optional[Sequence] = None, precision=None,
                 periphery_lr_scale=None, guard: Optional[GuardConfig] = None):
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "block-parallel training across devices (one pod per block): "
                "not ported yet (ROADMAP A5); pass one device or none for "
                "the round-robin engine")
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
        self.mode = "round_robin"
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
    def init_state(self, params) -> BlockParallelState:
        """Stacks and periphery are the masters' own storage (views): the
        engine trains ``params`` in place."""
        stacks = stack_block_views(params, self.dbm.ranges)
        _, periph = split_periphery(params)
        mom = self._opt_init(stacks)
        stack_opt = AdamWState(torch.zeros(self.B, dtype=torch.int32),
                               mom.mu, mom.nu)
        return BlockParallelState(stacks, periph, stack_opt,
                                  self._popt_init(periph))

    def _block_grads(self, stack_b, periph, b, tokens, generator, draw,
                     mult):
        """(loss, clipped grads of block b's full view, pre-clip norm)."""
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
        if self.tcfg.grad_clip is not None:
            scale, gnorm = clip_by_global_norm(grads, self.tcfg.grad_clip)
            for _, g in tree_items(grads):
                if g is not None:
                    g.mul_(scale)
        else:
            gnorm = global_norm(grads)
        return loss.detach(), grads, gnorm

    def step(self, state: BlockParallelState, tokens,
             generator: Optional[torch.Generator] = None, *,
             draws: Optional[List[Tuple]] = None, loss_mult=None,
             active=None, update_periphery: bool = True):
        """One batch → one update of EVERY active block. σ and ε of each
        block are drawn from ``generator`` in block order, or given as
        ``draws[b] = (sigma (Bsz,1,1), eps (Bsz,S,d))``. Returns (state',
        per-block losses (B,), grad norms (B,)) as host fp32 tensors (NaN
        for blocks that did not run). The update is in place: ``state'``
        holds the same tensors, with a new ``periph_opt``.

        ``loss_mult`` (B,) scales each block's loss inside the grad (the
        ``grad_nan`` injection point; default all-ones is bit-neutral).
        ``active`` (B,) masks blocks out entirely (dead pods / orphan-only
        degraded passes): an inactive block is not run — no stack update,
        no periphery contribution, no draws. ``update_periphery=False``
        freezes the periphery for this call (the supervisor's orphan passes,
        so that the survivors' pass stays the single periphery writer).

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
        owner = self.policy == "owner-broadcast"
        losses = torch.full((B,), float("nan"))
        gnorms = torch.full((B,), float("nan"))
        oks = np.zeros(B, bool)
        acc, n_ok, acc_w = {}, 0, 0.0
        for b in range(B):
            if not ran[b]:
                continue
            stack_b = _slice(stacks, b)
            loss, grads, gnorm = self._block_grads(
                stack_b, periph, b, tokens, generator,
                None if draws is None else draws[b], float(mult[b]))
            host = torch.stack([loss.float(), gnorm.float()]).cpu()
            ok, self.guard_ewma[b] = self.guard.classify(
                host[0], host[1], self.guard_ewma[b])
            losses[b], gnorms[b] = host
            oks[b] = bool(ok)
            if oks[b]:                   # else nothing of block b changes
                w = float(b == B - 1) if owner else 1.0 / B
                n_ok, acc_w = n_ok + 1, acc_w + w
                for path, g in tree_items({k: grads[k] for k in periph}):
                    if not w or g is None:
                        continue
                    if path in acc:
                        acc[path].add_(g.float(), alpha=w)
                    else:
                        acc[path] = g.float() * w
                opt_b = AdamWState(stack_opt.step[b],
                                   _slice(stack_opt.mu, b),
                                   _slice(stack_opt.nu, b))
                new, _ = self._opt_update({k: grads[k] for k in stacks},
                                          opt_b, stack_b)
                stack_opt.step[b] = new.step
            del grads
        # renormalise the periphery mean over the SURVIVING blocks: B/n_ok
        # is exactly 1.0 when every block is clean; the owner's sum already
        # is the owner's grads
        per_ok = acc_w > 0 if owner else n_ok > 0
        frozen = (self.policy == "freeze-after-warmup"
                  and int(periph_opt.step) >= self.freeze_steps)
        if per_ok and update_periphery and not frozen:
            scale = 1.0 if owner else B / n_ok
            if scale != 1.0:
                for a in acc.values():
                    a.mul_(scale)
            g_per = tree_map(lambda path, _: acc.get(path), periph)
            periph_opt, _ = self._popt_update(g_per, periph_opt, periph)
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

    def block_trees(self, state: BlockParallelState, b: int):
        """(stack_view, opt_view) for block ``b``: VIEWS of the live state
        (checkpoint payloads, rewind templates); clone them to keep them."""
        opt = AdamWState(state.stack_opt.step[b],
                         _slice(state.stack_opt.mu, b),
                         _slice(state.stack_opt.nu, b))
        return _slice(state.stacks, b), opt

    def write_block(self, state: BlockParallelState, b: int, stack_view,
                    opt_view) -> BlockParallelState:
        """Overwrite ONE block's stacked slice + optimizer moments and step
        counter in place (rewind / pod re-adoption) — every other block's
        state is untouched."""
        from repro_torch.checkpoint import copy_into
        stack, opt = self.block_trees(state, b)
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
        """The full params tree: each (B, u, ...) stacked leaf viewed as the
        (B·u, ...) master it is a view of, and the periphery (no copy)."""
        return {**{k: tree_map(lambda _, x: x.view(
            x.shape[0] * x.shape[1], *x.shape[2:]), v)
            for k, v in state.stacks.items()}, **state.periph}

    def save_checkpoint(self, state: BlockParallelState, ckpt_dir: str,
                        step: int = 0):
        """Per-block params + per-block optimizer moments + the periphery
        optimizer (the flat per-block layout) — each block is recoverable
        independently."""
        from repro_torch.checkpoint import (save_block, save_block_opt,
                                            save_pytree)
        params = self.full_params(state)
        for b, (start, size) in enumerate(self.dbm.ranges):
            save_block(ckpt_dir, params, b, start, size, step)
            save_block_opt(ckpt_dir, b, self.block_trees(state, b)[1], step)
        save_pytree(os.path.join(ckpt_dir, "periphery.opt.npz"),
                    state.periph_opt, {"step": step})

    def restore(self, params, ckpt_dir: str) -> BlockParallelState:
        """State over ``params`` (overwritten in place) from per-block
        checkpoints; blocks or optimizer files that are missing keep their
        current values / fresh initialization."""
        from repro_torch.checkpoint import (copy_into, load_block_opt,
                                            load_blocks, load_pytree)
        load_blocks(ckpt_dir, params, self.dbm.ranges)
        state = self.init_state(params)
        for b in range(self.B):
            opt_b = self.block_trees(state, b)[1]
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
