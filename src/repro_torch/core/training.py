"""Train-step builders (port of ``repro.core.training``, unguarded).

``make_db_train_step(dbm, b, ...)`` returns a step that computes the paper's
block-local loss (Eq. 6) and takes gradients ONLY for block b's unit slice
plus the shared periphery (embedding, readout, final norm, σ conditioning).
The block view is built from detached slices of the masters: new autograd
leaves that share their storage, so the other blocks' units take part in no
graph, and gradients and AdamW moments exist for the view alone. AdamW then
updates the view, and so the masters, in place.

``make_e2e_train_step`` is the end-to-end backprop baseline over every
param. Both are ``make_view_train_step`` over a loss, which the DiT, ViT,
masked-diffusion and recurrent-depth adapters' steps use too;
``train_views`` is the DiT, ViT and masked-diffusion training loop. Every
step returns ``(params, opt_state, loss, metrics)`` with ``params`` updated
in place (the same dict).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import precision as precision_mod
from repro_torch.configs.base import TrainConfig
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.nn.init import tree_items, tree_map
from repro_torch.optim import adamw, warmup_cosine

STACK_KEYS = ("layers", "units")


def extract_block_view(params: Dict, start: int, size: int) -> Dict:
    """Sub-tree of block b's unit slice + the shared periphery, as detached
    views of ``params`` (same storage, no autograd history). The view is a
    valid params dict whose stacks have length ``size`` (apply with
    unit_range=(0, size))."""
    view = {}
    for k, v in params.items():
        if k in STACK_KEYS:
            view[k] = tree_map(lambda _, p: p[start:start + size].detach(), v)
        else:
            view[k] = tree_map(lambda _, p: p.detach(), v)
    return view


def write_back_block_view(params: Dict, view: Dict, start: int) -> Dict:
    """Copy ``view`` into ``params`` at unit ``start``. A view made by
    ``extract_block_view`` already shares the masters' storage, and its
    leaves are skipped."""
    whole = dict(tree_items(params))
    with torch.no_grad():
        for path, blk in tree_items(view):
            dst = whole[path]
            if path[0] in STACK_KEYS:
                dst = dst[start:start + blk.shape[0]]
            if blk.data_ptr() != dst.data_ptr() \
                    or blk.stride() != dst.stride():
                dst.copy_(blk)
    return params


def make_optimizer(tcfg: TrainConfig):
    lr = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.steps)
    return adamw(lr, tcfg.b1, tcfg.b2, tcfg.eps,
                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)


def _grads(loss, tree):
    """d loss / d every leaf of ``tree`` (None for leaves it does not
    read), as a tree."""
    paths, leaves = zip(*tree_items(tree))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out: Dict = {}
    for path, g in zip(paths, grads):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return out


def _as_leaves(view):
    return tree_map(lambda _, p: p.requires_grad_(p.is_floating_point()),
                    view)


def make_view_train_step(loss_fn, tcfg: TrainConfig, unit_range=None):
    """(init_opt_state_fn, step_fn) training one view of the params with
    AdamW: block b's slice ``unit_range = (start, size)`` of every stack in
    ``STACK_KEYS`` plus the periphery, or every param when ``unit_range`` is
    None. ``loss_fn(view, *args, **kw) -> (loss, metrics)`` sees the view;
    gradients and AdamW moments exist for the view alone, and the update
    lands in the masters in place.

    step_fn(params, opt_state, *args, **kw) -> (params, opt_state, loss,
    metrics)"""
    opt_init, opt_update = make_optimizer(tcfg)

    def view_of(params):
        if unit_range is None:
            return tree_map(lambda _, p: p.detach(), params)
        return extract_block_view(params, *unit_range)

    def init_opt(params):
        return opt_init(view_of(params))

    def step(params, opt_state, *args, **kw):
        view = _as_leaves(view_of(params))
        loss, metrics = loss_fn(view, *args, **kw)
        grads = _grads(loss, view)
        # the view shares the masters' storage: the update lands in params
        opt_state, om = opt_update(grads, opt_state, view)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, loss.detach(), {**metrics, **om}

    return init_opt, step


def train_views(steps, params, batches, generator: torch.Generator,
                tcfg: TrainConfig, blockwise: bool, tag: str, log=print):
    """The adapters' training loop over ``make_view_train_step`` pairs
    ``steps``: one per block, each with its own AdamW state, of which
    ``blockwise`` takes one drawn uniformly from ``generator`` each
    iteration; else the one full-stack step. ``batches`` yields tuples of
    the steps' arguments, to which ``generator`` is appended. Returns
    (params, history [(it, block, loss)]), block -1 for the full stack."""
    dev = generator.device
    states = [init(params) for init, _ in steps]
    history = []
    for it in range(tcfg.steps):
        args = next(batches)
        k = int(torch.randint(0, len(steps), (), generator=generator,
                              device=dev)) if blockwise else 0
        params, states[k], loss, _ = steps[k][1](params, states[k], *args,
                                                 generator)
        history.append((it, k if blockwise else -1, float(loss)))
        if tcfg.log_every and it % tcfg.log_every == 0:
            log(f"[{tag}] it={it} block={history[-1][1]} "
                f"loss={float(loss):.4f}")
    return params, history


def make_db_train_step(dbm: DiffusionBlocksModel, b: int, tcfg: TrainConfig,
                       impl: str = "kernels", precision=None, guard=None):
    """Returns (init_opt_state_fn, step_fn).

    step_fn(params, opt_state_b, tokens, generator=None, *, sigma=None,
            eps=None) -> (params, opt_state_b, loss, metrics)

    σ (B, 1, 1) and ε (B, S, d) are drawn from ``generator`` unless given.
    ``precision`` keeps fp32 masters and moments while the loss sees
    compute-dtype copies; the cast's backward brings the grads to fp32."""
    if guard is not None:
        raise NotImplementedError(
            "guard (GuardConfig) belongs to the fault-tolerant training "
            "slice of the port")
    start, size = dbm.ranges[b]
    pol = precision_mod.get_policy(precision)

    def loss_fn(view, tokens, generator=None, *, sigma=None, eps=None):
        vc = precision_mod.cast_params_for_compute(pol, view, dbm.cfg.family)
        return dbm.block_loss(vc, b, tokens, generator, sigma=sigma, eps=eps,
                              impl=impl, unit_range=(0, size), precision=pol)

    return make_view_train_step(loss_fn, tcfg, (start, size))


def make_e2e_train_step(dbm: DiffusionBlocksModel, tcfg: TrainConfig,
                        impl: str = "kernels", precision=None):
    """Returns (init_opt_state_fn, step_fn) with
    step_fn(params, opt_state, tokens) -> (params, opt_state, loss,
    metrics)."""
    pol = precision_mod.get_policy(precision)

    def loss_fn(view, tokens):
        pc = precision_mod.cast_params_for_compute(pol, view, dbm.cfg.family)
        return dbm.e2e_loss(pc, tokens, impl=impl, precision=pol)

    return make_view_train_step(loss_fn, tcfg)


def _tokens(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch, dtype=torch.long).to(device)


def train_db(dbm: DiffusionBlocksModel, tcfg: TrainConfig, data_iter,
             generator: torch.Generator, params=None, log=print,
             impl: str = "kernels", precision=None):
    """Sequential block-cycling training (paper Fig. 3 right): each
    iteration trains one block drawn uniformly from ``generator``, with its
    own AdamW state (periphery moments included). Returns (params,
    history [(it, block, loss)])."""
    dev = generator.device
    if params is None:
        params = dbm.init(generator)
    steppers, opt_states = [], []
    for b in range(dbm.num_blocks):
        init_opt, step = make_db_train_step(dbm, b, tcfg, impl=impl,
                                            precision=precision)
        steppers.append(step)
        opt_states.append(init_opt(params))
    history = []
    for it in range(tcfg.steps):
        tokens = _tokens(next(data_iter), dev)
        b = int(torch.randint(0, dbm.num_blocks, (), generator=generator,
                              device=dev))
        params, opt_states[b], loss, m = steppers[b](
            params, opt_states[b], tokens, generator)
        history.append((it, b, float(loss)))
        if tcfg.log_every and it % tcfg.log_every == 0:
            log(f"[db] it={it} block={b} loss={float(loss):.4f} "
                f"gn={float(m['grad_norm']):.2f}")
    return params, history


def train_e2e(dbm: DiffusionBlocksModel, tcfg: TrainConfig, data_iter,
              generator: torch.Generator, params=None, log=print,
              impl: str = "kernels", precision=None):
    dev = generator.device
    if params is None:
        params = dbm.init(generator)
    init_opt, step = make_e2e_train_step(dbm, tcfg, impl=impl,
                                         precision=precision)
    opt_state = init_opt(params)
    history = []
    for it in range(tcfg.steps):
        params, opt_state, loss, _ = step(params, opt_state,
                                          _tokens(next(data_iter), dev))
        history.append((it, -1, float(loss)))
        if tcfg.log_every and it % tcfg.log_every == 0:
            log(f"[e2e] it={it} loss={float(loss):.4f}")
    return params, history
