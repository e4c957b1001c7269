"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``, with its formulas: bias correction from the step
count, weight decay inside the update, clip scale
``min(1, max_norm / max(norm, 1e-9))``).

Trees are nested dicts of tensors. The state is ``AdamWState(step, mu, nu)``
as in JAX: ``step`` a 0-dim int32 tensor on the CPU, ``mu``/``nu`` fp32
trees shaped like the params, so either package's states can be loaded by
the other's checkpoint code. Unlike JAX, ``update`` works IN PLACE: it
advances the moments and the params themselves (no second copy of a block's
params or moments), and returns the new state and metrics. A grad of None
(a param the loss does not read) counts as zero, as JAX's zero cotangent:
its moments decay and weight decay still applies.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.nn.init import tree_items, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, CPU
    mu: Any
    nu: Any


def _flat(tree) -> Dict:
    return dict(tree_items(tree))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for _, g in tree_items(tree)
          if g is not None]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree, max_norm: float):
    """(scale, norm): multiply every grad by ``scale`` to clip."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def adamw(lr: Union[Callable[[int], float], float], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = None):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> AdamWState:
        def z(_, p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(z, params), tree_map(z, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        if grad_clip is not None:
            scale, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            scale, gnorm = None, global_norm(grads)
        step = state.step + 1
        n = int(step)
        lr_t = lr_fn(n)
        bc1 = 1.0 - float(torch.tensor(b1) ** torch.tensor(float(n)))
        bc2 = 1.0 - float(torch.tensor(b2) ** torch.tensor(float(n)))
        g_of, mu, nu = _flat(grads), _flat(state.mu), _flat(state.nu)
        for path, p in tree_items(params):
            m, v, g = mu[path], nu[path], g_of.get(path)
            m.mul_(b1)
            v.mul_(b2)
            if g is not None:
                g = g.float()
                if scale is not None:
                    g = g * scale
                m.add_(g, alpha=1 - b1)
                v.addcmul_(g, g, value=1 - b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta.add_(p.float(), alpha=weight_decay)
            p.add_((delta * -lr_t).to(p.dtype))
        return AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                      "lr": lr_t}

    return init, update
