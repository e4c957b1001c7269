"""Mixture-of-Experts layer (port of ``repro.nn.moe``): a top-k router and
GShard-style capacity-limited dense dispatch.

Tokens are routed in groups of ``GROUP_SIZE`` (GShard's G x S layout), so
the one-hot dispatch tensor is (G, group, E, capacity) rather than (T, E,
capacity). Within a group each expert takes its tokens in order (a cumsum
over the group) up to ``capacity``; a token past it gets no term from that
expert. The dispatch and combine are dense one-hot products, as in JAX:
every expert's weights are read whatever the routing, and nothing reads a
routing decision on the host, so the layer replays from a CUDA graph.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import as_dtype

GROUP_SIZE = 512


def moe_spec(d: int, ff: int, cfg: MoEConfig, mlp_kind: str):
    E = cfg.num_experts
    spec = {
        "router": {"w": ParamSpec((d, E), ("embed", "experts"))},
        "wi": ParamSpec((E, d, ff), ("experts", "embed", "mlp")),
        "wo": ParamSpec((E, ff, d), ("experts", "mlp", "embed")),
    }
    if mlp_kind == "swiglu":
        spec["wg"] = ParamSpec((E, d, ff), ("experts", "embed", "mlp"))
    return spec


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index as ``jax.lax.top_k`` breaks them: k rounds of
    ``argmax`` (the first maximal index), each masking its pick. The
    entries are probabilities, so -1 masks."""
    vals, idx = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        p = p.scatter(-1, i, -1.0)
    return torch.cat(vals, -1), torch.cat(idx, -1)


def top_k_gating(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (G, S, E) -> (sparse gates (G, S, E) fp32, the Switch
    load-balance aux loss over all tokens, fp32 0-dim). The top-k gates
    are renormalised to sum to 1."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True)
    onehot = (topi[..., None] == torch.arange(E, device=logits.device)
              ).float()                                       # (G, S, k, E)
    gates = (onehot * topv[..., None]).sum(2)
    me = probs.mean((0, 1))
    ce = onehot.amax(2).mean((0, 1))
    return gates, E * (me * ce).sum()


def route(params, x: torch.Tensor, cfg: MoEConfig,
          group_size: Optional[int] = None):
    """The router's decisions for x (B, S, d): (xt (G, g, d), the tokens
    in groups; gates (G, g, E) fp32; the aux loss; pos (G, g, E), each
    pick's slot in its expert's queue within the group; capacity, the
    slots an expert has). A pick is kept where ``pos < capacity``."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    g = group_size or min(GROUP_SIZE, T)
    while T % g:            # a token count GROUP_SIZE does not divide
        g //= 2
    xt = x.reshape(T // g, g, d)
    gates, aux = top_k_gating(xt @ as_dtype(params["router"]["w"], x.dtype),
                              k)
    capacity = max(int(cfg.capacity_factor * k * g / E), 1)
    pos = torch.cumsum((gates > 0).to(torch.int32), dim=1) - 1
    return xt, gates, aux, pos, capacity


def moe_fwd(params, x: torch.Tensor, cfg: MoEConfig, mlp_kind: str,
            group_size: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 0-dim)."""
    dt = x.dtype
    xt, gates, aux, pos, capacity = route(params, x, cfg, group_size)
    keep = (gates > 0) & (pos < capacity)                     # (G, g, E)
    disp = keep[..., None] & (pos[..., None] == torch.arange(
        capacity, device=x.device))                           # (G, g, E, C)
    disp_f = disp.to(dt)
    combine = disp_f * gates.to(dt)[..., None]

    expert_in = torch.einsum("gsec,gsd->gecd", disp_f, xt)   # (G, E, C, d)
    wi, wo = as_dtype(params["wi"], dt), as_dtype(params["wo"], dt)
    if mlp_kind == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", expert_in,
                                as_dtype(params["wg"], dt))) * \
            torch.einsum("gecd,edf->gecf", expert_in, wi)
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, wi),
                   approximate="tanh")
    expert_out = torch.einsum("gecf,efd->gecd", h, wo)       # (G, E, C, d)
    out = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    return out.reshape(x.shape), aux.float()
