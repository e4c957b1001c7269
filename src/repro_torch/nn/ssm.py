"""Mamba2 layer, the serving half (port of ``repro.nn.ssm``: ``mamba2_spec``,
``_split_proj``, ``_causal_conv``, ``mamba2_init_state`` and
``mamba2_decode_step``), plus ``mamba2_chunk_step``, the chunked-prefill
form of the decode step.

State-space recurrence (per head, diagonal A = -exp(a_log)):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t ⊗ B_t        h: (P, N)
    y_t = C_t · h_t + D * x_t

JAX's Mamba2 is plain XLA (no ``pallas_call``), so this module is plain
torch. The training half, ``_chunk_scan``, ``mamba2_fwd`` and
``mamba2_two_pass``, is the next hybrid slice (ROADMAP A6.2, hybrid
training).

``mamba2_chunk_step`` computes what JAX's ``chunk_token_scan`` around
``mamba2_decode_step`` computes for a prefill chunk, without running the
decode step once a token: in_proj, the causal conv over [history ‖ chunk],
softplus, the gated RMSNorm and out_proj run over the whole chunk (JAX
re-reads each layer's in_proj and out_proj once a token), and the
recurrence over the chunk's C tokens is evaluated in its closed form, as
masked (C, C) products (the SSD dual form of ``_chunk_scan`` over one
chunk). A slot's tokens past ``n_valid[b]`` hold its state: their dt is
set to 0, which makes their decay exactly 1 and their increment exactly
0. ``models.common.chunk_token_scan`` over ``mamba2_decode_step`` is the
plain version the tests hold it to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import as_dtype


def mamba2_spec(d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    return {
        # in_proj produces [x (d_in), z gate (d_in), B (N), C (N), dt (H)]
        "in_proj": {"w": ParamSpec(
            (d_model, 2 * d_in + 2 * cfg.d_state + n_heads),
            ("embed", "heads"))},
        "conv_w": ParamSpec((cfg.d_conv, d_in + 2 * cfg.d_state),
                            (None, "heads"), "normal", 1.0),
        "conv_b": ParamSpec((d_in + 2 * cfg.d_state,), ("heads",), "zeros"),
        "a_log": ParamSpec((n_heads,), ("heads",), "uniform", 1.0),
        "dt_bias": ParamSpec((n_heads,), ("heads",), "zeros"),
        "d_skip": ParamSpec((n_heads,), ("heads",), "ones"),
        "norm_g": ParamSpec((d_in,), ("heads",), "ones"),
        "out_proj": {"w": ParamSpec((d_in, d_model), ("heads", "embed"))},
    }


def _split_proj(proj, d_in: int, d_state: int, n_heads: int):
    xz, rest = proj[..., :2 * d_in], proj[..., 2 * d_in:]
    x, z = xz[..., :d_in], xz[..., d_in:]
    B = rest[..., :d_state]
    C = rest[..., d_state:2 * d_state]
    dt = rest[..., 2 * d_state:]
    return x, z, B, C, dt


def _conv_taps(ext: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """sum_i ext[:, i:i + S] * w[i], in JAX's order of the K taps."""
    out = torch.zeros_like(ext[:, :S])
    for i in range(w.shape[0]):
        out = out + ext[:, i:i + S] * as_dtype(w[i], ext.dtype)
    return out


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u: (B, S, C), w: (K, C), prev: (B, K-1, C)
    history. Returns (silu(conv + b) (B, S, C), new history (B, K-1, C))."""
    K = w.shape[0]
    if prev is None:
        prev = u.new_zeros((u.shape[0], K - 1, u.shape[-1]))
    ext = torch.cat([prev.to(u.dtype), u], dim=1)
    out = _conv_taps(ext, w, u.shape[1])
    new_hist = ext[:, -(K - 1):] if K > 1 else prev
    return F.silu(out + as_dtype(b, u.dtype)), new_hist


def mamba2_init_state(batch: int, cfg: SSMConfig, d_model: int,
                      dtype=torch.float32, device="cuda") -> dict:
    """Zeroed per-slot state: ``h`` (B, H, P, N) fp32 and ``conv`` (B, K-1,
    d_in + 2N) in ``dtype``."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    return {
        "h": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_in + 2 * cfg.d_state),
                            dtype=dtype, device=device),
    }


def _gated_out(params, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """y * silu(z), the RMSNorm (fp32 statistics) with ``norm_g``, then
    out_proj: the tail of every Mamba2 mode."""
    y = y.to(dtype) * F.silu(z)
    yf = y.float()
    var = (yf * yf).mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6)
         * params["norm_g"].float()).to(dtype)
    return y @ as_dtype(params["out_proj"]["w"], dtype)


def _project(params, u: torch.Tensor, cfg: SSMConfig, d_model: int):
    """in_proj and its split, the conv input [x ‖ B ‖ C] beside z and the
    raw dt."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    proj = u @ as_dtype(params["in_proj"]["w"], u.dtype)
    x, z, Bm, Cm, dt = _split_proj(proj, d_in, cfg.d_state, H)
    return torch.cat([x, Bm, Cm], dim=-1), z, dt


def mamba2_decode_step(params, u: torch.Tensor, cfg: SSMConfig, d_model: int,
                       state: dict) -> Tuple[torch.Tensor, dict]:
    """Single-token decode: O(1) state update. u: (B, 1, d_model). Returns
    (out (B, 1, d_model), new state); ``state`` is not modified."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    conv_in, z, dt = _project(params, u, cfg, d_model)
    conv_out, conv_hist = _causal_conv(conv_in, params["conv_w"],
                                       params["conv_b"], state["conv"])
    x = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + N]
    Cm = conv_out[..., d_in + N:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())      # (B, 1, H)
    A = -torch.exp(params["a_log"].float())
    xh = x.reshape(-1, H, P).float()                              # (B, H, P)
    dt1 = dt[:, 0]                                                # (B, H)
    decay = torch.exp(dt1 * A)                                    # (B, H)
    inc = torch.einsum("bh,bhp,bn->bhpn", dt1, xh, Bm[:, 0].float())
    h = state["h"] * decay[..., None, None] + inc
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    y = y + params["d_skip"].float()[None, :, None] * xh
    out = _gated_out(params, y.reshape(-1, 1, d_in), z, u.dtype)
    return out, {"h": h, "conv": conv_hist}


def mamba2_chunk_step(params, u: torch.Tensor, cfg: SSMConfig, d_model: int,
                      state: dict, n_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, dict]:
    """A prefill chunk through one Mamba2 layer: u (B, C, d_model); slot b's
    tokens t < ``n_valid[b]`` advance its state, the rest hold it. Returns
    (out (B, C, d_model), new state) as ``chunk_token_scan`` over
    ``mamba2_decode_step`` would, up to fp32 reordering; out past
    ``n_valid[b]`` is garbage the caller never reads as a valid token's.
    ``state`` is not modified.

    Within the chunk, with cum_t = sum_{k<=t} dt_k A (0 for held tokens):
        h_t = exp(cum_t) h_0 + sum_{j<=t} exp(cum_t - cum_j) dt_j x_j ⊗ B_j
        y_t = exp(cum_t) C_t · h_0
              + sum_{j<=t} (C_t · B_j) exp(cum_t - cum_j) dt_j x_j + D x_t
    evaluated as batched (C, C), (C, P) and (P, C) x (C, N) products."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    Bsz, S, _ = u.shape
    K = params["conv_w"].shape[0]
    conv_in, z, dt = _project(params, u, cfg, d_model)
    ext = torch.cat([state["conv"].to(conv_in.dtype), conv_in], dim=1)
    conv_out = F.silu(_conv_taps(ext, params["conv_w"], S)
                      + as_dtype(params["conv_b"], conv_in.dtype))
    # each slot's new history: the K-1 conv inputs ending at its last valid
    # token (the old history where n_valid is 0)
    idx = (n_valid.long()[:, None]
           + torch.arange(K - 1, device=u.device)[None, :])
    conv_hist = torch.gather(ext, 1, idx[..., None].expand(-1, -1,
                                                           ext.shape[-1]))
    x = conv_out[..., :d_in].float().reshape(Bsz, S, H, P)
    Bm = conv_out[..., d_in:d_in + N].float()                     # (B, S, N)
    Cm = conv_out[..., d_in + N:].float()
    valid = (torch.arange(S, device=u.device)[None, :]
             < n_valid.to(u.device)[:, None])                     # (B, S)
    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (B, S, H)
    dt = torch.where(valid[..., None], dt, torch.zeros((), device=u.device))
    A = -torch.exp(params["a_log"].float())
    cum = torch.cumsum(dt * A, dim=1).transpose(1, 2)             # (B, H, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=u.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]                   # (B,H,S,S)
    L = torch.exp(torch.where(causal, seg,
                              torch.full((), float("-inf"),
                                         device=u.device)))
    xdt = (x * dt[..., None]).permute(0, 2, 1, 3)                 # (B,H,S,P)
    CB = Cm @ Bm.transpose(1, 2)                                  # (B, S, S)
    y = (CB[:, None] * L) @ xdt                                   # (B,H,S,P)
    h0 = state["h"].float()                                       # (B,H,P,N)
    y = y + torch.exp(cum)[..., None] * (Cm[:, None] @ h0.transpose(2, 3))
    y = y + params["d_skip"].float()[None, :, None, None] \
        * x.permute(0, 2, 1, 3)
    to_end = torch.exp(cum[..., -1:] - cum)                       # (B, H, S)
    h = (torch.exp(cum[..., -1])[..., None, None] * h0
         + (xdt * to_end[..., None]).transpose(2, 3) @ Bm[:, None])
    y = y.permute(0, 2, 1, 3).reshape(Bsz, S, d_in)
    out = _gated_out(params, y, z, u.dtype)
    return out, {"h": h, "conv": conv_hist.to(state["conv"].dtype)}
