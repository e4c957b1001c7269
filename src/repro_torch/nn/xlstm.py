"""xLSTM cells (arXiv:2405.04517) for serving (port of ``repro.nn.xlstm``,
its serving half): the mLSTM (matrix memory) and the sLSTM (scalar memory
with recurrent gate connections), one token at a time over a per-slot fp32
state, with the paper's stabilized exponential gating (the log-domain max
stabilizer m).

The states are tuples, as JAX's: the mLSTM's (C (B, H, hd, hd), n (B, H,
hd), m (B, H)) and the sLSTM's (h, c (B, H, hd), n (B, H), m (B, H)), so
their leaves flatten in JAX's order and a slot spilled in JAX's
``SpilledSlot`` wire format restores into the right leaves. Not every init
value is zero (``MLSTM_INIT``, ``SLSTM_INIT``): m starts at -1e30 and the
sLSTM's n at 1e-6.

JAX's xLSTM is plain XLA (no ``pallas_call``), so this module is plain
torch. The sequence forms (the parallel, chunked and strict-history mLSTM,
the sLSTM scan and both two-pass functions) serve training: ROADMAP A6.3b.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import as_dtype

NEG = -1e30
MLSTM_INIT = (0.0, 0.0, NEG)             # C, n, m
SLSTM_INIT = (0.0, 0.0, 1e-6, NEG)       # h, c, n, m


def _filled(shapes, values, device) -> tuple:
    return tuple(torch.full(s, v, dtype=torch.float32, device=device)
                 for s, v in zip(shapes, values))


def _rms_norm(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """fp32 y over its RMS (eps 1e-6) times the gain ``g``."""
    var = (y * y).mean(-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * g.float()


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_spec(d_model: int, n_heads: int, cfg: XLSTMConfig):
    d_in = int(cfg.proj_factor * d_model)
    return {
        "up": {"w": ParamSpec((d_model, 2 * d_in), ("embed", "heads"))},
        "wq": ParamSpec((d_in, d_in), ("heads", "heads")),
        "wk": ParamSpec((d_in, d_in), ("heads", "heads")),
        "wv": ParamSpec((d_in, d_in), ("heads", "heads")),
        "wif": ParamSpec((d_in, 2 * n_heads), ("heads", None)),
        "bif": ParamSpec((2 * n_heads,), (None,), "zeros"),
        "norm_g": ParamSpec((d_in,), ("heads",), "ones"),
        "down": {"w": ParamSpec((d_in, d_model), ("heads", "embed"))},
    }


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f):
    """One step. state: (C (B, H, hd, hd), n (B, H, hd), m (B, H)); q, k,
    v: (B, H, hd) fp32; log_i, log_f: (B, H). Returns (new state, h (B, H,
    hd))."""
    C, n, m = state
    hd = q.shape[-1]
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    k = k / (hd ** 0.5)
    C_new = (f_p[..., None] * C
             + i_p[..., None] * v[..., :, None] * k[..., None, :])
    n_new = f_p * n + i_p * k
    num = torch.einsum("bhvk,bhk->bhv", C_new, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, q).abs(),
                        torch.exp(-m_new))
    return (C_new, n_new, m_new), num / den[..., None]


def mlstm_init_state(batch: int, n_heads: int, d_in: int,
                     device="cuda") -> tuple:
    hd = d_in // n_heads
    return _filled(((batch, n_heads, hd, hd), (batch, n_heads, hd),
                    (batch, n_heads)), MLSTM_INIT, device)


def mlstm_decode_step(params, x: torch.Tensor, n_heads: int,
                      cfg: XLSTMConfig, state) -> Tuple[torch.Tensor, tuple]:
    """x: (B, 1, d). The O(1) recurrent update; ``state`` is not modified.
    Returns (out (B, 1, d), new state)."""
    B, dt = x.shape[0], x.dtype
    d_in = params["wq"].shape[0]
    hd = d_in // n_heads
    up = x @ as_dtype(params["up"]["w"], dt)
    h, z = up[..., :d_in], up[..., d_in:]
    q, k, v = ((h @ as_dtype(params[w], dt)).reshape(B, n_heads, hd).float()
               for w in ("wq", "wk", "wv"))
    gif = (h @ as_dtype(params["wif"], dt)
           + as_dtype(params["bif"], dt)).float()
    log_i = gif[:, 0, :n_heads]
    log_f = F.logsigmoid(gif[:, 0, n_heads:])
    new_state, y = _mlstm_recurrent_step(state, q, k, v, log_i, log_f)
    y = _rms_norm(y.reshape(B, 1, d_in), params["norm_g"])
    y = y.to(dt) * F.silu(z)
    return y @ as_dtype(params["down"]["w"], dt), new_state


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_spec(d_model: int, n_heads: int, cfg: XLSTMConfig):
    hd = d_model // n_heads
    return {
        # input projections for gates i, f, z, o
        "wx": ParamSpec((d_model, 4 * d_model), ("embed", "heads")),
        # block-diagonal recurrent matrices per head, per gate
        "r": ParamSpec((4, n_heads, hd, hd), (None, "heads", None, None),
                       "normal", 1.0),
        "b": ParamSpec((4 * d_model,), ("heads",), "zeros"),
        "norm_g": ParamSpec((d_model,), (None,), "ones"),
        "up": {"w": ParamSpec((d_model, 2 * d_model), ("embed", "mlp"))},
        "down": {"w": ParamSpec((d_model, d_model), ("mlp", "embed"))},
    }


def slstm_init_state(batch: int, n_heads: int, d_model: int,
                     device="cuda") -> tuple:
    hd = d_model // n_heads
    return _filled(((batch, n_heads, hd), (batch, n_heads, hd),
                    (batch, n_heads), (batch, n_heads)), SLSTM_INIT, device)


def _slstm_cell(params, xt: torch.Tensor, state, n_heads: int):
    """xt: (B, 4 d) pre-projected inputs; state: (h, c, n, m). The gates i
    and f are one scalar a head (their mean over the head dimension).
    Returns (new state, h (B, H, hd))."""
    h, c, n, m = state
    B, hd = xt.shape[0], h.shape[2]
    rec = torch.einsum("ghij,bhj->bghi", params["r"].float(), h)
    raw = (xt.float().reshape(B, 4, n_heads, hd) + rec
           + params["b"].float().reshape(4, n_heads, hd))
    i_t, f_t, z_t, o_t = raw.unbind(1)
    i_t = i_t.mean(-1)
    log_f = F.logsigmoid(f_t.mean(-1))
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n[..., None] + i_p
    h_new = torch.sigmoid(o_t) * c_new / n_new
    return (h_new, c_new, n_new[..., 0], m_new), h_new


def slstm_decode_step(params, x: torch.Tensor, n_heads: int,
                      cfg: XLSTMConfig, state) -> Tuple[torch.Tensor, tuple]:
    """x: (B, 1, d). One cell step, the norm and the gated MLP after it
    (gelu in its tanh form, as ``jax.nn.gelu``); ``state`` is not
    modified. Returns (out (B, 1, d), new state)."""
    B, _, d = x.shape
    dt = x.dtype
    xproj = (x @ as_dtype(params["wx"], dt))[:, 0]
    new_state, h = _slstm_cell(params, xproj, state, n_heads)
    y = _rms_norm(h.reshape(B, 1, d), params["norm_g"]).to(dt)
    up = y @ as_dtype(params["up"]["w"], dt)
    half = up.shape[-1] // 2
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return y @ as_dtype(params["down"]["w"], dt), new_state
