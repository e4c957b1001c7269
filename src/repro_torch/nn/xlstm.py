"""xLSTM cells (arXiv:2405.04517), port of ``repro.nn.xlstm``: the mLSTM
(matrix memory) and the sLSTM (scalar memory with recurrent gate
connections), with the paper's stabilized exponential gating (the
log-domain max stabilizer m).

Serving runs one token at a time over a per-slot fp32 state
(``mlstm_decode_step``, ``slstm_decode_step``). Training runs the sequence
forms: the mLSTM's quadratic parallel form (``_mlstm_parallel``), its
chunked form with a (C, n, m) carry across chunks (``_mlstm_chunked``), the
strict-history query of the two-pass loss (``_mlstm_hist_raw``), the
sLSTM's scan over time (``slstm_fwd``, an eager Python loop where JAX runs
``lax.scan``), and both two-pass functions (``mlstm_two_pass``,
``slstm_two_pass``), whose noisy token i takes one step from the clean
state after tokens < i. ``mlstm_fwd`` keeps JAX's branch rule: the parallel
form iff S <= 512 and no final state is asked for.

The states are tuples, as JAX's: the mLSTM's (C (B, H, hd, hd), n (B, H,
hd), m (B, H)) and the sLSTM's (h, c (B, H, hd), n (B, H), m (B, H)), so
their leaves flatten in JAX's order and a slot spilled in JAX's
``SpilledSlot`` wire format restores into the right leaves. Not every init
value is zero (``MLSTM_INIT``, ``SLSTM_INIT``): m starts at -1e30 and the
sLSTM's n at 1e-6.

Masked exponents are NEG = -1e30, never -inf, and are masked with
``where`` before ``exp``, as JAX's: in the strict-history query a row with
no history has every entry masked and its stabilizer at -1e30, so
``exp(E - m)`` is exp(0) there, finite garbage that the two-pass combine
multiplies by an exact 0. Maxima are ``torch.amax`` and ``torch.maximum``,
whose gradients split evenly across ties as JAX's do (ties occur: at that
row the intra- and inter-chunk stabilizers are both -1e30). The mLSTM
computes in a head-major (B, H, S, S) layout where JAX's einsums use (B,
S, S, H); the values are the same up to the order of fp32 sums.

JAX's xLSTM is plain XLA (no ``pallas_call``), so this module is plain
torch.
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


def _mlstm_project(params, x: torch.Tensor, n_heads: int):
    """x: (B, S, d) -> q, k, v (B, S, H, hd) fp32, the gate logits log_i
    and log_f (B, S, H) fp32 (log f through ``logsigmoid``), and the output
    gate's pre-activation z (B, S, d_in) in x's dtype."""
    B, S, _ = x.shape
    dt = x.dtype
    d_in = params["wq"].shape[0]
    hd = d_in // n_heads
    up = x @ as_dtype(params["up"]["w"], dt)
    h, z = up[..., :d_in], up[..., d_in:]
    q, k, v = ((h @ as_dtype(params[w], dt)).reshape(B, S, n_heads, hd)
               .float() for w in ("wq", "wk", "wv"))
    gif = (h @ as_dtype(params["wif"], dt)
           + as_dtype(params["bif"], dt)).float()
    return q, k, v, gif[..., :n_heads], F.logsigmoid(gif[..., n_heads:]), z


def _mlstm_finish(params, y: torch.Tensor, z: torch.Tensor,
                  x_dtype: torch.dtype) -> torch.Tensor:
    """y (B, S, d_in) fp32 -> the RMS norm, the output gate silu(z) and the
    down projection: (B, S, d) in ``x_dtype``."""
    y = _rms_norm(y, params["norm_g"]).to(x_dtype) * F.silu(z)
    return y @ as_dtype(params["down"]["w"], x_dtype)


def mlstm_decode_step(params, x: torch.Tensor, n_heads: int,
                      cfg: XLSTMConfig, state) -> Tuple[torch.Tensor, tuple]:
    """x: (B, 1, d). The O(1) recurrent update; ``state`` is not modified.
    Returns (out (B, 1, d), new state)."""
    B = x.shape[0]
    q, k, v, log_i, log_f, z = _mlstm_project(params, x, n_heads)
    new_state, y = _mlstm_recurrent_step(state, q[:, 0], k[:, 0], v[:, 0],
                                         log_i[:, 0], log_f[:, 0])
    return _mlstm_finish(params, y.reshape(B, 1, -1), z, x.dtype), new_state


def _heads_first(*xs):
    """(B, S, H, ...) -> (B, H, S, ...) for each of ``xs``."""
    return tuple(x.transpose(1, 2) for x in xs)


def _tril(n: int, diagonal: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril(diagonal)


def _mlstm_parallel(q, k, v, log_i, log_f) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) fp32; log_i, log_f: (B, S, H). The quadratic
    stabilized form: E[t, s] = Σ_{s<r<=t} log f_r + log i_s for s <= t.
    Returns h (B, S, H, hd)."""
    S, hd = q.shape[1], q.shape[3]
    q, k, v, li, lf = _heads_first(q, k, v, log_i, log_f)
    lf_cum = torch.cumsum(lf, -1)                               # (B, H, S)
    E = lf_cum[..., :, None] - lf_cum[..., None, :] + li[..., None, :]
    E = torch.where(_tril(S, 0, q.device), E, NEG)
    m = torch.amax(E, -1)                                       # (B, H, S)
    D = torch.exp(E - m[..., None])
    Ct = (q @ k.transpose(-1, -2)) / (hd ** 0.5) * D
    n = torch.maximum(Ct.sum(-1).abs(), torch.exp(-m))
    return ((Ct @ v) / n[..., None]).transpose(1, 2)


def _mlstm_chunk(carry, qi, ki, vi, li, lf, strict: bool):
    """One chunk of Q tokens from the carry (C0 (B, H, hd, hd), n0 (B, H,
    hd), m0 (B, H)); qi, ki, vi: (B, H, Q, hd), li, lf: (B, H, Q). Each
    query reads the keys s <= t of the chunk and the carry (``strict``:
    the keys s < t, the decay through f_{t-1} only). Returns (num (B, H,
    Q, hd), den (B, H, Q) unnormalised, m (B, H, Q), the carry after the
    chunk, inclusive)."""
    C0, n0, m0 = carry
    Q, hd = qi.shape[2], qi.shape[3]
    lf_cum = torch.cumsum(lf, -1)
    lq = lf_cum - lf if strict else lf_cum
    E = lq[..., :, None] - lf_cum[..., None, :] + li[..., None, :]
    E = torch.where(_tril(Q, -1 if strict else 0, qi.device), E, NEG)
    m_inter = lq + m0[..., None]
    m_t = torch.maximum(torch.amax(E, -1), m_inter)
    D = torch.exp(E - m_t[..., None])
    Ct = (qi @ ki.transpose(-1, -2)) / (hd ** 0.5) * D
    inter_w = torch.exp(m_inter - m_t)
    num = Ct @ vi + inter_w[..., None] * (qi @ C0.transpose(-1, -2))
    den = Ct.sum(-1) + inter_w * (qi @ n0[..., None])[..., 0]
    # the carry after the chunk
    lf_tot = lf_cum[..., -1]                                    # (B, H)
    dk = lf_tot[..., None] - lf_cum + li                        # (B, H, Q)
    m_end = torch.maximum(lf_tot + m0, torch.amax(dk, -1))
    w_end = torch.exp(dk - m_end[..., None])
    k_s = ki / (hd ** 0.5)
    decay = torch.exp(lf_tot + m0 - m_end)
    C_new = (decay[..., None, None] * C0
             + (w_end[..., None] * vi).transpose(-1, -2) @ k_s)
    n_new = decay[..., None] * n0 + (w_end[..., None] * k_s).sum(-2)
    return num, den, m_t, (C_new, n_new, m_end)


def _mlstm_chunks(q, k, v, log_i, log_f, chunk: int, strict: bool):
    """``_mlstm_chunk`` over S padded to a multiple of ``chunk`` (q, k, v
    with zeros, log i with NEG, log f with 0), from the init state: (num
    (B, S, H, hd), den, m (B, S, H), the final carry)."""
    B, S, H, hd = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    q, k, v, li, lf = _heads_first(q, k, v, log_i, log_f)
    carry = mlstm_init_state(B, H, H * hd, device=q.device)
    outs = []
    for c in range(0, S + pad, chunk):
        sl = slice(c, c + chunk)
        *out, carry = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl],
                                   v[:, :, sl], li[..., sl], lf[..., sl],
                                   strict)
        outs.append(out)
    num, den, m = (torch.cat(o, 2)[:, :, :S].transpose(1, 2)
                   for o in zip(*outs))
    return num, den, m, carry


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int = 256):
    """The chunked mLSTM: the quadratic form within each chunk and the
    (C, n, m) carry across chunks, memory O(S chunk) instead of O(S^2).
    q, k, v: (B, S, H, hd) fp32; log_i, log_f: (B, S, H). Returns (h (B,
    S, H, hd), the final state)."""
    num, den, m, final = _mlstm_chunks(q, k, v, log_i, log_f, chunk,
                                       strict=False)
    den = torch.maximum(den.abs(), torch.exp(-m))
    return num / den[..., None], final


def _mlstm_hist_raw(q, k, v, log_i, log_f, chunk: int = 256):
    """The strict-history query: for each position i the stabilized triple
    (num_i (B, S, H, hd), den_i, m_i (B, S, H)) of querying q_i against the
    clean state built from the tokens j < i, decayed through f_{i-1}
    only."""
    return _mlstm_chunks(q, k, v, log_i, log_f, chunk, strict=True)[:3]


def mlstm_fwd(params, x: torch.Tensor, n_heads: int, cfg: XLSTMConfig,
              return_state: bool = False):
    """x: (B, S, d). The parallel form iff S <= 512 and no final state is
    asked for, else the chunked form. Returns (out (B, S, d), the final
    state or None)."""
    B, S, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_project(params, x, n_heads)
    if S <= 512 and not return_state:
        y, final = _mlstm_parallel(q, k, v, log_i, log_f), None
    else:
        y, final = _mlstm_chunked(q, k, v, log_i, log_f)
    return _mlstm_finish(params, y.reshape(B, S, -1), z, x.dtype), final


def mlstm_two_pass(params, x_clean: torch.Tensor, x_noisy: torch.Tensor,
                   n_heads: int, cfg: XLSTMConfig):
    """DB two-pass: the clean stream as ``mlstm_fwd``; noisy token i takes
    one stabilized mLSTM step from the clean state at i - 1 (the
    strict-history query). Returns (y_clean, y_noisy) (B, S, d)."""
    B, S, _ = x_clean.shape
    qc, kc, vc, lic, lfc, zc = _mlstm_project(params, x_clean, n_heads)
    qn, kn, vn, lin, lfn, zn = _mlstm_project(params, x_noisy, n_heads)
    hd = qc.shape[-1]
    yc = (_mlstm_parallel(qc, kc, vc, lic, lfc) if S <= 512
          else _mlstm_chunked(qc, kc, vc, lic, lfc)[0])
    num_h, den_h, m_h = _mlstm_hist_raw(qn, kc, vc, lic, lfc)
    M = torch.maximum(lfn + m_h, lin)                           # (B, S, H)
    w_hist = torch.exp(lfn + m_h - M)
    w_self = torch.exp(lin - M)
    self_score = (qn * kn).sum(-1) / (hd ** 0.5)
    num = w_hist[..., None] * num_h + (w_self * self_score)[..., None] * vn
    den = torch.maximum((w_hist * den_h + w_self * self_score).abs(),
                        torch.exp(-M))
    y_n = num / den[..., None]
    return (_mlstm_finish(params, yc.reshape(B, S, -1), zc, x_clean.dtype),
            _mlstm_finish(params, y_n.reshape(B, S, -1), zn, x_clean.dtype))


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


def _slstm_finish(params, hs: torch.Tensor,
                  x_dtype: torch.dtype) -> torch.Tensor:
    """hs: (B, S, H, hd) cell outputs -> the RMS norm and the gated MLP
    after the cell (gelu in its tanh form, as ``jax.nn.gelu``): (B, S, d)
    in ``x_dtype``."""
    B, S = hs.shape[:2]
    y = _rms_norm(hs.reshape(B, S, -1), params["norm_g"]).to(x_dtype)
    up = y @ as_dtype(params["up"]["w"], x_dtype)
    half = up.shape[-1] // 2
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return y @ as_dtype(params["down"]["w"], x_dtype)


def slstm_decode_step(params, x: torch.Tensor, n_heads: int,
                      cfg: XLSTMConfig, state) -> Tuple[torch.Tensor, tuple]:
    """x: (B, 1, d). One cell step, the norm and the gated MLP after it;
    ``state`` is not modified. Returns (out (B, 1, d), new state)."""
    xproj = (x @ as_dtype(params["wx"], x.dtype))[:, 0]
    new_state, h = _slstm_cell(params, xproj, state, n_heads)
    return _slstm_finish(params, h[:, None], x.dtype), new_state


def slstm_fwd(params, x: torch.Tensor, n_heads: int, cfg: XLSTMConfig,
              state=None, return_states: bool = False):
    """x: (B, S, d): the cell over time from ``state`` (the init state if
    None), one eager step a token where JAX runs ``lax.scan``. Returns (out
    (B, S, d), the final state), and with ``return_states`` the state
    after every step, each leaf stacked (S, B, ...)."""
    B, S, d = x.shape
    xproj = x @ as_dtype(params["wx"], x.dtype)                 # (B, S, 4d)
    if state is None:
        state = slstm_init_state(B, n_heads, d, device=x.device)
    seq = []
    for xt in xproj.unbind(1):
        state, h = _slstm_cell(params, xt, state, n_heads)
        seq.append(state if return_states else h)
    if return_states:
        states = tuple(torch.stack(leaf) for leaf in zip(*seq))
        hs = states[0]
    else:
        hs = torch.stack(seq)
    y = _slstm_finish(params, hs.transpose(0, 1), x.dtype)
    return (y, state, states) if return_states else (y, state)


def slstm_two_pass(params, x_clean: torch.Tensor, x_noisy: torch.Tensor,
                   n_heads: int, cfg: XLSTMConfig):
    """DB two-pass: the clean scan, keeping the state after every step;
    noisy token i runs one cell step from the clean state after tokens <
    i (the init state for i = 0), all S B of them as one batch of rows
    (JAX maps the cell over time). Returns (y_clean, y_noisy) (B, S,
    d)."""
    B, S, d = x_clean.shape
    y_clean, _, seq = slstm_fwd(params, x_clean, n_heads, cfg,
                                return_states=True)
    init = slstm_init_state(B, n_heads, d, device=x_clean.device)
    prev = tuple(torch.cat([i[None], s[:-1]]).flatten(0, 1)
                 for s, i in zip(seq, init))                    # (S B, ...)
    xproj = x_noisy @ as_dtype(params["wx"], x_noisy.dtype)
    _, h = _slstm_cell(params, xproj.transpose(0, 1).flatten(0, 1), prev,
                       n_heads)
    h = h.reshape(S, B, *h.shape[1:]).transpose(0, 1)
    return y_clean, _slstm_finish(params, h, x_clean.dtype)
