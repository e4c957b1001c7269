"""Mamba2 layer (port of ``repro.nn.ssm``): ``mamba2_spec``,
``_split_proj``, ``_causal_conv``, ``_chunk_scan``, ``mamba2_fwd`` and
``mamba2_two_pass`` (training), ``mamba2_init_state`` and
``mamba2_decode_step`` (serving), plus ``mamba2_chunk_step``, the
chunked-prefill form of the decode step.

State-space recurrence (per head, diagonal A = -exp(a_log)):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t ⊗ B_t        h: (P, N)
    y_t = C_t · h_t + D * x_t

JAX's Mamba2 is plain XLA (no ``pallas_call``), so this module is plain
torch.

``_chunk_scan`` is the chunked SSD dual form: within a chunk of Q tokens
the recurrence is a masked (Q, Q) decay tile times batched products,
between chunks the state is carried by a Python loop over the chunks (JAX's
``uscan``), so one (B, H, Q, Q) tile is live at a time in the forward.
The forward formula is JAX's, the ``LOG_EPS`` clamp included. One
deliberate difference: JAX builds the tile as ``where(mask,
exp(max(diff, LOG_EPS)), 0)``, and above the diagonal ``diff`` is a
positive sum of |dt A| that overflows ``exp`` to inf once a chunk is long
enough (zamba2-7b's chunk of 128 is); the zero cotangent that ``where``
sends there then meets inf in ``exp``'s VJP and the gradients of
``a_log``, ``dt_bias`` and ``in_proj`` turn NaN while the forward stays
finite. Here the entries off the mask are set to ``LOG_EPS`` before
``exp`` and zeroed after it, so no masked entry reaches ``exp`` above 0:
the kept entries, the forward and every gradient JAX gets finite are
JAX's, and the gradients stay finite where JAX's are not.

``mamba2_two_pass`` is the DiffusionBlocks two-pass adaptation (paper App.
E.4): the clean stream runs the standard recurrence, and each noisy token i
is one decode step from the clean state h_{i-1}, for all i at once through
the strict scan with the noisy C as the output contraction.

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

LOG_EPS = -30.0


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


def _decay_tile(cum_q: torch.Tensor, cum: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """exp(max(cum_q[i] - cum[j], LOG_EPS)) where ``mask`` keeps (i, j), 0
    elsewhere: cum_q, cum (B, H, Q) -> (B, H, Q, Q). The entries off the
    mask reach ``exp`` as LOG_EPS, so its VJP never multiplies by inf (the
    module docstring)."""
    diff = cum_q[..., :, None] - cum[..., None, :]
    eps = torch.full((), LOG_EPS, device=diff.device)
    tile = torch.exp(torch.where(mask, diff, eps).clamp_min(LOG_EPS))
    return torch.where(mask, tile, torch.zeros((), device=diff.device))


def _chunk_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, *, strict: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (B, S, H, P), dt (B, S, H), Bmat and Cmat (B, S, N);
    S is padded with zeros to a multiple of ``chunk``. ``strict`` computes
    y_i = C_i · h_{i-1} (the history without token i, decayed through i-1):
    the two-pass adapter's query, with C from the noisy stream and x, dt, B
    building the clean state. Returns (y (B, S, H, P) fp32, h_final (B, H,
    P, N) fp32). Per chunk, with cum the in-chunk cumulative sum of dt A
    (cum_q = cum, or cum less the token's own term when strict):
        y_i = sum_j (C_i · B_j) exp(cum_q[i] - cum[j]) dt_j x_j     (j ⊴ i)
              + exp(cum_q[i]) C_i · h_in
        h_out = exp(cum[-1]) h_in + sum_j exp(cum[-1] - cum[j]) dt_j x_j ⊗ B_j
    as (Q, Q), (Q, P) and (P, Q) x (Q, N) products batched over (B, H)."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    dev = x.device
    A = -torch.exp(a_log.float())                                 # (H,)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril(
        -1 if strict else 0)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc = x[:, sl].float().permute(0, 2, 1, 3)                 # (B,H,Q,P)
        dtc = dt[:, sl].float().transpose(1, 2)                   # (B,H,Q)
        Bc, Cc = Bmat[:, sl].float(), Cmat[:, sl].float()         # (B,Q,N)
        dA = dtc * A[:, None]
        cum = torch.cumsum(dA, dim=-1)
        cum_q = cum - dA if strict else cum
        xdt = xc * dtc[..., None]
        CB = Cc @ Bc.transpose(1, 2)                              # (B,Q,Q)
        y = (CB[:, None] * _decay_tile(cum_q, cum, mask)) @ xdt
        decay_in = torch.exp(cum_q.clamp_min(LOG_EPS))
        y = y + decay_in[..., None] * (Cc[:, None] @ h.transpose(2, 3))
        total = cum[..., -1:]
        to_end = torch.exp((total - cum).clamp_min(LOG_EPS))
        s_c = (xdt * to_end[..., None]).transpose(2, 3) @ Bc[:, None]
        h = torch.exp(total.clamp_min(LOG_EPS))[..., None] * h + s_c
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S]          # (B,S,H,P)
    return y, h


def _conv_split(conv_out: torch.Tensor, d_in: int, N: int):
    """The conv output [x ‖ B ‖ C] as (x, B, C)."""
    return (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
            conv_out[..., d_in + N:])


def mamba2_fwd(params, u: torch.Tensor, cfg: SSMConfig, d_model: int
               ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward from a zero state (training; JAX's ``state``
    argument, a prefill's starting state, has no caller here). u: (B, S,
    d_model). Returns (out (B, S, d_model), final state {"h", "conv"})."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    conv_in, z, dt = _project(params, u, cfg, d_model)
    conv_out, conv_hist = _causal_conv(conv_in, params["conv_w"],
                                       params["conv_b"])
    x, Bm, Cm = _conv_split(conv_out, d_in, N)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    xh = x.reshape(*x.shape[:2], H, P)
    y, h = _chunk_scan(xh, dt, params["a_log"], Bm, Cm, cfg.chunk_size)
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(*x.shape[:2], d_in), z, u.dtype)
    return out, {"h": h, "conv": conv_hist}


def mamba2_two_pass(params, u_clean: torch.Tensor, u_noisy: torch.Tensor,
                    cfg: SSMConfig, d_model: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DB two-pass adaptation of a Mamba2 layer (paper App. E.4): the clean
    stream runs the standard recurrence; noisy token i is one decode step
    from the clean state h_{i-1}:

        h_i^n = exp(dt_i^n A) h_{i-1}^clean + dt_i^n x_i^n ⊗ B_i^n
        y_i^n = C_i^n · h_i^n + D x_i^n

    C_i^n · h_{i-1}^clean comes for every i at once from the strict scan
    of the clean x, dt, B with the noisy C; the causal conv gives noisy
    token i the clean history and its own input (the pre-activation conv
    corrected by w_last (noisy_i - clean_i)). Returns (y_clean, y_noisy),
    each (B, S, d_model)."""
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    conv_c_in, zc, dtc = _project(params, u_clean, cfg, d_model)
    conv_n_in, zn, dtn = _project(params, u_noisy, cfg, d_model)
    K = params["conv_w"].shape[0]
    S = conv_c_in.shape[1]
    ext = torch.cat([conv_c_in.new_zeros((conv_c_in.shape[0], K - 1,
                                          conv_c_in.shape[-1])),
                     conv_c_in], dim=1)
    lin_c = _conv_taps(ext, params["conv_w"], S) \
        + as_dtype(params["conv_b"], conv_c_in.dtype)
    w_last = as_dtype(params["conv_w"][K - 1], conv_c_in.dtype)
    lin_n = lin_c - conv_c_in * w_last + conv_n_in * w_last
    xc, Bc, Cc = _conv_split(F.silu(lin_c), d_in, N)
    xn, Bn, Cn = _conv_split(F.silu(lin_n), d_in, N)
    bias = params["dt_bias"].float()
    dtc = F.softplus(dtc.float() + bias)
    dtn = F.softplus(dtn.float() + bias)
    A = -torch.exp(params["a_log"].float())
    d_skip = params["d_skip"].float()[None, None, :, None]
    xch = xc.reshape(*xc.shape[:2], H, P)
    xnh = xn.reshape(*xn.shape[:2], H, P)

    y_clean, _ = _chunk_scan(xch, dtc, params["a_log"], Bc, Cc,
                             cfg.chunk_size)
    y_clean = y_clean + d_skip * xch.float()
    # history query: C_i^noisy · h_{i-1}^clean
    u_hist, _ = _chunk_scan(xch, dtc, params["a_log"], Bc, Cn,
                            cfg.chunk_size, strict=True)
    decay_n = torch.exp((dtn * A).clamp_min(LOG_EPS))             # (B,S,H)
    cb_self = (Cn.float() * Bn.float()).sum(-1)                   # (B,S)
    y_noisy = (decay_n[..., None] * u_hist
               + (dtn * cb_self[..., None])[..., None] * xnh.float())
    y_noisy = y_noisy + d_skip * xnh.float()
    dtype = u_clean.dtype
    return (_gated_out(params, y_clean.reshape(*zc.shape[:2], d_in), zc,
                       dtype),
            _gated_out(params, y_noisy.reshape(*zn.shape[:2], d_in), zn,
                       dtype))


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
    x, Bm, Cm = _conv_split(conv_out, d_in, N)
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
    x, Bm, Cm = (t.float() for t in _conv_split(conv_out, d_in, N))
    x = x.reshape(Bsz, S, H, P)                                   # Bm: (B,S,N)
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
