"""Basic layers: linear, norms, rotary embeddings, MLP, embedding/readout
(port of ``repro.nn.layers``).

JAX casts every weight with ``.astype(x.dtype)`` inside each matmul. The
port instead expects weights already in the stream's dtype: the serving
path hands the layers a compute-dtype copy made once
(``core.blocks.DiffusionBlocksModel.params_for``). ``as_dtype`` casts only
when a direct caller passes a mismatched weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.init import ParamSpec


def as_dtype(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w if w.dtype == dtype else w.to(dtype)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear_spec(d_in: int, d_out: int, axes=("embed", "mlp"),
                bias: bool = False, init: str = "normal", scale: float = 1.0):
    spec = {"w": ParamSpec((d_in, d_out), axes, init, scale)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (axes[1],), "zeros")
    return spec


def linear(params, x):
    y = x @ as_dtype(params["w"], x.dtype)
    if "b" in params:
        y = y + as_dtype(params["b"], x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms (fp32 statistics, output in the input dtype)
# ---------------------------------------------------------------------------

def norm_spec(d: int, kind: str):
    if kind == "rmsnorm":
        return {"g": ParamSpec((d,), (None,), "ones")}
    if kind == "layernorm":
        return {"g": ParamSpec((d,), (None,), "ones"),
                "b": ParamSpec((d,), (None,), "zeros")}
    if kind == "nonparam_ln":   # OLMo: no affine params
        return {}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["g"].float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["g"].float() + params["b"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split rotation, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S), on any
    device (the training masks keep theirs on the CPU)."""
    if theta <= 0:   # architecture without rope (whisper/vit/dit)
        return x
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.to(x.device)[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / gelu)
# ---------------------------------------------------------------------------

def mlp_spec(d: int, ff: int, kind: str):
    if kind == "swiglu":
        return {
            "wi": ParamSpec((d, ff), ("embed", "mlp")),
            "wg": ParamSpec((d, ff), ("embed", "mlp")),
            "wo": ParamSpec((ff, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, ff), ("embed", "mlp")),
        "wo": ParamSpec((ff, d), ("mlp", "embed")),
    }


def apply_mlp(params, x, kind: str):
    dt = x.dtype
    if kind == "swiglu":
        h = F.silu(x @ as_dtype(params["wg"], dt)) * (
            x @ as_dtype(params["wi"], dt))
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ as_dtype(params["wi"], dt), approximate="tanh")
    return h @ as_dtype(params["wo"], dt)


# ---------------------------------------------------------------------------
# Embedding / readout
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d: int, scale: float = 0.02):
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), "embed", scale)}


def l2_normalize_embeddings(table: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """App. C: L2-normalize embedding rows (anti embedding-collapse). Row-wise,
    so normalising gathered rows equals gathering normalised rows."""
    tf = table.float()
    n = torch.sqrt((tf * tf).sum(-1, keepdim=True))
    return (table / torch.clamp(n, min=eps)).to(table.dtype)


def readout_spec(d: int, vocab: int):
    return {"w": ParamSpec((d, vocab), ("embed", "vocab"))}


def readout(params, x):
    return x @ as_dtype(params["w"], x.dtype)
