"""Attention: GQA dimensions, parameter specs and the q/k/v projections
(port of ``repro.nn.attention`` lines 26-125). The paged serving attends
live in ``repro_torch.nn.cache``; the dense masks and ``attend`` are not
ported yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import as_dtype

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def attention_spec(d_model: int, dims: AttnDims, qkv_bias: bool = False):
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    spec = {
        "wq": ParamSpec((d_model, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d_model, kv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d_model, kv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d_model), ("heads", "embed")),
    }
    if qkv_bias:
        spec["bq"] = ParamSpec((h * hd,), ("heads",), "zeros")
        spec["bk"] = ParamSpec((kv * hd,), ("kv_heads",), "zeros")
        spec["bv"] = ParamSpec((kv * hd,), ("kv_heads",), "zeros")
    return spec


def project_qkv(params, x, dims: AttnDims, kv_x=None):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S_kv,KV,hd)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    S_kv = kv_x.shape[1]
    dt = x.dtype
    q = x @ as_dtype(params["wq"], dt)
    k = kv_x @ as_dtype(params["wk"], dt)
    v = kv_x @ as_dtype(params["wv"], dt)
    if "bq" in params:
        q = q + as_dtype(params["bq"], dt)
        k = k + as_dtype(params["bk"], dt)
        v = v + as_dtype(params["bv"], dt)
    q = q.reshape(B, S, dims.n_heads, dims.head_dim)
    k = k.reshape(B, S_kv, dims.n_kv_heads, dims.head_dim)
    v = v.reshape(B, S_kv, dims.n_kv_heads, dims.head_dim)
    return q, k, v
