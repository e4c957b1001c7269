"""Attention: GQA dimensions, parameter specs, the q/k/v projections, the
dense masks and the full-sequence attention of training (port of
``repro.nn.attention``). The paged serving attends live in
``repro_torch.nn.cache``.

``attend`` takes ``impl="kernels"`` (the flash-attention kernels through
``kernels.ops``; their plain versions on CPU tensors) or ``impl="ref"``
(``naive_attention``). Mask positions are CPU tensors: they only describe
the mask (the kernels rebuild it from indices), so checking them never
waits on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import apply_rope, as_dtype

NEG_INF = -1e30
IMPLS = ("kernels", "ref")

MaskMod = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


# ---------------------------------------------------------------------------
# Masks: (qpos, kpos) -> (Sq, Sk) bool, each tagged with its kernel mask
# ---------------------------------------------------------------------------

def causal_mask(qpos, kpos):
    return kpos[None, :] <= qpos[:, None]


causal_mask.lower_tri = True   # every attended key satisfies kp <= qp
# (kind, window, mask_seq) routing tag for the kernels (kernels/ops.py)
causal_mask.kernel_mask = ("causal", None, None)


def sliding_window_mask(window: int):
    def mask(qpos, kpos):
        k, q = kpos[None, :], qpos[:, None]
        return (k <= q) & (k > q - window)
    mask.lower_tri = True
    mask.kernel_mask = ("window", window, None)
    return mask


def bidirectional_mask(qpos, kpos):
    return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)


bidirectional_mask.kernel_mask = ("full", None, None)


def db_concat_mask(seq_len: int) -> MaskMod:
    """Paper App. E.4 causal-consistency mask for [clean || noisy] sequences:
    positions 0..S-1 are clean tokens, S..2S-1 noisy (S+i is the noisy copy
    of token i). Clean i attends causally to clean j <= i; noisy i+S attends
    to clean j < i (never clean token i, the denoising target) and to
    itself."""
    S = seq_len

    def mask(qpos, kpos):
        q = qpos[:, None]
        k = kpos[None, :]
        q_clean = q < S
        k_clean = k < S
        clean_clean = q_clean & k_clean & (k <= q)
        noisy_clean = (~q_clean) & k_clean & (k < q - S)
        noisy_self = (~q_clean) & (k == q)
        return clean_clean | noisy_clean | noisy_self
    mask.lower_tri = True
    mask.kernel_mask = ("db_concat", None, S)
    return mask


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
    # JAX casts the weights to x's dtype and promotes: an fp32 memory under
    # a bf16 stream gives fp32 k and v
    kt = torch.promote_types(dt, kv_x.dtype)
    q = x @ as_dtype(params["wq"], dt)
    k = kv_x.to(kt) @ as_dtype(params["wk"], dt).to(kt)
    v = kv_x.to(kt) @ as_dtype(params["wv"], dt).to(kt)
    if "bq" in params:
        q = q + as_dtype(params["bq"], dt)
        k = k + as_dtype(params["bk"], dt).to(kt)
        v = v + as_dtype(params["bv"], dt).to(kt)
    q = q.reshape(B, S, dims.n_heads, dims.head_dim)
    k = k.reshape(B, S_kv, dims.n_kv_heads, dims.head_dim)
    v = v.reshape(B, S_kv, dims.n_kv_heads, dims.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence attention (GQA-aware)
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference: q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask (Sq, Sk) bool or
    None. fp32 scores and softmax; returns q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if mask is not None:
        scores = torch.where(mask.to(scores.device)[None, None, None],
                             scores, torch.full((), NEG_INF,
                                                device=scores.device))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attend(q, k, v, *, mask_mod: Optional[MaskMod], qpos, kpos,
           impl: str = "kernels"):
    """``kernels``: the flash-attention kernels (``mask_mod=None`` means
    unmasked); ``ref``: ``naive_attention`` with the mask built from the
    positions. q of another dtype than k and v (a bf16 stream over an fp32
    memory) attends in the wider one, as JAX promotes; the output keeps
    q's dtype."""
    ct = torch.promote_types(q.dtype, k.dtype)
    if ct != q.dtype or ct != k.dtype:
        return attend(q.to(ct), k.to(ct), v.to(ct), mask_mod=mask_mod,
                      qpos=qpos, kpos=kpos, impl=impl).to(q.dtype)
    if impl == "kernels":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, mask_mod=mask_mod, qpos=qpos,
                                    kpos=kpos)
    if impl == "ref":
        mask = mask_mod(qpos, kpos) if mask_mod is not None else None
        return naive_attention(q, k, v, mask)
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def attention_fwd(params, x, dims: AttnDims, *, positions, mask_mod,
                  kv_x=None, kv_positions=None, rope_positions=None,
                  impl: str = "kernels"):
    """Full-sequence attention (training). Returns (out, (k, v)).

    ``positions`` drive the mask; ``rope_positions`` (default: positions)
    drive the rotary phases. They differ for the DB clean||noisy concat
    stream, where the noisy copy of token i sits at mask position S+i but
    rope position i.

    Cross-attention (``kv_x`` (B, Sk, d) given): q from ``x``, k and v from
    ``kv_x``, key positions ``kv_positions`` (default: ``positions``), and
    no rope on either side whatever ``rope_theta`` is: the memory has no
    positions relative to the text stream, and the serving path reads the
    precomputed (k, v) block with unroped queries. ``mask_mod=None`` is
    unmasked (the kernels' ``full`` kind, Sq != Sk)."""
    q, k, v = project_qkv(params, x, dims, kv_x)
    rpos = positions if rope_positions is None else rope_positions
    kpos = positions if kv_positions is None else kv_positions
    if kv_x is None:
        q = apply_rope(q, rpos, dims.rope_theta)
        k = apply_rope(k, rpos, dims.rope_theta)
    out = attend(q, k, v, mask_mod=mask_mod, qpos=positions, kpos=kpos,
                 impl=impl)
    out = out.reshape(*x.shape[:2], dims.n_heads * dims.head_dim)
    return out @ as_dtype(params["wo"], x.dtype), (k, v)
