"""Attention: GQA dimensions, parameter specs, the q/k/v projections, the
dense masks, the full-sequence attention of training and prefill, and the
one-token decode over a dense KV cache (port of ``repro.nn.attention``).
The paged serving attends live in ``repro_torch.nn.cache``.

``attend`` takes ``impl="kernels"`` (the flash-attention kernels through
``kernels.ops``; their plain versions on CPU tensors) or ``impl="ref"``
(``naive_attention``). Mask positions are CPU tensors: they only describe
the mask (the kernels rebuild it from indices), so checking them never
waits on the card. ``chunked_attention`` is JAX's two-level online-softmax
attend in plain torch: the reference route of a dense decode over more
than 4096 keys takes it, as JAX's does.

``decode_attention`` reads a dense cache ``{"k", "v"}`` (B, C, KV, hd),
a ring of C == window slots for a sliding window, and writes the token's
k/v IN PLACE at slot ``pos`` (``pos % C`` on a ring) when ``commit`` is
set; a denoising probe leaves the cache untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

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


def chunked_attention(q, k, v, mask_mod: Optional[MaskMod], qpos, kpos,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash-style two-level chunked attention with an online softmax, in
    fp32 (JAX's ``chunked_attention``): never more than one (q_chunk,
    kv_chunk) score tile per (slot, head). q (B, Sq, H, hd), k/v (B, Sk,
    KV, hd); ``qpos`` (Sq,) and ``kpos`` (Sk,) feed ``mask_mod`` (None:
    every real key). Padding queries repeat the last position; padding keys
    carry the sentinel position -1e9, and any key at or below -1e8 is not
    attended. As in JAX, a row that met only masked keys so far carries a
    running max of NEG_INF, so the first real key's correction wipes what
    it summed. Returns q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    pad_q, pad_k = (-Sq) % qc, (-Sk) % kc
    qpos, kpos = torch.as_tensor(qpos), torch.as_tensor(kpos)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        qpos = torch.cat([qpos, qpos[-1:].expand(pad_q)])
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = torch.cat([kpos, torch.full((pad_k,), -10**9,
                                           dtype=kpos.dtype,
                                           device=kpos.device)])
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for i in range(q.shape[1] // qc):
        qi = q[:, i * qc:(i + 1) * qc].float().reshape(B, qc, KV, G, hd)
        qp = qpos[i * qc:(i + 1) * qc]
        m = torch.full((B, KV, G, qc), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, qc), device=dev)
        acc = torch.zeros((B, KV, G, qc, hd), device=dev)
        for j in range(k.shape[1] // kc):
            ks = slice(j * kc, (j + 1) * kc)
            kp = kpos[ks]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, k[:, ks].float()) \
                * scale
            valid = kp > -(10 ** 8)
            if mask_mod is not None:
                valid = mask_mod(qp, kp) & valid[None, :]
            s = torch.where(valid.to(dev), s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v[:, ks].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))        # (B, qc, KV, G, hd)
    out = torch.cat(outs, dim=1).reshape(B, -1, H, hd)
    return out[:, :Sq].to(q.dtype)


def chunked_attention_triangle(q, k, v, mask_mod, qpos, kpos,
                               q_chunk: int = 1024, kv_chunk: int = 1024):
    """Causal ``chunked_attention`` that never computes a tile wholly in
    the future: query chunk i attends keys [0, (i + 1) q_chunk) only (JAX's
    ``chunked_attention_triangle``). Needs Sq == Sk, Sq a multiple of the
    chunk and ascending aranges for positions."""
    Sq, Sk = q.shape[1], k.shape[1]
    qc = min(q_chunk, Sq)
    if Sq % qc or Sq != Sk:
        raise ValueError(f"triangle path: aligned causal attention only, "
                         f"got Sq={Sq}, Sk={Sk}, chunk {qc}")
    outs = []
    for i in range(Sq // qc):
        hi = (i + 1) * qc
        outs.append(chunked_attention(
            q[:, i * qc:hi], k[:, :hi], v[:, :hi], mask_mod,
            qpos[i * qc:hi], kpos[:hi], qc, kv_chunk))
    return torch.cat(outs, dim=1)


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


# ---------------------------------------------------------------------------
# Dense KV cache: one-token decode (the dry-run and reference serving path)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, dims: AttnDims,
                  dtype=torch.bfloat16, n_units=(), device="cuda") -> dict:
    """Zeroed ``{"k", "v"}`` of shape (*n_units, batch, cache_len, KV,
    hd): ``n_units`` prepends the stacked unit axes."""
    shape = tuple(n_units) + (batch, cache_len, dims.n_kv_heads,
                              dims.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name in ("k", "v")}


def _valid_mask(qpos, kpos):
    """Every key whose position is not the -1e9 sentinel."""
    return (kpos > -10**9)[None, :].expand(qpos.shape[0], -1)


def decode_attention(params, x, dims: AttnDims, cache, pos: int, *,
                     window: Optional[int] = None, kv_chunk: int = 2048,
                     impl: str = "kernels", commit: bool = True):
    """One-token decode over a dense cache. x: (B, 1, d); cache["k"/"v"]:
    (B, C, KV, hd); ``pos`` (a Python int) is the token's absolute
    position, rope phase and slot (``pos % C`` on a sliding window's ring
    of C == window slots, where slot i holds the latest position p with
    p % C == i). Without a window, ``pos`` must be below C.

    ``impl="ref"``: JAX's masked attend over the cache with the fresh
    token at its slot (a copy, the cache itself is not written), naive up
    to 4096 keys, ``chunked_attention`` (q chunk 1, ``kv_chunk``) past
    that. ``impl="kernels"``: the committed tokens through the
    flash-decode kernel over the cache viewed as pages
    (``cache.dense_to_paged``: one page of C keys a slot, no copy) with
    lengths ``pos``, the fresh (k, v) folded in by ``combine_self``. A ring
    is first un-rotated into absolute order (a copy of the ring): its last
    L = min(pos, window - 1, C - 1) committed keys at [0, L), so the
    kernel's length mask is the window (C == window: JAX's
    min(pos, window - 1, C); on a ring shorter than the window the slot the
    token overwrites is left out, as the reference route leaves it out).

    With ``commit`` the token's k/v are written at its slot, in place,
    after the attend; a denoising probe (``commit=False``) writes nothing.
    Returns (out (B, 1, d), cache)."""
    from repro_torch.nn import cache as KVC          # import cycle
    B = x.shape[0]
    C = cache["k"].shape[1]
    if window is None and not 0 <= pos < C:
        raise ValueError(f"decode at position {pos} past a dense cache of "
                         f"{C} slots")
    KV, G, hd = dims.n_kv_heads, dims.q_per_kv, dims.head_dim
    q, k, v = project_qkv(params, x, dims)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, dims.rope_theta)
    k = apply_rope(k, posv, dims.rope_theta)
    slot = pos % C if window is not None else pos
    ck, cv = cache["k"], cache["v"]
    if impl == "kernels":
        if window is not None:
            n = min(pos, window - 1, C - 1)
            shift = (n - pos) % C
            k_lin, v_lin = torch.roll(ck, shift, 1), torch.roll(cv, shift, 1)
        else:
            n, k_lin, v_lin = pos, ck, cv
        pages, table = KVC.dense_to_paged(k_lin, v_lin)
        lengths = torch.full((B,), n, dtype=torch.int32, device=x.device)
        out = KVC.attend_paged(q[:, 0].reshape(B, KV, G, hd), pages, table,
                               lengths, k[:, 0], v[:, 0],
                               impl=impl).to(q.dtype)
    elif impl == "ref":
        idx = torch.arange(C, device=x.device)
        here = (idx == slot)[None, :, None, None]
        k_all = torch.where(here, k.to(ck.dtype), ck).to(q.dtype)
        v_all = torch.where(here, v.to(cv.dtype), cv).to(q.dtype)
        if window is not None:
            abs_pos = pos - (pos - idx) % C
            valid = (abs_pos >= 0) & (abs_pos > pos - window)
        else:
            valid = idx <= pos
        if C > 4096:
            kpos = torch.where(valid, idx, torch.full_like(idx, -10**9))
            out = chunked_attention(q, k_all, v_all, _valid_mask, posv,
                                    kpos, 1, kv_chunk)
        else:
            out = naive_attention(q, k_all, v_all, valid[None, :])
    else:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if commit:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
    out = out.reshape(B, 1, dims.n_heads * hd)
    return out @ as_dtype(params["wo"], x.dtype), cache
