"""Shared layer machinery (port of ``repro.models.common``: ``LayerCtx``,
``_mods``, ``_norm_modulate``, ``default_mask``, ``tlayer_apply``,
``two_pass_mask`` and ``tlayer_two_pass``).

Modes ported: ``train`` (the full sequence under ``ctx.mask_mod``, the
causal mask by default; the DB concat stream sets ``db_concat_mask`` and
separate rope positions), ``decode`` (one token per slot over the paged
cache, the denoising probe when ``commit`` is False) and ``prefill_chunk``
(C prompt tokens per slot appended to the paged cache and attended in one
call). ``tlayer_two_pass`` is the DB two-pass training layer: a clean
stream under the causal mask and a σ-conditioned noisy stream that attends
to the clean past and to itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import adaln
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L


@dataclasses.dataclass
class LayerCtx:
    cfg: ModelConfig
    mode: str = "decode"
    # ---- train ----
    positions: Optional[torch.Tensor] = None       # (S,) mask positions, CPU
    rope_positions: Optional[torch.Tensor] = None  # (S,) rope phases
    mask_mod: Optional[Callable] = None            # None: default_mask
    cond: Optional[torch.Tensor] = None         # (B, d) σ embedding, or None
    cond_mask: Optional[torch.Tensor] = None    # (S,) bool: where AdaLN applies
    impl: str = "kernels"                       # kernels | ref
    precision: Any = None                       # precision.Policy | None
    # ---- paged serving (nn.cache) ----
    lengths: Optional[torch.Tensor] = None      # (B,) int32 committed tokens
    page_table: Optional[torch.Tensor] = None   # (B, n_logical_pages) int32
    active: Optional[torch.Tensor] = None       # (B,) bool: slots that commit
    n_valid: Optional[torch.Tensor] = None      # (B,) prefill_chunk real toks
    commit: bool = True                         # False = denoise probe

    def dims(self) -> A.AttnDims:
        c = self.cfg
        return A.AttnDims(c.n_heads, c.n_kv_heads, c.head_dim, c.rope_theta)


def default_mask(cfg: ModelConfig, bidirectional: bool = False):
    if bidirectional:
        return A.bidirectional_mask
    if cfg.sliding_window:
        return A.sliding_window_mask(cfg.sliding_window)
    return A.causal_mask


def tlayer_spec(cfg: ModelConfig, db: bool):
    d = cfg.d_model
    dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.rope_theta)
    spec = {
        "ln1": L.norm_spec(d, cfg.norm),
        "attn": A.attention_spec(d, dims, cfg.qkv_bias),
        "ln2": L.norm_spec(d, cfg.norm),
        "mlp": L.mlp_spec(d, cfg.d_ff, cfg.mlp),
    }
    if db:
        spec["adaln"] = adaln.adaln_spec(d, n_mods=6)
    return spec


def _mods(params, ctx: LayerCtx):
    if ctx.cond is None or "adaln" not in params:
        return (None,) * 6
    return adaln.adaln_mods(params["adaln"], ctx.cond, ctx.cfg.d_model, 6)


def _norm_modulate(p_ln, h, ctx: LayerCtx, shift, scale, cond_mask):
    """norm → AdaLN modulate; under ``impl="kernels"`` the non-parametric-LN
    case with per-example ``(B, 1, d)`` mods and no ``cond_mask`` runs the
    ln-modulate kernels (one pass, differentiable), as JAX fuses it.
    Parametric norms (their weight is not applied by the kernel) and the
    cond-masked concat stream keep the plain composition."""
    if (ctx.impl == "kernels" and shift is not None and cond_mask is None
            and ctx.cfg.norm == "nonparam_ln" and shift.ndim == 3
            and shift.shape[1] == 1):
        from repro_torch.kernels import ops as kops
        return kops.ln_modulate(h, scale[:, 0], shift[:, 0])
    return adaln.modulate(L.apply_norm(p_ln, h, ctx.cfg.norm), shift, scale,
                          cond_mask)


def tlayer_apply(params, h, ctx: LayerCtx, *,
                 cache: Optional[KVC.PagedKV] = None):
    """One transformer layer: over the paged ``cache`` in the serving modes,
    over the whole sequence (no cache) in ``train``. Returns (h, cache)."""
    cfg = ctx.cfg
    dims = ctx.dims()
    s1, c1, g1, s2, c2, g2 = _mods(params, ctx)
    cm = ctx.cond_mask

    x = _norm_modulate(params["ln1"], h, ctx, s1, c1, cm)
    if ctx.mode == "train":
        attn_out, _ = A.attention_fwd(
            params["attn"], x, dims, positions=ctx.positions,
            mask_mod=ctx.mask_mod or default_mask(cfg),
            rope_positions=ctx.rope_positions, impl=ctx.impl)
    elif ctx.mode == "prefill_chunk":
        attn_out, cache = KVC.paged_prefill_attention(
            params["attn"], x, dims, cache, lengths=ctx.lengths,
            page_table=ctx.page_table, n_valid=ctx.n_valid,
            window=cfg.sliding_window, impl=ctx.impl)
    elif ctx.mode == "decode":
        attn_out, cache = KVC.paged_decode_attention(
            params["attn"], x, dims, cache, lengths=ctx.lengths,
            page_table=ctx.page_table, active=ctx.active,
            commit=ctx.commit, window=cfg.sliding_window, impl=ctx.impl)
    else:
        raise NotImplementedError(
            f"mode {ctx.mode!r}: the port has the train, paged decode and "
            "prefill_chunk modes only so far")
    h = adaln.gate(h, attn_out, g1, cm, impl=ctx.impl)

    x = _norm_modulate(params["ln2"], h, ctx, s2, c2, cm)
    mlp_out = L.apply_mlp(params["mlp"], x, cfg.mlp)
    h = adaln.gate(h, mlp_out, g2, cm, impl=ctx.impl)
    return h, cache


def two_pass_mask(seq_len: int) -> A.MaskMod:
    """Mask for two-pass DB attention: q are the S noisy tokens; keys are
    [clean(0..S-1) || noisy_diag(0..S-1)]. Noisy query i sees clean j < i and
    its own noisy key (position S+i)."""
    S = seq_len

    def mask(qpos, kpos):
        q = qpos[:, None]          # noisy query index i (0..S-1)
        k = kpos[None, :]
        clean = (k < S) & (k < q)
        self_k = k == q + S
        return clean | self_k
    mask.kernel_mask = ("two_pass", None, S)
    return mask


def tlayer_two_pass(params, h_clean, h_noisy, ctx: LayerCtx):
    """DB two-pass for an attention layer: the clean stream runs standard
    causal attention with no σ modulation; the noisy stream is modulated and
    gated by the σ conditioning and attends to the clean past and its own
    noisy key. Mask positions are ``ctx.positions`` (arange(S), on the CPU);
    rope phases come from ``ctx.rope_positions`` when set (the same arange on
    the stream's device). Returns (h_clean, h_noisy)."""
    cfg = ctx.cfg
    dims = ctx.dims()
    S = h_clean.shape[1]
    s1, c1, g1, s2, c2, g2 = _mods(params, ctx)
    pos = ctx.positions if ctx.positions is not None else torch.arange(S)
    rpos = ctx.rope_positions if ctx.rope_positions is not None else pos

    # --- attention ---
    xc = L.apply_norm(params["ln1"], h_clean, cfg.norm)         # no mods
    xn = _norm_modulate(params["ln1"], h_noisy, ctx, s1, c1, None)
    qc, kc, vc = A.project_qkv(params["attn"], xc, dims)
    qn, kn, vn = A.project_qkv(params["attn"], xn, dims)
    qc, kc, qn, kn = (L.apply_rope(t, rpos, dims.rope_theta)
                      for t in (qc, kc, qn, kn))
    base_mask = ctx.mask_mod or default_mask(cfg)
    oc = A.attend(qc, kc, vc, mask_mod=base_mask, qpos=pos, kpos=pos,
                  impl=ctx.impl)
    on = A.attend(qn, torch.cat([kc, kn], dim=1), torch.cat([vc, vn], dim=1),
                  mask_mod=two_pass_mask(S), qpos=pos,
                  kpos=torch.cat([pos, pos + S]), impl=ctx.impl)

    def proj(o):
        return o.reshape(*o.shape[:2], dims.n_heads * dims.head_dim) \
            @ L.as_dtype(params["attn"]["wo"], o.dtype)
    h_clean = h_clean + proj(oc)
    h_noisy = adaln.gate(h_noisy, proj(on), g1, impl=ctx.impl)

    # --- mlp ---
    xc = L.apply_norm(params["ln2"], h_clean, cfg.norm)
    xn = _norm_modulate(params["ln2"], h_noisy, ctx, s2, c2, None)
    h_clean = h_clean + L.apply_mlp(params["mlp"], xc, cfg.mlp)
    h_noisy = adaln.gate(h_noisy, L.apply_mlp(params["mlp"], xn, cfg.mlp),
                         g2, impl=ctx.impl)
    return h_clean, h_noisy
