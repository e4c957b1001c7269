"""Shared layer machinery (port of ``repro.models.common``: ``LayerCtx``,
``_mods``, ``_norm_modulate``, ``default_mask``, ``tlayer_apply``,
``two_pass_mask`` and ``tlayer_two_pass``).

Modes ported: ``train`` (the full sequence under ``ctx.mask_mod``, the
causal mask by default; the DB concat stream sets ``db_concat_mask`` and
separate rope positions), ``prefill`` (``train``'s attention over a prompt,
returning each self layer's roped (k, v) and each cross layer's projected
memory as ``{"k", "v"}``: the dense caches), ``decode`` (one token a slot:
over the paged cache at each slot's ``lengths[b]``, or over a dense cache
``{"k", "v"}`` at the scalar ``ctx.pos``; the denoising probe when
``commit`` is False) and ``prefill_chunk`` (C prompt tokens per slot
appended to the paged cache and attended in one call). ``tlayer_two_pass``
is the DB two-pass training layer: a clean stream under the causal mask
and a σ-conditioned noisy stream that attends to the clean past and to
itself.

Recurrent layers (the hybrid's Mamba2, the xLSTM's cells) keep a per-slot
state beside the pages, or in place of them: ``chunk_token_scan`` advances
one over a chunk a token at a time (the xLSTM's chunk mode, and the plain
version of the hybrid's), ``masked_state_update`` holds the inactive
slots' state and ``write_state`` writes a new state into the cache's
storage in place.

Cross layers (``tlayer_spec(cross=True)``: the VLM's tanh-gated image
attention; the encoder-decoder's cross branch, ``models.encdec``) attend in
the cached modes the slot's precomputed (k, v) conditioning block
(``write_cross_block`` projects it once at admission) under
``ctx.cond_lengths`` (``cross_cached_attn``). In ``train`` they attend
``ctx.kv_x`` (the VLM's image embeddings, the encoder-decoder's encoded
memory) through ``attention_fwd(kv_x=...)``: unmasked, no rope, the flash
kernels' ``full`` kind at Sq != Sk.

MoE layers (``tlayer_spec(moe_layer=True)``: a ``moe`` subtree in place of
``mlp``) route through ``nn.moe.moe_fwd``. In ``train`` each adds its
router's load-balance loss to ``ctx.aux`` (``add_aux``), which
``core.blocks`` reads after the units ran; the serving modes drop it, as
JAX's serving steps do.
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
from repro_torch.nn import moe as M
from repro_torch.nn.init import ParamSpec


@dataclasses.dataclass
class LayerCtx:
    cfg: ModelConfig
    mode: str = "decode"
    # ---- train ----
    positions: Optional[torch.Tensor] = None       # (S,) mask positions, CPU
    rope_positions: Optional[torch.Tensor] = None  # (S,) rope phases
    mask_mod: Optional[Callable] = None            # None: default_mask
    # cross-attention memory (the encoder's output, B, Sk, d) and its key
    # positions (Sk,) on the CPU: set by make_ctx in every mode but decode
    kv_x: Optional[torch.Tensor] = None
    kv_positions: Optional[torch.Tensor] = None
    cond: Optional[torch.Tensor] = None         # (B, d) σ embedding, or None
    cond_mask: Optional[torch.Tensor] = None    # (S,) bool: where AdaLN applies
    impl: str = "kernels"                       # kernels | ref
    precision: Any = None                       # precision.Policy | None
    # ---- dense-cache decode ----
    pos: Optional[int] = None                   # the token's position
    kv_chunk: int = 1024                        # key tile past 4096 keys
    # ---- paged serving (nn.cache) ----
    lengths: Optional[torch.Tensor] = None      # (B,) int32 committed tokens
    page_table: Optional[torch.Tensor] = None   # (B, n_logical_pages) int32
    active: Optional[torch.Tensor] = None       # (B,) bool: slots that commit
    n_valid: Optional[torch.Tensor] = None      # (B,) prefill_chunk real toks
    # (B,) int32 valid tokens of each slot's cross (conditioning) block; 0 =
    # unconditioned (the cross term is exactly 0); None reads the whole block
    cond_lengths: Optional[torch.Tensor] = None
    commit: bool = True                         # False = denoise probe
    # the MoE routers' load-balance loss summed over the layers run in
    # ``train`` (fp32 0-dim), None until a MoE layer adds to it
    aux: Optional[torch.Tensor] = None

    def dims(self) -> A.AttnDims:
        c = self.cfg
        return A.AttnDims(c.n_heads, c.n_kv_heads, c.head_dim, c.rope_theta)

    def add_aux(self, aux: torch.Tensor) -> None:
        """Add a MoE layer's aux loss to ``self.aux`` in ``train``; the
        serving modes drop it."""
        if self.mode == "train":
            self.aux = aux if self.aux is None else self.aux + aux


def chunk_token_scan(step_fn, x, state, n_valid):
    """Advance a recurrent layer over a prefill chunk one token at a time,
    as JAX's ``lax.scan`` does: ``step_fn(x_t (B, 1, d), state) -> (y_t
    (B, 1, d), new_state)``; slots whose valid tokens ran out (t >=
    ``n_valid[b]``) hold their state. Functional: ``state`` is not
    modified. Returns (y (B, C, d), final state). The plain version of
    ``nn.ssm.mamba2_chunk_step`` (the hybrid's chunk mode), kept for the
    tests and for recurrences without a closed chunk form."""
    ys = []
    for t in range(x.shape[1]):
        y_t, new = step_fn(x[:, t:t + 1], state)
        state = masked_state_update(new, state, t < n_valid)
        ys.append(y_t[:, 0])
    return torch.stack(ys, dim=1), state


def masked_state_update(new_state, old_state, active):
    """Per-slot recurrent-state commit mask for ragged and continuous
    batching: inactive slots keep their old state. Leaves lead with the
    slot axis (B, ...). Functional; paged KV needs no such mask (inactive
    appends go to the trash page)."""
    if active is None or old_state is None:
        return new_state
    if isinstance(new_state, dict):
        return {k: masked_state_update(n, old_state[k], active)
                for k, n in new_state.items()}
    if isinstance(new_state, tuple):
        return tuple(masked_state_update(n, o, active)
                     for n, o in zip(new_state, old_state))
    return torch.where(active.reshape((-1,) + (1,) * (new_state.ndim - 1)),
                       new_state, old_state)


def write_state(dst, new) -> None:
    """Copy a new per-slot state tree (dicts and tuples of tensors) into
    ``dst``'s storage, in place: a captured CUDA graph holds the state's
    addresses, as it holds the pool's pages."""
    if isinstance(dst, dict):
        for k, t in dst.items():
            write_state(t, new[k])
    elif isinstance(dst, tuple):
        for t, n in zip(dst, new):
            write_state(t, n)
    else:
        dst.copy_(new)


def default_mask(cfg: ModelConfig, bidirectional: bool = False):
    if bidirectional:
        return A.bidirectional_mask
    if cfg.sliding_window:
        return A.sliding_window_mask(cfg.sliding_window)
    return A.causal_mask


# ---------------------------------------------------------------------------
# Cross-attention over per-slot conditioning blocks (image or audio memory)
# ---------------------------------------------------------------------------

def cross_cached_attn(p, x, ctx: LayerCtx, cache):
    """Cross-attention of x (B, S, d) over the slot's precomputed (k, v)
    conditioning block ``cache`` (B, Sk, KV, hd), masked to
    ``ctx.cond_lengths`` (None: the whole block). Only q is projected: JAX's ``project_qkv`` also
    computes k and v from x and drops them. Returns (B, S, d)."""
    dims = ctx.dims()
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ L.as_dtype(p["wq"], dt)
    if "bq" in p:
        q = q + L.as_dtype(p["bq"], dt)
    q = q.reshape(B, S, dims.n_heads, dims.head_dim)
    lens = ctx.cond_lengths
    if lens is None:
        lens = torch.full((B,), cache["k"].shape[1], dtype=torch.int32,
                          device=x.device)
    out = KVC.cross_attend(q, cache["k"].to(dt), cache["v"].to(dt), lens)
    out = out.reshape(B, S, dims.n_heads * dims.head_dim)
    return out @ L.as_dtype(p["wo"], dt)


def project_cross_kv(p, cond, dims: A.AttnDims):
    """Project conditioning embeddings (B, Sk, d) into a cross block's
    (k, v) (B, Sk, KV, hd): the admission-time half of
    ``cross_cached_attn``, in cond's dtype."""
    B, Sk, _ = cond.shape
    k = cond @ L.as_dtype(p["wk"], cond.dtype)
    v = cond @ L.as_dtype(p["wv"], cond.dtype)
    if "bk" in p:
        k = k + L.as_dtype(p["bk"], cond.dtype)
        v = v + L.as_dtype(p["bv"], cond.dtype)
    return (k.reshape(B, Sk, dims.n_kv_heads, dims.head_dim),
            v.reshape(B, Sk, dims.n_kv_heads, dims.head_dim))


@torch.no_grad()
def write_cross_block(cross_cache, cross_params, cond, dims: A.AttnDims,
                      slot=None):
    """Write projected conditioning into the per-slot cross blocks, IN
    PLACE (a captured decode segment holds their addresses).

    cross_cache: {"k", "v"} (n_units, num_slots, block, KV, hd);
    cross_params: the stacked per-unit cross-attention params (leading
    n_units axis); cond: (B, Sk, d) with Sk <= block. ``slot=None`` needs
    B == num_slots and writes every slot; an int ``slot`` writes that
    slot's row, B == 1. The whole row is written (zeros past Sk), so a
    recycled slot never sees its previous occupant's tail. Unit by unit,
    so the fp32 projection of one unit is the largest transient."""
    n_units, num_slots, cap = cross_cache["k"].shape[:3]
    B, Sk = cond.shape[:2]
    if Sk > cap:
        raise ValueError(f"conditioning length {Sk} exceeds the block "
                         f"capacity {cap}")
    if slot is None and B != num_slots:
        raise ValueError(
            f"set_conditioning(slot=None) writes every slot: cond batch {B} "
            f"!= num_slots {num_slots}")
    if slot is not None and B != 1:
        raise ValueError(f"set_conditioning(slot={slot}) writes one slot: "
                         f"cond batch {B} != 1")
    rows = slice(None) if slot is None else slice(int(slot), int(slot) + 1)
    for u in range(n_units):
        p = {k: t[u] for k, t in cross_params.items()}
        k, v = project_cross_kv(p, cond, dims)
        for name, new in (("k", k), ("v", v)):
            dst = cross_cache[name][u, rows]
            dst[:, :Sk].copy_(new)
            dst[:, Sk:].zero_()
    return cross_cache


def tlayer_spec(cfg: ModelConfig, db: bool, *, cross: bool = False,
                moe_layer: bool = False):
    d = cfg.d_model
    dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.rope_theta)
    spec = {
        "ln1": L.norm_spec(d, cfg.norm),
        "attn": A.attention_spec(d, dims, cfg.qkv_bias),
        "ln2": L.norm_spec(d, cfg.norm),
    }
    if moe_layer:
        spec["moe"] = M.moe_spec(d, cfg.d_ff, cfg.moe, cfg.mlp)
    else:
        spec["mlp"] = L.mlp_spec(d, cfg.d_ff, cfg.mlp)
    if db:
        spec["adaln"] = adaln.adaln_spec(d, n_mods=6)
    if cross:
        # the tanh gate of the cross-attention output (llama-3.2-vision),
        # zero at init: a fresh cross layer contributes nothing
        spec["xgate"] = ParamSpec((1,), (None,), "zeros")
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


def _mlp(params, x, ctx: LayerCtx, moe_layer: bool):
    """The layer's MLP, or its MoE with the aux loss added to ``ctx``."""
    if not moe_layer:
        return L.apply_mlp(params["mlp"], x, ctx.cfg.mlp)
    out, aux = M.moe_fwd(params["moe"], x, ctx.cfg.moe, ctx.cfg.mlp)
    ctx.add_aux(aux)
    return out


def tlayer_apply(params, h, ctx: LayerCtx, *, cross: bool = False,
                 moe_layer: bool = False, cache=None):
    """One transformer layer: over the whole sequence (no cache) in
    ``train`` and ``prefill``, over ``cache`` in ``decode`` (a PagedKV, or
    a dense ``{"k", "v"}`` read at ``ctx.pos``) and ``prefill_chunk``. A
    ``cross`` layer attends the slot's conditioning block ``cache`` ({"k",
    "v"}) in the cached modes and ``ctx.kv_x`` otherwise, its output
    through the tanh gate ``xgate``. A ``moe_layer`` routes its MLP through
    ``nn.moe`` (the aux loss to ``ctx.add_aux``). Returns (h, cache): in
    ``prefill`` the layer's new dense cache {"k", "v"} (the self layer's
    roped keys, the cross layer's projected memory), else the cache it was
    given."""
    cfg = ctx.cfg
    dims = ctx.dims()
    s1, c1, g1, s2, c2, g2 = _mods(params, ctx)
    cm = ctx.cond_mask

    x = _norm_modulate(params["ln1"], h, ctx, s1, c1, cm)
    if cross:
        if cache is not None and ctx.mode in ("decode", "prefill_chunk"):
            attn_out = cross_cached_attn(params["attn"], x, ctx, cache)
        elif ctx.mode not in ("train", "prefill"):
            raise NotImplementedError(
                f"cross-attention layer in mode {ctx.mode!r} without its "
                "cache")
        elif ctx.kv_x is None:
            raise ValueError(
                "cross-attention layer with no conditioning memory: pass "
                "aux_inputs (image_embs) on the training and prefill paths; "
                "the serving engines admit unconditioned requests with "
                "cond_lengths=0")
        else:
            attn_out, (k, v) = A.attention_fwd(
                params["attn"], x, dims, positions=ctx.positions,
                mask_mod=None, kv_x=ctx.kv_x,
                kv_positions=ctx.kv_positions, impl=ctx.impl)
            if ctx.mode == "prefill":
                cache = {"k": k, "v": v}
        attn_out = attn_out * torch.tanh(L.as_dtype(params["xgate"],
                                                    attn_out.dtype))
    elif ctx.mode in ("train", "prefill"):
        attn_out, (k, v) = A.attention_fwd(
            params["attn"], x, dims, positions=ctx.positions,
            mask_mod=ctx.mask_mod or default_mask(cfg),
            rope_positions=ctx.rope_positions, impl=ctx.impl)
        if ctx.mode == "prefill":
            cache = {"k": k, "v": v}
    elif ctx.mode == "prefill_chunk":
        attn_out, cache = KVC.paged_prefill_attention(
            params["attn"], x, dims, cache, lengths=ctx.lengths,
            page_table=ctx.page_table, n_valid=ctx.n_valid,
            window=cfg.sliding_window, impl=ctx.impl)
    elif ctx.mode == "decode":
        attn_out, cache = decode_self(params["attn"], x, ctx, cache,
                                      cfg.sliding_window)
    else:
        raise ValueError(f"unknown mode {ctx.mode!r}")
    h = adaln.gate(h, attn_out, g1, cm, impl=ctx.impl)

    x = _norm_modulate(params["ln2"], h, ctx, s2, c2, cm)
    h = adaln.gate(h, _mlp(params, x, ctx, moe_layer), g2, cm,
                   impl=ctx.impl)
    return h, cache


def decode_self(p, x, ctx: LayerCtx, cache, window):
    """One token's self-attention in ``decode``: over the paged pool at
    each slot's ``ctx.lengths[b]``, or over the dense cache at ``ctx.pos``.
    Appends (writes) the token's k/v only when ``ctx.commit``. Returns
    (out, cache)."""
    if isinstance(cache, KVC.PagedKV):
        return KVC.paged_decode_attention(
            p, x, ctx.dims(), cache, lengths=ctx.lengths,
            page_table=ctx.page_table, active=ctx.active,
            commit=ctx.commit, window=window, impl=ctx.impl)
    return A.decode_attention(p, x, ctx.dims(), cache, ctx.pos,
                              window=window, kv_chunk=ctx.kv_chunk,
                              impl=ctx.impl, commit=ctx.commit)


def zip_caches(fn, caches: list):
    """``fn`` (``torch.stack`` or ``torch.cat``) over the matching leaves
    of alike cache trees (dicts and tuples of tensors): ``prefill`` stacks
    the units' dense caches on a new unit axis, as JAX's scans stack them,
    and joins the blocks' on that axis."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: zip_caches(fn, [c[k] for c in caches]) for k in first}
    if isinstance(first, tuple):
        return tuple(zip_caches(fn, [c[i] for c in caches])
                     for i in range(len(first)))
    return fn(caches)


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


def tlayer_two_pass(params, h_clean, h_noisy, ctx: LayerCtx, *,
                    moe_layer: bool = False):
    """DB two-pass for an attention layer: the clean stream runs standard
    causal attention with no σ modulation; the noisy stream is modulated and
    gated by the σ conditioning and attends to the clean past and its own
    noisy key. Mask positions are ``ctx.positions`` (arange(S), on the CPU);
    rope phases come from ``ctx.rope_positions`` when set (the same arange on
    the stream's device). A ``moe_layer`` routes each stream through the
    MoE on its own and adds both aux losses to ``ctx``. Returns (h_clean,
    h_noisy)."""
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
    h_clean = h_clean + _mlp(params, xc, ctx, moe_layer)
    h_noisy = adaln.gate(h_noisy, _mlp(params, xn, ctx, moe_layer), g2,
                         impl=ctx.impl)
    return h_clean, h_noisy
