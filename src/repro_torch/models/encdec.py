"""Whisper-style encoder-decoder, the audio family (port of
``repro.models.encdec``).

The mel-spectrogram and conv frontend is stubbed, as in JAX: requests carry
frame embeddings, ``audio_embs`` (n_frames, d). The encoder (bidirectional
self-attention layers under the kernels' ``full`` kind, then ``enc_norm``)
runs clean as conditioning; DiffusionBlocks partitions the decoder stack
only, and the encoder and ``enc_norm`` are shared periphery (outside
``core.training.STACK_KEYS``), so every block's step trains them.

A decoder layer is self-attention, cross-attention over the encoder's
memory and an MLP. In DB mode the self-attention and MLP branches are
AdaLN-modulated on σ; the cross branch is neither modulated nor gated (it
carries the conditioning). As in JAX, the decoder gates in plain ops
(``adaln.gate(..., impl="ref")``: JAX's ``encdec`` calls ``adaln.gate`` with
no ``impl``), and its norm is the parametric LayerNorm, so it reaches no
gate-residual or ln-modulate kernel; its attention runs through the flash
kernels (self: causal, db_concat, two_pass; cross: ``full`` with Sq != Sk).

Params (JAX's tree): ``encoder`` (n_encoder_layers, ...) of
``common.tlayer_spec``, ``enc_norm``, ``layers`` (n_layers, ...) of
``dlayer_spec``. The serving cache is ``{"self": PagedKV (n_layers, P,
psz, KV, hd), "cross": {"k", "v"} (n_layers, num_slots, n_audio_frames,
KV, hd)}``: the decoder's history is paged, each slot's audio block is
projected once at admission (``set_conditioning``) and read under
``ctx.cond_lengths``. The dense cache (``init_cache``) has the same
layout with the decoder's keys in ``{"k", "v"}`` (n_layers, slots, C, KV,
hd); ``prefill`` returns each layer's self (k, v) over the prompt and its
projected memory. The encoder mixes every frame into every frame, so a
zero-padded batch does not encode each row as its unpadded self
(``cond_padding_safe`` False): ragged audio is served through the
continuous batcher, which encodes each request alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import precision as precision_mod
from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.models.transformer import (_dims, _index, _prefilled,
                                           _unbind, _unit_views)
from repro_torch.nn import adaln
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L
from repro_torch.nn.init import stack_specs


def dlayer_spec(cfg, db: bool):
    d = cfg.d_model
    dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.rope_theta)
    spec = {
        "ln1": L.norm_spec(d, cfg.norm),
        "attn": A.attention_spec(d, dims, cfg.qkv_bias),
        "lnx": L.norm_spec(d, cfg.norm),
        "xattn": A.attention_spec(d, dims, cfg.qkv_bias),
        "ln2": L.norm_spec(d, cfg.norm),
        "mlp": L.mlp_spec(d, cfg.d_ff, cfg.mlp),
    }
    if db:
        spec["adaln"] = adaln.adaln_spec(d, n_mods=6)
    return spec


def _self_attn(p, x, ctx: C.LayerCtx, cache):
    """The decoder's self-attention: over ``cache`` in the serving modes
    (paged or, in ``decode``, dense at ``ctx.pos``), over the whole
    sequence (causal unless ``ctx.mask_mod``) in ``train`` and ``prefill``.
    Returns (out, cache): in ``prefill`` the layer's {"k", "v"}."""
    dims = ctx.dims()
    if ctx.mode == "prefill_chunk":
        return KVC.paged_prefill_attention(
            p, x, dims, cache, lengths=ctx.lengths,
            page_table=ctx.page_table, n_valid=ctx.n_valid, impl=ctx.impl)
    if ctx.mode == "decode":
        return C.decode_self(p, x, ctx, cache, None)
    if ctx.mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {ctx.mode!r}")
    out, (k, v) = A.attention_fwd(p, x, dims, positions=ctx.positions,
                                  mask_mod=ctx.mask_mod or A.causal_mask,
                                  rope_positions=ctx.rope_positions,
                                  impl=ctx.impl)
    return out, ({"k": k, "v": v} if ctx.mode == "prefill" else None)


def _cross_attn(p, x, ctx: C.LayerCtx, cache):
    """Cross-attention over the encoder's memory: the slot's precomputed
    block in the serving modes, ``ctx.kv_x`` in ``train`` and ``prefill``.
    Returns (out, cache): in ``prefill`` the projected memory {"k", "v"}."""
    if cache is not None and ctx.mode in ("decode", "prefill_chunk"):
        return C.cross_cached_attn(p, x, ctx, cache), cache
    if ctx.kv_x is None:
        raise ValueError(
            "cross-attention layer with no conditioning memory: pass "
            "aux_inputs (audio_embs) on the training and prefill paths; the "
            "serving engines admit unconditioned requests with "
            "cond_lengths=0")
    out, (k, v) = A.attention_fwd(p, x, ctx.dims(), positions=ctx.positions,
                                  mask_mod=None, kv_x=ctx.kv_x,
                                  kv_positions=ctx.kv_positions,
                                  impl=ctx.impl)
    return out, ({"k": k, "v": v} if ctx.mode == "prefill" else None)


def dlayer_apply(p, h, ctx: C.LayerCtx, cache=None):
    """One decoder layer; ``cache`` is the unit's {"self": PagedKV or
    {"k", "v"}, "cross": {"k", "v"}} in the serving modes, None in
    ``train`` and ``prefill``. Returns (h, cache): in ``prefill`` the
    layer's new {"self", "cross"}."""
    cfg = ctx.cfg
    s1, c1, g1, s2, c2, g2 = C._mods(p, ctx)
    sc, xc = (None, None) if cache is None else (cache["self"],
                                                 cache["cross"])
    cm = ctx.cond_mask

    x = adaln.modulate(L.apply_norm(p["ln1"], h, cfg.norm), s1, c1, cm)
    out, sc = _self_attn(p["attn"], x, ctx, sc)
    h = adaln.gate(h, out, g1, cm, impl="ref")

    x = L.apply_norm(p["lnx"], h, cfg.norm)
    out, xc = _cross_attn(p["xattn"], x, ctx, xc)
    h = h + out

    x = adaln.modulate(L.apply_norm(p["ln2"], h, cfg.norm), s2, c2, cm)
    h = adaln.gate(h, L.apply_mlp(p["mlp"], x, cfg.mlp), g2, cm, impl="ref")
    if ctx.mode == "prefill":
        cache = {"self": sc, "cross": xc}
    return h, cache


def dlayer_two_pass(p, hc, hn, ctx: C.LayerCtx):
    """Two-pass DB for the decoder layer: the self-attention and MLP as
    ``common.tlayer_two_pass`` (the clean stream causal and unmodulated,
    the noisy stream σ-modulated and gated, attending the clean past and
    itself; no rope, as JAX applies none here), and between them the
    unmodulated cross-attention for both streams. Returns (hc, hn)."""
    cfg = ctx.cfg
    s1, c1, g1, s2, c2, g2 = C._mods(p, ctx)
    dims = ctx.dims()
    S = hc.shape[1]
    pos = ctx.positions if ctx.positions is not None else torch.arange(S)

    xc = L.apply_norm(p["ln1"], hc, cfg.norm)
    xn = adaln.modulate(L.apply_norm(p["ln1"], hn, cfg.norm), s1, c1)
    qc, kc, vc = A.project_qkv(p["attn"], xc, dims)
    qn, kn, vn = A.project_qkv(p["attn"], xn, dims)
    oc = A.attend(qc, kc, vc, mask_mod=A.causal_mask, qpos=pos, kpos=pos,
                  impl=ctx.impl)
    on = A.attend(qn, torch.cat([kc, kn], dim=1), torch.cat([vc, vn], dim=1),
                  mask_mod=C.two_pass_mask(S), qpos=pos,
                  kpos=torch.cat([pos, pos + S]), impl=ctx.impl)

    def proj(o):
        return o.reshape(*o.shape[:2], dims.n_heads * dims.head_dim) \
            @ L.as_dtype(p["attn"]["wo"], o.dtype)
    hc = hc + proj(oc)
    hn = adaln.gate(hn, proj(on), g1, impl="ref")

    # cross-attention: both streams attend the encoder's memory
    hc = hc + _cross_attn(p["xattn"], L.apply_norm(p["lnx"], hc, cfg.norm),
                          ctx, None)[0]
    hn = hn + _cross_attn(p["xattn"], L.apply_norm(p["lnx"], hn, cfg.norm),
                          ctx, None)[0]

    xc = L.apply_norm(p["ln2"], hc, cfg.norm)
    xn = adaln.modulate(L.apply_norm(p["ln2"], hn, cfg.norm), s2, c2)
    hc = hc + L.apply_mlp(p["mlp"], xc, cfg.mlp)
    hn = adaln.gate(hn, L.apply_mlp(p["mlp"], xn, cfg.mlp), g2, impl="ref")
    return hc, hn


class EncDecModel(BaseModel):
    """whisper-small: ``n_units`` decoder layers (one unit a layer) over
    the memory of an encoder of ``n_encoder_layers`` layers."""

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers           # decoder layers

    @property
    def kv_carries_all_state(self) -> bool:
        # the decoder's history is all in the paged self-attention KV; the
        # audio block is per-request conditioning, as the VLM's image block
        return True

    def build_spec(self):
        cfg = self.cfg
        spec = self.common_spec()
        # the encoder: bidirectional transformer layers, never σ-conditioned
        enc_layer = C.tlayer_spec(dataclasses.replace(cfg,
                                                      sliding_window=None),
                                  db=False)
        spec["encoder"] = stack_specs(enc_layer, cfg.n_encoder_layers)
        spec["enc_norm"] = L.norm_spec(cfg.d_model, cfg.norm)
        spec["layers"] = stack_specs(dlayer_spec(cfg, self.db is not None),
                                     cfg.n_layers)
        return spec

    def encode(self, params, audio_embs, ctx: C.LayerCtx):
        """audio_embs (B, n_frames, d) -> the memory (B, n_frames, d), in
        audio_embs' dtype (as JAX's ``encode``: under the bf16 policy an fp32
        input keeps the encoder in fp32 over the bf16-rounded weights). The
        sinusoidal positions, the encoder layers over the whole sequence
        under the bidirectional mask, then ``enc_norm``."""
        S = audio_embs.shape[1]
        h = audio_embs + L.sinusoidal_positions(
            S, self.cfg.d_model, audio_embs.device).to(audio_embs.dtype)
        ectx = dataclasses.replace(
            ctx, mode="train", mask_mod=A.bidirectional_mask,
            positions=torch.arange(S), rope_positions=None, cond=None,
            cond_mask=None, kv_x=None, kv_positions=None)
        for u in _unbind(params["encoder"], 0, self.cfg.n_encoder_layers):
            h, _ = C.tlayer_apply(u, h, ectx)
        return L.apply_norm(params["enc_norm"], h, self.cfg.norm)

    def embed(self, params, tokens, dtype=None, positions=None):
        """Token rows plus sinusoidal absolute positions (no rope):
        arange(S) by default; ``positions`` (broadcastable to the tokens'
        shape) carry each slot's true offsets on the serving paths, so
        ragged batches embed at their own positions."""
        h = self.token_rows(params, tokens, dtype)
        if positions is None:
            pos = L.sinusoidal_positions(h.shape[1], self.cfg.d_model,
                                         h.device)
        else:
            pos = L.sinusoidal_at(positions, self.cfg.d_model)
        return h + pos.to(h.dtype)

    def unit_params(self, params) -> list:
        """Per-unit views of the stacked ``layers`` tree (``_unit_views``)."""
        return _unit_views(self, params["layers"],
                           lambda t: [_index(t, u)
                                      for u in range(self.n_units)])

    def apply_units(self, params, h, start: int, size: int, ctx, cache=None,
                    reset_mask=None):
        """Run decoder units [start, start + size): with no cache over the
        whole sequence (``train``, ``prefill``; the memory in ``ctx.kv_x``;
        ``prefill`` returns the units' {"self", "cross"} stacked), else
        over ``cache``, paged or dense (sliced to those units);
        ``reset_mask`` restarts the hidden stream from the input ``h``
        before each flagged unit. Returns (h, cache)."""
        if cache is None:
            assert reset_mask is None
            caches = []
            for u in _unbind(params["layers"], start, size):
                h, c = dlayer_apply(u, h, ctx)
                caches.append(c)
            return h, _prefilled(ctx, caches)
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            h, _ = dlayer_apply(units[start + i], h, ctx,
                                KVC.cache_unit(cache, i))
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        for u in _unbind(params["layers"], start, size):
            h_clean, h_noisy = dlayer_two_pass(u, h_clean, h_noisy, ctx)
        return h_clean, h_noisy

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda") -> dict:
        """Zeroed dense caches for ``size`` decoder units (all by default):
        {"self": {"k", "v"} (size, batch, cache_len, KV, hd), "cross": {"k",
        "v"} (size, batch, n_audio_frames, KV, hd)}, the audio blocks that
        ``set_conditioning`` writes."""
        del start
        size = self.n_units if size is None else size
        dims = _dims(self.cfg)
        return {"self": A.init_kv_cache(batch, cache_len, dims, dtype,
                                        (size,), device),
                "cross": A.init_kv_cache(batch, self.cfg.n_audio_frames,
                                         dims, dtype, (size,), device)}

    def init_paged_cache(self, num_slots: int, n_pages: int, page_size: int,
                         policy=None, device="cuda") -> dict:
        """The decoder's paged self-attention pool (n_units, n_pages,
        page_size, KV, hd) in the policy's KV dtype and zeroed audio blocks
        (n_units, num_slots, n_audio_frames, KV, hd) in ``kv_dense`` (never
        int8: they have no per-page scales)."""
        pol = precision_mod.get_policy(policy)
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        shape = (self.n_units, num_slots, cfg.n_audio_frames,
                 cfg.n_kv_heads, cfg.head_dim)
        return {
            "self": KVC.init_paged_kv(n_pages, page_size, dims, pol.kv,
                                      n_units=self.n_units, device=device),
            "cross": {k: torch.zeros(shape, dtype=pol.kv_dense,
                                     device=device) for k in ("k", "v")},
        }

    def reset_paged_slots(self, cache, slot_mask):
        """Zero the audio blocks of the masked slots, in place."""
        idx = torch.nonzero(torch.as_tensor(slot_mask))[:, 0]
        if idx.numel():
            for t in cache["cross"].values():
                t.index_fill_(1, idx.to(t.device), 0)
        return cache

    @property
    def paged_state_axes(self) -> dict:
        # audio blocks are (units, slots, n_audio_frames, KV, hd): axis 1
        return {"cross": 1}

    def cache_batch(self, cache) -> int:
        return cache["cross"]["k"].shape[1]

    # ---- conditioning (stubbed mel/conv frontend + the encoder stack) ----
    @property
    def max_cond_tokens(self) -> int:
        return self.cfg.n_audio_frames

    def aux_input_specs(self, batch: int, dtype=torch.bfloat16):
        return {"audio_embs": torch.empty(
            (batch, self.cfg.n_audio_frames, self.cfg.d_model), dtype=dtype,
            device="meta")}

    @property
    def cond_padding_safe(self) -> bool:
        return False      # bidirectional encoder: padded frames leak in

    def encode_conditioning(self, params, aux_inputs, ctx=None):
        if not aux_inputs or "audio_embs" not in aux_inputs:
            return None
        if ctx is None:
            ctx = C.LayerCtx(cfg=self.cfg, mode="train")
        return self.encode(params, aux_inputs["audio_embs"], ctx)

    def set_conditioning(self, params, cache, cond, slot=None):
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        C.write_cross_block(cache["cross"], params["layers"]["xattn"], cond,
                            dims, slot)
        return cache
