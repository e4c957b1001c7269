"""Dense and MoE decoders and the VLM (port of
``repro.models.transformer``): ``DecoderModel`` for the dense and MoE
families (every layer of the MoE family routes its MLP through
``nn.moe``) and ``VLMModel``, llama-3.2-vision's superblocks of self
layers and one tanh-gated cross-attention layer, which attends the image
embeddings (``ctx.kv_x``) in training and the slot's image block in
serving. Both have the training passes, concat and two-pass, the
paged-serving paths and the dense-cache ones (``init_cache``; ``prefill``
returns each unit's (k, v) over the prompt, stacked on the unit axis as
JAX's scans stack them). The JAX ``lax.scan`` over units is a Python loop
over the stacked unit axis; the MoE routers' aux loss goes to ``ctx.aux``
(``common.LayerCtx.add_aux``) instead of the scan's carry."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import precision as precision_mod
from repro_torch.configs.base import DENSE, MOE
from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn.init import stack_specs, tree_map


class DecoderModel(BaseModel):
    """Standard decoder stack; one unit is one layer, every layer a MoE
    layer for the MoE family."""

    def __init__(self, cfg, db=None):
        if cfg.family not in (DENSE, MOE):
            raise NotImplementedError(
                f"family {cfg.family!r}: the port has the dense decoder and "
                "the MoE (DecoderModel), the VLM (VLMModel), the hybrid "
                "(models.hybrid.HybridModel), the encoder-decoder "
                "(models.encdec.EncDecModel) and the xLSTM "
                "(models.ssm_model.XLSTMModel)")
        super().__init__(cfg, db)

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers

    @property
    def is_moe(self) -> bool:
        return self.cfg.family == MOE

    @property
    def kv_carries_all_state(self) -> bool:
        return True

    def build_spec(self):
        spec = self.common_spec()
        spec["layers"] = stack_specs(
            C.tlayer_spec(self.cfg, self.db is not None,
                          moe_layer=self.is_moe), self.cfg.n_layers)
        return spec

    def apply_units(self, params, h, start: int, size: int, ctx,
                    cache: Optional[KVC.PagedKV] = None, reset_mask=None):
        """Run units [start, start + size) over ``cache`` (paged or dense;
        its unit axis covers exactly those units), or with no cache over
        the whole sequence (``train``; ``prefill`` returns the units' dense
        caches {"k", "v"} (size, B, S, KV, hd)). ``reset_mask`` (a sequence
        of ``size`` bools) restarts the hidden stream from the input ``h``
        before each flagged unit: the commit passes restart every DB block's
        clean stream from the raw embeddings. Returns (h, cache)."""
        if cache is None:
            assert reset_mask is None
            # one unbind per leaf: its backward stacks the units' grads in
            # one pass (per-unit indexing would add a zero-padded full-size
            # grad per unit)
            units = _unbind(params["layers"], start, size)
            caches = []
            for u in units:
                h, c = C.tlayer_apply(u, h, ctx, moe_layer=self.is_moe)
                caches.append(c)
            return h, _prefilled(ctx, caches)
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            h, _ = C.tlayer_apply(units[start + i], h, ctx,
                                  moe_layer=self.is_moe,
                                  cache=KVC.cache_unit(cache, i))
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        """DB two-pass training over units [start, start + size): the clean
        and noisy streams through ``tlayer_two_pass`` unit by unit. Returns
        (h_clean, h_noisy)."""
        for u in _unbind(params["layers"], start, size):
            h_clean, h_noisy = C.tlayer_two_pass(u, h_clean, h_noisy, ctx,
                                                 moe_layer=self.is_moe)
        return h_clean, h_noisy

    def unit_params(self, params) -> list:
        """Per-unit views of the stacked ``layers`` tree (``_unit_views``)."""
        return _unit_views(self, params["layers"],
                           lambda t: [_index(t, u)
                                      for u in range(self.n_units)])

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda") -> dict:
        """Zeroed dense caches {"k", "v"} (size, batch, C, KV, hd) for
        ``size`` units (all by default); C is ``cache_len``, or the ring of
        min(cache_len, sliding_window) under a window."""
        del start
        size = self.n_units if size is None else size
        cfg = self.cfg
        clen = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                else cache_len)
        return A.init_kv_cache(batch, clen, _dims(cfg), dtype, (size,),
                               device)

    def init_paged_cache(self, num_slots: int, n_pages: int, page_size: int,
                         policy=None, device="cuda") -> KVC.PagedKV:
        """One pool per unit, stacked: (n_units, n_pages, page_size, KV, hd)
        in the policy's KV dtype (page 0 is the trash page)."""
        del num_slots   # the pool is shared; slots own pages via the table
        pol = precision_mod.get_policy(policy)
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        return KVC.init_paged_kv(n_pages, page_size, dims, pol.kv,
                                 n_units=self.n_units, device=device)


class VLMModel(BaseModel):
    """Llama-3.2-vision-style decoder: ``n_units`` superblocks of
    ``k_self`` self layers and one tanh-gated cross-attention layer over
    the slot's image block (the vision encoder is stubbed: requests carry
    patch embeddings, ``image_embs`` (n_image_tokens, d)).

    Params: ``units/self`` stacked twice, (n_units, k_self, ...), and
    ``units/cross`` once, (n_units, ...), as JAX has them. The serving
    cache is ``{"self": PagedKV (n_units, k_self, P, psz, KV, hd), "cross":
    {"k", "v"} (n_units, num_slots, n_image_tokens, KV, hd)}``: the self
    layers' history is paged, the image block is fixed per slot (written
    once at admission by ``set_conditioning``, read under
    ``ctx.cond_lengths``; 0 makes the cross term exactly 0). In training
    (no cache) the cross layer attends ``ctx.kv_x``, the image embeddings
    ``make_ctx`` takes from ``aux_inputs``."""

    @property
    def k_self(self) -> int:
        return self.cfg.cross_attn_every - 1

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_attn_every

    @property
    def kv_carries_all_state(self) -> bool:
        # the sequence's history is all in the paged self-attention KV; the
        # image block is per-request conditioning, so the same text under
        # the same image (the prefix cache's fingerprint) shares soundly
        return True

    def build_spec(self):
        db = self.db is not None
        spec = self.common_spec()
        spec["units"] = {
            "self": stack_specs(stack_specs(C.tlayer_spec(self.cfg, db),
                                            self.k_self, "inner"),
                                self.n_units),
            "cross": stack_specs(C.tlayer_spec(self.cfg, db, cross=True),
                                 self.n_units),
        }
        return spec

    def unit_params(self, params) -> list:
        """[(self layers' views, cross layer's view)] per unit of the
        ``units`` tree (``_unit_views``)."""
        def views(units):
            return [([_index(_index(units["self"], u), j)
                      for j in range(self.k_self)],
                     _index(units["cross"], u))
                    for u in range(self.n_units)]
        return _unit_views(self, params["units"], views)

    def apply_units(self, params, h, start: int, size: int, ctx, cache=None,
                    reset_mask=None):
        """Run units [start, start + size): per unit the ``k_self`` self
        layers, then the cross layer; with no cache over the whole sequence
        (``train``, ``prefill``; the images in ``ctx.kv_x``), else over the
        serving ``cache``, paged or dense (sliced to those units,
        ``cache_units``). ``prefill`` returns {"self": {"k", "v"} (size,
        k_self, B, S, KV, hd), "cross": {"k", "v"} (size, B, Sk, KV, hd)}.
        ``reset_mask`` restarts the hidden stream from the input ``h``
        before each flagged unit. Returns (h, cache)."""
        if cache is None:
            assert reset_mask is None
            caches = []
            for u in _unbind(params["units"], start, size):
                selfs = []
                for p in _unbind(u["self"], 0, self.k_self):
                    h, c = C.tlayer_apply(p, h, ctx)
                    selfs.append(c)
                h, c = C.tlayer_apply(u["cross"], h, ctx, cross=True)
                caches.append({"self": _prefilled(ctx, selfs),
                               "cross": c})
            return h, _prefilled(ctx, caches)
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            selfs, cross = units[start + i]
            c = KVC.cache_unit(cache, i)
            for j, p in enumerate(selfs):
                h, _ = C.tlayer_apply(p, h, ctx,
                                      cache=KVC.cache_unit(c["self"], j))
            h, _ = C.tlayer_apply(cross, h, ctx, cross=True,
                                  cache=c["cross"])
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        """DB two-pass training over units [start, start + size): the self
        layers through ``tlayer_two_pass``, then both streams through the
        cross layer (``tlayer_apply`` in ``train``) under the same σ ctx,
        as JAX's: the clean stream is σ-modulated and gated there too.
        Returns (h_clean, h_noisy)."""
        for u in _unbind(params["units"], start, size):
            for p in _unbind(u["self"], 0, self.k_self):
                h_clean, h_noisy = C.tlayer_two_pass(p, h_clean, h_noisy,
                                                     ctx)
            h_clean, _ = C.tlayer_apply(u["cross"], h_clean, ctx, cross=True)
            h_noisy, _ = C.tlayer_apply(u["cross"], h_noisy, ctx, cross=True)
        return h_clean, h_noisy

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda") -> dict:
        """Zeroed dense caches for ``size`` units (all by default): {"self":
        {"k", "v"} (size, k_self, batch, cache_len, KV, hd), "cross": {"k",
        "v"} (size, batch, n_image_tokens, KV, hd)}, the image blocks that
        ``set_conditioning`` writes."""
        del start
        size = self.n_units if size is None else size
        dims = _dims(self.cfg)
        return {"self": A.init_kv_cache(batch, cache_len, dims, dtype,
                                        (size, self.k_self), device),
                "cross": A.init_kv_cache(batch, self.cfg.n_image_tokens,
                                         dims, dtype, (size,), device)}

    def init_paged_cache(self, num_slots: int, n_pages: int, page_size: int,
                         policy=None, device="cuda") -> dict:
        """The paged self-attention pool (n_units, k_self, n_pages,
        page_size, KV, hd) in the policy's KV dtype and zeroed image blocks
        (n_units, num_slots, n_image_tokens, KV, hd) in ``kv_dense`` (never
        int8: they have no per-page scales)."""
        pol = precision_mod.get_policy(policy)
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        shape = (self.n_units, num_slots, cfg.n_image_tokens,
                 cfg.n_kv_heads, cfg.head_dim)
        return {
            "self": KVC.init_paged_kv(n_pages, page_size, dims, pol.kv,
                                      n_units=(self.n_units, self.k_self),
                                      device=device),
            "cross": {k: torch.zeros(shape, dtype=pol.kv_dense,
                                     device=device) for k in ("k", "v")},
        }

    def reset_paged_slots(self, cache, slot_mask):
        """Zero the image blocks of the masked slots, in place."""
        idx = torch.nonzero(torch.as_tensor(slot_mask))[:, 0]
        if idx.numel():
            for t in cache["cross"].values():
                t.index_fill_(1, idx.to(t.device), 0)
        return cache

    @property
    def paged_state_axes(self) -> dict:
        # image blocks are (units, slots, n_image_tokens, KV, hd): axis 1
        return {"cross": 1}

    def cache_batch(self, cache) -> int:
        return cache["cross"]["k"].shape[1]

    # ---- conditioning (stubbed vision frontend) --------------------------
    @property
    def max_cond_tokens(self) -> int:
        return self.cfg.n_image_tokens

    def aux_input_specs(self, batch: int, dtype=torch.bfloat16):
        return {"image_embs": torch.empty(
            (batch, self.cfg.n_image_tokens, self.cfg.d_model), dtype=dtype,
            device="meta")}

    def encode_conditioning(self, params, aux_inputs, ctx=None):
        if not aux_inputs or "image_embs" not in aux_inputs:
            return None
        return aux_inputs["image_embs"]

    def set_conditioning(self, params, cache, cond, slot=None):
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        C.write_cross_block(cache["cross"], params["units"]["cross"]["attn"],
                            cond, dims, slot)
        return cache


def _dims(cfg) -> A.AttnDims:
    return A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.rope_theta)


def _prefilled(ctx, caches: list):
    """The units' dense caches stacked on the unit axis in ``prefill``;
    None in ``train``."""
    return (C.zip_caches(torch.stack, caches) if ctx.mode == "prefill"
            else None)


def _unit_views(model, tree, make) -> list:
    """``make(tree)``, the per-unit views of a stacked param tree, made once
    per tree (the fp32 masters and a compute-dtype copy alternate within a
    step, so the last few trees are remembered by identity)."""
    memo = model.__dict__.setdefault("_unit_memo", {})
    hit = memo.get(id(tree))
    if hit is None or hit[0] is not tree:
        if len(memo) >= 4:
            memo.pop(next(iter(memo)))
        hit = memo[id(tree)] = (tree, make(tree))
    return hit[1]


def _unbind(tree, start: int, size: int) -> list:
    """``size`` per-unit trees of units [start, start + size)."""
    parts = tree_map(lambda _, t: (t if (start, size) == (0, t.shape[0])
                                   else t[start:start + size]).unbind(0),
                     tree)
    return [tree_map(lambda _, p: p[i], parts) for i in range(size)]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]

