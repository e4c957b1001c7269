"""Uniform model API (port of ``repro.models.model_api.BaseModel``): specs,
init, embedding, σ conditioning, logits, the full forward, and the
continuous batcher's hooks on per-slot state.

A model is partitioned into ``n_units`` units (for the dense family one
unit is one transformer layer), the granularity at which DiffusionBlocks
slices the network into blocks. Every family has two serving caches:
``init_paged_cache`` (the engines' pools) and ``init_cache(batch,
cache_len, dtype, start, size)``, JAX's dense layout, which ``prefill``
returns and the dense ``decode`` reads at ``LayerCtx.pos``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import DBConfig, ModelConfig
from repro_torch.nn import adaln
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L
from repro_torch.nn.init import init_params


class BaseModel:
    def __init__(self, cfg: ModelConfig, db: Optional[DBConfig] = None):
        self.cfg = cfg
        self.db = db
        self.spec = self.build_spec()

    @property
    def n_units(self) -> int:
        raise NotImplementedError

    def build_spec(self):
        raise NotImplementedError

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return init_params(self.spec, generator, dtype)

    def common_spec(self):
        """Embedding / head / final norm / σ-conditioning specs."""
        cfg = self.cfg
        spec = {
            "embed": L.embed_spec(cfg.vocab_size, cfg.d_model),
            "final_norm": L.norm_spec(cfg.d_model, cfg.norm),
        }
        if not cfg.tie_embeddings:
            spec["head"] = L.readout_spec(cfg.d_model, cfg.vocab_size)
        if self.db is not None:
            spec["cond"] = adaln.sigma_embed_spec(self.db.cond_dim,
                                                  cfg.d_model)
        return spec

    def _normalize(self, rows):
        if self.db is not None and self.db.embed_l2_normalize:
            return L.l2_normalize_embeddings(rows)
        return rows

    def embedding_table(self, params):
        return self._normalize(params["embed"]["table"])

    def token_rows(self, params, tokens, dtype=None):
        """Rows of the (L2-normalised) table. Normalisation is row-wise, so
        the port normalises the gathered rows instead of the whole
        vocabulary-sized table, as JAX does, on every call."""
        h = self._normalize(params["embed"]["table"][tokens.long()])
        return h if dtype is None else h.to(dtype)

    def embed(self, params, tokens, dtype=None, positions=None):
        """The token rows (``token_rows``). ``positions`` (broadcastable to
        the tokens' shape) matter only for families with absolute position
        embeddings (the encoder-decoder); the rope families ignore them."""
        del positions
        return self.token_rows(params, tokens, dtype)

    def cond(self, params, log_sigma, dtype=torch.float32):
        assert self.db is not None
        return adaln.sigma_embedding(params["cond"], log_sigma / 4.0,
                                     self.db.cond_dim, dtype)

    def reset_paged_slots(self, cache, slot_mask):
        """Reset the per-slot state of slots recycled for a new request.
        Paged KV needs none (length masking hides stale pages), so a purely
        paged family returns the cache as it is."""
        return cache

    @property
    def paged_state_axes(self) -> dict:
        """Slot axis of every dense per-slot subtree of the paged cache, by
        top-level cache key: what ``cache.spill_slot``/``restore_slot``
        need. Purely paged families have none."""
        return {}

    def cache_batch(self, cache) -> int:
        """Dim 1 of the cache's first tensor, as JAX reads it (the layout
        is the family's: the VLM overrides with its blocks' slot axis)."""
        return KVC.cache_tensors(cache)[0].shape[1]

    # ---- conditioning (aux image or audio inputs) -------------------------
    # The serving engines feature-test these instead of switching on the
    # family: the static engine writes every slot's block before prefill,
    # the continuous batcher one slot's at admission. Unconditioned
    # families keep these defaults.

    @property
    def max_cond_tokens(self) -> int:
        """Capacity of the per-slot conditioning block (0: the family takes
        no aux conditioning inputs)."""
        return 0

    def aux_input_specs(self, batch: int, dtype=torch.bfloat16):
        """{name: a meta tensor of the aux input's shape and dtype} (no
        allocation), or None for an unconditioned family."""
        return None

    @property
    def cond_padding_safe(self) -> bool:
        """True when ``encode_conditioning`` is position-local, so a
        zero-padded aux batch with per-row valid lengths encodes each row
        as its unpadded self would (the VLM's passthrough)."""
        return True

    def encode_conditioning(self, params, aux_inputs, ctx=None):
        """The cross-attention memory (B, Sk, d) of the aux inputs, or None
        when the family is unconditioned or none was given."""
        return None

    def set_conditioning(self, params, cache, cond, slot=None):
        """Project ``cond`` (B, Sk, d) through every unit's cross-attention
        (k, v) into the cache's per-slot blocks, in place: every slot when
        ``slot`` is None (B == slots), else slot ``slot`` (B == 1). The
        valid length travels separately (``LayerCtx.cond_lengths``)."""
        raise ValueError(
            f"family {self.cfg.family!r} has no conditioning inputs")

    @property
    def kv_carries_all_state(self) -> bool:
        """True when a sequence's whole history lives in paged KV, so two
        slots mapping the same prefix pages share the same computation: the
        precondition of the shared-prefix page cache."""
        return False

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda"):
        """Zeroed dense caches of units [start, start + size) (every unit
        by default): each leaf leads with the unit axis, then the batch."""
        raise NotImplementedError

    def forward(self, params, tokens, ctx, cache=None):
        """The full stack over ``tokens`` (B, S) in the ctx policy's compute
        dtype (the logits' reductions stay fp32): returns (logits (B, S, V),
        cache), the cache ``apply_units`` returns in ``ctx.mode`` (the
        units' dense caches in ``prefill``). A MoE family's aux loss is in
        ``ctx.aux``."""
        pol = getattr(ctx, "precision", None)
        h = self.embed(params, tokens,
                       dtype=None if pol is None
                       else pol.compute_for(self.cfg.family))
        h, cache = self.apply_units(params, h, 0, self.n_units, ctx, cache)
        return self.logits(params, h), cache

    def logits(self, params, h):
        h = L.apply_norm(params["final_norm"], h, self.cfg.norm)
        if self.cfg.tie_embeddings:
            return h @ self.embedding_table(params).T.to(h.dtype)
        return L.readout(params["head"], h)


def build_model(cfg: ModelConfig, db: Optional[DBConfig] = None) -> BaseModel:
    """The model of ``cfg.family`` (port of ``repro.models.build_model``):
    ``VLMModel`` for the vlm family, ``HybridModel`` for the hybrid
    (zamba2), ``EncDecModel`` for the audio family (whisper),
    ``XLSTMModel`` for the ``ssm`` family (xLSTM), else
    ``DecoderModel``: the dense and MoE families,
    which raises for any other."""
    from repro_torch.configs.base import AUDIO, HYBRID, SSM, VLM
    from repro_torch.models import encdec as E         # import cycle
    from repro_torch.models import hybrid as H
    from repro_torch.models import ssm_model as X
    from repro_torch.models import transformer as T
    cls = {VLM: T.VLMModel, HYBRID: H.HybridModel, AUDIO: E.EncDecModel,
           SSM: X.XLSTMModel}.get(cfg.family, T.DecoderModel)
    return cls(cfg, db)
