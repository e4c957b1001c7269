"""Uniform model API (port of ``repro.models.model_api.BaseModel``, the part
the serving path needs: specs, init, embedding, σ conditioning, logits).

A model is partitioned into ``n_units`` units (for the dense family one
unit is one transformer layer), the granularity at which DiffusionBlocks
slices the network into blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import DBConfig, ModelConfig
from repro_torch.nn import adaln
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

    def embed(self, params, tokens, dtype=None):
        """Rows of the (L2-normalised) table. Normalisation is row-wise, so
        the port normalises the gathered rows instead of the whole
        vocabulary-sized table, as JAX does, on every call."""
        h = self._normalize(params["embed"]["table"][tokens.long()])
        return h if dtype is None else h.to(dtype)

    def cond(self, params, log_sigma, dtype=torch.float32):
        assert self.db is not None
        return adaln.sigma_embedding(params["cond"], log_sigma / 4.0,
                                     self.db.cond_dim, dtype)

    def logits(self, params, h):
        h = L.apply_norm(params["final_norm"], h, self.cfg.norm)
        if self.cfg.tie_embeddings:
            return h @ self.embedding_table(params).T.to(h.dtype)
        return L.readout(params["head"], h)


def build_model(cfg: ModelConfig, db: Optional[DBConfig] = None) -> BaseModel:
    """The model of ``cfg.family`` (port of ``repro.models.build_model``).
    The port has the dense decoder only: ``DecoderModel`` raises for any
    other family."""
    from repro_torch.models.transformer import DecoderModel  # import cycle
    return DecoderModel(cfg, db)
