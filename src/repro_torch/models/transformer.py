"""Dense decoder (port of ``repro.models.transformer.DecoderModel``, dense
family: the training passes, concat and two-pass, and the paged-serving
paths). The JAX ``lax.scan`` over units is a Python loop over the stacked
``layers`` axis."""
from __future__ import annotations

from typing import Optional

from repro_torch import precision as precision_mod
from repro_torch.configs.base import DENSE
from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn.init import stack_specs, tree_map


class DecoderModel(BaseModel):
    """Standard decoder stack; one unit is one layer."""

    def __init__(self, cfg, db=None):
        if cfg.family != DENSE:
            raise NotImplementedError(
                f"family {cfg.family!r}: the port has the dense decoder only "
                "so far")
        super().__init__(cfg, db)

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers

    @property
    def kv_carries_all_state(self) -> bool:
        return True

    def build_spec(self):
        spec = self.common_spec()
        spec["layers"] = stack_specs(C.tlayer_spec(self.cfg,
                                                   self.db is not None),
                                     self.cfg.n_layers)
        return spec

    def apply_units(self, params, h, start: int, size: int, ctx,
                    cache: Optional[KVC.PagedKV] = None, reset_mask=None):
        """Run units [start, start + size) over the paged ``cache`` (whose
        unit axis covers exactly those units), or with no cache over the
        whole sequence (``ctx.mode == "train"``). ``reset_mask`` (a sequence
        of ``size`` bools) restarts the hidden stream from the input ``h``
        before each flagged unit: the commit passes restart every DB block's
        clean stream from the raw embeddings. Returns (h, cache)."""
        if cache is None:
            assert reset_mask is None
            # one unbind per leaf: its backward stacks the units' grads in
            # one pass (per-unit indexing would add a zero-padded full-size
            # grad per unit)
            units = _unbind(params["layers"], start, size)
            for u in units:
                h, _ = C.tlayer_apply(u, h, ctx)
            return h, None
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            h, _ = C.tlayer_apply(units[start + i], h, ctx,
                                  cache=cache.unit(i))
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        """DB two-pass training over units [start, start + size): the clean
        and noisy streams through ``tlayer_two_pass`` unit by unit. Returns
        (h_clean, h_noisy)."""
        for u in _unbind(params["layers"], start, size):
            h_clean, h_noisy = C.tlayer_two_pass(u, h_clean, h_noisy, ctx)
        return h_clean, h_noisy

    def unit_params(self, params) -> list:
        """Per-unit views of the stacked ``layers`` tree, made once per param
        tree (the fp32 masters and a compute-dtype copy alternate within a
        step, so the last few trees are remembered by identity)."""
        layers = params["layers"]
        memo = self.__dict__.setdefault("_unit_memo", {})
        hit = memo.get(id(layers))
        if hit is None or hit[0] is not layers:
            if len(memo) >= 4:
                memo.pop(next(iter(memo)))
            hit = (layers, [_index(layers, u) for u in range(self.n_units)])
            memo[id(layers)] = hit
        return hit[1]

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

