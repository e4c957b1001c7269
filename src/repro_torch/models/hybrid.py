"""Zamba2-style hybrid (port of ``repro.models.hybrid``, the serving
half): a Mamba2 backbone with one SHARED-weight attention + MLP block
applied after every ``attn_every`` Mamba layers.

A unit is ``attn_every`` Mamba layers and one application of the shared
block. The shared block's weights are the same for every unit; each
application keeps its own paged KV. The serving cache is

    {"mamba": {"h": (n_units, inner, slots, H, P, N) fp32,
               "conv": (n_units, inner, slots, K-1, d_in + 2N)},
     "shared_kv": PagedKV (n_units, P, psz, KV, hd)}

with the states in ``Policy.state_for(HYBRID)`` (fp32 under every shipped
policy) and the pages in the policy's KV dtype. The states are written in
place (``models.common.write_state``), so the batcher's CUDA graphs hold
their addresses as they hold the pages'; a denoising probe
(``ctx.commit=False``) leaves them bit-unchanged, and inactive slots hold
theirs.

JAX scans over units and over the inner Mamba layers with ``uscan``
(``nn/scan_util.py``: ``lax.scan`` with XLA's unroll and remat knobs); the
port loops over them in Python, as ``VLMModel.apply_units`` does, so that
module has no port. Serving only: the uncached ``apply_units``, the train
mode of ``mamba_layer_apply`` and ``apply_units_two_pass`` raise until the
hybrid-training slice (ROADMAP A6.2, hybrid training).

Conditioning: none (``max_cond_tokens`` 0). ``kv_carries_all_state`` is
False (the Mamba state is per slot, not paged), so the prefix cache and a
``SharedPagePool`` refuse the family, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch import precision as precision_mod
from repro_torch.configs.base import HYBRID
from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.models.transformer import _index, _unit_views
from repro_torch.nn import adaln
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as SSM
from repro_torch.nn.init import stack_specs

TRAINING = ("the hybrid serves only: training it (the two-pass SSD scan and "
            "the flash-attention kernels at hd 112) is ROADMAP A6.2, hybrid "
            "training")


def mamba_layer_spec(cfg, db: bool):
    spec = {
        "ln": L.norm_spec(cfg.d_model, cfg.norm),
        "mixer": SSM.mamba2_spec(cfg.d_model, cfg.ssm),
    }
    if db:
        spec["adaln"] = adaln.adaln_spec(cfg.d_model, n_mods=3)
    return spec


def mamba_layer_apply(p, h, ctx: C.LayerCtx, state: dict):
    """One pre-norm Mamba2 layer over the slot's ``state`` ({"h", "conv"},
    slot-leading views into the cache), σ-modulated and gated in the
    probes. ``decode``: one token; the new state is written in place when
    ``ctx.commit`` (inactive slots hold theirs), never in a probe.
    ``prefill_chunk``: C tokens, slot b's first ``ctx.n_valid[b]`` advance
    its state (``mamba2_chunk_step``). Returns h."""
    cfg = ctx.cfg
    if ctx.cond is not None and "adaln" in p:
        s, c, g = adaln.adaln_mods(p["adaln"], ctx.cond, cfg.d_model, 3)
    else:
        s = c = g = None
    x = adaln.modulate(L.apply_norm(p["ln"], h, cfg.norm), s, c)
    if ctx.mode == "decode":
        y, new = SSM.mamba2_decode_step(p["mixer"], x, cfg.ssm, cfg.d_model,
                                        state)
        if ctx.commit:
            C.write_state(state, C.masked_state_update(new, state,
                                                       ctx.active))
    elif ctx.mode == "prefill_chunk":
        y, new = SSM.mamba2_chunk_step(p["mixer"], x, cfg.ssm, cfg.d_model,
                                       state, ctx.n_valid)
        C.write_state(state, new)
    else:
        raise NotImplementedError(f"mamba layer in mode {ctx.mode!r}: "
                                  f"{TRAINING}")
    return adaln.gate(h, y, g, impl=ctx.impl)


class HybridModel(BaseModel):
    """zamba2-7b: ``n_units`` units of ``inner`` Mamba2 layers and the
    shared attention block. Params: ``units/mamba`` stacked twice,
    (n_units, inner, ...), and ``shared`` unstacked, JAX's tree."""

    @property
    def inner(self) -> int:
        return self.cfg.attn_every

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers // self.inner

    def build_spec(self):
        db = self.db is not None
        spec = self.common_spec()
        m = mamba_layer_spec(self.cfg, db)
        spec["units"] = {"mamba": stack_specs(
            stack_specs(m, self.inner, "inner"), self.n_units)}
        spec["shared"] = C.tlayer_spec(self.cfg, db)
        return spec

    def unit_params(self, params) -> list:
        """[the unit's Mamba layers' views] per unit (``_unit_views``)."""
        def views(units):
            return [[_index(_index(units["mamba"], u), j)
                     for j in range(self.inner)]
                    for u in range(self.n_units)]
        return _unit_views(self, params["units"], views)

    def apply_units(self, params, h, start: int, size: int, ctx, cache=None,
                    reset_mask=None):
        """Run units [start, start + size) over the serving ``cache``
        (sliced to those units, ``cache_units``): each unit's Mamba layers
        over their state rows, then the shared block over the unit's paged
        KV. ``reset_mask`` restarts the hidden stream from the input ``h``
        before each flagged unit. Returns (h, cache)."""
        if cache is None:
            raise NotImplementedError(f"HybridModel without a cache: "
                                      f"{TRAINING}")
        h0 = h
        units = self.unit_params(params)
        shared = params["shared"]
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            c = KVC.cache_unit(cache, i)
            for j, p in enumerate(units[start + i]):
                h = mamba_layer_apply(p, h, ctx,
                                      KVC.cache_unit(c["mamba"], j))
            h, _ = C.tlayer_apply(shared, h, ctx, cache=c["shared_kv"])
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        raise NotImplementedError(f"HybridModel.apply_units_two_pass: "
                                  f"{TRAINING}")

    def init_paged_cache(self, num_slots: int, n_pages: int, page_size: int,
                         policy=None, device="cuda") -> dict:
        """Zeroed Mamba states (n_units, inner, num_slots, ...) in
        ``state_for(HYBRID)`` (``h`` always fp32) and the shared block's
        pool (n_units, n_pages, page_size, KV, hd) in the policy's KV
        dtype (page 0 is the trash page)."""
        pol = precision_mod.get_policy(policy)
        cfg = self.cfg
        dims = A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.rope_theta)
        one = SSM.mamba2_init_state(num_slots, cfg.ssm, cfg.d_model,
                                    pol.state_for(HYBRID), device="meta")
        return {
            "mamba": {k: torch.zeros((self.n_units, self.inner) + t.shape,
                                     dtype=t.dtype, device=device)
                      for k, t in one.items()},
            "shared_kv": KVC.init_paged_kv(n_pages, page_size, dims, pol.kv,
                                           n_units=self.n_units,
                                           device=device),
        }

    def reset_paged_slots(self, cache, slot_mask):
        """Restore the masked slots' Mamba rows (axis 2) to the init state,
        which is zero, in place; the pages need no reset."""
        idx = torch.nonzero(torch.as_tensor(slot_mask))[:, 0]
        if idx.numel():
            for t in cache["mamba"].values():
                t.index_fill_(2, idx.to(t.device), 0)
        return cache

    @property
    def paged_state_axes(self) -> dict:
        # Mamba state leaves are (units, inner, slots, ...): slot axis 2
        return {"mamba": 2}

    def cache_batch(self, cache) -> int:
        return cache["mamba"]["h"].shape[2]
