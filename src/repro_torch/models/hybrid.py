"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2
backbone with one SHARED-weight attention + MLP block applied after every
``attn_every`` Mamba layers.

A unit is ``attn_every`` Mamba layers and one application of the shared
block. The shared block's weights are the same for every unit; each
application keeps its own paged KV. The serving cache is

    {"mamba": {"h": (n_units, inner, slots, H, P, N) fp32,
               "conv": (n_units, inner, slots, K-1, d_in + 2N)},
     "shared_kv": PagedKV (n_units, P, psz, KV, hd)}

with the states in ``Policy.state_for(HYBRID)`` (fp32 under every shipped
policy) and the pages in the policy's KV dtype. The dense cache
(``init_cache``, JAX's layout) is the same with the shared block's keys in
``{"k", "v"}`` (n_units, slots, C, KV, hd), a ring of C = min(cache_len,
sliding_window) under the window; ``prefill`` returns each Mamba layer's
final state from ``mamba2_fwd`` and the shared block's (k, v) over the
prompt, stacked on the unit axes. The states are written in
place (``models.common.write_state``), so the batcher's CUDA graphs hold
their addresses as they hold the pages'; a denoising probe
(``ctx.commit=False``) leaves them bit-unchanged, and inactive slots hold
theirs.

Training: the uncached ``apply_units`` in the ``train`` mode (each Mamba
layer through ``mamba2_fwd``, the shared block over the whole sequence
under the sliding-window mask: the end-to-end baseline) and
``apply_units_two_pass`` (DiffusionBlocks' block loss, which routes the
recurrent families to two-pass: each Mamba layer through
``mamba2_two_pass``, the shared block through ``tlayer_two_pass``). The
family computes in fp32 under every policy (``Policy.fp32_families``).

JAX scans over units and over the inner Mamba layers with ``uscan``
(``nn/scan_util.py``: ``lax.scan`` with XLA's unroll and remat knobs); the
port loops over them in Python, as ``VLMModel.apply_units`` does, so that
module has no port.

Conditioning: none (``max_cond_tokens`` 0). ``kv_carries_all_state`` is
False (the Mamba state is per slot, not paged), so the prefix cache and a
``SharedPagePool`` refuse the family, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import precision as precision_mod
from repro_torch.configs.base import HYBRID
from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.models.transformer import (_dims, _index, _prefilled,
                                           _unbind, _unit_views)
from repro_torch.nn import adaln
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as SSM
from repro_torch.nn.init import stack_specs

def mamba_layer_spec(cfg, db: bool):
    spec = {
        "ln": L.norm_spec(cfg.d_model, cfg.norm),
        "mixer": SSM.mamba2_spec(cfg.d_model, cfg.ssm),
    }
    if db:
        spec["adaln"] = adaln.adaln_spec(cfg.d_model, n_mods=3)
    return spec


def _mods(p, ctx: C.LayerCtx):
    """(shift, scale, gate) from the layer's AdaLN head where ``ctx.cond``
    is set, else Nones."""
    if ctx.cond is None or "adaln" not in p:
        return None, None, None
    return adaln.adaln_mods(p["adaln"], ctx.cond, ctx.cfg.d_model, 3)


def mamba_layer_apply(p, h, ctx: C.LayerCtx, state: Optional[dict] = None):
    """One pre-norm Mamba2 layer, σ-modulated and gated where ``ctx.cond``
    is set. ``train`` and ``prefill``: the whole sequence from a zero state
    (``mamba2_fwd``), no ``state``; ``prefill`` returns the final state.
    The serving modes run over the slot's ``state`` ({"h", "conv"},
    slot-leading views into the cache): ``decode``, one token, the new
    state written in place when ``ctx.commit`` (inactive slots hold
    theirs), never in a probe; ``prefill_chunk``, C tokens, slot b's first
    ``ctx.n_valid[b]`` advancing its state (``mamba2_chunk_step``).
    Returns (h, state): the new state in ``prefill``, else ``state``."""
    cfg = ctx.cfg
    s, c, g = _mods(p, ctx)
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
    elif ctx.mode in ("train", "prefill"):
        y, new = SSM.mamba2_fwd(p["mixer"], x, cfg.ssm, cfg.d_model)
        if ctx.mode == "prefill":
            state = new
    else:
        raise ValueError(f"unknown mode {ctx.mode!r}")
    return adaln.gate(h, y, g, impl=ctx.impl), state


def mamba_layer_two_pass(p, hc, hn, ctx: C.LayerCtx):
    """DB two-pass for a Mamba2 layer: the clean stream unmodulated with a
    plain residual, the noisy stream σ-modulated and gated. Returns (hc,
    hn)."""
    cfg = ctx.cfg
    s, c, g = _mods(p, ctx)
    xc = L.apply_norm(p["ln"], hc, cfg.norm)
    xn = adaln.modulate(L.apply_norm(p["ln"], hn, cfg.norm), s, c)
    yc, yn = SSM.mamba2_two_pass(p["mixer"], xc, xn, cfg.ssm, cfg.d_model)
    return hc + yc, adaln.gate(hn, yn, g, impl=ctx.impl)


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

    def _train_units(self, params, start: int, size: int) -> list:
        """[the unit's Mamba layers' trees] for units [start, start +
        size), one unbind per leaf and axis (``_unbind``: the backward
        stacks each leaf's grads in one pass)."""
        return [_unbind(u, 0, self.inner)
                for u in _unbind(params["units"]["mamba"], start, size)]

    def apply_units(self, params, h, start: int, size: int, ctx, cache=None,
                    reset_mask=None):
        """Run units [start, start + size): with no cache over the whole
        sequence (``train``; ``prefill`` returns the units' dense caches,
        {"mamba": final states (size, inner, B, ...), "shared_kv": {"k",
        "v"} (size, B, S, KV, hd)}), else over ``cache``, paged or dense
        (sliced to those units, ``cache_units``): each unit's Mamba layers
        over their state rows, then the shared block over the unit's KV.
        ``reset_mask`` restarts the hidden stream from the input ``h``
        before each flagged unit. Returns (h, cache)."""
        shared = params["shared"]
        if cache is None:
            assert reset_mask is None
            caches = []
            for layers in self._train_units(params, start, size):
                states = []
                for p in layers:
                    h, st = mamba_layer_apply(p, h, ctx)
                    states.append(st)
                h, kv = C.tlayer_apply(shared, h, ctx)
                caches.append({"mamba": _prefilled(ctx, states),
                               "shared_kv": kv})
            return h, _prefilled(ctx, caches)
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            c = KVC.cache_unit(cache, i)
            for j, p in enumerate(units[start + i]):
                h, _ = mamba_layer_apply(p, h, ctx,
                                         KVC.cache_unit(c["mamba"], j))
            h, _ = C.tlayer_apply(shared, h, ctx, cache=c["shared_kv"])
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        """DB two-pass training over units [start, start + size): per unit
        its Mamba layers through ``mamba_layer_two_pass``, then the shared
        block through ``tlayer_two_pass``. Returns (h_clean, h_noisy)."""
        shared = params["shared"]
        for layers in self._train_units(params, start, size):
            for p in layers:
                h_clean, h_noisy = mamba_layer_two_pass(p, h_clean, h_noisy,
                                                        ctx)
            h_clean, h_noisy = C.tlayer_two_pass(shared, h_clean, h_noisy,
                                                 ctx)
        return h_clean, h_noisy

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda") -> dict:
        """Zeroed dense caches for ``size`` units (all by default), JAX's
        layout: {"mamba": {"h" fp32, "conv" in ``dtype``} (size, inner,
        batch, ...), "shared_kv": {"k", "v"} (size, batch, C, KV, hd)}, C
        the ring of min(cache_len, sliding_window) under a window."""
        del start
        size = self.n_units if size is None else size
        cfg = self.cfg
        clen = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                else cache_len)
        one = SSM.mamba2_init_state(batch, cfg.ssm, cfg.d_model, dtype,
                                    device="meta")
        return {
            "mamba": {k: torch.zeros((size, self.inner) + t.shape,
                                     dtype=t.dtype, device=device)
                      for k, t in one.items()},
            "shared_kv": A.init_kv_cache(batch, clen, _dims(cfg), dtype,
                                         (size,), device),
        }

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
