"""xLSTM model (port of ``repro.models.ssm_model``), its serving half: units
of one (sLSTM, mLSTM) block pair, each block a pre-norm residual,
σ-modulated and gated where ``ctx.cond`` is set (the denoising probes; the
commit passes run with no cond, their gates plain residual adds).

The serving cache holds the cells' states and no pages:

    {"mlstm": (C (n_units, slots, H, hd, hd), n (n_units, slots, H, hd),
               m (n_units, slots, H)),
     "slstm": (h, c (n_units, slots, H, hd), n, m (n_units, slots, H))}

all fp32 under every policy (JAX's state constructors pin it; the family
also computes in fp32, ``Policy.fp32_families``), tuples as JAX's so the
leaves flatten in its order. The states are written in place
(``models.common.write_state``), so the batcher's CUDA graphs hold their
addresses; a denoising probe (``ctx.commit=False``) leaves them
bit-unchanged, inactive slots hold theirs, and a recycled slot is reset
to the init values (m -1e30, the sLSTM's n 1e-6), not to zero.

Modes: ``decode`` (one token a slot through ``slstm_decode_step`` and
``mlstm_decode_step``) and ``prefill_chunk`` (``chunk_token_scan`` over
those same steps, slot b's tokens past ``ctx.n_valid[b]`` holding its
state), as JAX's; the state has no pages, so the dense cache
(``init_cache``) and the paged one are the same tree, and ``decode`` runs
over either. ``prefill`` runs the sequence forms over the prompt from the
init state (``slstm_fwd`` and ``mlstm_fwd(return_state=True)``, the
chunked form) and returns each block's final state, stacked on the unit
axis. Training: the uncached ``apply_units`` in the ``train`` mode (each
block over the whole sequence, ``slstm_fwd`` and ``mlstm_fwd``: the
end-to-end baseline) and ``apply_units_two_pass`` (DiffusionBlocks' block
loss, which routes the recurrent families to two-pass: ``slstm_two_pass``
and ``mlstm_two_pass``, the clean stream a plain residual, the noisy
stream σ-modulated and gated).

JAX scans over units with ``uscan``; the port loops over them in Python,
as ``HybridModel.apply_units`` does. Conditioning: none
(``max_cond_tokens`` 0). ``kv_carries_all_state`` is False (the state is
per slot, not paged), so the prefix cache and a ``SharedPagePool`` refuse
the family, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common as C
from repro_torch.models.model_api import BaseModel
from repro_torch.models.transformer import (_index, _prefilled, _unbind,
                                           _unit_views)
from repro_torch.nn import adaln
from repro_torch.nn import cache as KVC
from repro_torch.nn import layers as L
from repro_torch.nn import xlstm as X
from repro_torch.nn.init import stack_specs

_STEPS = {"slstm": X.slstm_decode_step, "mlstm": X.mlstm_decode_step}
_FWDS = {"slstm": X.slstm_fwd, "mlstm": X.mlstm_fwd}
_TWO_PASS = {"slstm": X.slstm_two_pass, "mlstm": X.mlstm_two_pass}
_INITS = {"slstm": X.SLSTM_INIT, "mlstm": X.MLSTM_INIT}


def _block_spec(cfg, db: bool, kind: str):
    spec = {"ln": L.norm_spec(cfg.d_model, cfg.norm)}
    if kind == "slstm":
        spec["cell"] = X.slstm_spec(cfg.d_model, cfg.n_heads, cfg.xlstm)
    else:
        spec["cell"] = X.mlstm_spec(cfg.d_model, cfg.n_heads, cfg.xlstm)
    if db:
        spec["adaln"] = adaln.adaln_spec(cfg.d_model, n_mods=3)
    return spec


def _mods3(p, ctx: C.LayerCtx):
    """(shift, scale, gate) from the block's AdaLN head where ``ctx.cond``
    is set, else Nones."""
    if ctx.cond is not None and "adaln" in p:
        return adaln.adaln_mods(p["adaln"], ctx.cond, ctx.cfg.d_model, 3)
    return None, None, None


def _block_apply(p, h, ctx: C.LayerCtx, kind: str, state=None):
    """One pre-norm xLSTM block. ``train`` and ``prefill``: the whole
    sequence from the init state, no ``state``; ``prefill`` returns the
    final state. The serving modes run over the slots' ``state`` (a tuple
    of slot-leading views into the cache): ``decode``, one token, the new
    state written in place when ``ctx.commit`` (inactive slots hold
    theirs), never in a probe; ``prefill_chunk``, C tokens through the
    token scan. Returns (h, state): the new state in ``prefill``, else
    ``state``."""
    cfg = ctx.cfg
    s, c, g = _mods3(p, ctx)
    x = adaln.modulate(L.apply_norm(p["ln"], h, cfg.norm), s, c)

    def cell(xt, st):
        return _STEPS[kind](p["cell"], xt, cfg.n_heads, cfg.xlstm, st)
    if ctx.mode == "decode":
        y, new = cell(x, state)
        if ctx.commit:
            C.write_state(state, C.masked_state_update(new, state,
                                                       ctx.active))
    elif ctx.mode == "prefill_chunk":
        y, new = C.chunk_token_scan(cell, x, state, ctx.n_valid)
        C.write_state(state, new)
    elif ctx.mode == "train":
        y, _ = _FWDS[kind](p["cell"], x, cfg.n_heads, cfg.xlstm)
    elif ctx.mode == "prefill":
        kw = {"return_state": True} if kind == "mlstm" else {}
        y, state = _FWDS[kind](p["cell"], x, cfg.n_heads, cfg.xlstm, **kw)
    else:
        raise ValueError(f"unknown mode {ctx.mode!r}")
    return adaln.gate(h, y, g, impl=ctx.impl), state


def _block_two_pass(p, hc, hn, ctx: C.LayerCtx, kind: str):
    """DB two-pass for one block: the clean stream unmodulated with a plain
    residual, the noisy stream σ-modulated and gated. Returns (hc, hn)."""
    cfg = ctx.cfg
    s, c, g = _mods3(p, ctx)
    xc = L.apply_norm(p["ln"], hc, cfg.norm)
    xn = adaln.modulate(L.apply_norm(p["ln"], hn, cfg.norm), s, c)
    yc, yn = _TWO_PASS[kind](p["cell"], xc, xn, cfg.n_heads, cfg.xlstm)
    return hc + yc, adaln.gate(hn, yn, g, impl=ctx.impl)


class XLSTMModel(BaseModel):
    """xlstm-125m: ``n_units`` units of one sLSTM and one mLSTM block.
    Params: ``units/slstm`` and ``units/mlstm`` stacked (n_units, ...),
    JAX's tree."""

    @property
    def n_units(self) -> int:
        return self.cfg.n_layers // 2      # (sLSTM, mLSTM) pairs

    def build_spec(self):
        db = self.db is not None
        spec = self.common_spec()
        spec["units"] = {kind: stack_specs(_block_spec(self.cfg, db, kind),
                                           self.n_units)
                         for kind in ("slstm", "mlstm")}
        return spec

    def unit_params(self, params) -> list:
        """Per-unit views of the stacked ``units`` tree (``_unit_views``)."""
        return _unit_views(self, params["units"],
                           lambda t: [_index(t, u)
                                      for u in range(self.n_units)])

    def apply_units(self, params, h, start: int, size: int, ctx, cache=None,
                    reset_mask=None):
        """Run units [start, start + size), each unit's sLSTM block then
        its mLSTM block: with no cache over the whole sequence (``train``;
        one unbind a leaf, so the backward stacks each leaf's grads in one
        pass; ``prefill`` returns the units' final states stacked, the
        cache's layout), else over the serving ``cache`` (sliced to those
        units, ``cache_units``). ``reset_mask`` restarts the hidden stream
        from the input ``h`` before each flagged unit. Returns (h,
        cache)."""
        if cache is None:
            assert reset_mask is None
            caches = []
            for p in _unbind(params["units"], start, size):
                states = {}
                for kind in ("slstm", "mlstm"):
                    h, states[kind] = _block_apply(p[kind], h, ctx, kind)
                caches.append(states)
            return h, _prefilled(ctx, caches)
        h0 = h
        units = self.unit_params(params)
        for i in range(size):
            if reset_mask is not None and reset_mask[i]:
                h = h0
            c = KVC.cache_unit(cache, i)
            for kind in ("slstm", "mlstm"):
                h, _ = _block_apply(units[start + i][kind], h, ctx, kind,
                                    c[kind])
        return h, cache

    def apply_units_two_pass(self, params, h_clean, h_noisy, start: int,
                             size: int, ctx):
        """DB two-pass training over units [start, start + size): each
        unit's sLSTM block then its mLSTM block through
        ``_block_two_pass``. Returns (h_clean, h_noisy)."""
        for p in _unbind(params["units"], start, size):
            for kind in ("slstm", "mlstm"):
                h_clean, h_noisy = _block_two_pass(p[kind], h_clean,
                                                   h_noisy, ctx, kind)
        return h_clean, h_noisy

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   start: int = 0, size: Optional[int] = None,
                   device="cuda") -> dict:
        """The init states of ``size`` units (all by default), stacked:
        each leaf (size, batch, ...) fp32 whatever ``dtype`` (JAX's state
        constructors pin it); ``cache_len`` is not used (the state is O(1)
        a slot), as in JAX."""
        del cache_len, dtype, start
        size = self.n_units if size is None else size
        cfg = self.cfg
        d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
        one = {"slstm": X.slstm_init_state(batch, cfg.n_heads, cfg.d_model,
                                           device=device),
               "mlstm": X.mlstm_init_state(batch, cfg.n_heads, d_in,
                                           device=device)}
        return {k: tuple(t.expand(size, *t.shape).contiguous() for t in st)
                for k, st in one.items()}

    def init_paged_cache(self, num_slots: int, n_pages: int, page_size: int,
                         policy=None, device="cuda") -> dict:
        """The state is O(1) a slot: nothing to page. The engines' lengths,
        page tables and active masks still apply; the pages are simply
        unused. The policy is not threaded: the states are fp32 under
        every policy, as JAX's."""
        del n_pages, policy
        return self.init_cache(num_slots, page_size, device=device)

    def reset_paged_slots(self, cache, slot_mask):
        """Restore the masked slots' state (axis 1) to the init values, in
        place: m to -1e30 and the sLSTM's n to 1e-6, not to zero."""
        idx = torch.nonzero(torch.as_tensor(slot_mask))[:, 0]
        if idx.numel():
            for kind, init in _INITS.items():
                for t, v in zip(cache[kind], init):
                    t.index_fill_(1, idx.to(t.device), v)
        return cache

    @property
    def paged_state_axes(self) -> dict:
        # state leaves are (units, slots, ...): slot axis 1, which is also
        # what the inherited ``cache_batch`` reads
        return {"slstm": 1, "mlstm": 1}
