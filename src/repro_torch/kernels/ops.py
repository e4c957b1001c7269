"""Routing from the model's training calls onto the kernels (port of
``repro.kernels.ops``; the serving attends call theirs from ``nn.cache``).

``ln_modulate``, ``gate_residual``, ``euler_update`` and ``edm_loss`` are
the differentiable fused AdaLN, Euler-step and EDM-loss kernels.
``flash_attention`` is the (B, S, H, hd) adapter ``nn.attention.attend``
uses under ``impl="kernels"``: it maps the mask constructor onto a kernel
mask kind by its ``kernel_mask`` tag and hands the kernels (B, H, S, hd)
transposed VIEWS, which they read through strides (no copy). Untagged masks and positions that are not an arange
raise: the kernels derive positions from indices, so either would be
silently wrong attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import edm_loss as _edm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adaln as _ad


def _route_mask(mask_mod):
    """Map an ``attention.MaskMod`` onto a kernel mask kind: the tag
    ``(kind, window, mask_seq)`` the supported constructors carry; no mask
    is ``full``. Anything untagged is rejected."""
    if mask_mod is None:
        return ("full", None, None)
    tag = getattr(mask_mod, "kernel_mask", None)
    if tag is None:
        raise NotImplementedError(
            f"mask_mod {getattr(mask_mod, '__name__', mask_mod)!r} has no "
            "kernel equivalent; use impl='ref' (or tag the mask constructor "
            "with .kernel_mask = (kind, window, mask_seq))")
    return tag


def _check_positions(pos, n: int, name: str):
    """The kernels derive mask positions from indices, so ``pos`` must be
    ``arange(n)``: a wrong length or wrong contents (packed segments,
    offsets, ring buffers) raise."""
    if pos is None:
        return
    if pos.shape[0] != n:
        raise NotImplementedError(
            f"flash attention requires {name} == arange({n}); got length "
            f"{pos.shape[0]}")
    if not torch.equal(pos.detach().to("cpu", torch.int64),
                       torch.arange(n)):
        raise NotImplementedError(
            f"flash attention requires {name} == arange({n}); got "
            "non-standard positions (packed/offset/ring positions have no "
            "kernel mask equivalent, use impl='ref')")


def flash_attention(q, k, v, *, mask_mod=None, qpos=None, kpos=None):
    """q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    kind, win, mseq = _route_mask(mask_mod)
    _check_positions(qpos, q.shape[1], "qpos")
    _check_positions(kpos, k.shape[1], "kpos")
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), mask_kind=kind, window=win,
                              mask_seq=mseq)
    return out.transpose(1, 2)


def ln_modulate(x, scale, shift):
    return _ad.ln_modulate(x, scale, shift)


def gate_residual(res, branch, gate):
    return _ad.gate_residual(res, branch, gate)


def euler_update(z, f, sigma, sigma_to, sigma_data: float = 0.5):
    return _ad.fused_euler(z, f, sigma, sigma_to, sigma_data)


def edm_loss(f, z, y, sigma, sigma_data: float = 0.5):
    return _edm.edm_loss(f, z, y, sigma, sigma_data)
