"""Noise-level conditioning (paper §3.1 Step 3): DiT-style AdaLN
(port of ``repro.nn.adaln``).

``sigma_embedding`` maps log σ through Fourier features + MLP to a
conditioning vector c; each layer's ``adaln`` head produces (shift, scale,
gate) pairs that modulate the pre-norm stream and gate the residual branch:

    h' = h + gate * f( norm(h) * (1 + scale) + shift )

``gate`` routes the unmasked σ-conditioned case, a per-example ``(B, 1, d)``
gate, through the differentiable gate-residual kernels
(``kernels.fused_adaln``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.init import ParamSpec
from repro_torch.nn.layers import as_dtype


def sigma_embed_spec(cond_dim: int, d_model: int):
    return {
        "mlp1": {"w": ParamSpec((cond_dim, d_model), (None, "mlp"))},
        "mlp2": {"w": ParamSpec((d_model, d_model), (None, "mlp"))},
    }


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """fp32 linspace with ``jnp.linspace``'s formula (start·(1−t) + stop·t,
    t = i/(num−1)), so the Fourier frequencies match the JAX package's bits;
    ``torch.linspace`` rounds differently in the last place."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start * (1.0 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def fourier_features(log_sigma: torch.Tensor, dim: int) -> torch.Tensor:
    """log_sigma: (B,) -> (B, dim). The EDM c_noise = log(σ)/4 convention is
    applied by the caller."""
    half = dim // 2
    freqs = torch.exp(_linspace(0.0, 6.0, half, log_sigma.device))
    ang = log_sigma[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sigma_embedding(params, log_sigma: torch.Tensor, cond_dim: int,
                    dtype=torch.float32) -> torch.Tensor:
    ff = fourier_features(log_sigma.float(), cond_dim).to(dtype)
    h = F.silu(ff @ as_dtype(params["mlp1"]["w"], dtype))
    return F.silu(h @ as_dtype(params["mlp2"]["w"], dtype))


def adaln_spec(d_model: int, n_mods: int = 6):
    """Per-layer modulation head: cond (d) -> n_mods * d (zero-init =>
    identity)."""
    return {"w": ParamSpec((d_model, n_mods * d_model), (None, "mlp"),
                           "zeros"),
            "b": ParamSpec((n_mods * d_model,), ("mlp",), "zeros")}


def adaln_mods(params, cond: torch.Tensor, d_model: int,
               n_mods: int = 6) -> Tuple[torch.Tensor, ...]:
    """cond: (B, d) -> n_mods tensors of (B, 1, d) (views into one product)."""
    m = cond @ as_dtype(params["w"], cond.dtype) \
        + as_dtype(params["b"], cond.dtype)
    return tuple(m[:, None, i * d_model:(i + 1) * d_model]
                 for i in range(n_mods))


def modulate(x: torch.Tensor, shift: Optional[torch.Tensor],
             scale: Optional[torch.Tensor],
             cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if shift is None:
        return x
    y = x * (1.0 + scale.to(x.dtype)) + shift.to(x.dtype)
    if cond_mask is None:
        return y
    return torch.where(cond_mask[None, :, None], y, x)


def gate(residual: torch.Tensor, branch: torch.Tensor,
         g: Optional[torch.Tensor],
         cond_mask: Optional[torch.Tensor] = None,
         impl: str = "kernels") -> torch.Tensor:
    """``impl="kernels"`` sends a per-example ``(B, 1, d)`` gate with no
    ``cond_mask`` to the gate-residual kernels, forward and backward (their
    plain versions on CPU tensors); ``impl="ref"`` and the masked or
    unconditioned cases stay in plain torch."""
    if g is None:
        return residual + branch
    if impl == "kernels" and cond_mask is None and g.ndim == 3 \
            and g.shape[1] == 1:
        from repro_torch.kernels import ops as kops
        return kops.gate_residual(residual, branch, g[:, 0])
    gated = branch * (1.0 + g.to(branch.dtype))
    if cond_mask is not None:
        gated = torch.where(cond_mask[None, :, None], gated, branch)
    return residual + gated
