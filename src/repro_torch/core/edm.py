"""EDM machinery (Karras et al. 2022) as the sampler uses it (port of
``repro.core.edm``).

Variance-Exploding formulation: z_σ = y + σ ε. Denoiser parameterization

    D_θ(z; σ) = c_skip(σ) z + c_out(σ) F_θ(c_in(σ) z; c_noise(σ))

with  c_skip = σ_d²/(σ²+σ_d²),  c_out = σ σ_d/√(σ²+σ_d²),
      c_in  = 1/√(σ²+σ_d²),    c_noise = log(σ)/4.
"""
from __future__ import annotations

import torch


def preconditioning(sigma: torch.Tensor, sigma_data: float):
    """Returns (c_skip, c_out, c_in, c_noise); sigma is a tensor."""
    s2 = sigma ** 2
    d2 = sigma_data ** 2
    c_skip = d2 / (s2 + d2)
    c_out = sigma * sigma_data * torch.rsqrt(s2 + d2)
    c_in = torch.rsqrt(s2 + d2)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def denoise_combine(z: torch.Tensor, f_out: torch.Tensor,
                    sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """D = c_skip z + c_out F. z is the UNSCALED noisy input (the block saw
    c_in·z)."""
    c_skip, c_out, _, _ = preconditioning(sigma, sigma_data)
    return c_skip * z + c_out * f_out


def euler_step(z: torch.Tensor, d_hat: torch.Tensor, sigma_from: float,
               sigma_to: float) -> torch.Tensor:
    """PF-ODE Euler step σ_from -> σ_to (< σ_from), paper Eq. (5):
    z' = (σ_to/σ_from) z + (1 − σ_to/σ_from) D (returns D at σ_to = 0)."""
    r = sigma_to / sigma_from
    return r * z + (1.0 - r) * d_hat
