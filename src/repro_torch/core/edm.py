"""EDM machinery (Karras et al. 2022) as the sampler and the training
losses use it (port of ``repro.core.edm``).

Variance-Exploding formulation: z_σ = y + σ ε. Denoiser parameterization

    D_θ(z; σ) = c_skip(σ) z + c_out(σ) F_θ(c_in(σ) z; c_noise(σ))

with  c_skip = σ_d²/(σ²+σ_d²),  c_out = σ σ_d/√(σ²+σ_d²),
      c_in  = 1/√(σ²+σ_d²),    c_noise = log(σ)/4,
and loss weighting w(σ) = (σ²+σ_d²)/(σ σ_d)².

The random draws (u for σ, ε for the noise) can be passed in; otherwise
they come from an explicit ``torch.Generator`` (torch and JAX give
different numbers from one seed, so tests hand both sides the same draws).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import DBConfig


def weighting(sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    return (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2


def preconditioning(sigma: torch.Tensor, sigma_data: float):
    """Returns (c_skip, c_out, c_in, c_noise); sigma is a tensor."""
    s2 = sigma ** 2
    d2 = sigma_data ** 2
    c_skip = d2 / (s2 + d2)
    c_out = sigma * sigma_data * torch.rsqrt(s2 + d2)
    c_in = torch.rsqrt(s2 + d2)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def sample_sigma_in_qrange(generator: Optional[torch.Generator], shape,
                           db: DBConfig, q_lo: float, q_hi: float, *,
                           u: Optional[torch.Tensor] = None,
                           device=None) -> torch.Tensor:
    """Truncated log-normal σ by the inverse CDF of a uniform q in
    [q_lo, q_hi] (q is the CDF of log σ under N(P_mean, P_std²)). ``u`` is
    that uniform draw, else it comes from ``generator``."""
    if u is None:
        u = q_lo + (q_hi - q_lo) * torch.rand(
            shape, generator=generator, dtype=torch.float32,
            device=device if device is not None else
            (generator.device if generator is not None else None))
    return torch.exp(db.p_mean + db.p_std * torch.special.ndtri(u.float()))


def add_noise(generator: Optional[torch.Generator], y: torch.Tensor,
              sigma: torch.Tensor, *, eps: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y: (..., d); sigma broadcastable to y[..., :1]. Returns (z_σ, ε);
    ``eps`` is the standard-normal draw, else it comes from ``generator``."""
    if eps is None:
        eps = torch.randn(y.shape, generator=generator, dtype=torch.float32,
                          device=y.device)
    eps = eps.to(device=y.device, dtype=torch.float32)
    return y + sigma * eps.to(y.dtype), eps


def denoise_combine(z: torch.Tensor, f_out: torch.Tensor,
                    sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """D = c_skip z + c_out F. z is the UNSCALED noisy input (the block saw
    c_in·z)."""
    c_skip, c_out, _, _ = preconditioning(sigma, sigma_data)
    return c_skip * z + c_out * f_out


def edm_l2_loss(f_out: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """w(σ)·||D − y||² rewritten in F-space with unit weight:
    ||F − (y − c_skip z)/c_out||² (elementwise mean)."""
    c_skip, c_out, _, _ = preconditioning(sigma, sigma_data)
    target = (y - c_skip * z) / c_out
    return torch.mean(torch.square(f_out.float() - target.float()))


def euler_step(z: torch.Tensor, d_hat: torch.Tensor, sigma_from: float,
               sigma_to: float) -> torch.Tensor:
    """PF-ODE Euler step σ_from -> σ_to (< σ_from), paper Eq. (5):
    z' = (σ_to/σ_from) z + (1 − σ_to/σ_from) D (returns D at σ_to = 0)."""
    r = sigma_to / sigma_from
    return r * z + (1.0 - r) * d_hat


def sampler_step(z: torch.Tensor, f_out: torch.Tensor, sigma_from: float,
                 sigma_to: float, sigma_data: float,
                 impl: str = "kernels") -> torch.Tensor:
    """One sampler step σ_from → σ_to of z (B, ...) given the denoiser's F
    at σ_from: under ``impl="kernels"`` the fused Euler kernel (combine and
    step in one pass), else ``denoise_combine`` + ``euler_step`` (D itself
    at σ_to = 0), as the JAX samplers compose them."""
    sig = torch.full((z.shape[0],), sigma_from, dtype=torch.float32,
                     device=z.device)
    if impl == "kernels":
        from repro_torch.kernels import ops as kops
        return kops.euler_update(z, f_out, sig, torch.full_like(sig, sigma_to),
                                 sigma_data)
    sig = sig.reshape((-1,) + (1,) * (z.ndim - 1))
    d_hat = denoise_combine(z, f_out.float(), sig, sigma_data)
    return euler_step(z, d_hat, sigma_from, sigma_to) if sigma_to > 0 \
        else d_hat
