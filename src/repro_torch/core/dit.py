"""Continuous-target diffusion model (DiT-style) under DiffusionBlocks —
paper §5.2 (port of ``repro.core.dit``). The model is already a denoiser, so
the conversion is the native fit: block b trains and serves only its
σ-range. B=1 recovers the standard DiT/EDM baseline. Inference applies ONE
block per Euler step ⇒ B× fewer layer evaluations per step (paper App. H).

Every layer runs ``tlayer_apply`` in train mode under ``bidirectional_mask``
(the ``full`` attention kernel under ``impl="kernels"``) with a per-example
σ embedding and no ``cond_mask``, so its two σ-gates go to the gate-residual
kernels; the LayerNorm is parametric, so the ln-modulate kernel is not used
(as in JAX's ``_norm_modulate``). Under ``impl="kernels"`` the l2 loss runs
the EDM-loss kernels and the sampler takes every Euler step (the last, to
σ = 0, included) through the fused Euler kernel; ``impl="ref"`` keeps the
plain compositions (``edm_l2_loss``, ``denoise_combine`` + ``euler_step``).

Random draws are explicit: σ and ε for the losses (else drawn from a
``torch.Generator``), ``z0`` (JAX draws σ_max · normal) or a generator for
``sample``.

``make_db_step`` / ``make_e2e_step`` train block b's layers plus the
periphery (``in_proj``, ``pos``, ``final_norm``, ``out_proj``, ``cond``), or
every param, through ``core.training``'s block views and AdamW; ``train``
is the loop of the JAX package's Table 2 benchmark with one AdamW state per
block (the JAX loop updates the whole tree with one state).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import DBConfig, ModelConfig, TrainConfig
from repro_torch.core import edm
from repro_torch.core import partition as P
from repro_torch.core import training as T
from repro_torch.models import common as C
from repro_torch.models.transformer import _unbind
from repro_torch.nn import adaln
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn.init import ParamSpec, init_params, stack_specs


class DiTDiffusionBlocks:
    def __init__(self, cfg: ModelConfig, db: DBConfig, data_dim: int,
                 n_tokens: int,
                 distribution: Optional[Sequence[int]] = None):
        self.cfg, self.db = cfg, db
        self.data_dim, self.n_tokens = data_dim, n_tokens
        self.ranges = P.unit_ranges(cfg.n_layers, db.num_blocks, distribution)
        self.edges = P.sigma_edges(db)
        d = cfg.d_model
        self.spec = {
            "in_proj": L.linear_spec(data_dim, d, (None, "embed")),
            "pos": ParamSpec((n_tokens, d), (None, "embed"), "embed", 0.02),
            "layers": stack_specs(C.tlayer_spec(cfg, db=True), cfg.n_layers),
            "final_norm": L.norm_spec(d, cfg.norm),
            "out_proj": L.linear_spec(d, data_dim, ("embed", None),
                                      init="zeros"),
            "cond": adaln.sigma_embed_spec(db.cond_dim, d),
        }

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return init_params(self.spec, generator, dtype)

    def denoise(self, params, z, sigma, start: int, size: int,
                impl: str = "kernels"):
        """F_θ for layers [start, start+size): z (B, T, data_dim), sigma
        (B, 1, 1). Returns F (B, T, data_dim) (EDM F-space)."""
        _, _, c_in, _ = edm.preconditioning(sigma, self.db.sigma_data)
        h = L.linear(params["in_proj"], (c_in * z).float())
        h = h + params["pos"][None]
        cond = adaln.sigma_embedding(params["cond"],
                                     torch.log(sigma.reshape(-1)) / 4.0,
                                     self.db.cond_dim)
        ctx = C.LayerCtx(cfg=self.cfg, mode="train",
                         positions=torch.arange(self.n_tokens),
                         mask_mod=A.bidirectional_mask, cond=cond, impl=impl)
        for p in _unbind(params["layers"], start, size):
            h, _ = C.tlayer_apply(p, h, ctx)
        h = L.apply_norm(params["final_norm"], h, self.cfg.norm)
        return L.linear(params["out_proj"], h)

    def d_hat(self, params, z, sigma, block: int, impl: str = "kernels"):
        start, size = self.ranges[block]
        f = self.denoise(params, z, sigma, start, size, impl)
        return edm.denoise_combine(z, f, sigma, self.db.sigma_data)

    def block_loss(self, params, b: int, y, generator=None, *, sigma=None,
                   eps=None, unit_range=None, impl: str = "kernels"):
        """Eq. (6) with the L2 inner loss in F-space (unit weight, the EDM
        identity w(σ)c_out² = 1). σ (B, 1, 1) is drawn in block b's
        overlap-expanded range and ε like y, from ``generator`` unless
        given."""
        start, size = unit_range or self.ranges[b]
        Bsz = y.shape[0]
        if sigma is None:
            q_lo, q_hi = P.block_qrange(self.db, b)
            sigma = edm.sample_sigma_in_qrange(generator, (Bsz, 1, 1),
                                               self.db, q_lo, q_hi,
                                               device=y.device)
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=y.device).reshape(Bsz, 1, 1)
        z, _ = edm.add_noise(generator, y, sigma, eps=eps)
        f = self.denoise(params, z, sigma, start, size, impl)
        if impl == "kernels":
            from repro_torch.kernels import ops as kops
            loss = kops.edm_loss(f, z, y, sigma.reshape(Bsz),
                                 sigma_data=self.db.sigma_data)
        else:
            loss = edm.edm_l2_loss(f, z, y, sigma, self.db.sigma_data)
        return loss, {"l2": loss}

    def e2e_loss(self, params, y, generator=None, *, sigma=None, eps=None,
                 impl: str = "kernels"):
        """Standard EDM training of the FULL stack (the paper's DiT
        baseline); σ is drawn as JAX draws it, in block 0's range."""
        return self.block_loss(params, 0, y, generator, sigma=sigma, eps=eps,
                               unit_range=(0, self.cfg.n_layers), impl=impl)

    @torch.no_grad()
    def sample(self, params, batch: int, num_steps: int = 18,
               blockwise: bool = True, *, z0=None, generator=None,
               impl: str = "kernels"):
        """Euler sampler. blockwise=True: one block per step (DB); False:
        the full stack per step (baseline). ``z0`` (batch, T, data_dim) is
        the initial z, else σ_max · N(0, 1) from ``generator``. Returns the
        samples and the layer-evaluation count (the inference-cost metric of
        Table 2 / App. H)."""
        sched = P.sampling_schedule(self.db, num_steps)
        dev = params["pos"].device
        shape = (batch, self.n_tokens, self.data_dim)
        if z0 is None:
            z = self.db.sigma_max * torch.randn(
                shape, generator=generator, dtype=torch.float32, device=dev)
        else:
            z = torch.as_tensor(z0, dtype=torch.float32,
                                device=dev).reshape(shape)
        layer_evals = 0
        for i in range(len(sched) - 1):
            s_from, s_to = float(sched[i]), float(sched[i + 1])
            sig = torch.full((batch, 1, 1), s_from, dtype=torch.float32,
                             device=dev)
            if blockwise:
                start, size = self.ranges[P.block_of_sigma(self.db, s_from)]
            else:
                start, size = 0, self.cfg.n_layers
            layer_evals += size
            f = self.denoise(params, z, sig, start, size, impl)
            z = edm.sampler_step(z, f, s_from, s_to,
                                 self.db.sigma_data, impl)
        return z, layer_evals


# ---------------------------------------------------------------------------
# Training steps and loop
# ---------------------------------------------------------------------------

def make_db_step(dit: DiTDiffusionBlocks, b: int, tcfg: TrainConfig,
                 impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) for block b: gradients and AdamW moments
    for ``layers[start:start+size]`` and the periphery only.

    step_fn(params, opt_state_b, y, generator=None, *, sigma=None, eps=None)
    -> (params, opt_state_b, loss, metrics)"""
    start, size = dit.ranges[b]

    def loss_fn(view, y, generator=None, *, sigma=None, eps=None):
        return dit.block_loss(view, b, y, generator, sigma=sigma, eps=eps,
                              unit_range=(0, size), impl=impl)

    return T.make_view_train_step(loss_fn, tcfg, (start, size))


def make_e2e_step(dit: DiTDiffusionBlocks, tcfg: TrainConfig,
                  impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) over every param, with the signature of
    ``make_db_step``'s step."""
    def loss_fn(view, y, generator=None, *, sigma=None, eps=None):
        return dit.e2e_loss(view, y, generator, sigma=sigma, eps=eps,
                            impl=impl)

    return T.make_view_train_step(loss_fn, tcfg)


def train(dit: DiTDiffusionBlocks, tcfg: TrainConfig, data_iter,
          generator: torch.Generator, params=None, blockwise: bool = True,
          impl: str = "kernels", log=print):
    """The Table 2 training loop: ``blockwise`` trains a block drawn
    uniformly from ``generator`` each step (each block with its own AdamW
    state), else the full stack (one state). ``data_iter`` yields (B, T,
    data_dim) arrays. Returns (params, history [(it, block, loss)]), block
    -1 for the full stack."""
    dev = generator.device
    if params is None:
        params = dit.init(generator)
    steps = ([make_db_step(dit, b, tcfg, impl)
              for b in range(dit.db.num_blocks)] if blockwise
             else [make_e2e_step(dit, tcfg, impl)])
    batches = ((torch.as_tensor(np.asarray(y), dtype=torch.float32).to(dev),)
               for y in data_iter)
    return T.train_views(steps, params, batches, generator, tcfg, blockwise,
                         "dit", log)
