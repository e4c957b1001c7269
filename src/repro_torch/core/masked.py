"""Masked diffusion language model adapter (paper §5.3 + Appendix D; port
of ``repro.core.masked``).

Continuous-time MDM (MD4-style) with linear schedule α(t) = 1 − t. App. D
shows the training mass is uniform in α, so DiffusionBlocks partitions the
masking schedule by equal decrements of α: block b owns t ∈ [t_{b-1}, t_b]
with t_b = b/B. Each block trains ONLY on its masking-rate interval; the
global NELBO decomposes as Σ_b L_b (Eq. 13).

The model is the dense decoder under ``bidirectional_mask`` (the ``full``
attention kernel under ``impl="kernels"``) with the t embedding on every
position and no ``cond_mask``, so its two σ-gates run the gate-residual
kernels; its LayerNorm is parametric, so the ln-modulate kernel is not used.

Random draws are explicit: t (B, 1) and the mask uniforms (B, S) of
``block_loss`` (else drawn from a ``torch.Generator``), the same pairs for
``nelbo_bpc``, and for ``generate`` each step's Gumbel noise (JAX's
``jax.random.categorical`` is argmax(logits + gumbel)) and unmask uniforms.

``make_db_step`` / ``make_e2e_step`` train block b's layers plus the
periphery (``embed``, ``final_norm``, ``head``, ``cond``), or every param,
through ``core.training``'s block views and AdamW; ``train`` is the loop of
the JAX package's Table 3 benchmark with one AdamW state per block (the JAX
loop updates the whole tree with one state).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DBConfig, ModelConfig, TrainConfig
from repro_torch.core import partition as P
from repro_torch.core import training as T
from repro_torch.core.blocks import gumbel
from repro_torch.models import build_model
from repro_torch.models.common import LayerCtx
from repro_torch.nn import adaln
from repro_torch.nn import attention as A


def sampler_times(n: int) -> np.ndarray:
    """The n + 1 demasking times 1 → 0 of ``generate`` in fp32:
    ``jnp.linspace(1, 0, n + 1)`` as the reference computes it on the CPU,
    1 − i · fp32(1/n) (the division by n taken as a product with its
    reciprocal), so that the block and unmask rates match it bit for bit."""
    i = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(n))
    return np.concatenate([np.float32(1) - i, np.zeros(1, np.float32)])


class MaskedDiffusionBlocks:
    """vocab_size includes the [MASK] token at index vocab_size-1."""

    def __init__(self, cfg: ModelConfig, db: DBConfig,
                 distribution: Optional[Sequence[int]] = None):
        self.cfg, self.db = cfg, db
        self.mask_id = cfg.vocab_size - 1
        self.model = build_model(cfg, db)
        self.ranges = P.unit_ranges(self.model.n_units, db.num_blocks,
                                    distribution)

    @property
    def spec(self):
        return self.model.spec

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return self.model.init(generator, dtype)

    def block_of_t(self, t: float) -> int:
        """Block 0 serves the HIGHEST masking rates (t near 1), mirroring
        the σ ordering of the continuous case."""
        B = self.db.num_blocks
        return min(B - 1, int((1.0 - t) * B))

    def t_range(self, b: int) -> Tuple[float, float]:
        B = self.db.num_blocks
        return 1.0 - (b + 1) / B, 1.0 - b / B

    def _ctx(self, params, t, S: int, impl: str) -> LayerCtx:
        cond = adaln.sigma_embedding(params["cond"], t, self.db.cond_dim)
        return LayerCtx(cfg=self.cfg, mode="train",
                        positions=torch.arange(S),
                        mask_mod=A.bidirectional_mask, cond=cond, impl=impl)

    def _forward(self, params, tokens_masked, t, start: int, size: int,
                 impl: str = "kernels"):
        """Logits (B, S, V) of units [start, start + size) at times t
        (B,)."""
        ctx = self._ctx(params, t, tokens_masked.shape[1], impl)
        h = self.model.embed(params, tokens_masked)
        h, _ = self.model.apply_units(params, h, start, size, ctx)
        return self.model.logits(params, h)

    def block_loss(self, params, b: int, tokens, generator=None, *, t=None,
                   u=None, unit_range=None, impl: str = "kernels"):
        """Eq. (13): E_t∈[t_lo,t_hi] [ (−α'/(1−α)) Σ_masked CE ] with linear
        α: weight 1/t, normalized per token. t (B, 1) is drawn uniformly in
        block b's range and the mask uniforms u (B, S) on [0, 1), from
        ``generator`` unless given; t is floored at 1e-3 and a token is
        masked where u < t."""
        start, size = unit_range or self.ranges[b]
        Bsz, S = tokens.shape
        dev = tokens.device
        if t is None:
            lo, hi = self.t_range(b)
            t = lo + (hi - lo) * torch.rand((Bsz, 1), generator=generator,
                                            device=dev)
        if u is None:
            u = torch.rand((Bsz, S), generator=generator, device=dev)
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=dev).reshape(Bsz, 1).clamp_min(1e-3)
        mask = torch.as_tensor(u, dtype=torch.float32,
                               device=dev).reshape(Bsz, S) < t
        x_t = torch.where(mask, self.mask_id, tokens)
        logits = self._forward(params, x_t, t[:, 0], start, size, impl)
        logp = torch.log_softmax(logits.float(), -1)
        ce = -torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
        per_tok = torch.sum(mask * ce * (1.0 / t), dim=1) / S
        loss = per_tok.mean()
        return loss, {"ce": loss, "mask_rate": mask.float().mean()}

    def e2e_loss(self, params, tokens, generator=None, *, t=None, u=None,
                 impl: str = "kernels"):
        """Standard MDM over the full stack (the MD4 baseline): block 0's
        loss, so t ~ U(0, 1) only when num_blocks = 1, as the reference's
        Table 3 builds its baseline."""
        return self.block_loss(params, 0, tokens, generator, t=t, u=u,
                               unit_range=(0, self.model.n_units), impl=impl)

    @torch.no_grad()
    def nelbo_bpc(self, params, tokens, generator=None, n_samples: int = 4,
                  blockwise: bool = True, *, draws=None,
                  impl: str = "kernels") -> torch.Tensor:
        """Monte-Carlo NELBO in bits/char. ``blockwise`` evaluates each t
        with the block that owns it (DB); otherwise the full stack
        (baseline). ``draws`` yields the (t, u) pair of each loss in loop
        order (samples, then blocks), else they come from ``generator``."""
        Bn = self.db.num_blocks if blockwise else 1
        draws = iter(draws) if draws is not None else None
        total = 0.0
        for _ in range(n_samples):
            for b in range(Bn):
                t, u = next(draws) if draws is not None else (None, None)
                if blockwise:
                    loss, _ = self.block_loss(params, b, tokens, generator,
                                              t=t, u=u, impl=impl)
                    total = total + loss / Bn
                else:
                    loss, _ = self.e2e_loss(params, tokens, generator, t=t,
                                            u=u, impl=impl)
                    total = total + loss
        # each block's expectation covers 1/B of t uniformly, so averaging
        # the per-block losses IS the full-integral Monte-Carlo estimate
        return total / n_samples / math.log(2.0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, params, batch: int, seq_len: int,
                 num_steps: Optional[int] = None, *, generator=None,
                 gumbel_noise=None, u=None, impl: str = "kernels"):
        """Iterative demasking t: 1 → 0; the step at time t uses
        block_of_t(t), then a greedy fill of any leftovers with the last
        block. Step i samples each position as argmax(logits +
        ``gumbel_noise[i]`` (batch, seq_len, V)) and unmasks a masked one
        where ``u[i]`` (batch, seq_len) < (t_i − t_{i+1}) / t_i; both are
        drawn from ``generator`` unless given. Returns (batch, seq_len)
        tokens."""
        N = num_steps or self.db.num_sampling_steps
        dev = params["embed"]["table"].device
        x = torch.full((batch, seq_len), self.mask_id, dtype=torch.long,
                       device=dev)
        ts = sampler_times(N)
        for i in range(N):
            t_now, t_next = float(ts[i]), float(ts[i + 1])
            start, size = self.ranges[self.block_of_t(max(t_now, 1e-3))]
            tvec = torch.full((batch,), max(t_now, 1e-3), device=dev)
            logits = self._forward(params, x, tvec, start, size,
                                   impl).float()
            g = (gumbel(generator, logits.shape, dev) if gumbel_noise is None
                 else torch.as_tensor(gumbel_noise[i], device=dev))
            pred = torch.argmax(logits + g, -1)
            # unmask each currently-masked token w.p. (t_now - t_next)/t_now,
            # the rate rounded to fp32 as the reference compares it
            p_unmask = float(np.float32((t_now - t_next) / max(t_now, 1e-6)))
            ui = (torch.rand(x.shape, generator=generator, device=dev)
                  if u is None else torch.as_tensor(u[i], device=dev))
            unmask = (ui < p_unmask) & (x == self.mask_id)
            x = torch.where(unmask, pred, x)
        start, size = self.ranges[self.db.num_blocks - 1]
        logits = self._forward(params, x, torch.full((batch,), 1e-3,
                                                     device=dev),
                               start, size, impl)
        return torch.where(x == self.mask_id, logits.argmax(-1), x)


# ---------------------------------------------------------------------------
# Training steps and loop
# ---------------------------------------------------------------------------

def make_db_step(mdm: MaskedDiffusionBlocks, b: int, tcfg: TrainConfig,
                 impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) for block b: gradients and AdamW moments
    for ``layers[start:start+size]`` and the periphery only.

    step_fn(params, opt_state_b, tokens, generator=None, *, t=None, u=None)
    -> (params, opt_state_b, loss, metrics)"""
    start, size = mdm.ranges[b]

    def loss_fn(view, tokens, generator=None, *, t=None, u=None):
        return mdm.block_loss(view, b, tokens, generator, t=t, u=u,
                              unit_range=(0, size), impl=impl)

    return T.make_view_train_step(loss_fn, tcfg, (start, size))


def make_e2e_step(mdm: MaskedDiffusionBlocks, tcfg: TrainConfig,
                  impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) over every param, with the signature of
    ``make_db_step``'s step."""
    def loss_fn(view, tokens, generator=None, *, t=None, u=None):
        return mdm.e2e_loss(view, tokens, generator, t=t, u=u, impl=impl)

    return T.make_view_train_step(loss_fn, tcfg)


def train(mdm: MaskedDiffusionBlocks, tcfg: TrainConfig, data_iter,
          generator: torch.Generator, params=None, blockwise: bool = True,
          impl: str = "kernels", log=print):
    """The Table 3 training loop: ``blockwise`` trains a block drawn
    uniformly from ``generator`` each step (each block with its own AdamW
    state), else the full stack (one state). ``data_iter`` yields (B, S)
    token arrays. Returns (params, history [(it, block, loss)]), block -1
    for the full stack."""
    dev = generator.device
    if params is None:
        params = mdm.init(generator)
    steps = ([make_db_step(mdm, b, tcfg, impl)
              for b in range(mdm.db.num_blocks)] if blockwise
             else [make_e2e_step(mdm, tcfg, impl)])
    batches = ((torch.as_tensor(np.asarray(x), dtype=torch.long).to(dev),)
               for x in data_iter)
    return T.train_views(steps, params, batches, generator, tcfg, blockwise,
                         "mdm", log)
