"""Recurrent-depth (Huginn) adapter — paper §5.5 / App. E.5 / Fig. 1 right
(port of ``repro.core.recurrent``).

Architecture: prelude (2 layers) → recurrent core (4 layers, applied K times)
→ coda (2 layers). The baseline trains with K recurrences and truncated BPTT
(last ``bptt_k`` iterations carry gradients). DiffusionBlocks reinterprets the
recurrence as a diffusion process: the core is trained as a single-pass
denoiser D(z_σ, x, σ) — eliminating the K-fold training compute — while
inference keeps K iterations, now as Euler steps of the PF-ODE.

The prelude and coda run causal attention; the core in ``db_loss`` and
``db_generate_logits`` runs the clean‖noisy stream of length 2S under
``db_concat_mask`` with a ``cond_mask`` (so the AdaLN modulation and gates
stay plain torch), in ``baseline_loss`` causally and unconditioned. Under
``impl="kernels"`` attention runs the flash-attention kernels and each
Euler step of ``db_generate_logits`` the fused Euler kernel, reading F as
the strided noisy half of the core's output (no copy).

The random draws JAX makes inside are arguments here: ``s0`` (the
baseline's initial state, σ_data · normal in JAX), σ and ε (``db_loss``)
and ``z0`` (the sampler's initial z, σ_max · normal from ``PRNGKey(0)`` in
JAX); each is drawn from a ``torch.Generator`` when not given.

``make_step(model.baseline_loss | model.db_loss, tcfg)`` trains every param
through ``core.training``'s view step and AdamW; ``train`` is the loop of
the JAX package's Table 5 benchmark.
"""
from __future__ import annotations

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
from repro_torch.nn.init import init_params, stack_specs, tree_items


def _draw(generator, shape, scale: float, device):
    return scale * torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)


class RecurrentDepthModel:
    def __init__(self, cfg: ModelConfig, db: DBConfig, prelude: int = 2,
                 coda: int = 2, recurrence: int = 32, bptt_k: int = 8):
        self.cfg, self.db = cfg, db
        self.K, self.bptt_k = recurrence, bptt_k
        d = cfg.d_model
        self.spec = {
            "embed": L.embed_spec(cfg.vocab_size, d),
            "prelude": stack_specs(C.tlayer_spec(cfg, db=False), prelude),
            # the core is σ-conditioned (AdaLN) — it IS the denoiser
            "core": stack_specs(C.tlayer_spec(cfg, db=True), cfg.n_layers),
            "adapter": L.linear_spec(2 * d, d, (None, "embed")),
            "coda": stack_specs(C.tlayer_spec(cfg, db=False), coda),
            "final_norm": L.norm_spec(d, cfg.norm),
            "head": L.readout_spec(d, cfg.vocab_size),
            "cond": adaln.sigma_embed_spec(db.cond_dim, d),
        }

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return init_params(self.spec, generator, dtype)

    @staticmethod
    def _stack(layers_params, h, ctx):
        n = next(tree_items(layers_params))[1].shape[0]
        for p in _unbind(layers_params, 0, n):
            h, _ = C.tlayer_apply(p, h, ctx)
        return h

    def _embed_ctx(self, tokens, impl: str) -> C.LayerCtx:
        S = tokens.shape[1]
        return C.LayerCtx(cfg=self.cfg, mode="train",
                          positions=torch.arange(S),
                          rope_positions=torch.arange(S,
                                                      device=tokens.device),
                          impl=impl)

    def _concat_ctx(self, S: int, device, impl: str) -> C.LayerCtx:
        """The core's clean‖noisy context: mask positions 0..2S-1, rope
        positions 0..S-1 twice, AdaLN on the noisy half only."""
        ar = torch.arange(S, device=device)
        return C.LayerCtx(cfg=self.cfg, mode="train",
                          positions=torch.arange(2 * S),
                          rope_positions=torch.cat([ar, ar]),
                          mask_mod=A.db_concat_mask(S), impl=impl,
                          cond_mask=torch.arange(2 * S, device=device) >= S)

    def _cond(self, params, sigma):
        return adaln.sigma_embedding(params["cond"],
                                     torch.log(sigma.reshape(-1)) / 4.0,
                                     self.db.cond_dim)

    def prelude_out(self, params, tokens, impl: str = "kernels"):
        ctx = self._embed_ctx(tokens, impl)
        table = L.l2_normalize_embeddings(params["embed"]["table"])
        h = table[tokens]
        return self._stack(params["prelude"], h, ctx), ctx

    def core_once(self, params, e, s, ctx):
        """One core application: s' from adapter([s, e]) through the core
        layers."""
        x = torch.cat([s, e], dim=-1)
        h = L.linear(params["adapter"], x)
        return self._stack(params["core"], h, ctx)

    def readout(self, params, s, ctx):
        h = self._stack(params["coda"], s, ctx)
        h = L.apply_norm(params["final_norm"], h, self.cfg.norm)
        return L.readout(params["head"], h)

    # ------------------------------------------------------------------
    # Baseline: K-iteration recurrence with truncated BPTT
    # ------------------------------------------------------------------
    def baseline_loss(self, params, tokens, generator=None, *, s0=None,
                      impl: str = "kernels"):
        """Next-token CE after K core iterations from ``s0`` (the initial
        state, σ_data · N(0, 1) from ``generator`` when None). The first
        K − bptt_k iterations run without autograd (JAX cuts the gradient
        there with ``stop_gradient``): the same gradients, no stored
        activations."""
        e, ctx = self.prelude_out(params, tokens, impl)
        if s0 is None:
            s0 = _draw(generator, e.shape, self.db.sigma_data, e.device)
        s = torch.as_tensor(s0, device=e.device).to(e.dtype)
        cut, grad = self.K - self.bptt_k, torch.is_grad_enabled()
        for k in range(self.K):
            with torch.set_grad_enabled(grad and k >= cut):
                s = s + self.core_once(params, e, s, ctx)
        logits = self.readout(params, s, ctx)
        ce = _ce(logits[:, :-1], tokens[:, 1:])
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    # DiffusionBlocks: single-pass denoiser training (B=1 over the core)
    # ------------------------------------------------------------------
    def db_loss(self, params, tokens, generator=None, *, sigma=None,
                eps=None, impl: str = "kernels"):
        """AR adapter with the core as one block: noisy slot i carries
        z = emb(x_i) + σε with σ ~ p_noise over the FULL range; one forward
        pass, no BPTT. Causal consistency via the concat mask. σ (B, 1, 1)
        and ε (B, S, d) come from ``generator`` unless given."""
        Bsz, S = tokens.shape
        dev = tokens.device
        if sigma is None:
            q_lo = float(P.q_of_sigma(self.db.sigma_min, self.db))
            q_hi = float(P.q_of_sigma(self.db.sigma_max, self.db))
            sigma = edm.sample_sigma_in_qrange(generator, (Bsz, 1, 1),
                                               self.db, q_lo, q_hi,
                                               device=dev)
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=dev).reshape(Bsz, 1, 1)
        e, _ = self.prelude_out(params, tokens, impl)
        table = L.l2_normalize_embeddings(params["embed"]["table"])
        y = table[tokens]
        z, _ = edm.add_noise(generator, y, sigma, eps=eps)
        _, _, c_in, _ = edm.preconditioning(sigma, self.db.sigma_data)
        ctx = self._concat_ctx(S, dev, impl)
        ctx.cond = self._cond(params, sigma)
        e2 = torch.cat([e, e], dim=1)
        s2 = torch.cat([e.to(z.dtype), (c_in * z).to(z.dtype)], dim=1)
        f = self.core_once(params, e2, s2, ctx)[:, S:]
        d_hat = edm.denoise_combine(z, f.float(), sigma, self.db.sigma_data)
        logits = self.readout(params, d_hat.to(f.dtype),
                              self._embed_ctx(tokens, impl))
        ce = _ce(logits, tokens)
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def db_generate_logits(self, params, tokens, num_steps=None, *, z0=None,
                           generator=None, impl: str = "kernels"):
        """Teacher-forced parallel sampling of all positions (evaluation):
        K Euler steps of the core as denoiser, conditioned on the clean
        prefix via the concat mask (positions denoise in parallel). ``z0``
        (B, S, d) is the initial z, else σ_max · N(0, 1) from
        ``generator``."""
        Bsz, S = tokens.shape
        N = num_steps or self.K
        sched = P.sampling_schedule(self.db, N)
        e, _ = self.prelude_out(params, tokens, impl)
        if z0 is None:
            z0 = _draw(generator, e.shape, self.db.sigma_max, e.device)
        z = torch.as_tensor(z0, dtype=torch.float32, device=e.device)
        ctx = self._concat_ctx(S, e.device, impl)
        e2 = torch.cat([e, e], dim=1)
        for i in range(N):
            s_from, s_to = float(sched[i]), float(sched[i + 1])
            sig = torch.full((Bsz, 1, 1), s_from, dtype=torch.float32,
                             device=e.device)
            _, _, c_in, _ = edm.preconditioning(sig, self.db.sigma_data)
            ctx.cond = self._cond(params, sig)
            s2 = torch.cat([e, (c_in * z).to(e.dtype)], dim=1)
            f = self.core_once(params, e2, s2, ctx)[:, S:]
            z = edm.sampler_step(z, f, s_from, s_to, self.db.sigma_data,
                                 impl)
        return self.readout(params, z.to(e.dtype),
                            self._embed_ctx(tokens, impl))


def _ce(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


# ---------------------------------------------------------------------------
# Training steps and loop
# ---------------------------------------------------------------------------

def make_step(loss, tcfg: TrainConfig, impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) training every param on ``loss``, a
    model's ``baseline_loss`` or ``db_loss`` (one block: the core is the
    single DiffusionBlocks block).

    step_fn(params, opt_state, tokens, generator=None, **draws) with the
    loss's draws (``s0``, or ``sigma`` and ``eps``) -> (params, opt_state,
    loss, metrics)"""
    def loss_fn(view, tokens, generator=None, **draws):
        return loss(view, tokens, generator, impl=impl, **draws)

    return T.make_view_train_step(loss_fn, tcfg)


def train(model: RecurrentDepthModel, loss, tcfg: TrainConfig, data_iter,
          generator: torch.Generator, params=None, impl: str = "kernels",
          log=print):
    """The Table 5 training loop: ``tcfg.steps`` steps of ``loss`` (the
    model's ``baseline_loss`` or ``db_loss``) on the (B, S) token batches of
    ``data_iter``. Returns (params, history [(it, loss)])."""
    dev = generator.device
    if params is None:
        params = model.init(generator)
    init, step = make_step(loss, tcfg, impl)
    state = init(params)
    history = []
    for it in range(tcfg.steps):
        tokens = torch.as_tensor(np.asarray(next(data_iter)),
                                 dtype=torch.long).to(dev)
        params, state, value, _ = step(params, state, tokens, generator)
        history.append((it, float(value)))
        if tcfg.log_every and it % tcfg.log_every == 0:
            log(f"[{loss.__name__}] it={it} loss={float(value):.4f}")
    return params, history
