"""DiffusionBlocks over the dense and MoE decoders, the VLM, the hybrid,
the encoder-decoder and the xLSTM (port of ``repro.core.blocks``): the
block-local training loss of the AR adapter in concat or two-pass mode
with the CE or l2 loss (``block_loss``: every family but the recurrent
ones in either mode, the hybrid and the xLSTM always in two-pass, their
Mamba layers and cells having no mask), the
end-to-end baseline (``e2e_loss``), and the sampler over the paged cache
(conditioned slots read their image or audio blocks under
``cond_lengths``, the hybrid's Mamba rows and the xLSTM's cell states
advance in place) and over the dense one (``serve_step``, ``prefill``,
``prefill_probe``: JAX's dry-run and reference path, every slot at one
position ``pos``; the cache from ``model.init_cache``, filled by
per-token commits or returned by ``prefill``, written in place).

Conditioning inputs (``aux_inputs``: ``{"image_embs": (B, Sk, d)}`` for
the VLM, ``{"audio_embs": (B, Sk, d)}`` for the encoder-decoder) go
through ``model.encode_conditioning`` in ``make_ctx`` (the encoder-decoder
runs its encoder there, inside the loss's graph) into ``ctx.kv_x``, which
the cross-attention attends in ``train``.

Both losses report ``metrics["aux"]``, the MoE routers' load-balance loss
summed over the layers run (``ctx.aux``; 0 for the other families), and
add ``cfg.moe.router_aux_weight * aux`` to the loss they return for the
MoE family; ``metrics["loss"]`` is the loss before it, as in JAX.

Training. ``block_loss`` runs block b's units over the clean‖noisy stream
of length 2S under ``db_concat_mask`` (concat) or over paired clean and
noisy streams (two_pass); it reads only units ``ranges[b]`` (+ the
embedding, readout and σ conditioning), so autograd never reaches another
block's units. σ and ε can be passed in; otherwise they are drawn from a
``torch.Generator``. ``chunked_ce`` recomputes each chunk's logits in the
backward (``torch.utils.checkpoint``), so the (S, vocab) logits never exist
for the whole sequence.

The next token's embedding is denoised by an Euler chain σ_max → 0 in which
block b (units ``ranges[b]``) serves the noise range [edges[b+1], edges[b]]
(one probe per block per step, ``commit=False``); the readout picks the
token, and a commit pass appends its k/v to every unit's pool, restarting
the hidden stream from the raw embedding at each block's first unit.

Precision split, as in JAX: the denoise chain starts from an fp32 ``z`` and
every probe computes in fp32 (against the pool in its storage dtype); only
the commit passes (``commit_token``, ``commit_prompt_chunk``) run in the
policy's compute dtype, with a compute-dtype copy of the layer weights made
once (``params_for``).

The sampler's random draws are arguments: ``z0`` is the chain's initial z
(JAX draws it as ``σ_max · normal``) and ``noise`` the sampler's Gumbel
noise (JAX's ``jax.random.categorical`` is argmax(logits + gumbel));
``launch.serve.DecodeEngine.draw`` makes them from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import precision as precision_mod
from repro_torch.configs.base import HYBRID, SSM, DBConfig, ModelConfig
from repro_torch.core import edm
from repro_torch.core import partition as P
from repro_torch.models.common import LayerCtx, zip_caches
from repro_torch.models.model_api import build_model
from repro_torch.nn import attention as A
from repro_torch.nn import cache as KVC
from repro_torch.nn.init import cast_floating


def _ce_sum(model, params, h_i, t_i):
    logits = model.logits(params, h_i)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.clamp(t_i, min=0).long()
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.where(t_i >= 0, ce, torch.zeros((), device=ce.device)).sum()


def chunked_ce(model, params, h: torch.Tensor, targets: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE through the readout, ``chunk`` positions at a
    time; each chunk's logits are recomputed in the backward, so the
    (S, vocab) logits never exist for the whole sequence."""
    B, S = targets.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(h.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_ce_sum, model, params, h[:, sl],
                                   targets[:, sl], use_reentrant=False)
    return total / (B * S)


# leaves that stay fp32 in the compute-dtype copy: norm gains are read in
# fp32, and the AdaLN heads run only in the fp32 probe
_KEEP_FP32 = ("ln1", "lnx", "ln2", "adaln")


def gumbel(generator: Optional[torch.Generator], shape,
           device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u), u ~ U[tiny, 1) in fp32 (as
    ``jax.random.gumbel`` draws it)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _aux(ctx: LayerCtx, device) -> torch.Tensor:
    """The aux loss the ctx's MoE layers added (fp32 0-dim; 0 if none)."""
    if ctx.aux is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return ctx.aux


def _needs_two_pass(cfg: ModelConfig) -> bool:
    """SSM recurrences have no attention mask: the concat trick does not
    apply."""
    return cfg.family in (HYBRID, SSM)


class DiffusionBlocksModel:
    def __init__(self, cfg: ModelConfig, db: DBConfig,
                 distribution: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.db = db
        self.model = build_model(cfg, db)
        self.edges = P.sigma_edges(db)                     # descending, B+1
        self.ranges = P.unit_ranges(self.model.n_units, db.num_blocks,
                                    distribution)
        self.causal_mode = ("two_pass" if _needs_two_pass(cfg)
                            else db.causal_mode)

    @property
    def num_blocks(self) -> int:
        return self.db.num_blocks

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return self.model.init(generator, dtype)

    def params_for(self, params, dtype: torch.dtype):
        """``params`` with the layer weights (the dense ``layers`` or the
        VLM's ``units``) in ``dtype``: the fp32 masters themselves for fp32,
        else a copy made on first use and kept while the same master tree is
        passed (JAX casts inside every matmul)."""
        if dtype == torch.float32:
            return params
        memo = self.__dict__.setdefault("_compute_copies", {})
        hit = memo.get(dtype)
        if hit is None or hit[0] is not params:
            copy = dict(params, **{k: cast_floating(params[k], dtype,
                                                    keep=_KEEP_FP32)
                                   for k in ("layers", "units")
                                   if k in params})
            hit = memo[dtype] = (params, copy)
        return hit[1]

    def sample_block_sigma(self, generator, shape, b: int, *, u=None,
                           device=None) -> torch.Tensor:
        q_lo, q_hi = P.block_qrange(self.db, b, with_overlap=True)
        return edm.sample_sigma_in_qrange(generator, shape, self.db, q_lo,
                                          q_hi, u=u, device=device)

    def draw_block(self, generator, tokens: torch.Tensor, b: int, *,
                   sigma=None, eps=None):
        """Block b's noise for ``tokens`` (Bsz, S): σ (Bsz, 1, 1) in its
        overlap-expanded range, then ε (Bsz, S, d) fp32 standard normal,
        each drawn from ``generator`` unless given. ``block_loss`` draws
        through it, and so does the block-parallel engine, which draws
        every block's full-batch pair in block order."""
        Bsz, S = tokens.shape
        dev = tokens.device
        if sigma is None:
            sigma = self.sample_block_sigma(generator, (Bsz, 1, 1), b,
                                            device=dev)
        if eps is None:
            eps = torch.randn((Bsz, S, self.cfg.d_model),
                              generator=generator, dtype=torch.float32,
                              device=dev)
        return sigma, eps

    def make_ctx(self, params, S: int, mode: str, sigma=None,
                 aux_inputs: Optional[Dict[str, torch.Tensor]] = None,
                 precision=None, **kw) -> LayerCtx:
        """A ``LayerCtx`` over positions arange(S) (on the CPU: they only
        describe the mask), σ-conditioned when ``sigma`` is given. In every
        mode but ``decode`` (which reads the cache's blocks) ``aux_inputs``
        are encoded (``model.encode_conditioning``) into ``ctx.kv_x``, with
        key positions arange(Sk)."""
        ctx = LayerCtx(cfg=self.cfg, mode=mode, positions=torch.arange(S),
                       precision=precision_mod.get_policy(precision), **kw)
        if sigma is not None:
            ctx.cond = self.model.cond(params, torch.log(sigma.reshape(-1)))
        if mode != "decode":
            kv_x = self.model.encode_conditioning(params, aux_inputs, ctx)
            if kv_x is not None:
                ctx.kv_x = kv_x
                ctx.kv_positions = torch.arange(kv_x.shape[1])
        return ctx

    # ------------------------------------------------------------------
    # Training losses
    # ------------------------------------------------------------------
    def block_loss(self, params, b: int, tokens: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   sigma: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   aux_inputs: Optional[Dict[str, torch.Tensor]] = None,
                   impl: str = "kernels",
                   unit_range: Optional[Tuple[int, int]] = None,
                   precision=None) -> Tuple[torch.Tensor, Dict]:
        """Paper Eq. (6) for the AR adapter: noisy slot i carries
        z_i = emb(x_i) + σ ε and is conditioned on clean x_{<i}; block b
        denoises it. σ (B, 1, 1) is drawn in block b's overlap-expanded
        range, one per example; ε (B, S, d) is standard normal. Both come
        from ``generator`` unless given.

        ``causal_mode`` (``DBConfig.causal_mode``, or ``two_pass`` for
        the recurrent families, which have no mask): ``concat`` runs one
        clean‖noisy stream of length 2S under ``db_concat_mask``;
        ``two_pass`` runs the clean and noisy streams side by side through
        ``apply_units_two_pass``.
        ``DBConfig.loss``: ``ce`` takes CE of the denoiser output through
        the readout; ``l2`` is the score-matching loss in F-space (under
        ``impl="kernels"`` the EDM-loss kernels, which never store the
        target). The σ preconditioning, denoiser combine and loss stay fp32;
        the hidden stream runs in the policy's compute dtype. ``aux_inputs``
        condition a cross-attending family (``make_ctx``); the clean stream
        is the token rows alone, as JAX's (no absolute positions)."""
        pol = precision_mod.get_policy(precision)
        cd = pol.compute_for(self.cfg.family)
        Bsz, S = tokens.shape
        dev = tokens.device
        start, size = unit_range if unit_range is not None \
            else self.ranges[b]
        sigma, eps = self.draw_block(generator, tokens, b, sigma=sigma,
                                     eps=eps)
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=dev).reshape(Bsz, 1, 1)

        emb_clean = self.model.token_rows(params, tokens)
        z, _ = edm.add_noise(generator, emb_clean.float(), sigma, eps=eps)
        _, _, c_in, _ = edm.preconditioning(sigma, self.db.sigma_data)
        z_in = (c_in * z).to(cd)

        ar = torch.arange(S, device=dev)
        if self.causal_mode == "concat":
            stream = torch.cat([emb_clean.to(cd), z_in], dim=1)
            ctx = self.make_ctx(params, 2 * S, "train", sigma, aux_inputs,
                                impl=impl, precision=pol)
            ctx.mask_mod = A.db_concat_mask(S)
            ctx.rope_positions = torch.cat([ar, ar])
            ctx.cond_mask = torch.arange(2 * S, device=dev) >= S
            h, _ = self.model.apply_units(params, stream, start, size, ctx)
            f_out = h[:, S:]
        else:
            ctx = self.make_ctx(params, S, "train", sigma, aux_inputs,
                                impl=impl, precision=pol)
            ctx.rope_positions = ar
            _, f_out = self.model.apply_units_two_pass(
                params, emb_clean.to(cd), z_in, start, size, ctx)

        if self.db.loss == "l2":
            f32, y32 = f_out.float(), emb_clean.float()
            if impl == "kernels":
                from repro_torch.kernels import ops as kops
                loss = kops.edm_loss(f32, z, y32, sigma.reshape(Bsz),
                                     sigma_data=self.db.sigma_data)
            else:
                loss = edm.edm_l2_loss(f32, z, y32, sigma,
                                       self.db.sigma_data)
            metrics = {"l2": loss}
        else:
            d_hat = edm.denoise_combine(z, f_out.float(), sigma,
                                        self.db.sigma_data)
            loss = chunked_ce(self.model, params, d_hat.to(emb_clean.dtype),
                              tokens)
            metrics = {"ce": loss}
        aux = _aux(ctx, dev)
        metrics.update({"loss": loss, "aux": aux,
                        "sigma_mean": sigma.mean()})
        return self._with_aux(loss, aux), metrics

    def _with_aux(self, loss, aux):
        """``loss`` plus the weighted router aux loss for the MoE family."""
        if self.cfg.moe is None:
            return loss
        return loss + self.cfg.moe.router_aux_weight * aux

    def e2e_loss(self, params, tokens: torch.Tensor, *,
                 aux_inputs: Optional[Dict[str, torch.Tensor]] = None,
                 impl: str = "kernels", precision=None
                 ) -> Tuple[torch.Tensor, Dict]:
        """End-to-end next-token CE over the FULL stack (the backprop
        baseline; ``cond`` is None, so the AdaLN heads stay inert),
        conditioned on ``aux_inputs`` where the family takes them."""
        pol = precision_mod.get_policy(precision)
        S = tokens.shape[1]
        ctx = self.make_ctx(params, S, "train", None, aux_inputs, impl=impl,
                            precision=pol)
        ctx.rope_positions = torch.arange(S, device=tokens.device)
        h = self.model.embed(params, tokens,
                             dtype=pol.compute_for(self.cfg.family))
        h, _ = self.model.apply_units(params, h, 0, self.model.n_units, ctx)
        loss = chunked_ce(self.model, params, h[:, :-1], tokens[:, 1:])
        aux = _aux(ctx, tokens.device)
        return self._with_aux(loss, aux), {"ce": loss, "aux": aux}

    # ------------------------------------------------------------------
    # Block-wise Euler sampling of the next token (App. B / H)
    # ------------------------------------------------------------------
    def denoise_schedule(self, steps_per_block: int = 1) -> list:
        """[(block, σ_from, σ_to)] as Python floats, descending; the last
        step lands on 0."""
        out = []
        Bn = self.num_blocks
        for b in range(Bn):
            hi, lo = float(self.edges[b]), float(self.edges[b + 1])
            if b == Bn - 1:
                lo = 0.0
            qs = np.linspace(hi, lo, steps_per_block + 1)
            for i in range(steps_per_block):
                out.append((b, float(qs[i]), float(qs[i + 1])))
        return out

    def _probe_block(self, params, b: int, z: torch.Tensor, sigma: float,
                     cache, ctx_base: LayerCtx) -> torch.Tensor:
        """Run block b's units over one noisy token without appending (at
        each slot's ``lengths[b]`` over a paged cache, at ``pos`` over a
        dense one). Returns F (B, 1, d) in z's dtype."""
        start, size = self.ranges[b]
        sig = torch.full((z.shape[0], 1, 1), sigma, dtype=torch.float32,
                         device=z.device)
        _, _, c_in, _ = edm.preconditioning(sig, self.db.sigma_data)
        ctx = dataclasses.replace(ctx_base, mode="decode", commit=False)
        ctx.cond = self.model.cond(params, torch.log(sig.reshape(-1)))
        h = (c_in * z).to(z.dtype)
        h, _ = self.model.apply_units(self.params_for(params, z.dtype), h,
                                      start, size, ctx,
                                      KVC.cache_units(cache, start, size))
        return h

    def denoise_next_token(self, params, cache, ctx_base: LayerCtx,
                           steps_per_block: int = 1, *,
                           z0: torch.Tensor) -> torch.Tensor:
        """Full Euler chain (σ_max → 0) for the token at each slot's
        ``ctx_base.lengths`` (paged) or at ``ctx_base.pos`` (dense) from the
        initial z ``z0`` (B, 1, d). Returns D (B, 1, d)."""
        lengths = ctx_base.lengths
        batch = (lengths.shape[0] if lengths is not None
                 else self.model.cache_batch(cache))
        z = torch.as_tensor(z0, dtype=torch.float32,
                            device=params["embed"]["table"].device
                            ).reshape(batch, 1, self.cfg.d_model)
        for b, s_from, s_to in self.denoise_schedule(steps_per_block):
            f = self._probe_block(params, b, z, s_from, cache, ctx_base)
            # a 0-dim CPU tensor: fp32 preconditioning without a device copy
            sig = torch.tensor(s_from, dtype=torch.float32)
            d_hat = edm.denoise_combine(z, f.float(), sig,
                                        self.db.sigma_data)
            z = edm.euler_step(z, d_hat, s_from, max(s_to, 0.0)) \
                if s_to > 0 else d_hat
            z = z.to(f.dtype)
        return z

    def commit_token(self, params, cache, token, ctx_base: LayerCtx):
        """Append the chosen token's k/v to every unit's pool in one pass over
        all units; each block's clean stream restarts from the raw embedding
        (blocks are independent denoisers). ``cond`` is None, so the gates
        are plain residual adds. The token embeds at each slot's offset
        ``lengths[b]``, or at ``pos`` over a dense cache (absolute-position
        families)."""
        ctx = dataclasses.replace(ctx_base, mode="decode", cond=None,
                                  commit=True)
        cd = precision_mod.get_policy(ctx.precision).compute_for(
            self.cfg.family)
        epos = (ctx.lengths[:, None] if ctx.lengths is not None else
                torch.full((1, 1), ctx.pos, device=token.device))
        emb = self.model.embed(params, token, dtype=cd, positions=epos)
        self.model.apply_units(self.params_for(params, cd), emb, 0,
                               self.model.n_units, ctx, cache,
                               reset_mask=self._block_starts())
        return cache

    def _block_starts(self) -> List[bool]:
        starts = [False] * self.model.n_units
        for start, _ in self.ranges:
            starts[start] = True
        return starts

    def sample_token(self, logits, temperature: float = 0.0, top_k: int = 0,
                     noise: Optional[torch.Tensor] = None):
        """Greedy (``temperature == 0``) or temperature / top-k sampling as
        ``jax.random.categorical`` samples: argmax(logits / T + ``noise``),
        the Gumbel noise of the logits' shape (``gumbel``)."""
        logits = logits.float()
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        if noise is None:
            raise ValueError("sampling at temperature > 0 needs its Gumbel "
                             "noise")
        logits = logits / temperature
        if top_k and top_k < logits.shape[-1]:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, float("-inf")),
                                 logits)
        return torch.argmax(logits + noise, dim=-1)

    # ------------------------------------------------------------------
    # Dense-cache serving (JAX's dry-run and single-request reference path)
    # ------------------------------------------------------------------
    def dense_ctx(self, pos: int, *, precision=None, impl: str = "kernels",
                  cond_lengths=None) -> LayerCtx:
        """The ``decode`` context of a dense cache at position ``pos``: the
        base of ``serve_step`` and of a prompt's per-token
        ``commit_token``s."""
        return LayerCtx(cfg=self.cfg, mode="decode", pos=int(pos),
                        precision=precision_mod.get_policy(precision),
                        impl=impl, cond_lengths=cond_lengths)

    def serve_step(self, params, cache, pos: int, *, z0, noise=None,
                   steps_per_block: int = 1, temperature: float = 0.0,
                   top_k: int = 0, precision=None, impl: str = "kernels",
                   cond_lengths=None, return_logits: bool = False):
        """One generation step over the DENSE cache (``model.init_cache``):
        every slot denoises the token at position ``pos`` from ``z0`` (B,
        1, d) through the blocks, samples (``noise`` (B, V) the Gumbel noise
        at temperature > 0) and commits it at ``pos`` in place. Conditioned
        families read their blocks (``model.set_conditioning``) under
        ``cond_lengths`` (B,), or whole when None. The policy defaults to
        fp32, as JAX's ``serve_step`` runs. Returns (token (B,), cache),
        plus the logits (B, V) with ``return_logits``."""
        ctx = self.dense_ctx(pos, precision=precision, impl=impl,
                             cond_lengths=cond_lengths)
        d_final = self.denoise_next_token(params, cache, ctx,
                                          steps_per_block, z0=z0)
        logits = self.model.logits(params, d_final)[:, 0]
        token = self.sample_token(logits, temperature, top_k, noise)
        cache = self.commit_token(params, cache, token[:, None], ctx)
        if return_logits:
            return token, cache, logits
        return token, cache

    def _prefill_ctx(self, params, tokens, aux_inputs, impl, precision):
        pol = precision_mod.get_policy(precision)
        S = tokens.shape[1]
        ctx = self.make_ctx(params, S, "prefill", None, aux_inputs,
                            impl=impl, precision=pol)
        ctx.rope_positions = torch.arange(S, device=tokens.device)
        cd = pol.compute_for(self.cfg.family)
        return ctx, self.model.embed(params, tokens, dtype=cd), \
            self.params_for(params, cd)

    def prefill_probe(self, params, tokens, k: int, aux_inputs=None,
                      impl: str = "kernels", precision=None):
        """The clean stream over the first ``k`` units only (the dry run's
        cost probe). Returns (logits (B, 1, V) of the last position, the
        k units' dense caches)."""
        ctx, emb, p = self._prefill_ctx(params, tokens, aux_inputs, impl,
                                        precision)
        h, sub = self.model.apply_units(p, emb, 0, k, ctx)
        return self.model.logits(params, h[:, -1:]), sub

    def prefill(self, params, tokens, aux_inputs=None, impl: str = "kernels",
                precision=None):
        """Clean-stream prefill of every unit's dense cache over the prompt
        ``tokens`` (B, S) in the policy's compute dtype (fp32 by default, as
        JAX's): each block's units run from the raw embeddings (blocks are
        independent denoisers, as in ``commit_token``), their caches joined
        on the unit axis. The caches hold the S positions (not a ring, even
        under a sliding window). Returns (logits (B, 1, V) of the last
        position, cache)."""
        ctx, emb, p = self._prefill_ctx(params, tokens, aux_inputs, impl,
                                        precision)
        parts = []
        for start, size in self.ranges:
            h, sub = self.model.apply_units(p, emb, start, size, ctx)
            parts.append(sub)
        return (self.model.logits(params, h[:, -1:]),
                zip_caches(torch.cat, parts))

    # ------------------------------------------------------------------
    # Paged serving steps (used by launch.serve)
    # ------------------------------------------------------------------
    def _paged_ctx(self, lengths, page_table, active, precision, impl,
                   cond_lengths=None) -> LayerCtx:
        return LayerCtx(cfg=self.cfg, mode="decode",
                        precision=precision_mod.get_policy(precision),
                        impl=impl, lengths=lengths, page_table=page_table,
                        active=active, cond_lengths=cond_lengths)

    def serve_step_paged(self, params, kv, page_table, lengths, *, z0,
                         noise=None, forced=None, active=None,
                         steps_per_block: int = 1, temperature: float = 0.0,
                         top_k: int = 0, precision=None,
                         impl: str = "kernels", return_logits: bool = False,
                         cond_lengths=None):
        """One generation step over the paged cache: each slot denoises from
        ``z0`` (B, 1, d) and commits at its own position ``lengths[b]``;
        inactive slots compute but their appends go to the trash page.
        ``noise`` (B, V) is the sampler's Gumbel noise (temperature > 0).
        Where ``forced`` (B,) is >= 0 the slot commits that token instead of
        its sample (a prompt token of a continuous-batching segment).
        Conditioned slots read their conditioning block from the cache under
        ``cond_lengths`` (B,) (written once at admission). Returns (token
        (B,), kv, new_lengths), plus the step's logits (B, V) with
        ``return_logits``."""
        ctx = self._paged_ctx(lengths, page_table, active, precision, impl,
                              cond_lengths)
        d_final = self.denoise_next_token(params, kv, ctx, steps_per_block,
                                          z0=z0)
        logits = self.model.logits(params, d_final)[:, 0]
        token = self.sample_token(logits, temperature, top_k, noise)
        if forced is not None:
            token = torch.where(forced >= 0, forced, token)
        kv = self.commit_token(params, kv, token[:, None], ctx)
        new_lengths = lengths + (active.to(lengths.dtype)
                                 if active is not None else 1)
        if return_logits:
            return token, kv, new_lengths, logits
        return token, kv, new_lengths

    def commit_prompt_token(self, params, kv, page_table, lengths, token, *,
                            active=None, precision=None,
                            impl: str = "kernels", cond_lengths=None):
        """Commit a known (prompt) token (B, 1) at each slot's
        ``lengths[b]`` without the denoising probe: ``commit_token`` in the
        decode mode. Returns (kv, new_lengths)."""
        ctx = self._paged_ctx(lengths, page_table, active, precision, impl,
                              cond_lengths)
        kv = self.commit_token(params, kv, token, ctx)
        return kv, lengths + (active.to(lengths.dtype)
                              if active is not None else 1)

    def commit_prompt_chunk(self, params, kv, page_table, lengths, tokens, *,
                            n_valid, precision=None, impl: str = "kernels",
                            cond_lengths=None):
        """Commit up to C known prompt tokens per slot in one pass: tokens
        (B, C) start at each slot's own ``lengths[b]`` (their embedding
        positions too); entries past ``n_valid[b]`` are padding whose k/v go
        to the trash page. Returns (kv, lengths + n_valid)."""
        ctx = self._paged_ctx(lengths, page_table, None, precision, impl,
                              cond_lengths)
        ctx.mode = "prefill_chunk"
        ctx.n_valid = n_valid
        cd = precision_mod.get_policy(ctx.precision).compute_for(
            self.cfg.family)
        C = tokens.shape[1]
        epos = lengths[:, None] + torch.arange(C, dtype=lengths.dtype,
                                               device=lengths.device)
        emb = self.model.embed(params, tokens, dtype=cd, positions=epos)
        self.model.apply_units(self.params_for(params, cd), emb, 0,
                               self.model.n_units, ctx, kv,
                               reset_mask=self._block_starts())
        return kv, lengths + n_valid
