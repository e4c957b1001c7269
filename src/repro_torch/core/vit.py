"""ViT classification adapter (paper §5.1 / App. B, App. E.1; port of
``repro.core.vit``).

Input sequence = [CLS, patch embeddings, noisy label embedding z_σ]. Each
block denoises the label token within its noise range; CE is taken through
the classification head on the denoised label embedding (Eq. 6 with the CE
inner loss). Inference runs the Euler chain over the blocks and classifies
the final z. The end-to-end baseline is a standard ViT ([CLS] readout).

Every layer runs ``tlayer_apply`` in train mode under ``bidirectional_mask``
(the ``full`` attention kernel under ``impl="kernels"``; VIT_CIFAR's head
dim is 32). In DB mode the σ embedding modulates and gates the label token
only (``cond_mask``), so the AdaLN stays plain torch, as on the AR concat
stream; the baseline runs unconditioned. ``predict`` takes every Euler
step, the last to σ = 0 included, through ``edm.sampler_step`` (the fused
Euler kernel under ``impl="kernels"``).

Random draws are explicit: σ and ε for ``block_loss`` (else drawn from a
``torch.Generator``), ``z0`` (JAX draws σ_max · normal) or a generator for
``predict``.

``make_db_step`` / ``make_e2e_step`` train block b's layers plus the
periphery (``patch``, ``cls``, ``pos``, ``label_emb``, ``final_norm``,
``head``, ``cond``), or every param, through ``core.training``'s block views
and AdamW; ``train`` is the DB and e2e part of the JAX package's Table 1
benchmark with one AdamW state per block (the JAX loop updates the whole
tree with one state).
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


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of (B, classes) logits against (B,) labels, in fp32."""
    logp = torch.log_softmax(logits.float(), -1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()


class ViTDiffusionBlocks:
    def __init__(self, cfg: ModelConfig, db: DBConfig, image_size: int = 32,
                 patch: int = 4, channels: int = 3,
                 distribution: Optional[Sequence[int]] = None):
        self.cfg, self.db = cfg, db
        self.patch, self.channels, self.image_size = patch, channels, image_size
        self.n_patches = (image_size // patch) ** 2
        self.num_classes = cfg.vocab_size
        self.ranges = P.unit_ranges(cfg.n_layers, db.num_blocks, distribution)
        self.edges = P.sigma_edges(db)
        d = cfg.d_model
        self.spec = {
            "patch": L.linear_spec(patch * patch * channels, d,
                                   (None, "embed")),
            "cls": ParamSpec((1, d), (None, "embed"), "embed", 0.02),
            "pos": ParamSpec((1 + self.n_patches + 1, d), (None, "embed"),
                             "embed", 0.02),
            "label_emb": ParamSpec((self.num_classes, d), ("vocab", "embed"),
                                   "embed", 1.0),
            "layers": stack_specs(C.tlayer_spec(cfg, db=True), cfg.n_layers),
            "final_norm": L.norm_spec(d, cfg.norm),
            "head": L.readout_spec(d, self.num_classes),
            "cond": adaln.sigma_embed_spec(db.cond_dim, d),
        }

    def init(self, generator: torch.Generator, dtype=torch.float32):
        return init_params(self.spec, generator, dtype)

    # ------------------------------------------------------------------
    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, n_patches, p*p*C)."""
        B, H, W, Ch = images.shape
        p = self.patch
        x = images.reshape(B, H // p, p, W // p, p, Ch)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, self.n_patches,
                                                   p * p * Ch)

    def tokens(self, params, images, z_label):
        """[CLS, patches, z_label] + positions: (B, n_patches + 2, d)."""
        B = images.shape[0]
        patches = L.linear(params["patch"], self.patchify(images))
        cls = params["cls"][None].expand(B, 1, self.cfg.d_model)
        seq = torch.cat([cls.to(patches.dtype), patches,
                         z_label.to(patches.dtype)], dim=1)
        return seq + params["pos"][None].to(seq.dtype)

    def label_table(self, params):
        return L.l2_normalize_embeddings(params["label_emb"])

    def _run(self, params, seq, start: int, size: int, cond,
             impl: str = "kernels"):
        """Layers [start, start + size) over ``seq``; ``cond`` (B, d)
        modulates the label token only, or None (no modulation)."""
        S = seq.shape[1]
        ctx = C.LayerCtx(cfg=self.cfg, mode="train",
                         positions=torch.arange(S),
                         mask_mod=A.bidirectional_mask, cond=cond, impl=impl)
        if cond is not None:   # modulate only the label token
            ctx.cond_mask = torch.arange(S, device=seq.device) == S - 1
        h = seq
        for p in _unbind(params["layers"], start, size):
            h, _ = C.tlayer_apply(p, h, ctx)
        return h

    def _cond(self, params, sigma):
        return adaln.sigma_embedding(params["cond"],
                                     torch.log(sigma.reshape(-1)) / 4.0,
                                     self.db.cond_dim)

    def _classify(self, params, x):
        """Logits of (B, d) rows through the final norm and the head."""
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm)
        return L.readout(params["head"], x)

    # ------------------------------------------------------------------
    def block_loss(self, params, b: int, images, labels, generator=None, *,
                   sigma=None, eps=None, unit_range=None,
                   impl: str = "kernels"):
        """Eq. (6) with the CE inner loss on the denoised label token. σ
        (B, 1, 1) is drawn in block b's overlap-expanded range and ε (B, 1,
        d) from ``generator`` unless given."""
        start, size = unit_range or self.ranges[b]
        Bsz, dev = images.shape[0], images.device
        if sigma is None:
            q_lo, q_hi = P.block_qrange(self.db, b)
            sigma = edm.sample_sigma_in_qrange(generator, (Bsz, 1, 1),
                                               self.db, q_lo, q_hi,
                                               device=dev)
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=dev).reshape(Bsz, 1, 1)
        y_emb = self.label_table(params)[labels.long()][:, None]   # (B,1,d)
        z, _ = edm.add_noise(generator, y_emb, sigma, eps=eps)
        _, _, c_in, _ = edm.preconditioning(sigma, self.db.sigma_data)
        seq = self.tokens(params, images, c_in * z)
        h = self._run(params, seq, start, size, self._cond(params, sigma),
                      impl)
        d_hat = edm.denoise_combine(z, h[:, -1:].float(), sigma,
                                    self.db.sigma_data)
        ce = _ce(self._classify(params, d_hat.to(h.dtype)[:, 0]), labels)
        return ce, {"ce": ce}

    def e2e_loss(self, params, images, labels, *, impl: str = "kernels"):
        """Standard ViT baseline: [CLS, patches] through all layers, head on
        CLS (the label slot is fed zeros, conditioning off)."""
        h = self._backbone(params, images, impl)
        ce = _ce(self._classify(params, h[:, 0]), labels)
        return ce, {"ce": ce}

    def _backbone(self, params, images, impl):
        z0 = torch.zeros(images.shape[0], 1, self.cfg.d_model,
                         device=images.device)
        seq = self.tokens(params, images, z0)
        return self._run(params, seq, 0, self.cfg.n_layers, None, impl)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, params, images, num_steps: Optional[int] = None, *,
                z0=None, generator=None, impl: str = "kernels"):
        """Euler chain σ_max → 0 over the blocks, one block a step;
        classify the final z. ``z0`` (B, 1, d) is the initial z, else σ_max
        · N(0, 1) from ``generator``. Returns (classes, logits)."""
        steps = num_steps or max(self.db.num_blocks,
                                 self.cfg.n_layers // self.db.num_blocks)
        sched = P.sampling_schedule(self.db, steps)
        Bsz, dev = images.shape[0], images.device
        shape = (Bsz, 1, self.cfg.d_model)
        if z0 is None:
            z = self.db.sigma_max * torch.randn(
                shape, generator=generator, dtype=torch.float32, device=dev)
        else:
            z = torch.as_tensor(z0, dtype=torch.float32,
                                device=dev).reshape(shape)
        for i in range(len(sched) - 1):
            s_from, s_to = float(sched[i]), float(sched[i + 1])
            start, size = self.ranges[P.block_of_sigma(self.db, s_from)]
            sig = torch.full((Bsz, 1, 1), s_from, dtype=torch.float32,
                             device=dev)
            _, _, c_in, _ = edm.preconditioning(sig, self.db.sigma_data)
            seq = self.tokens(params, images, c_in * z)
            h = self._run(params, seq, start, size, self._cond(params, sig),
                          impl)
            z = edm.sampler_step(z, h[:, -1:], s_from, s_to,
                                 self.db.sigma_data, impl)
        logits = self._classify(params, z.to(h.dtype)[:, 0])
        return logits.argmax(-1), logits

    @torch.no_grad()
    def predict_e2e(self, params, images, *, impl: str = "kernels"):
        logits = self._classify(params,
                                self._backbone(params, images, impl)[:, 0])
        return logits.argmax(-1), logits


def accuracy(pred, labels) -> float:
    """Fraction of ``pred`` equal to ``labels`` (tensors or arrays)."""
    pred = torch.as_tensor(pred).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())


# ---------------------------------------------------------------------------
# Training steps and loop
# ---------------------------------------------------------------------------

def make_db_step(vit: ViTDiffusionBlocks, b: int, tcfg: TrainConfig,
                 impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) for block b: gradients and AdamW moments
    for ``layers[start:start+size]`` and the periphery only.

    step_fn(params, opt_state_b, images, labels, generator=None, *,
    sigma=None, eps=None) -> (params, opt_state_b, loss, metrics)"""
    start, size = vit.ranges[b]

    def loss_fn(view, images, labels, generator=None, *, sigma=None,
                eps=None):
        return vit.block_loss(view, b, images, labels, generator, sigma=sigma,
                              eps=eps, unit_range=(0, size), impl=impl)

    return T.make_view_train_step(loss_fn, tcfg, (start, size))


def make_e2e_step(vit: ViTDiffusionBlocks, tcfg: TrainConfig,
                  impl: str = "kernels"):
    """(init_opt_state_fn, step_fn) over every param, with the signature of
    ``make_db_step``'s step (the baseline draws nothing: ``generator`` is
    not read)."""
    def loss_fn(view, images, labels, generator=None):
        return vit.e2e_loss(view, images, labels, impl=impl)

    return T.make_view_train_step(loss_fn, tcfg)


def train(vit: ViTDiffusionBlocks, tcfg: TrainConfig, data_iter,
          generator: torch.Generator, params=None, blockwise: bool = True,
          impl: str = "kernels", log=print):
    """The Table 1 training loop (DB and e2e): ``blockwise`` trains a block
    drawn uniformly from ``generator`` each step (each block with its own
    AdamW state), else the full stack (one state). ``data_iter`` yields
    (images (B, H, W, C), labels (B,)) arrays. Returns (params, history
    [(it, block, loss)]), block -1 for the full stack."""
    dev = generator.device
    if params is None:
        params = vit.init(generator)
    steps = ([make_db_step(vit, b, tcfg, impl)
              for b in range(vit.db.num_blocks)] if blockwise
             else [make_e2e_step(vit, tcfg, impl)])
    batches = ((torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev),
                torch.as_tensor(np.asarray(y), dtype=torch.long).to(dev))
               for x, y in data_iter)
    return T.train_views(steps, params, batches, generator, tcfg, blockwise,
                         "vit", log)
