"""PyTorch port: the bf16 tensor-core flash-attention forward, on the CPU.

The kernel (``fwd_tc_kernel`` in ``kernels/csrc/flash_attention_fwd.cu``)
runs only on the card. Here:

(a) the layout it takes: ``flash_attention.tc_aligned`` (16-byte aligned
    base, batch / head / sequence strides in multiples of 16 bytes) admits
    every view the model hands the kernels, in concat and two-pass DB
    steps (forward inputs, and the backward's dO and gradient buffers, which
    the tensor-core backward kernels take under the same rule), and refuses
    odd strides and offsets;
(b) its arithmetic, emulated in torch: bf16 inputs, fp32 scores, an online
    softmax over 64-key tiles in base 2, P split into bf16 hi + lo and both
    products accumulated in fp32. Held against ``flash_attention_fwd_ref``
    under ``chip_smoke.compare``'s own bound (2e-4 + 2^-7 |ref| on the bf16
    out, 2e-4 + 2e-4 |ref| on lse) for all five mask kinds, and its fp32
    out and lse against the Pallas kernel (interpret mode) at 1e-4;
(c) the same emulation with P rounded to bf16 alone breaks that bound in
    every mask kind: the reason the kernel splits P.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.configs import DBConfig, TrainConfig, get_config, reduced
from repro_torch.core import training as T
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.data import MarkovLM
from repro_torch.kernels import flash_attention as FA

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

TILE = 64
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
# kind -> (Sq, Sk, window, mask_seq): ragged lengths, several 64-key tiles
CASES = {"full": (100, 190, None, None), "causal": (200, 200, None, None),
         "window": (200, 200, 37, None), "db_concat": (260, 260, None, 130),
         "two_pass": (130, 260, None, 130)}


# ---------------------------------------------------------------------------
# (a) the layout the kernel takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["concat", "two_pass"])
def test_model_views_are_tc_aligned(monkeypatch, mode):
    """Every q, k, v a bf16 DB step hands the attention kernels (the
    reshaped projections as transposed views, the two-pass noisy stream's
    ``torch.cat`` keys) is one the tensor-core forward takes; so is every
    dO the step's backward hands the attention backward, as it arrives
    (before any copy), and the dq, dk, dv buffers the backward wrappers
    allocate (``torch.empty_like`` of q, k, v)."""
    seen, seen_bwd = [], []
    orig = FA.flash_attention
    orig_bwd = FA._Flash.backward

    def record(q, k, v, **kw):
        seen.append((kw["mask_kind"], q, k, v))
        return orig(q, k, v, **kw)

    def record_bwd(ctx, do):
        q, k, v = ctx.saved_tensors[:3]
        seen_bwd.append((ctx.cfg.mask_kind, do, torch.empty_like(q),
                         torch.empty_like(k), torch.empty_like(v)))
        return orig_bwd(ctx, do)

    monkeypatch.setattr(FA, "flash_attention", record)
    monkeypatch.setattr(FA._Flash, "backward", staticmethod(record_bwd))
    arch = "olmo-1b" if mode == "two_pass" else "stablelm-1.6b"
    cfg = reduced(get_config(arch), n_layers=2, d_model=128, n_heads=2)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2,
                                             causal_mode=mode))
    gen = torch.Generator().manual_seed(0)
    params = dbm.init(gen)
    init, step = T.make_db_train_step(dbm, 0, TrainConfig(steps=2),
                                      precision="bf16")
    tokens = torch.as_tensor(next(MarkovLM(vocab_size=cfg.vocab_size,
                                           seed=7).iterator(2, 24)))
    step(params, init(params), tokens, gen)
    kinds = {k for k, *_ in seen}
    assert kinds == ({"causal", "two_pass"} if mode == "two_pass"
                     else {"db_concat"})
    # the two-pass step's last clean call reaches no loss: no backward
    assert len(seen_bwd) == len(seen) - (mode == "two_pass")
    for kind, *tensors in seen:
        for name, x in zip("qkv", tensors):
            assert x.dtype == torch.bfloat16 and x.shape[-1] == 64
            assert FA.tc_aligned(x.data_ptr(), x.stride(),
                                 x.element_size()), (kind, name, x.stride())
    for kind, *tensors in seen_bwd:
        for name, x in zip(("do", "dq", "dk", "dv"), tensors):
            assert x.dtype == torch.bfloat16 and x.shape[-1] == 64
            assert FA.tc_aligned(x.data_ptr(), x.stride(),
                                 x.element_size()), (kind, name, x.stride())


@pytest.mark.parametrize("ptr,strides,elt,ok", [
    (0, (4 * 512 * 64, 64, 4 * 64, 1), 2, True),     # (B, S, H, hd) view
    (256, (2 * 1024 * 128, 1024 * 128, 128, 1), 2, True),   # contiguous
    (0, (2 * 8 * 64, 8 * 64, 64, 1), 4, True),       # fp32: 16 B rows
    (2, (4 * 512 * 64, 64, 4 * 64, 1), 2, False),    # base off by 2 bytes
    (8, (4 * 512 * 64, 64, 4 * 64, 1), 2, False),    # base off by 8 bytes
    (0, (2 * 8 * 68, 8 * 68, 68, 1), 2, False),      # sequence stride 68
    (0, (2 * 8 * 64, 8 * 64 + 4, 64, 1), 2, False),  # head stride
    (0, (2 * 8 * 64 + 2, 8 * 64, 64, 1), 2, False),  # batch stride
])
def test_tc_aligned_rejects_odd_strides_and_offsets(ptr, strides, elt, ok):
    assert FA.tc_aligned(ptr, strides, elt) is ok


# ---------------------------------------------------------------------------
# (b), (c) the kernel's arithmetic
# ---------------------------------------------------------------------------

def emulate(q, k, v, cfg: FA.FlashConfig, split: bool = True):
    """(out fp32 before its bf16 rounding, lse) as ``fwd_tc_kernel``
    computes them: scores in fp32 from bf16 q, k, scaled by
    log2(e)/sqrt(hd); per 64-key tile the masked scores at -1e30, the running
    max m (0 subtracted while a row has seen no key), P = 2^(s - m), the
    correction 2^(m_old - m); P . V as bf16(P) . V plus, with ``split``,
    bf16(P - bf16(P)) . V, in fp32."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    Sk = k.shape[2]
    qf = q.float()
    kf, vf = (FA._expand_kv(x, G).float() for x in (k, v))
    keep = FA.keep_mask(cfg, Sq, Sk)
    neg = torch.tensor(FA.NEG_INF)
    scale2 = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    m = torch.full((B, H, Sq), FA.NEG_INF)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Sk, TILE):
        ks = slice(k0, k0 + TILE)
        s = (qf @ kf[:, :, ks].transpose(-1, -2)) * scale2
        s = torch.where(keep[:, ks], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == FA.NEG_INF, torch.zeros(()), m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, ks]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, ks]
        acc = acc * corr[..., None] + pv
        m = m_new
    lc = l.clamp(min=1e-30)
    lse = torch.where(l > 0, m * LN2 + torch.log(lc), neg)
    return acc / lc[..., None], lse


def _inputs(kind, hd, seed):
    Sq, Sk, window, mseq = CASES[kind]
    rs = np.random.RandomState(seed)
    B, KV, G = 1, 2, 2
    mk = lambda H, S: torch.from_numpy(  # noqa: E731
        rs.randn(B, H, S, hd).astype(np.float32)).bfloat16()
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    return cfg, mk(KV * G, Sq), mk(KV, Sk), mk(KV, Sk)


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_p_arithmetic_meets_the_card_bound(kind, hd):
    cfg, q, k, v = _inputs(kind, hd, seed=hd)
    out, lse = emulate(q, k, v, cfg)
    SMOKE.compare(f"emulated tensor-core forward {kind} hd {hd}",
                  (out.bfloat16(), lse), FA.flash_attention_fwd_ref(q, k, v,
                                                                    cfg),
                  bf16_rounding=True)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_split_p_arithmetic_matches_pallas(kind):
    """fp32 out and lse of the emulation against the Pallas kernel
    (interpret mode, 64-row tiles) on the same bf16-valued inputs in fp32:
    the split P is accurate to ~2^-17, far inside 1e-4."""
    cfg, q, k, v = _inputs(kind, 64, seed=3)
    out, lse = emulate(q, k, v, cfg)
    jcfg = JFA.FlashConfig(mask_kind=cfg.mask_kind, window=cfg.window,
                           mask_seq=cfg.mask_seq, block_q=TILE,
                           block_k=TILE, interpret=True)
    jout, jlse = JFA._fwd_impl(*(jnp.asarray(x.float().numpy())
                                 for x in (q, k, v)), jcfg)
    Sq = q.shape[2]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), 1e-4, 1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Sq],
                               1e-4, 1e-4)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_bf16_p_alone_breaks_the_card_bound(kind):
    cfg, q, k, v = _inputs(kind, 64, seed=64)
    out, lse = emulate(q, k, v, cfg, split=False)
    with pytest.raises(SMOKE.SmokeError, match="disagrees"):
        SMOKE.compare(f"bf16 P {kind}", (out.bfloat16(), lse),
                      FA.flash_attention_fwd_ref(q, k, v, cfg),
                      bf16_rounding=True)
