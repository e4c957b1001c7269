"""PyTorch port: the bf16 tensor-core attention backward, on the CPU.

The kernels (``dkv_tc_kernel`` and ``dq_tc_kernel`` in
``kernels/csrc/flash_attention_bwd.cu``) run only on the card. Here their
arithmetic is emulated in torch, tile by tile:

- bf16 q, k, v, dO; fp32 products;
- P = 2^(s * scale * log2(e) - lse * log2(e)) from the forward's natural-log
  lse, selected to 0 where the mask refuses the pair (never pushed through
  exp: a row that sees no key has lse = -1e30);
- dS = P (dP - delta) scale;
- dV += P^T dO and dK += dS^T Q over 64-query tiles, dQ += dS K over
  64-key tiles, each fp32 operand split into bf16 hi + lo and both products
  accumulated in fp32.

dk/dv masks from the key side, through a mirror of ``key_queries`` in
``kernels/csrc/flash_attention.cuh`` (the queries that keep a key, as at
most two intervals), which is itself checked against ``keep_mask``.

Held against ``_bwd_dq_ref`` / ``_bwd_dkv_ref`` under
``chip_smoke.compare``'s bound (2e-4 + 2^-7 |ref| on bf16 outputs) in all
five mask kinds at hd 64 and 128 with G = 2, one case with a query row that
sees no key; and, in fp32, against the Pallas backward (``_bwd_impl``,
interpret mode, 64-row tiles) at 1e-4.

What the splits buy (``test_unsplit_operands_against_the_card_bound``):
with both split every output is inside the bound (its worst error is that
of the output's one bf16 rounding); P rounded to bf16 alone puts dv past
twice the bound in every case at both head dims, and dS rounded alone
does the same to dk and dq. So both kernels split P and dS.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.kernels import flash_attention as FA
from torch_attention_cases import TC_BWD_CASES

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

TILE = 64
LOG2E = 1.4426950408889634
# name -> (kind, Sq, Sk, window, mask_seq), shared with the card tests
CASES = TC_BWD_CASES


def key_queries(cfg: FA.FlashConfig, Sq: int, Sk: int):
    """(lo1, hi1, lo2, hi2), each (Sk,) int64: the queries that keep key kp
    are [lo1, hi1) and [lo2, hi2), inside [0, Sq) (``key_queries`` of
    flash_attention.cuh, vectorised over the keys)."""
    kp = torch.arange(Sk)
    zero = torch.zeros_like(kp)
    lo1, hi1, lo2, hi2 = zero, torch.full_like(kp, Sq), zero, zero
    S = cfg.mask_seq
    if cfg.mask_kind == "causal":
        lo1 = kp
    elif cfg.mask_kind == "window":
        lo1, hi1 = kp, kp + cfg.window
    elif cfg.mask_kind == "db_concat":
        clean = kp < S
        lo1 = kp
        hi1 = torch.where(clean, torch.full_like(kp, S), kp + 1)
        lo2 = torch.where(clean, kp + S + 1, zero)
        hi2 = torch.where(clean, torch.full_like(kp, Sq), zero)
    elif cfg.mask_kind == "two_pass":
        clean = kp < S
        lo1 = torch.where(clean, kp + 1, kp - S)
        hi1 = torch.where(clean, torch.full_like(kp, Sq), kp - S + 1)
    clip = lambda x: x.clamp(0, Sq)  # noqa: E731
    return clip(lo1), clip(hi1), clip(lo2), clip(hi2)


def _keep_t(bounds, q0, q1):
    """(Sk, q1 - q0) keep-mask of queries [q0, q1) from key_queries."""
    lo1, hi1, lo2, hi2 = (b[:, None] for b in bounds)
    qp = torch.arange(q0, q1)[None, :]
    return ((qp >= lo1) & (qp < hi1)) | ((qp >= lo2) & (qp < hi2))


def _split(x: torch.Tensor, split: bool):
    """The bf16 operand terms of fp32 x: (hi, lo) or (hi,)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _consts(hd):
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    return scale, scale * torch.tensor(LOG2E, dtype=torch.float32)


def emulate_dkv(q, k, v, do, lse, delta, cfg, split_p=True, split_ds=True):
    """fp32 (dk, dv) before their bf16 rounding, as ``dkv_tc_kernel``
    computes them: per KV head, over the G query heads of its group and
    every 64-query tile, the transposed tiles S^T = K Q^T and dP^T = V dO^T,
    P^T from lse in base 2 (0 where key_queries refuses), dS^T, then
    dV += P^T dO and dK += dS^T Q with each fp32 operand as bf16 terms."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale, scale2 = _consts(hd)
    bounds = key_queries(cfg, Sq, Sk)
    view = lambda x: x.float().reshape(B, KV, G, *x.shape[2:])  # noqa: E731
    qg, dog, lseg, deltag = view(q), view(do), view(lse), view(delta)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(B, KV, Sk, hd)
    dv = torch.zeros(B, KV, Sk, hd)
    for g in range(G):
        for q0 in range(0, Sq, TILE):
            qs = slice(q0, q0 + TILE)
            qt, dot = qg[:, :, g, qs], dog[:, :, g, qs]
            lse2 = lseg[:, :, g, qs] * LOG2E
            keep = _keep_t(bounds, q0, min(q0 + TILE, Sq))
            sT = kf @ qt.transpose(-1, -2)                  # (B, KV, Sk, n)
            pT = torch.where(keep, torch.exp2(sT * scale2 - lse2[:, :, None]),
                             torch.zeros(()))
            dpT = vf @ dot.transpose(-1, -2)
            dsT = pT * (dpT - deltag[:, :, g, None, qs]) * scale
            for term in _split(pT, split_p):
                dv = dv + term @ dot
            for term in _split(dsT, split_ds):
                dk = dk + term @ qt
    return dk, dv


def emulate_dq(q, k, v, do, lse, delta, cfg, split_ds=True):
    """fp32 dq before its bf16 rounding, as ``dq_tc_kernel`` computes it:
    per 64-key tile S = Q K^T and dP = dO V^T, P from lse in base 2 (0 where
    the mask refuses), dS, then dQ += dS K with dS as bf16 terms."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale, scale2 = _consts(hd)
    keep = FA.keep_mask(cfg, Sq, Sk)
    kf, vf = (FA._expand_kv(x, H // KV).float() for x in (k, v))
    qf, dof = q.float(), do.float()
    lse2 = (lse * LOG2E)[..., None]
    dq = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Sk, TILE):
        ks = slice(k0, k0 + TILE)
        s = qf @ kf[:, :, ks].transpose(-1, -2)
        p = torch.where(keep[:, ks], torch.exp2(s * scale2 - lse2),
                        torch.zeros(()))
        dp = dof @ vf[:, :, ks].transpose(-1, -2)
        ds = p * (dp - delta[..., None]) * scale
        for term in _split(ds, split_ds):
            dq = dq + term @ kf[:, :, ks]
    return dq


def _inputs(name, hd, seed, G=2):
    """cfg and bf16 q, k, v, dO (numpy, from a seed), with the plain
    forward's lse and delta = rowsum(dO * out) on its bf16 out, as the
    card check takes them from the forward kernel."""
    kind, Sq, Sk, window, mseq = CASES[name]
    rs = np.random.RandomState(seed)
    B, KV = 1, 2
    mk = lambda H, S: torch.from_numpy(  # noqa: E731
        rs.randn(B, H, S, hd).astype(np.float32)).bfloat16()
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    q, k, v, do = mk(KV * G, Sq), mk(KV, Sk), mk(KV, Sk), mk(KV * G, Sq)
    out, lse = FA.flash_attention_fwd_ref(q, k, v, cfg)
    return cfg, q, k, v, do, lse, FA.attention_delta(out, do)


@pytest.mark.parametrize("name", sorted(CASES))
def test_key_queries_mirror_matches_keep_mask(name):
    kind, Sq, Sk, window, mseq = CASES[name]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    got = _keep_t(key_queries(cfg, Sq, Sk), 0, Sq)
    assert torch.equal(got, FA.keep_mask(cfg, Sq, Sk).T)


def test_cut_keys_case_has_a_row_that_sees_no_key():
    kind, Sq, Sk, window, mseq = CASES["two_pass, cut keys"]
    keep = FA.keep_mask(FA.FlashConfig(kind, mask_seq=mseq), Sq, Sk)
    assert not keep[0].any() and keep[1:].any(-1).all()


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_arithmetic_meets_the_card_bound(name, hd):
    cfg, q, k, v, do, lse, delta = _inputs(name, hd, seed=hd)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, cfg)
    dq = emulate_dq(q, k, v, do, lse, delta, cfg)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all()
    SMOKE.compare(f"emulated dq {name} hd {hd}", dq.bfloat16(),
                  FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg),
                  bf16_rounding=True)
    SMOKE.compare(f"emulated dk/dv {name} hd {hd}",
                  (dk.bfloat16(), dv.bfloat16()),
                  FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg),
                  bf16_rounding=True)
    if name == "two_pass, cut keys":
        assert (dq[:, :, 0] == 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_arithmetic_matches_pallas(name):
    """fp32 dq, dk, dv of the emulation against the Pallas backward
    (interpret mode, 64-row tiles) on the same bf16-valued inputs in fp32,
    with JAX's own forward lse and delta: the split operands are accurate
    to ~2^-17, far inside 1e-4."""
    cfg, q, k, v, do, _, _ = _inputs(name, 64, seed=5)
    jcfg = JFA.FlashConfig(mask_kind=cfg.mask_kind, window=cfg.window,
                           mask_seq=cfg.mask_seq, block_q=TILE,
                           block_k=TILE, interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()) for x in (q, k, v, do))
    jout, jlse = JFA._fwd_impl(jq, jk, jv, jcfg)
    jdq, jdk, jdv = JFA._bwd_impl(jq, jk, jv, jout, jlse, jdo, jcfg)
    Sq = q.shape[2]
    lse = torch.from_numpy(np.array(jlse)[..., :Sq])
    delta = FA.attention_delta(torch.from_numpy(np.array(jout)), do)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, cfg)
    dq = emulate_dq(q, k, v, do, lse, delta, cfg)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-4, 1e-4)


# (operand left unsplit, outputs it breaks): P feeds dv alone; dS feeds dk
# and dq
UNSPLIT = {"P": ("dv",), "dS": ("dk", "dq")}


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("operand", sorted(UNSPLIT))
def test_unsplit_operands_against_the_card_bound(operand, name, hd):
    """Rounding P (or dS) to one bf16 term puts the outputs it feeds past
    twice the card bound, in every case at both head dims, and leaves the
    others inside it: the reason both kernels split them."""
    cfg, q, k, v, do, lse, delta = _inputs(name, hd, seed=hd + 1)
    split_p, split_ds = operand != "P", operand != "dS"
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, cfg, split_p=split_p,
                         split_ds=split_ds)
    dq = emulate_dq(q, k, v, do, lse, delta, cfg, split_ds=split_ds)
    rdk, rdv = FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    pairs = {"dq": (dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)),
             "dk": (dk, rdk), "dv": (dv, rdv)}
    for out, (got, want) in pairs.items():
        label = f"unsplit {operand}: {out} {name} hd {hd}"
        if out in UNSPLIT[operand]:
            with pytest.raises(SMOKE.SmokeError, match="disagrees"):
                SMOKE.compare(label, got.bfloat16(), want,
                              bf16_rounding=True)
            err = (got.bfloat16().float() - want.float()).abs()
            limit = SMOKE.TOL + SMOKE.BF16_ULP * want.float().abs()
            assert (err / limit).max() > 2, label
        else:
            SMOKE.compare(label, got.bfloat16(), want, bf16_rounding=True)
