"""PyTorch port: the fp32 tensor-core attention backward, on the CPU.

The kernels (``dkv_tf32_kernel`` and ``dq_tf32_kernel`` in
``kernels/csrc/flash_attention_bwd.cu``) run only on the card. Here:

(a) the ``mma.sync`` m16n8k8 tf32 fragments they fill: a warp's registers,
    filled as the kernels fill them, give the five products. In a score
    product (S^T = K Q^T, dP^T = V dO^T; S = Q K^T) n-index g of an n8 tile
    stands for row g ^ (g >> 2) of the streamed tile; in a gradient product
    (dV += P^T dO, dK += dS^T Q; dQ += dS K) the score accumulators are the
    A operand as they stand, and two adjacent output tiles take dims 2g and
    2g + 1 of a 16-dim slice from one float2 a row, stored as float4;
(b) every shared-memory read of those fragments, at the rows' pitch of
    HD + 8 floats, touches each bank once a half-warp request, and without
    the row swap the gradient products' reads would not;
(c) their arithmetic, emulated in torch: each operand split into a big and
    a small tf32 term on the int32 view (``split`` of
    ``test_torch_attention_tf32.py``), three products each (3xTF32), 64-row
    tiles, P from the lse in base 2 (0 where the mask refuses the pair,
    from the key side in dk/dv through ``key_queries``), the relabelled k
    orders. Held against ``_bwd_dq_ref`` / ``_bwd_dkv_ref`` under
    ``chip_smoke.compare``'s fp32 bound (2e-4 + 2e-4 |ref|) in every
    ``TC_BWD_CASES`` case at hd 64 and 128 with G = 2 on inputs of scale 2,
    and against the Pallas backward (``_bwd_impl``, interpret mode, 64-row
    tiles) at 1e-4;
(d) 1xTF32 in any one of the five products puts the outputs it feeds past
    that bound (10x and more on inputs of scale 2), and leaves the others
    inside it: the reason the kernels split all five.

Why scale 2 and not the forward tests' 3: the gradients' errors grow
steeply with the inputs' scale (the logits' and dP's magnitudes), and at
scale 3 the fp32 plain version itself misses the bound against the same
function evaluated in fp64 (``test_scale_3_is_past_fp32s_own_reach``), so
neither it nor any fp32 kernel summing in another order can be held to it
there. At scale 2 the plain version is within a quarter of the bound of
the fp64 answer and the emulation within half of it of the plain version.

(e) ``tune_attention_bwd.py``'s variants still apply to the committed
    source, and its "chosen" variant is that source.
"""
import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.kernels import flash_attention as FA
from test_torch_attention_bwd_tc import _keep_t, key_queries
from test_torch_attention_tf32 import K8, c_frag, mma_m16n8k8, product
from torch_attention_cases import TC_BWD_CASES

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def _load_tune():
    """tune_attention_bwd.py as a module (it imports chip_smoke)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "chip_smoke", SMOKE)
        spec = importlib.util.spec_from_file_location(
            "tune_attention_bwd", ROOT / "tune_attention_bwd.py")
        tune = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tune)
    return tune


TUNE = _load_tune()

TILE = 64
LOG2E = 1.4426950408889634
# the row of an 8-row score tile that n-index g stands for (score_row)
SCORE_ROW = [g ^ (g >> 2) for g in range(8)]
# a gradient product's k order inside an 8-wide step: k-index t is score
# column 2t, t + 4 is column 2t + 1
GRAD_K8 = [SCORE_ROW[2 * t] for t in range(4)] + \
    [SCORE_ROW[2 * t + 1] for t in range(4)]
SCALE = 2.0                      # the inputs' scale (module docstring)
PRODUCTS = ("S", "dP", "dV", "dK", "dQ")
# the outputs each product feeds: S gives P, which every gradient takes;
# dP gives dS, which dk and dq take
FEEDS = {"S": ("dq", "dk", "dv"), "dP": ("dq", "dk"), "dV": ("dv",),
         "dK": ("dk",), "dQ": ("dq",)}


def _lanes():
    return [divmod(lane, 4) for lane in range(32)]


# ---------------------------------------------------------------------------
# (a) the fragments
# ---------------------------------------------------------------------------

def score_product(A: np.ndarray, Bt: np.ndarray, nj: int) -> np.ndarray:
    """A (16 x hd) times Bt^T (Bt: 8 nj x hd rows) as score_products_tf32
    computes it, returned as the accumulators hold it: (16, 8 nj), column
    8j + n is n-index n of n8 tile j. A by q_frag_tf32's float2 reads (rows
    g, g + 8, dims 8kk + 2t, 2t + 1), B by one float2 of row 8j +
    score_row(g) at dims 8kk + 2t."""
    hd = A.shape[1]
    out = np.zeros((16, 8 * nj))
    for j in range(nj):
        for kk in range(hd // 8):
            d = 8 * kk
            a = [(A[g, d + 2 * t], A[g + 8, d + 2 * t], A[g, d + 2 * t + 1],
                  A[g + 8, d + 2 * t + 1]) for g, t in _lanes()]
            b = [(Bt[8 * j + SCORE_ROW[g], d + 2 * t],
                  Bt[8 * j + SCORE_ROW[g], d + 2 * t + 1])
                 for g, t in _lanes()]
            out[:, 8 * j:8 * j + 8] += mma_m16n8k8(a, b)
    return out


def gradient_product(acc: np.ndarray, Bm: np.ndarray) -> np.ndarray:
    """acc (16, 8 nj) in the accumulators' layout times the rows of Bm
    (8 nj x hd) as the gradient loops compute it, returned as store_row
    writes it: the A fragment straight from each tile's accumulators
    (c_frag: (c0, c2, c1, c3)); for output tiles 2dd, 2dd + 1, B from one
    float2 of rows 8j + 2t + sw and 8j + 2t + 1 - sw (sw = t >> 1) at dims
    16dd + 2g; each thread stores dims 16dd + 4t .. + 3 of rows g, g + 8."""
    nj, hd = acc.shape[1] // 8, Bm.shape[1]
    tiles = np.zeros((hd // 8, 16, 8))          # output n8 tiles
    for j in range(nj):
        a = []
        for lane in range(32):
            c = c_frag(acc[:, 8 * j:8 * j + 8], lane)
            a.append((c[0], c[2], c[1], c[3]))
        for dd in range(hd // 16):
            b0, b1 = [], []
            for g, t in _lanes():
                sw = t >> 1
                r0 = 8 * j + 2 * t + sw
                r1 = r0 + 1 - 2 * sw
                x = Bm[r0, 16 * dd + 2 * g:16 * dd + 2 * g + 2]
                y = Bm[r1, 16 * dd + 2 * g:16 * dd + 2 * g + 2]
                b0.append((x[0], y[0]))
                b1.append((x[1], y[1]))
            tiles[2 * dd] += mma_m16n8k8(a, b0)
            tiles[2 * dd + 1] += mma_m16n8k8(a, b1)
    out = np.full((16, hd), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(2):
            for dd in range(hd // 16):
                d0, d1 = tiles[2 * dd], tiles[2 * dd + 1]
                e0, e1 = c_frag(d0, lane), c_frag(d1, lane)
                out[g + 8 * i, 16 * dd + 4 * t:16 * dd + 4 * t + 4] = (
                    e0[2 * i], e1[2 * i], e0[2 * i + 1], e1[2 * i + 1])
    return out


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
def test_fragment_layouts_compute_the_five_products(hd):
    """One warp's 16 rows against a 32-row pass: the score products give
    the scores with n-index g standing for row score_row(g), and the
    gradient products on those accumulators give P^T dO (dV), dS^T Q (dK)
    and dS K (dQ) exactly, whatever rows the accumulators' columns stand
    for, written at the right dims."""
    rs = np.random.RandomState(hd)
    K, V = rs.randn(16, hd), rs.randn(16, hd)      # dk/dv: the warp's keys
    Q, dO = rs.randn(32, hd), rs.randn(32, hd)     # the pass's queries
    perm = [8 * j + SCORE_ROW[n] for j in range(4) for n in range(8)]
    sT = score_product(K, Q, 4)
    dpT = score_product(V, dO, 4)
    np.testing.assert_allclose(sT, (K @ Q.T)[:, perm], 1e-12, 1e-12)
    np.testing.assert_allclose(dpT, (V @ dO.T)[:, perm], 1e-12, 1e-12)
    # any P^T, dS^T in the accumulators' layout: column c is query perm[c]
    pT, dsT = rs.rand(16, 32), rs.randn(16, 32)
    inv = np.argsort(perm)
    np.testing.assert_allclose(gradient_product(pT, dO),
                               pT[:, inv] @ dO, 1e-12, 1e-12)
    np.testing.assert_allclose(gradient_product(dsT, Q),
                               dsT[:, inv] @ Q, 1e-12, 1e-12)
    # dq: the warp's queries against a pass of keys, K read both ways
    Qw, dOw, Kp, Vp = (rs.randn(n, hd) for n in (16, 16, 32, 32))
    np.testing.assert_allclose(score_product(Qw, Kp, 4),
                               (Qw @ Kp.T)[:, perm], 1e-12, 1e-12)
    np.testing.assert_allclose(score_product(dOw, Vp, 4),
                               (dOw @ Vp.T)[:, perm], 1e-12, 1e-12)
    ds = rs.randn(16, 32)
    np.testing.assert_allclose(gradient_product(ds, Kp), ds[:, inv] @ Kp,
                               1e-12, 1e-12)


# ---------------------------------------------------------------------------
# (b) shared-memory banks
# ---------------------------------------------------------------------------

def _requests(hd: int, rows_of=SCORE_ROW):
    """Every float2 read of the kernels' fragment loops, as the word
    offsets each lane reads (rows of HD + 8 floats), one list of 32 lanes a
    warp instruction: A fragments (rows 16w + g and + 8, dims 8kk + 2t),
    score B (rows 8j + rows_of[g], dims 8kk + 2t), gradient B (rows 8j + 2t
    + sw and 8j + 2t + 1 - sw as rows_of[2t], rows_of[2t + 1] name them,
    dims 16dd + 2g)."""
    P = hd + 8
    reqs = []
    for w in range(4):
        for kk in range(hd // 8):
            for half in (0, 8):
                reqs.append([(16 * w + g + half) * P + 8 * kk + 2 * t
                             for g, t in _lanes()])
    for j in range(8):
        for kk in range(hd // 8):
            reqs.append([(8 * j + rows_of[g]) * P + 8 * kk + 2 * t
                         for g, t in _lanes()])
        for dd in range(hd // 16):
            for e in (0, 1):
                reqs.append([(8 * j + rows_of[2 * t + e]) * P + 16 * dd
                             + 2 * g for g, t in _lanes()])
    return reqs


def _wavefronts(req) -> int:
    """Shared-memory wavefronts of one 64-bit warp read: each half-warp is
    served alone, in as many passes as the most words any one bank holds."""
    n = 0
    for half in (req[:16], req[16:]):
        banks = {}
        for word in half:
            for w in (word, word + 1):
                banks.setdefault(w % 32, set()).add(w)
        n += max(len(words) for words in banks.values())
    return n


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
def test_fragment_reads_are_free_of_bank_conflicts(hd):
    reqs = _requests(hd)
    assert all(_wavefronts(r) == 2 for r in reqs)
    # with n-index g standing for row g, the gradient reads of rows 2t and
    # 2t + 4 collide
    plain = _requests(hd, rows_of=list(range(8)))
    assert max(_wavefronts(r) for r in plain) == 4


# ---------------------------------------------------------------------------
# (c), (d) the kernels' arithmetic
# ---------------------------------------------------------------------------

def _consts(hd):
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    return scale, scale * torch.tensor(LOG2E, dtype=torch.float32)


def _order(n: int, k8) -> torch.Tensor:
    """Indices of n (a multiple of 8) rows in the kernels' k order."""
    return torch.tensor([8 * j + e for j in range(n // 8) for e in k8])


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., S, d) or (..., S) with zero rows up to S + n."""
    pad = (0, n) if x.ndim == 3 else (0, 0, 0, n)
    return torch.nn.functional.pad(x.float(), pad)


# the rows of a 64-row tile that each pass of the kernels takes (32 rows,
# kTf32Pass)
PASSES = [slice(c, c + 32) for c in range(0, TILE, 32)]


def emulate_dkv(q, k, v, do, lse, delta, cfg, plain=()):
    """fp32 (dk, dv) as ``dkv_tf32_kernel`` computes them: per KV head,
    over the G query heads of its group and every 64-query tile (queries
    past Sq zero and masked), S^T = K Q^T and dP^T = V dO^T over the dims in
    the kernel's k order, P^T from the lse in base 2 (0 where key_queries
    refuses), dS^T, then dV += P^T dO and dK += dS^T Q, each pass's share
    over its queries in the gradient k order added to the running sums;
    each product 3xTF32, or plain tf32 for the ones named in ``plain``."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale, scale2 = _consts(hd)
    pad = -Sq % TILE
    bounds = key_queries(cfg, Sq, Sk)
    view = lambda x: _pad_rows(x, pad).reshape(  # noqa: E731
        B, KV, G, Sq + pad, *x.shape[3:])
    qg, dog = view(q), view(do)
    lseg, deltag = view(lse), view(delta)
    dims, rows = _order(hd, K8), _order(TILE, GRAD_K8)
    kf, vf = k.float()[..., dims], v.float()[..., dims]
    dk = torch.zeros(B, KV, Sk, hd)
    dv = torch.zeros(B, KV, Sk, hd)
    for g in range(G):
        for q0 in range(0, Sq + pad, TILE):
            qs = slice(q0, q0 + TILE)
            qt, dot = qg[:, :, g, qs], dog[:, :, g, qs]
            lse2 = (lseg[:, :, g, None, qs] * LOG2E)
            keep = _keep_t(bounds, q0, q0 + TILE)
            sT = product(kf, qt[..., dims].transpose(-1, -2), "S" not in plain)
            pT = torch.where(keep, torch.exp2(sT * scale2 - lse2),
                             torch.zeros(()))
            dpT = product(vf, dot[..., dims].transpose(-1, -2),
                          "dP" not in plain)
            dsT = pT * (dpT - deltag[:, :, g, None, qs]) * scale
            for c in PASSES:
                dv = dv + product(pT[..., rows[c]], dot[:, :, rows[c]],
                                  "dV" not in plain)
                dk = dk + product(dsT[..., rows[c]], qt[:, :, rows[c]],
                                  "dK" not in plain)
    return dk, dv


def emulate_dq(q, k, v, do, lse, delta, cfg, plain=()):
    """fp32 dq as ``dq_tf32_kernel`` computes it: per 64-key tile (keys
    past Sk zero and masked) S = Q K^T and dP = dO V^T over the dims in the
    kernel's k order, P from the lse in base 2 (0 where the mask refuses),
    dS, then dQ += dS K, each pass's share over its keys in the gradient k
    order added to the running sum."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale, scale2 = _consts(hd)
    pad = -Sk % TILE
    keep = torch.nn.functional.pad(FA.keep_mask(cfg, Sq, Sk), (0, pad))
    dims, rows = _order(hd, K8), _order(TILE, GRAD_K8)
    kf, vf = (_pad_rows(FA._expand_kv(x, H // KV), pad) for x in (k, v))
    qf, dof = q.float()[..., dims], do.float()[..., dims]
    lse2 = (lse * LOG2E)[..., None]
    dq = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Sk + pad, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = product(qf, kt[..., dims].transpose(-1, -2), "S" not in plain)
        p = torch.where(keep[:, k0:k0 + TILE],
                        torch.exp2(s * scale2 - lse2), torch.zeros(()))
        dp = product(dof, vt[..., dims].transpose(-1, -2), "dP" not in plain)
        ds = p * (dp - delta[..., None]) * scale
        for c in PASSES:
            dq = dq + product(ds[..., rows[c]], kt[:, :, rows[c]],
                              "dQ" not in plain)
    return dq


def _inputs(name, hd, seed, scale):
    """cfg and fp32 q, k, v, dO of the given scale (numpy, from a seed),
    G = 2, with the plain forward's lse and delta = rowsum(dO * out)."""
    kind, Sq, Sk, window, mseq = TC_BWD_CASES[name]
    rs = np.random.RandomState(seed)
    B, KV, G = 1, 2, 2
    mk = lambda H, S: torch.from_numpy(  # noqa: E731
        scale * rs.randn(B, H, S, hd).astype(np.float32))
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    q, k, v, do = mk(KV * G, Sq), mk(KV, Sk), mk(KV, Sk), mk(KV * G, Sq)
    out, lse = FA.flash_attention_fwd_ref(q, k, v, cfg)
    return cfg, q, k, v, do, lse, FA.attention_delta(out, do)


def _outputs(cfg, q, k, v, do, lse, delta, plain=()):
    """{name: (emulated, plain version)} of dq, dk and dv."""
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, cfg, plain)
    dq = emulate_dq(q, k, v, do, lse, delta, cfg, plain)
    rdk, rdv = FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    return {"dq": (dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)),
            "dk": (dk, rdk), "dv": (dv, rdv)}


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("name", sorted(TC_BWD_CASES))
def test_3xtf32_backward_meets_the_card_bound(name, hd):
    cfg, *args = _inputs(name, hd, seed=hd, scale=SCALE)
    outs = _outputs(cfg, *args)
    for out, (got, want) in outs.items():
        SMOKE.compare(f"emulated fp32 tensor-core {out} {name} hd {hd}",
                      got, want)
    if name == "two_pass, cut keys":
        assert (outs["dq"][0][:, :, 0] == 0).all()


@pytest.mark.parametrize("name", sorted(TC_BWD_CASES))
def test_3xtf32_backward_matches_pallas(name):
    """dq, dk, dv of the emulation against the Pallas backward (interpret
    mode, 64-row tiles) on the same fp32 inputs, with JAX's own forward lse
    and delta: within 1e-4."""
    cfg, q, k, v, do, _, _ = _inputs(name, 64, seed=5, scale=1.0)
    jcfg = JFA.FlashConfig(mask_kind=cfg.mask_kind, window=cfg.window,
                           mask_seq=cfg.mask_seq, block_q=TILE,
                           block_k=TILE, interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jout, jlse = JFA._fwd_impl(jq, jk, jv, jcfg)
    jdq, jdk, jdv = JFA._bwd_impl(jq, jk, jv, jout, jlse, jdo, jcfg)
    lse = torch.from_numpy(np.array(jlse)[..., :q.shape[2]])
    delta = FA.attention_delta(torch.from_numpy(np.array(jout)), do)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, cfg)
    dq = emulate_dq(q, k, v, do, lse, delta, cfg)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-4, 1e-4)


def test_hd32_vit_sequence_matches_pallas():
    """The plain fp32 dq and dk/dv and the emulations of
    ``dq_tf32_kernel<32>`` and ``dkv_tf32_kernel<32>`` against the Pallas
    backward (interpret mode, 64-row tiles) at hd 32, S = 66 (ViT: the
    second tile of each side holds 2 rows), ``full`` mask, on JAX's own
    forward lse and delta: within 1e-4; the emulations also under the card
    bound against the plain versions."""
    rs = np.random.RandomState(66)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 4, 66, 32).astype(np.float32))
                   for _ in range(4))
    cfg = FA.FlashConfig("full")
    jcfg = JFA.FlashConfig(mask_kind="full", block_q=TILE, block_k=TILE,
                           interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jout, jlse = JFA._fwd_impl(jq, jk, jv, jcfg)
    want = JFA._bwd_impl(jq, jk, jv, jout, jlse, jdo, jcfg)
    lse = torch.from_numpy(np.array(jlse)[..., :66])
    delta = FA.attention_delta(torch.from_numpy(np.array(jout)), do)
    ref = (FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg),) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    emu = (emulate_dq(q, k, v, do, lse, delta, cfg),) + \
        emulate_dkv(q, k, v, do, lse, delta, cfg)
    SMOKE.compare("emulated fp32 tensor-core backward, hd 32, S 66", emu,
                  ref)
    for got in (ref, emu):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), 1e-4, 1e-4)


@pytest.mark.parametrize("name", sorted(TC_BWD_CASES))
@pytest.mark.parametrize("plain", PRODUCTS)
def test_1xtf32_in_one_product_breaks_the_card_bound(plain, name):
    """Any one of the five products in plain tf32 puts the outputs it feeds
    past the card bound, and leaves the others inside it: the reason both
    kernels split all five."""
    cfg, *args = _inputs(name, 64, seed=64, scale=SCALE)
    for out, (got, want) in _outputs(cfg, *args, plain=(plain,)).items():
        label = f"1xTF32 in {plain}: {out} {name}"
        if out in FEEDS[plain]:
            with pytest.raises(SMOKE.SmokeError, match="disagrees"):
                SMOKE.compare(label, got, want)
        else:
            SMOKE.compare(label, got, want)


@pytest.mark.parametrize("scale", [SCALE, 3.0])
def test_scale_3_is_past_fp32s_own_reach(scale):
    """The fp32 plain versions against their own formulas in fp64 on the
    same inputs, lse and delta: inside the card bound at the tests' scale,
    past it at scale 3 (the reason the tests take scale 2)."""
    cfg, *args = _inputs("full", 128, seed=128, scale=scale)
    want = TUNE.bwd_fp64(*args, cfg)
    got = (FA._bwd_dq_ref(*args, cfg),) + FA._bwd_dkv_ref(*args, cfg)
    worst = max(((g.double() - w).abs() / (SMOKE.TOL + SMOKE.TOL * w.abs()))
                .max().item() for g, w in zip(got, want))
    assert (worst < 0.5) if scale == SCALE else (worst > 1.0), worst


# ---------------------------------------------------------------------------
# (e) the tuning script's variants
# ---------------------------------------------------------------------------

def test_tuning_variants_apply_to_the_committed_source():
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
           ).read_text()
    built = {name: TUNE.variant_source(src, *spec)
             for name, spec in TUNE.VARIANTS.items()}
    assert built.pop("chosen") == src
    assert len(set(built.values())) == len(built)
    assert all(text != src for text in built.values())
