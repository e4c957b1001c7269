"""PyTorch port: the fp32 tensor-core flash-attention forward, on the CPU.

The kernel (``fwd_tf32_kernel`` in ``kernels/csrc/flash_attention_fwd.cu``)
runs only on the card. Here:

(a) the ``mma.sync`` m16n8k8 tf32 fragment layouts it relies on: a warp's
    registers, filled as the kernel fills them (Q and K with k-index t as
    element 2t of an 8-wide slice and t + 4 as 2t + 1; P straight from the
    score accumulators and V with the same relabelling of keys), give
    Q K^T and P V;
(b) its arithmetic, emulated in torch: each operand split into a big term
    (x plus half a tf32 ulp, read to 19 bits: rounded to nearest, ties
    away) and a small one (x - big, read truncated to 19 bits), done on the
    int32 view; three products each (3xTF32); 64-key tiles; the online
    softmax in base 2; the relabelled key order of P V. Held against
    ``flash_attention_fwd_ref`` under ``chip_smoke.compare``'s own fp32
    bound (2e-4 + 2e-4 |ref|) for all five mask kinds at hd 64 and 128, on
    inputs of scale 3, with ragged lengths and a row that sees no key, and
    against the Pallas kernel (interpret mode) at 1e-4;
(c) the same emulation with one product in plain tf32 (1xTF32) breaks that
    bound, in Q K^T and in P V, in every mask kind: the reason the kernel
    splits both;
(d) the fp32 q, k, v and out of a reduced DiT DB step and of reduced Huginn
    steps, and their backward's dO, dq, dk and dv, are tensors
    ``tc_aligned`` admits, so the main paths take the fp32 kernels' 16-byte
    copies (the 4-byte ones are for other views);
(e) ``tune_attention_fwd.py``'s variants still apply to the committed
    source, and its "chosen" variant is that source.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.configs import TrainConfig, paper, reduced
from repro_torch.core import dit as DIT
from repro_torch.core import recurrent as REC
from repro_torch.kernels import flash_attention as FA
from torch_attention_cases import TC_BWD_CASES

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

TILE = 64
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LOW13 = 0x1FFF                       # the mantissa bits tf32 drops
# the k order of one 8-wide step: k-index t is element 2t, t + 4 is 2t + 1
K8 = [0, 2, 4, 6, 1, 3, 5, 7]


# ---------------------------------------------------------------------------
# tf32 on the int32 view
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous().view(torch.int32)


def tf32_read(bits: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read from a 32-bit operand: its top 19 bits."""
    return (bits & ~LOW13).view(torch.float32)


def split(x: torch.Tensor):
    """(big, small) as ``split_tf32`` hands them to the tensor cores, as
    the values they read: big = x + 0x1000 read to 19 bits (x rounded to
    nearest, ties away), small = x - big read to 19 bits (truncated)."""
    big = tf32_read(_bits(x) + 0x1000)
    return big, tf32_read(_bits(x - big))


def product(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b on tf32 operands: 3xTF32 (big*big + big*small + small*big) or,
    with ``three`` false, the plain tf32 product big*big."""
    ab, asm = split(a)
    bb, bsm = split(b)
    if not three:
        return ab @ bb
    return asm @ bb + ab @ bsm + ab @ bb


# ---------------------------------------------------------------------------
# (a) the fragment layouts
# ---------------------------------------------------------------------------

def mma_m16n8k8(a_regs, b_regs) -> np.ndarray:
    """D = A B of one m16n8k8 mma from each lane's registers, by the PTX
    layouts: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    B b0 (k t, n g), b1 (k t + 4, n g); g = lane / 4, t = lane % 4."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_regs[lane]
        B[t, g], B[t + 4, g] = b_regs[lane]
    return A @ B


def c_frag(D: np.ndarray, lane: int):
    """A lane's 4 accumulators of a 16 x 8 C tile: (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1)."""
    g, t = lane // 4, lane % 4
    return D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
def test_fragment_layouts_compute_the_tile_products(hd):
    rs = np.random.RandomState(hd)
    Q, K, V = rs.randn(16, hd), rs.randn(64, hd), rs.randn(64, hd)
    # S = Q K^T, n8 tile j: q_frag_tf32's float2 reads of rows g and g + 8
    # at dims 8kk + 2t, 2t + 1, and K's float2 at row 8j + g
    S = np.zeros((16, 64))
    for j in range(8):
        for kk in range(hd // 8):
            a = [(Q[g, 8 * kk + 2 * t], Q[g + 8, 8 * kk + 2 * t],
                  Q[g, 8 * kk + 2 * t + 1], Q[g + 8, 8 * kk + 2 * t + 1])
                 for g, t in (divmod(lane, 4) for lane in range(32))]
            b = [(K[8 * j + g, 8 * kk + 2 * t], K[8 * j + g, 8 * kk + 2 * t + 1])
                 for g, t in (divmod(lane, 4) for lane in range(32))]
            S[:, 8 * j:8 * j + 8] += mma_m16n8k8(a, b)
    np.testing.assert_allclose(S, Q @ K.T, rtol=1e-12, atol=1e-12)
    # O = P V: P as the score accumulators s[j] of each lane, its A
    # fragment (s[j][0], s[j][2], s[j][1], s[j][3]); V's B fragment
    # V[8j + 2t][8d + g], V[8j + 2t + 1][8d + g]
    P = rs.rand(16, 64)
    O = np.zeros((16, hd))
    for d in range(hd // 8):
        for j in range(8):
            a, b = [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                c = c_frag(P[:, 8 * j:8 * j + 8], lane)
                a.append((c[0], c[2], c[1], c[3]))
                b.append((V[8 * j + 2 * t, 8 * d + g],
                          V[8 * j + 2 * t + 1, 8 * d + g]))
            O[:, 8 * d:8 * d + 8] += mma_m16n8k8(a, b)
    np.testing.assert_allclose(O, P @ V, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# (b), (c) the kernel's arithmetic
# ---------------------------------------------------------------------------

def emulate(q, k, v, cfg: FA.FlashConfig, three_qk: bool = True,
            three_pv: bool = True):
    """(out, lse) as ``fwd_tf32_kernel`` computes them from fp32 q, k, v:
    per 64-key tile (keys past Sk zero and masked) the scores by the tf32
    products, scaled by fp32(1/sqrt(hd)) * fp32(log2 e), masked to -1e30;
    the running max m (0 subtracted while a row has seen no key), P =
    2^(s - m), the correction 2^(m_old - m); P V over the keys of each
    8-wide step in the kernel's order; out = acc / max(l, 1e-30), lse =
    m ln 2 + log(l), or -1e30 where l = 0."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    Sk = k.shape[2]
    pad = -Sk % TILE
    kf, vf = (torch.nn.functional.pad(FA._expand_kv(x, G).float(),
                                      (0, 0, 0, pad)) for x in (k, v))
    keep = torch.nn.functional.pad(FA.keep_mask(cfg, Sq, Sk), (0, pad))
    neg = torch.tensor(FA.NEG_INF)
    scale2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    order = torch.tensor([8 * j + e for j in range(TILE // 8) for e in K8])
    m = torch.full((B, H, Sq), FA.NEG_INF)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, hd)
    for k0 in range(0, Sk + pad, TILE):
        ks = slice(k0, k0 + TILE)
        s = product(q.float(), kf[:, :, ks].transpose(-1, -2), three_qk)
        s = torch.where(keep[:, ks], s * scale2, neg)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == FA.NEG_INF, torch.zeros(()), m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        pv = product(p[..., order], vf[:, :, ks][:, :, order], three_pv)
        acc = acc * corr[..., None] + pv
        m = m_new
    lc = l.clamp(min=1e-30)
    lse = torch.where(l > 0, m * LN2 + torch.log(lc), neg)
    return acc / lc[..., None], lse


def _inputs(name, hd, seed, scale):
    kind, Sq, Sk, window, mseq = TC_BWD_CASES[name]
    rs = np.random.RandomState(seed)
    B, KV, G = 1, 2, 2
    mk = lambda H, S: torch.from_numpy(  # noqa: E731
        scale * rs.randn(B, H, S, hd).astype(np.float32))
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    return cfg, mk(KV * G, Sq), mk(KV, Sk), mk(KV, Sk)


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("name", sorted(TC_BWD_CASES))
def test_3xtf32_arithmetic_meets_the_card_bound(name, hd):
    cfg, q, k, v = _inputs(name, hd, seed=hd, scale=3.0)
    out, lse = emulate(q, k, v, cfg)
    want = FA.flash_attention_fwd_ref(q, k, v, cfg)
    SMOKE.compare(f"emulated fp32 tensor-core forward {name} hd {hd}",
                  (out, lse), want)
    if name == "two_pass, cut keys":
        assert (out[:, :, 0] == 0).all() and (lse[:, :, 0] <= -1e29).all()


@pytest.mark.parametrize("name", sorted(set(TC_BWD_CASES)
                                        - {"two_pass, cut keys"}))
def test_3xtf32_arithmetic_matches_pallas(name):
    """out and lse of the emulation against the Pallas kernel (interpret
    mode, 64-row tiles) on the same fp32 inputs: within 1e-4."""
    cfg, q, k, v = _inputs(name, 64, seed=3, scale=1.0)
    out, lse = emulate(q, k, v, cfg)
    jcfg = JFA.FlashConfig(mask_kind=cfg.mask_kind, window=cfg.window,
                           mask_seq=cfg.mask_seq, block_q=TILE,
                           block_k=TILE, interpret=True)
    jout, jlse = JFA._fwd_impl(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               jcfg)
    Sq = q.shape[2]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), 1e-4, 1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Sq],
                               1e-4, 1e-4)


def _vit_inputs(seed: int):
    """fp32 q, k, v at ViT's shape, reduced in batch: hd 32, 4 heads, S =
    66 (1 + 64 patches + 1 label token), so the second 64-row tile of Q and
    of K holds 2 rows; ``full`` mask."""
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(  # noqa: E731
        rs.randn(2, 4, 66, 32).astype(np.float32))
    return FA.FlashConfig("full"), mk(), mk(), mk()


def test_hd32_vit_sequence_matches_pallas():
    """The plain fp32 forward and the emulation of ``fwd_tf32_kernel<32>``
    against the Pallas kernel (interpret mode, 64-row tiles) at hd 32, S =
    66: within 1e-4; the emulation also under the card bound."""
    cfg, q, k, v = _vit_inputs(32)
    jcfg = JFA.FlashConfig(mask_kind="full", block_q=TILE, block_k=TILE,
                           interpret=True)
    jout, jlse = JFA._fwd_impl(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               jcfg)
    want = (np.asarray(jout), np.asarray(jlse)[..., :66])
    ref = FA.flash_attention_fwd_ref(q, k, v, cfg)
    emu = emulate(q, k, v, cfg)
    SMOKE.compare("emulated fp32 tensor-core forward, hd 32, S 66", emu, ref)
    for got in (ref, emu):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, 1e-4, 1e-4)


@pytest.mark.parametrize("plain", ["Q K^T", "P V"])
@pytest.mark.parametrize("name", sorted(set(TC_BWD_CASES)
                                        - {"two_pass, cut keys"}))
def test_1xtf32_breaks_the_card_bound(name, plain):
    cfg, q, k, v = _inputs(name, 64, seed=64, scale=3.0)
    out, lse = emulate(q, k, v, cfg, three_qk=plain != "Q K^T",
                       three_pv=plain != "P V")
    with pytest.raises(SMOKE.SmokeError, match="disagrees"):
        SMOKE.compare(f"1xTF32 in {plain}, {name}", (out, lse),
                      FA.flash_attention_fwd_ref(q, k, v, cfg))


# ---------------------------------------------------------------------------
# (d) the model's fp32 views
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Record, for every attention call, q, k, v and the out buffer of the
    forward, and dO and the dq, dk and dv buffers of the backward
    (``torch.empty_like``, as the card's wrappers allocate them)."""
    seen = []
    fwd, dq, dkv = (FA.flash_attention, FA.flash_attention_bwd_dq,
                    FA.flash_attention_bwd_dkv)

    def record(q, k, v, **kw):
        seen.append((kw["mask_kind"], {"q": q, "k": k, "v": v,
                                       "out": torch.empty_like(q)}))
        return fwd(q, k, v, **kw)

    def record_dq(q, k, v, do, lse, delta, cfg):
        seen.append((cfg.mask_kind, {"dO": do, "dq": torch.empty_like(q)}))
        return dq(q, k, v, do, lse, delta, cfg)

    def record_dkv(q, k, v, do, lse, delta, cfg):
        seen.append((cfg.mask_kind, {"dO": do, "dk": torch.empty_like(k),
                                     "dv": torch.empty_like(v)}))
        return dkv(q, k, v, do, lse, delta, cfg)

    monkeypatch.setattr(FA, "flash_attention", record)
    monkeypatch.setattr(FA, "flash_attention_bwd_dq", record_dq)
    monkeypatch.setattr(FA, "flash_attention_bwd_dkv", record_dkv)
    return seen


def _assert_16_byte_copies(seen, kinds):
    assert {kind for kind, _ in seen} == kinds
    assert {name for _, tensors in seen for name in tensors} == {
        "q", "k", "v", "out", "dO", "dq", "dk", "dv"}
    for kind, tensors in seen:
        for name, x in tensors.items():
            assert x.dtype == torch.float32 and x.shape[-1] == 64
            assert FA.tc_aligned(x.data_ptr(), x.stride(),
                                 x.element_size()), (kind, name, x.stride())


def test_dit_step_views_take_16_byte_copies(monkeypatch):
    seen = _record(monkeypatch)
    cfg = reduced(paper.DIT_S2, n_layers=3, d_model=128, n_heads=2)
    dit = DIT.DiTDiffusionBlocks(cfg, paper.DIT_DB, data_dim=16, n_tokens=8)
    gen = torch.Generator().manual_seed(0)
    params = dit.init(gen)
    y = torch.randn(2, 8, 16, generator=gen)
    init, step = DIT.make_db_step(dit, 0, TrainConfig(steps=2))
    step(params, init(params), y, sigma=torch.full((2, 1, 1), 0.5),
         eps=torch.randn(2, 8, 16, generator=gen))
    _assert_16_byte_copies(seen, {"full"})


def test_recurrent_views_take_16_byte_copies(monkeypatch):
    seen = _record(monkeypatch)
    cfg = reduced(paper.HUGINN, n_layers=2, d_model=128, n_heads=2, vocab=64)
    m = REC.RecurrentDepthModel(cfg, paper.HUGINN_DB, recurrence=2,
                                bptt_k=1)
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen)
    tokens = torch.randint(0, 64, (2, 12), generator=gen)
    tcfg = TrainConfig(steps=2)
    init, step = REC.make_step(m.db_loss, tcfg)
    step(params, init(params), tokens, sigma=torch.full((2, 1, 1), 0.5),
         eps=torch.randn(2, 12, 128, generator=gen))
    init, step = REC.make_step(m.baseline_loss, tcfg)
    step(params, init(params), tokens,
         s0=0.5 * torch.randn(2, 12, 128, generator=gen))
    _assert_16_byte_copies(seen, {"causal", "db_concat"})


# ---------------------------------------------------------------------------
# (e) the tuning script's variants
# ---------------------------------------------------------------------------

def test_tuning_variants_apply_to_the_committed_source(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "chip_smoke", SMOKE)
    spec = importlib.util.spec_from_file_location(
        "tune_attention_fwd", ROOT / "tune_attention_fwd.py")
    tune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tune)
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_fwd.cu"
           ).read_text()
    built = {name: tune.variant_source(src, *spec)
             for name, spec in tune.VARIANTS.items()}
    assert built.pop("chosen") == src
    assert len(set(built.values())) == len(built)
    assert all(text != src for text in built.values())
