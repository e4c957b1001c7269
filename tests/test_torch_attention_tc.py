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
    every mask kind: the reason the kernel splits P;
(d) shared memory at each bf16 head dim (hd 120 in hd 128's tiles, its 16th
    chunk a zero pad): every ``ldmatrix`` of the three bf16 kernels reads
    its swizzled tile free of bank conflicts, and one tile fill writes each
    chunk once, zero-filling the pad and the rows past the sequence end.
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

@pytest.mark.parametrize("mode,arch", [
    pytest.param("concat", "stablelm-1.6b", id="concat"),
    pytest.param("two_pass", "olmo-1b", id="two_pass"),
    pytest.param("concat", "h2o-danube-3-4b", id="h2o-concat"),
    pytest.param("two_pass", "h2o-danube-3-4b", id="h2o-two_pass")])
def test_model_views_are_tc_aligned(monkeypatch, mode, arch):
    """Every q, k, v a bf16 DB step hands the attention kernels (the
    reshaped projections as transposed views, the two-pass noisy stream's
    ``torch.cat`` keys) is one the tensor-core forward takes; so is every
    dO the step's backward hands the attention backward, as it arrives
    (before any copy), and the dq, dk, dv buffers the backward wrappers
    allocate (``torch.empty_like`` of q, k, v). h2o-danube3-4b at hd 120
    (4 query heads on 1 KV head, window 64): rows of 240 bytes, 15 of the
    kernels' 16-byte chunks."""
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
    h2o = arch == "h2o-danube-3-4b"
    cfg = reduced(get_config(arch), n_layers=2, d_model=480 if h2o else 128,
                  n_heads=4 if h2o else 2)
    hd = cfg.head_dim
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
    clean = "window" if h2o else "causal"
    assert kinds == ({clean, "two_pass"} if mode == "two_pass"
                     else {"db_concat"})
    assert hd == (120 if h2o else 64)
    # the two-pass step's last clean call reaches no loss: no backward
    assert len(seen_bwd) == len(seen) - (mode == "two_pass")
    for kind, *tensors in seen:
        for name, x in zip("qkv", tensors):
            assert x.dtype == torch.bfloat16 and x.shape[-1] == hd
            assert FA.tc_aligned(x.data_ptr(), x.stride(),
                                 x.element_size()), (kind, name, x.stride())
    for kind, *tensors in seen_bwd:
        for name, x in zip(("do", "dq", "dk", "dv"), tensors):
            assert x.dtype == torch.bfloat16 and x.shape[-1] == hd
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


# ---------------------------------------------------------------------------
# (d) shared memory: the tiles' fills and ldmatrix reads
# ---------------------------------------------------------------------------

def _swizzle(chunks: int, row: int, chunk: int) -> int:
    """Byte offset of 16-byte chunk ``chunk`` of tile row ``row``, as
    ``rtmma::swizzle<CHUNKS>`` (``csrc/mma.cuh``) places it."""
    return (row * chunks + (chunk ^ (row & 7))) * 16


def _plain(chunks: int, row: int, chunk: int) -> int:
    return (row * chunks + chunk) * 16


def _ldmatrix_reads(kernel: str, ht: int):
    """Every ``ldmatrix`` (x4, plain or .trans) of one warp in the three
    bf16 kernels' loops, as (tile row, 16-byte chunk) for each of the 32
    lanes: A fragments (rows r0 + lane % 16, chunk c0 + lane / 16), B
    fragments (rows r0 + lane % 8 + 8 (lane / 16), chunk c0 + (lane / 8) %
    2), and the transposed reads of V, dO, Q and K (as A). ``ht``: the tile
    row in elements (``FA.tile_dim``)."""
    a = lambda r0, c0: [(r0 + (ln & 15), c0 + ln // 16)  # noqa: E731
                        for ln in range(32)]
    b = lambda r0, c0: [(r0 + (ln & 7) + 8 * (ln // 16),  # noqa: E731
                         c0 + (ln // 8) % 2) for ln in range(32)]
    ks, nd = ht // 16, ht // 8
    reads = []
    for w in range(4):
        for kk in range(ks):
            if kernel == "fwd":
                reads.append(a(16 * w, 2 * kk))                      # Q
                reads += [b(16 * np_, 2 * kk) for np_ in range(4)]  # K
            else:                 # two_products over both 32-row passes
                reads += [a(16 * w, 2 * kk)] * 2                 # A1, A2
                reads += [b(p0 + 16 * np_, 2 * kk) for p0 in (0, 32)
                          for np_ in range(2)] * 2               # B1, B2
        steps = [(0, kk) for kk in range(4)] if kernel == "fwd" else \
            [(p0, kk) for p0 in (0, 32) for kk in range(2)]
        for p0, kk in steps:      # V (fwd), dO and Q (dk/dv), K (dq)
            reads += [a(p0 + 16 * kk, 2 * dp)
                      for dp in range(nd // 2)] * (2 if kernel == "dkv"
                                                    else 1)
    return reads


def _ldmatrix_wavefronts(lanes, place, chunks: int) -> int:
    """Shared-memory wavefronts of one x4 ldmatrix: each 8-lane phase reads
    eight 16-byte rows, in as many passes as the most distinct chunks any
    one 16-byte bank group (4 banks) holds."""
    n = 0
    for phase in range(4):
        groups = {}
        for row, chunk in lanes[8 * phase:8 * phase + 8]:
            byte = place(chunks, row, chunk)
            groups.setdefault(byte // 16 % 8, set()).add(byte)
        n += max(len(v) for v in groups.values())
    return n


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_ldmatrix_reads_are_free_of_bank_conflicts(kernel, hd):
    """Every ldmatrix of ``fwd_tc_kernel``, ``dq_tc_kernel`` and
    ``dkv_tc_kernel`` reads its four 8 x 16-byte matrices in one wavefront
    each from the swizzled tiles, at hd 120 in hd 128's 16-chunk rows too
    (the 16th chunk, the zero pad, included: the k16 steps reach it); an
    unswizzled tile would take eight a matrix (rows of 128 or 256 bytes
    put a phase's eight rows on one bank group)."""
    ht = FA.tile_dim(hd)
    chunks = ht // 8
    reads = _ldmatrix_reads(kernel, ht)
    assert max(c for lanes in reads for _, c in lanes) == chunks - 1
    assert all(_ldmatrix_wavefronts(r, _swizzle, chunks) == 4
               for r in reads)
    assert max(_ldmatrix_wavefronts(r, _plain, chunks) for r in reads) == 32


@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
def test_tile_fill_covers_every_chunk_and_zeroes_the_pad(hd):
    """``load_tile_async<HD>`` (bf16, ``csrc/flash_attention.cuh``): the
    128 threads' copies of one fill land on every 16-byte chunk of the
    64-row tile exactly once, and the chunks past the head dim (the 16th at
    hd 120) are zero-fill copies on every fill, as are the rows past the
    sequence end; nothing is left as a previous fill wrote it."""
    ht = FA.tile_dim(hd)
    chunks = ht // 8
    rows_valid = 40                       # a ragged tile: rows 40-63 past n
    seen = {}
    for i in range(TILE * chunks // 128):
        for thread in range(128):
            e = thread + 128 * i
            r, c = divmod(e, chunks)
            ok = r < rows_valid and 8 * c < hd
            seen.setdefault(_swizzle(chunks, r, c), []).append(ok)
    assert sorted(seen) == [16 * j for j in range(TILE * chunks)]
    assert all(len(v) == 1 for v in seen.values())
    zero = sum(not v[0] for v in seen.values())
    assert zero == (TILE - rows_valid) * chunks + rows_valid * (
        chunks - hd // 8)
