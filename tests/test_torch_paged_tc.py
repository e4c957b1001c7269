"""PyTorch port: the paged decode and chunked-prefill kernels, on the CPU.

The kernels (``paged_decode_kernel`` in ``kernels/csrc/flash_decode.cu``,
``prefill_tc_kernel`` in ``kernels/csrc/flash_prefill.cu``) run only on the
card. Here:

(a) the plain functions around them: ``prefill_route`` (dtypes -> kernel:
    ``"tc"``, or ``"tf32"`` for ``prefill_tf32_kernel``, whose arithmetic
    ``tests/test_torch_prefill_tf32.py`` emulates),
    and the dtypes the serving path hands ``flash_prefill`` under each
    policy; decode's launch sizing (``decode_splits``, ``max_tiles``) and
    the warps a block ``decode_launch`` picks from its shared memory;
(b) decode's shared-memory reads: the scores read one 16- or 8-byte copy
    of 32 consecutive staged K rows, which at the chosen pitch (an odd
    number of copies a row) takes the fewest wavefronts a request can,
    and at the unpadded pitch does not where a row is an even number of
    copies; the P.V reads of one V row take one wavefront a phase;
(c) prefill_tc_kernel's arithmetic, emulated in torch: bf16 q and K/V
    (int8 converted exactly), fp32 scores times the key's page K scale and
    1/sqrt(hd) in base 2, an online softmax over 64-key tiles gathered
    through a shuffled page table, per 64-row tile over only the tiles its
    rows see, p times the key's page V scale, then P split into bf16
    hi + lo. Held against ``flash_prefill_ref`` under ``chip_smoke.compare``'s
    fp32 bound (2e-4 + 2e-4 |ref|) for G in {1, 4}, hd in {64, 120} (and
    112 at G 1, C 64), window None / 5, C in {17, 64}, bf16 and int8
    pages, with an empty slot and
    chunks that cross pages; its output against the Pallas kernel
    (``repro.kernels.flash_prefill``, interpret mode) at 1e-4; and with
    bf16 P alone (no lo term) past the bound: the reason P is split;
(d) decode's split of a slot's 32-key tiles across blocks and warps, each
    with its own online softmax, merged in fp32 as the kernels merge them,
    against ``flash_decode_ref`` under the same bound, the empty slot
    (out = 0, lse ~ -1e30) and a window included;
(e) ``tune_paged_decode.py``'s build variants still apply to the committed
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

from repro.kernels import flash_prefill as JFP
from repro_torch.configs import DBConfig, get_config, reduced
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import flash_prefill as FP
from repro_torch.launch import serve as S
from repro_torch.nn import cache as KVC

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

LOG2E = 1.4426950408889634
NEG = -1e30
PSZ = 16
PREFILL_TILE = 64
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "fp32": torch.float32}


# ---------------------------------------------------------------------------
# (a) routes and launch sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype,page_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "tc"),
    (torch.bfloat16, torch.int8, "tc"),
    (torch.bfloat16, torch.float32, "tf32"),
    (torch.float32, torch.bfloat16, "tf32"),
    (torch.float32, torch.int8, "tf32"),
    (torch.float32, torch.float32, "tf32"),
])
def test_prefill_route_is_a_function_of_the_dtypes(q_dtype, page_dtype,
                                                   route):
    assert FP.prefill_route(q_dtype, page_dtype) == route


@pytest.mark.parametrize("precision,route", [
    ("bf16", "tc"), ("bf16_kvint8", "tc"), ("fp32", "tf32"),
    ("fp32_kvint8", "tf32")])
def test_serving_prefill_takes_its_policys_route(monkeypatch, precision,
                                                 route):
    """The chunked prefill of ``generate`` hands ``flash_prefill`` q and
    pages whose dtypes route every bf16 policy (the serving default among
    them) to the bf16 tensor-core kernel and the fp32 ones to the 3xTF32
    kernel."""
    seen = []
    orig = KVC.flash_prefill

    def record(q, k_pages, *args, **kw):
        seen.append(FP.prefill_route(q.dtype, k_pages.dtype))
        return orig(q, k_pages, *args, **kw)

    monkeypatch.setattr(KVC, "flash_prefill", record)
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2, d_model=64,
                  n_heads=2)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2))
    gen = torch.Generator().manual_seed(0)
    params = dbm.init(gen)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 9))
    S.generate(dbm, params, prompts, 1, precision=precision, chunk_size=4,
               generator=gen)
    assert seen and set(seen) == {route}


STAGES = 2                  # kStages of csrc/flash_decode.cu
SMEM_MAX = 232448           # kMaxSmem of csrc/paged_attention.cuh


def decode_pitch(hd: int, elt: int):
    """(bytes a copy, copies a row, row pitch in copies) of the staged K/V
    rows, as ``DecodeTile`` in csrc/flash_decode.cu lays them out: 16-byte
    copies where the row is a multiple of 16 bytes, else 8; the pitch an
    odd number of copies."""
    row = hd * elt
    cb = 16 if row % 16 == 0 else 8
    ch = row // cb
    return cb, ch, ch | 1


def decode_smem(hd: int, elt: int, warps: int, R: int = 8) -> int:
    """``decode_smem``: each warp's ring (STAGES x K and V tiles and the 32
    keys' two page scales), its R query rows and its m, l."""
    cb, _, pch = decode_pitch(hd, elt)
    stage = 2 * FD.TILE_KEYS * pch * cb + 2 * FD.TILE_KEYS * 4
    return warps * (STAGES * stage + (R * hd + 2 * R) * 4)


def test_decode_pitch_is_an_odd_number_of_copies():
    for hd in FD.SUPPORTED_HD:
        for elt in (4, 2, 1):
            cb, ch, pch = decode_pitch(hd, elt)
            assert cb * ch == hd * elt and pch % 2 == 1 and pch - ch <= 1
            assert cb == (16 if hd * elt % 16 == 0 else 8)
    assert decode_pitch(120, 1) == (8, 15, 15)     # int8 rows: 120 bytes
    assert decode_pitch(112, 1) == (16, 7, 7)      # int8 rows: 7 x 16 bytes


@pytest.mark.parametrize("hd,elt,warps", [
    (64, 2, 4), (120, 2, 4), (128, 2, 4), (64, 1, 4), (120, 1, 4),
    (64, 4, 4), (120, 4, 2), (128, 4, 2), (112, 2, 4), (112, 1, 4),
    (112, 4, 2)])
def test_decode_warps_keep_the_block_in_shared_memory(hd, elt, warps):
    """decode_launch takes 4 warps where their shared memory fits an SM at
    the largest group (R = 8), else 2, which always fit."""
    picked = 4 if decode_smem(hd, elt, 4) <= SMEM_MAX else 2
    assert picked == warps
    assert decode_smem(hd, elt, picked) <= SMEM_MAX


def test_decode_splits():
    sms = 132
    # stablelm (B=8, KV=32): the pairs fill the SMs, one block a pair
    assert FD.decode_splits(256, FD.max_tiles(544, None), sms) == 1
    # h2o-danube3 (B=8, KV=8) under a 64-key window: 3 tiles at most
    assert FD.max_tiles(544, 64) == 3
    assert FD.decode_splits(64, FD.max_tiles(544, 64), sms) == 1
    # fewer pairs than SMs over 544 keys (olmo-1b KV=16; KV=8 G=4 models):
    # 17 tiles, too few to split
    assert FD.decode_splits(128, FD.max_tiles(544, None), sms) == 1
    assert FD.decode_splits(64, FD.max_tiles(544, None), sms) == 1
    # over 4352 keys (136 tiles): about two blocks an SM
    assert FD.decode_splits(128, FD.max_tiles(4352, None), sms) == 3
    assert FD.decode_splits(64, FD.max_tiles(4352, None), sms) == 5
    # few pairs over long histories: a block every BLOCK_TILES tiles
    assert FD.decode_splits(8, FD.max_tiles(4096, None), sms) == 8
    assert FD.decode_splits(12, FD.max_tiles(1280, None), sms) == 2
    assert FD.decode_splits(1, FD.max_tiles(1 << 16, None), sms) \
        == FD.MAX_SPLIT
    for pairs in (1, 7, 64, 131):
        for keys in (1, 40, 300, 5000):
            tiles = FD.max_tiles(keys, None)
            n = FD.decode_splits(pairs, tiles, sms)
            assert 1 <= n <= FD.MAX_SPLIT
            assert n == 1 or n * FD.BLOCK_TILES <= tiles


# ---------------------------------------------------------------------------
# (b) decode's shared-memory banks
# ---------------------------------------------------------------------------

def wavefronts(addrs, width: int) -> int:
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane
    at byte addresses ``addrs``: the warp is served in phases of 128 bytes'
    worth of lanes (8 lanes of 16 bytes, 16 of 8, all 32 below), each in
    as many passes as the most distinct 4-byte words one bank holds."""
    per_phase = 128 // width if width > 4 else 32
    n = 0
    for p0 in range(0, len(addrs), per_phase):
        banks = {}
        for a in addrs[p0:p0 + per_phase]:
            for w in range(a // 4, (a + width - 1) // 4 + 1):
                banks.setdefault(w % 32, set()).add(w)
        n += max(len(v) for v in banks.values())
    return n


def score_reads(hd, elt, pitch_copies):
    """Every score read of a tile: lane j reads copy c of staged K row j."""
    cb, ch, _ = decode_pitch(hd, elt)
    return [([j * pitch_copies * cb + c * cb for j in range(32)], cb)
            for c in range(ch)]


@pytest.mark.parametrize("elt", [4, 2, 1])
@pytest.mark.parametrize("hd", FD.SUPPORTED_HD)
def test_decode_score_reads_are_free_of_bank_conflicts(hd, elt):
    cb, ch, pch = decode_pitch(hd, elt)
    least = 32 * cb // 128                  # phases a request needs
    assert all(wavefronts(a, w) == least
               for a, w in score_reads(hd, elt, pch))
    if ch % 2 == 0:  # unpadded, 128 / cb lanes of a phase share a bank group
        worst = max(wavefronts(a, w) for a, w in score_reads(hd, elt, ch))
        assert worst > least


@pytest.mark.parametrize("elt", [4, 2, 1])
@pytest.mark.parametrize("hd", FD.SUPPORTED_HD)
def test_decode_value_reads_are_free_of_bank_conflicts(hd, elt):
    cb, _, pch = decode_pitch(hd, elt)
    for j in (0, 1, 31):                    # lanes on dims 64i + 2 lane
        for i in range(-(-hd // 64)):
            lanes = [j * pch * cb + (64 * i + 2 * lane) * elt
                     for lane in range(32) if 64 * i + 2 * lane < hd]
            assert wavefronts(lanes, 2 * elt) == max(1, 64 * elt // 128)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_inputs(seed, *, B, C, KV, G, hd, page, lengths, q_dtype="bf16"):
    """q, pages (K, V), scales or None, a shuffled page table (page 0 the
    trash page) and lengths, from numpy; one slot has lengths 0."""
    rs = np.random.RandomState(seed)
    n_keys = max(lengths) + C
    npg = -(-n_keys // PSZ) + 1
    P = 1 + B * npg
    shape = (P, PSZ, KV, hd)
    if page == "int8":
        k = torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy((rs.rand(P) * 0.02 + 1e-3).astype(np.float32))
        vs = torch.from_numpy((rs.rand(P) * 0.02 + 1e-3).astype(np.float32))
    else:
        k = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            DTYPES[page])
        v = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            DTYPES[page])
        ks = vs = None
    qshape = (B, C, KV, G, hd) if C else (B, KV, G, hd)
    q = torch.from_numpy(rs.randn(*qshape).astype(np.float32)).to(
        DTYPES[q_dtype])
    table = torch.from_numpy(
        (1 + rs.permutation(B * npg)).astype(np.int32).reshape(B, npg))
    return q, k, v, ks, vs, table, torch.tensor(lengths, dtype=torch.int32)


def gather_raw(pages, scale, table_b, n_pad):
    """A slot's logical rows (n_pad, KV, hd) as stored (fp32 values of bf16
    or int8, no scale), zero past the pool, and each key's page scale."""
    P, psz, KV, hd = pages.shape
    rows = pages[table_b.long()].float().reshape(-1, KV, hd)
    sc = (scale[table_b.long()].repeat_interleave(psz) if scale is not None
          else torch.ones(rows.shape[0]))
    pad = n_pad - rows.shape[0]
    return (torch.cat([rows, torch.zeros(pad, KV, hd)]),
            torch.cat([sc, torch.zeros(pad)]))


# ---------------------------------------------------------------------------
# (c) prefill_tc_kernel's arithmetic
# ---------------------------------------------------------------------------

def emulate_prefill(q, k, v, ks, vs, table, lengths, window,
                    split: bool = True):
    B, C, KV, G, hd = q.shape
    rows = C * G
    n_keys = table.shape[1] * PSZ
    n_pad = -(-n_keys // PREFILL_TILE) * PREFILL_TILE + PREFILL_TILE
    scale2 = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(B, KV, rows, hd)
    for b in range(B):
        n = int(lengths[b])
        kr, ksc = gather_raw(k, ks, table[b], n_pad)
        vr, vsc = gather_raw(v, vs, table[b], n_pad)
        for kv in range(KV):
            qr = q[b, :, kv].reshape(rows, hd).float()   # r = i * G + g
            for r0 in range(0, rows, PREFILL_TILE):
                rr = torch.arange(r0, min(r0 + PREFILL_TILE, rows))
                pos = n + rr // G
                q_first, q_last = int(pos[0]), int(pos[-1])
                kend = min(q_last + 1, n_keys)
                kbeg = max(0, q_first - window + 1) if window else 0
                khi = torch.clamp(pos, max=n_keys - 1)
                klo = (torch.clamp(pos - window + 1, min=0) if window
                       else torch.zeros_like(pos))
                m = torch.full((len(rr),), NEG)
                l = torch.zeros(len(rr))
                acc = torch.zeros(len(rr), hd)
                for k0 in range(kbeg // PREFILL_TILE * PREFILL_TILE, kend,
                                PREFILL_TILE):
                    keys = torch.arange(k0, k0 + PREFILL_TILE)
                    live = ((keys >= kbeg) & (keys < kend)).float()
                    K = kr[keys, kv] * live[:, None]       # zero-filled
                    V = vr[keys, kv] * live[:, None]
                    s = (qr[rr] @ K.T) * (scale2 * (ksc[keys] * live))
                    keep = (keys[None] >= klo[:, None]) & (
                        keys[None] <= khi[:, None])
                    s = torch.where(keep, s, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.amax(-1))
                    m_use = torch.where(m_new == NEG, torch.zeros(()), m_new)
                    corr = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use[:, None])
                    l = l * corr + p.sum(-1)
                    pv = p * (vsc[keys] * live)
                    hi = pv.bfloat16().float()
                    pvv = hi @ V
                    if split:
                        pvv = pvv + (pv - hi).bfloat16().float() @ V
                    acc = acc * corr[:, None] + pvv
                    m = m_new
                out[b, kv, rr] = acc / l.clamp(min=1e-30)[:, None]
    return out.reshape(B, KV, C, G, hd).permute(0, 2, 1, 3, 4)


PREFILL_CASES = [(G, hd, w, C, page) for G in (1, 4) for hd in (64, 120)
                 for w in (None, 5) for C in (17, 64)
                 for page in ("bf16", "int8")] + [
    # zamba2's head dim: rows padded to 128 dims in shared memory
    (1, 112, w, 64, page) for w in (None, 5) for page in ("bf16", "int8")]


def _prefill_inputs(G, hd, C, page, seed):
    # slot 0 empty; slot 1's chunk starts mid-page and crosses pages; slot
    # 2's history spans several 64-key tiles
    return make_inputs(seed, B=3, C=C, KV=2, G=G, hd=hd, page=page,
                       lengths=[0, 13, 150])


@pytest.mark.parametrize("G,hd,window,C,page", PREFILL_CASES)
def test_prefill_tc_arithmetic_meets_the_card_bound(G, hd, window, C, page):
    q, k, v, ks, vs, table, lens = _prefill_inputs(G, hd, C, page,
                                                   seed=G + hd + C)
    got = emulate_prefill(q, k, v, ks, vs, table, lens, window)
    want = FP.flash_prefill_ref(q, k, v, table, lens, window=window,
                                k_scale=ks, v_scale=vs)
    SMOKE.compare(f"emulated prefill_tc G={G} hd={hd} C={C} {page}", got,
                  want)


@pytest.mark.parametrize("G,page,window", [(1, "bf16", None),
                                           (4, "int8", 5), (4, "bf16", 5)])
def test_prefill_tc_arithmetic_matches_pallas(G, page, window):
    """fp32 output of the emulation against the Pallas kernel (interpret
    mode) on the same stored values: q's bf16 values in fp32."""
    q, k, v, ks, vs, table, lens = _prefill_inputs(G, 64, 17, page, seed=5)
    got = emulate_prefill(q, k, v, ks, vs, table, lens, window)
    jp = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[k.dtype]
    jk = jnp.asarray(k.float().numpy()).astype(jp)
    jv = jnp.asarray(v.float().numpy()).astype(jp)
    sc = ({} if ks is None else
          dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(
              vs.numpy())))
    want = JFP.flash_prefill(jnp.asarray(q.float().numpy()), jk, jv,
                             jnp.asarray(table.numpy()),
                             jnp.asarray(lens.numpy()), window=window,
                             interpret=True, **sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-4, 1e-4)


@pytest.mark.parametrize("G,page", [(1, "bf16"), (4, "int8")])
def test_bf16_p_alone_breaks_the_card_bound(G, page):
    q, k, v, ks, vs, table, lens = _prefill_inputs(G, 64, 64, page, seed=9)
    got = emulate_prefill(q, k, v, ks, vs, table, lens, None, split=False)
    want = FP.flash_prefill_ref(q, k, v, table, lens, k_scale=ks,
                                v_scale=vs)
    with pytest.raises(SMOKE.SmokeError, match="disagrees"):
        SMOKE.compare("bf16 P alone", got, want)


# ---------------------------------------------------------------------------
# (d) decode's split across blocks and warps
# ---------------------------------------------------------------------------

def _online(q, K, V, ksc, scale, vsc, valid, state):
    """One 32-key tile of a warp's online softmax, as the kernel: scores
    (q . k) * ksc * scale, natural exp, p times the V scale into acc."""
    m, l, acc = state
    s = (q @ K.T) * ksc[None] * scale
    s = torch.where(valid[None], s, torch.tensor(NEG))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(valid[None], torch.exp(s - m_new[:, None]),
                    torch.zeros(()))
    corr = torch.exp(m - m_new)
    return (m_new, l * corr + p.sum(-1),
            acc * corr[:, None] + (p * vsc[None]) @ V)


def _merge(states):
    M = torch.stack([s[0] for s in states]).amax(0)
    c = [torch.exp(s[0] - M) for s in states]
    L = sum(s[1] * ci for s, ci in zip(states, c))
    O = sum(s[2] * ci[:, None] for s, ci in zip(states, c))
    return M, L, O


def emulate_decode(q, k, v, ks, vs, table, lengths, window, nsplit,
                   nwarps=4):
    B, KV, G, hd = q.shape
    T = FD.TILE_KEYS
    n_keys = table.shape[1] * PSZ
    n_pad = -(-n_keys // T) * T + T
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(B, KV, G, hd)
    lse = torch.zeros(B, KV, G)
    for b in range(B):
        n = int(lengths[b])
        kend = min(n, n_keys)
        kbeg = max(0, n - window + 1) if window else 0
        tb = kbeg // T
        nt = (kend - 1) // T + 1 - tb if kend > kbeg else 0
        per = -(-nt // nsplit)
        kr, ksc = gather_raw(k, ks, table[b], n_pad)
        vr, vsc = gather_raw(v, vs, table[b], n_pad)
        for kv in range(KV):
            qf = q[b, kv].float()
            splits = []
            for z in range(nsplit):
                t_hi = tb + min(nt, (z + 1) * per)
                warps = []
                for w in range(nwarps):
                    st = (torch.full((G,), NEG), torch.zeros(G),
                          torch.zeros(G, hd))
                    for ti in range(tb + z * per + w, t_hi, nwarps):
                        keys = torch.arange(ti * T, ti * T + T)
                        valid = (keys >= kbeg) & (keys < kend)
                        live = valid.float()[:, None]
                        st = _online(qf, kr[keys, kv] * live,
                                     vr[keys, kv] * live, ksc[keys], scale,
                                     vsc[keys], valid, st)
                    warps.append(st)
                splits.append(_merge(warps))
            M, L, O = _merge(splits) if nsplit > 1 else splits[0]
            Lc = L.clamp(min=1e-30)
            out[b, kv] = O / Lc[:, None]
            lse[b, kv] = M + torch.log(Lc)
    return out, lse


DECODE_CASES = [(G, w, page, ns) for G in (1, 4) for w in (None, 5)
                for page in ("fp32", "bf16", "int8") for ns in (1, 3)]


@pytest.mark.parametrize("G,window,page,nsplit", DECODE_CASES)
def test_decode_split_and_merge_meets_the_card_bound(G, window, page,
                                                     nsplit):
    q, k, v, ks, vs, table, lens = make_inputs(
        G + 11 * nsplit, B=3, C=0, KV=2, G=G, hd=64, page=page,
        lengths=[0, 37, 300], q_dtype="fp32")
    out, lse = emulate_decode(q, k, v, ks, vs, table, lens, window, nsplit)
    ro, rl = FD.flash_decode_ref(q, k, v, table, lens, window=window,
                                 k_scale=ks, v_scale=vs)
    SMOKE.compare(f"emulated decode split {nsplit}", (out, lse), (ro, rl))
    assert (out[0] == 0).all() and (lse[0] < -1e29).all()


# ---------------------------------------------------------------------------
# (e) the tuning script's variants
# ---------------------------------------------------------------------------

def test_tuning_variants_apply_to_the_committed_source():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "chip_smoke", SMOKE)
        spec = importlib.util.spec_from_file_location(
            "tune_paged_decode", ROOT / "tune_paged_decode.py")
        tune = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tune)
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_decode.cu").read_text()
    built = {name: tune.variant_source(src, stages)
             for name, stages in tune.VARIANTS.items()}
    assert built.pop("chosen") == src
    assert all(text != src for text in built.values())
    assert STAGES == tune.VARIANTS["chosen"]
