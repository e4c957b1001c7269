"""PyTorch port: the 3xTF32 chunked-prefill kernel, on the CPU.

The kernel (``prefill_tf32_kernel`` in ``kernels/csrc/flash_prefill.cu``,
the ``"tf32"`` route of ``flash_prefill.prefill_route``: fp32 q or fp32
pages) runs only on the card. Here its arithmetic, emulated in torch: per
64-row tile of rows r = i * G + g over only the 64-key tiles its rows see,
keys gathered through a shuffled page table (zero outside the visible keys
and past the pool), S = Q K^T by 3xTF32 products (each operand split into
big + small as ``split_tf32`` does, on the int32 view; a bf16 or int8
operand is exact in tf32, its small term zero), scaled by the key's page K
scale and 1/sqrt(hd) in base 2, masked per row, an online softmax in base 2,
p times the key's page V scale, then O += P V by 3xTF32 in the kernel's key
order. Held against ``flash_prefill_ref`` under ``chip_smoke.compare``'s
fp32 bound (2e-4 + 2e-4 |ref|) for G in {1, 4}, hd in {64, 120, 128},
window None / 5, C in {17, 64}, fp32 and int8 pages under fp32 q (the fp32
and fp32_kvint8 policies), the route's two other pairs (fp32 q over bf16
pages, bf16 q over fp32 pages), with an empty slot and chunks that cross
pages; against the Pallas kernel (``repro.kernels.flash_prefill``,
interpret mode) at 1e-4; and with either product in plain tf32 (1xTF32)
past the bound: the reason every fp32 operand is split.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_prefill as JFP
from repro_torch.kernels import flash_prefill as FP
from test_torch_attention_tf32 import K8, product
from test_torch_paged_tc import LOG2E, NEG, PSZ, SMOKE, gather_raw, \
    make_inputs

torch.set_num_threads(1)
TILE = 64
# the kernel's key order within a 64-key tile for P V: k8 step j, k-index t
# is key 8j + 2t, t + 4 is 8j + 2t + 1
ORDER = torch.tensor([8 * j + e for j in range(TILE // 8) for e in K8])


def emulate_prefill_tf32(q, k, v, ks, vs, table, lengths, window,
                         three_qk: bool = True, three_pv: bool = True):
    B, C, KV, G, hd = q.shape
    rows = C * G
    n_keys = table.shape[1] * PSZ
    n_pad = -(-n_keys // TILE) * TILE + TILE
    scale2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    out = torch.zeros(B, KV, rows, hd)
    for b in range(B):
        n = int(lengths[b])
        kr, ksc = gather_raw(k, ks, table[b], n_pad)
        vr, vsc = gather_raw(v, vs, table[b], n_pad)
        for kv in range(KV):
            qr = q[b, :, kv].reshape(rows, hd).float()   # r = i * G + g
            for r0 in range(0, rows, TILE):
                rr = torch.arange(r0, min(r0 + TILE, rows))
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
                for k0 in range(kbeg // TILE * TILE, kend, TILE):
                    keys = torch.arange(k0, k0 + TILE)
                    live = ((keys >= kbeg) & (keys < kend)).float()
                    K = kr[keys, kv] * live[:, None]       # zero-filled
                    V = vr[keys, kv] * live[:, None]
                    s = product(qr[rr], K.T, three_qk)
                    s = s * (scale2 * (ksc[keys] * live))
                    keep = (keys[None] >= klo[:, None]) & (
                        keys[None] <= khi[:, None])
                    s = torch.where(keep, s, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.amax(-1))
                    m_use = torch.where(m_new == NEG, torch.zeros(()), m_new)
                    corr = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use[:, None])
                    l = l * corr + p.sum(-1)
                    pv = p * (vsc[keys] * live)
                    pvv = product(pv[:, ORDER], V[ORDER], three_pv)
                    acc = acc * corr[:, None] + pvv
                    m = m_new
                out[b, kv, rr] = acc / l.clamp(min=1e-30)[:, None]
    return out.reshape(B, KV, C, G, hd).permute(0, 2, 1, 3, 4)


def _inputs(G, hd, C, page, seed, q_dtype="fp32"):
    # slot 0 empty; slot 1's chunk starts mid-page and crosses pages; slot
    # 2's history spans several 64-key tiles
    return make_inputs(seed, B=3, C=C, KV=2, G=G, hd=hd, page=page,
                       lengths=[0, 13, 150], q_dtype=q_dtype)


def _check(q, k, v, ks, vs, table, lens, window, label):
    got = emulate_prefill_tf32(q, k, v, ks, vs, table, lens, window)
    want = FP.flash_prefill_ref(q, k, v, table, lens, window=window,
                                k_scale=ks, v_scale=vs)
    SMOKE.compare(label, got, want)


POLICY_CASES = [(G, hd, w, C, page) for G in (1, 4) for hd in (64, 120, 128)
                for w in (None, 5) for C in (17, 64)
                for page in ("fp32", "int8")]


@pytest.mark.parametrize("G,hd,window,C,page", POLICY_CASES)
def test_prefill_tf32_arithmetic_meets_the_card_bound(G, hd, window, C,
                                                      page):
    """fp32 q over fp32 pages (the fp32 policy) and over int8 pages
    (fp32_kvint8)."""
    q, k, v, ks, vs, table, lens = _inputs(G, hd, C, page, seed=G + hd + C)
    assert FP.prefill_route(q.dtype, k.dtype) == "tf32"
    _check(q, k, v, ks, vs, table, lens, window,
           f"emulated prefill_tf32 G={G} hd={hd} C={C} {page}")


@pytest.mark.parametrize("q_dtype,page", [("fp32", "bf16"),
                                          ("bf16", "fp32")])
@pytest.mark.parametrize("hd,window", [(64, None), (120, 5)])
def test_prefill_tf32_other_pairs_meet_the_card_bound(q_dtype, page, hd,
                                                      window):
    """The route's pairs no policy produces: fp32 q over bf16 pages, bf16 q
    over fp32 pages (the bf16 operand exact, its product dropped)."""
    q, k, v, ks, vs, table, lens = _inputs(4, hd, 17, page, seed=hd,
                                           q_dtype=q_dtype)
    assert FP.prefill_route(q.dtype, k.dtype) == "tf32"
    _check(q, k, v, ks, vs, table, lens, window,
           f"emulated prefill_tf32 {q_dtype} q over {page} pages")


def test_rows_past_the_pool_see_the_pool_only():
    """Empty slots whose chunk (20 tokens) is longer than the one page the
    table gives each: rows past the pool's 16 keys see those 16, and stay
    finite."""
    q, k, v, ks, vs, table, lens = make_inputs(
        4, B=2, C=20, KV=1, G=1, hd=64, page="fp32", lengths=[0, 0],
        q_dtype="fp32")
    table = table[:, :1].contiguous()
    got = emulate_prefill_tf32(q, k, v, ks, vs, table, lens, None)
    want = FP.flash_prefill_ref(q, k, v, table, lens)
    assert torch.isfinite(got).all()
    SMOKE.compare("empty slots", got, want)


@pytest.mark.parametrize("G,page,window", [(1, "fp32", None),
                                           (4, "int8", 5), (4, "fp32", 5)])
def test_prefill_tf32_arithmetic_matches_pallas(G, page, window):
    """fp32 output of the emulation against the Pallas kernel (interpret
    mode) on the same stored values."""
    q, k, v, ks, vs, table, lens = _inputs(G, 64, 17, page, seed=5)
    got = emulate_prefill_tf32(q, k, v, ks, vs, table, lens, window)
    jp = {torch.float32: jnp.float32, torch.int8: jnp.int8}[k.dtype]
    jk = jnp.asarray(k.float().numpy()).astype(jp)
    jv = jnp.asarray(v.float().numpy()).astype(jp)
    sc = ({} if ks is None else
          dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(
              vs.numpy())))
    want = JFP.flash_prefill(jnp.asarray(q.numpy()), jk, jv,
                             jnp.asarray(table.numpy()),
                             jnp.asarray(lens.numpy()), window=window,
                             interpret=True, **sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-4, 1e-4)


@pytest.mark.parametrize("plain", ["Q K^T", "P V"])
@pytest.mark.parametrize("G", [1, 4])
def test_1xtf32_breaks_the_card_bound(G, plain):
    q, k, v, ks, vs, table, lens = _inputs(G, 64, 64, "fp32", seed=9)
    got = emulate_prefill_tf32(q, k, v, ks, vs, table, lens, None,
                               three_qk=plain != "Q K^T",
                               three_pv=plain != "P V")
    want = FP.flash_prefill_ref(q, k, v, table, lens)
    with pytest.raises(SMOKE.SmokeError, match="disagrees"):
        SMOKE.compare(f"1xTF32 in {plain}", got, want)
