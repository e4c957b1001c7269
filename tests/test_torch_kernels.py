"""PyTorch port: the kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; here it is held against the Pallas kernel it ports, run in
interpret mode on the same inputs (made with numpy). bf16 and int8 pages are
compared at the fp32 tolerance: both sides read identical stored values and
accumulate in fp32.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as JFD
from repro.kernels import flash_prefill as JFP
from repro.kernels import fused_adaln as JAD
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import flash_prefill as TFP
from repro_torch.kernels import fused_adaln as TAD

# small tensors: one torch thread is as fast, and the suite's xdist workers
# share the cores with JAX
torch.set_num_threads(1)
ATOL = RTOL = 1e-4


def _bf16_round(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def make_pool(rs, dtype, P, psz, KV, hd):
    """(jax k, jax v, torch k, torch v, scales) holding identical values."""
    if dtype == "int8":
        kq = rs.randint(-127, 128, size=(P, psz, KV, hd)).astype(np.int8)
        vq = rs.randint(-127, 128, size=(P, psz, KV, hd)).astype(np.int8)
        ks = (rs.rand(P) * 0.02 + 0.001).astype(np.float32)
        vs = (rs.rand(P) * 0.02 + 0.001).astype(np.float32)
        return (jnp.asarray(kq), jnp.asarray(vq), torch.from_numpy(kq),
                torch.from_numpy(vq), (ks, vs))
    k = rs.randn(P, psz, KV, hd).astype(np.float32)
    v = rs.randn(P, psz, KV, hd).astype(np.float32)
    if dtype == "bf16":
        k, v = _bf16_round(k), _bf16_round(v)
        return (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                None)
    return (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k),
            torch.from_numpy(v), None)


def _scales(scales, lib):
    if scales is None:
        return None, None
    if lib == "jax":
        return tuple(jnp.asarray(s) for s in scales)
    return tuple(torch.from_numpy(s) for s in scales)


B, KV, HD, PSZ, NPG = 3, 2, 16, 4, 4
P = 1 + B * NPG


def _table(rs):
    # shuffled physical pages (page 0 stays the trash page)
    return (1 + rs.permutation(B * NPG)).astype(np.int32).reshape(B, NPG)


SWEEP = [(G, w, dt) for G in (1, 2) for w in (None, 5)
         for dt in ("fp32", "bf16", "int8")]


@pytest.mark.parametrize("G,window,dtype", SWEEP)
def test_flash_decode_matches_pallas(G, window, dtype):
    rs = np.random.RandomState(10 + G)
    jk, jv, tk, tv, sc = make_pool(rs, dtype, P, PSZ, KV, HD)
    q = rs.randn(B, KV, G, HD).astype(np.float32)
    table = _table(rs)
    lengths = np.array([0, 7, 15], np.int32)   # empty, mid-page, multi-page
    jks, jvs = _scales(sc, "jax")
    out_j, lse_j = JFD.flash_decode(jnp.asarray(q), jk, jv,
                                    jnp.asarray(table), jnp.asarray(lengths),
                                    window=window, k_scale=jks, v_scale=jvs,
                                    interpret=True)
    tks, tvs = _scales(sc, "torch")
    out_t, lse_t = TFD.flash_decode(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(table),
                                  torch.from_numpy(lengths), window=window,
                                  k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), ATOL, RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), ATOL, RTOL)
    assert np.all(out_t.numpy()[0] == 0) and np.all(lse_t.numpy()[0] < -1e29)


@pytest.mark.parametrize("G,window,dtype", SWEEP)
def test_flash_prefill_matches_pallas(G, window, dtype):
    rs = np.random.RandomState(20 + G)
    C = 5
    jk, jv, tk, tv, sc = make_pool(rs, dtype, P, PSZ, KV, HD)
    q = rs.randn(B, C, KV, G, HD).astype(np.float32)
    table = _table(rs)
    lengths = np.array([0, 3, 9], np.int32)
    jks, jvs = _scales(sc, "jax")
    out_j = JFP.flash_prefill(jnp.asarray(q), jk, jv, jnp.asarray(table),
                              jnp.asarray(lengths), window=window,
                              k_scale=jks, v_scale=jvs, interpret=True)
    tks, tvs = _scales(sc, "torch")
    out_t = TFP.flash_prefill(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(table),
                            torch.from_numpy(lengths), window=window,
                            k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), ATOL, RTOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 6])
def test_gate_residual_matches_pallas(dtype, S):
    rs = np.random.RandomState(30 + S)
    d = 64
    res = rs.randn(2, S, d).astype(np.float32)
    br = rs.randn(2, S, d).astype(np.float32)
    g = (0.1 * rs.randn(2, d)).astype(np.float32)
    if dtype == "bf16":
        res, br = _bf16_round(res), _bf16_round(br)
        jres, jbr = jnp.asarray(res, jnp.bfloat16), jnp.asarray(br,
                                                                jnp.bfloat16)
        tres, tbr = torch.from_numpy(res).bfloat16(), \
            torch.from_numpy(br).bfloat16()
    else:
        jres, jbr = jnp.asarray(res), jnp.asarray(br)
        tres, tbr = torch.from_numpy(res), torch.from_numpy(br)
    out_j = JAD.fused_gate_residual(jres, jbr, jnp.asarray(g),
                                    interpret=True)
    out_t = TAD.gate_residual(tres, tbr, torch.from_numpy(g))
    assert out_t.dtype == tres.dtype
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               ATOL, RTOL)


def test_combine_self_matches_jax():
    rs = np.random.RandomState(40)
    out = rs.randn(3, 2, 2, 8).astype(np.float32)
    lse = rs.randn(3, 2, 2).astype(np.float32)
    lse[0] = -1e30                                  # empty cache: pure self
    s_self = rs.randn(3, 2, 2).astype(np.float32)
    v_self = rs.randn(3, 2, 8).astype(np.float32)
    ref = JFD.combine_self(*map(jnp.asarray, (out, lse, s_self, v_self)))
    got = TFD.combine_self(*map(torch.from_numpy, (out, lse, s_self, v_self)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), ATOL, RTOL)
    np.testing.assert_allclose(got.numpy()[0],
                               np.broadcast_to(v_self[0][:, None], (2, 2, 8)),
                               ATOL, RTOL)


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path or raises;
    it never reaches the plain version."""
    meta = dict(device="meta")
    q = torch.empty(2, 2, 1, 64, **meta)
    pages = torch.empty(5, 4, 2, 64, **meta)
    table = torch.empty(2, 2, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        TFD.flash_decode(q, pages, pages, table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        TFP.flash_prefill(q[:, None], pages, pages, table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.gate_residual(torch.empty(2, 1, 64, **meta),
                        torch.empty(2, 1, 64, **meta),
                        torch.empty(2, 64, **meta))
