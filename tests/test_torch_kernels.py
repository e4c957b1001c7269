"""PyTorch port: the kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; here it is held against the Pallas kernel it ports, run in
interpret mode on the same inputs (made with numpy). bf16 and int8 pages are
compared at the fp32 tolerance: both sides read identical stored values and
accumulate in fp32.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import flash_decode as JFD
from repro.kernels import flash_prefill as JFP
from repro.kernels import fused_adaln as JAD
from repro.kernels import ref as JREF
from repro_torch.core import edm as TEDMC
from repro_torch.kernels import edm_loss as TEDM
from repro_torch.kernels import flash_attention as TFA
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
    rows, vec = torch.empty(2, 3, 64, **meta), torch.empty(2, 64, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.gate_residual(rows, rows, vec)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.gate_residual_bwd(rows, vec, rows)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.ln_modulate(rows, vec, vec)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.ln_modulate_bwd(rows, vec, rows)
    sig = torch.empty(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        TEDM.edm_loss(rows, rows, rows, sig, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        TEDM.edm_loss_bwd(rows, rows, rows, sig, sig, torch.empty(2, 1,
                                                                  **meta))
    with pytest.raises(ValueError, match="CUDA"):
        TAD.fused_euler(rows, rows, sig, sig, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        TAD.euler_bwd(rows, sig, sig)
    x = torch.empty(2, 2, 8, 64, **meta)
    cfg = TFA.FlashConfig("causal")
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_fwd(x, x, x, cfg)
    lse = torch.empty(2, 2, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_bwd_dq(x, x, x, x, lse, lse, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_bwd_dkv(x, x, x, x, lse, lse, cfg)


# ---------------------------------------------------------------------------
# Flash attention (forward, dq, dk/dv): plain versions against the Pallas
# kernels in interpret mode, values and jax.vjp grads. JAX tiles of 16 over
# lengths that are not multiples of 16 cover padded and partial tiles.
# ---------------------------------------------------------------------------

FA_HD, FA_BLK = 16, 16
# kind -> (Sq, Sk, window, mask_seq)
FA_CASES = {"full": (21, 37, None, None), "causal": (37, 37, None, None),
            "window": (37, 37, 5, None), "db_concat": (38, 38, None, 19),
            "two_pass": (19, 38, None, 19)}


def _fa_inputs(rs, G, Sq, Sk, KV=2, B=2):
    q = rs.randn(B, KV * G, Sq, FA_HD).astype(np.float32)
    k = rs.randn(B, KV, Sk, FA_HD).astype(np.float32)
    v = rs.randn(B, KV, Sk, FA_HD).astype(np.float32)
    do = rs.randn(B, KV * G, Sq, FA_HD).astype(np.float32)
    return q, k, v, do


def _jax_fa(q, k, v, do, kind, window, mseq):
    f = lambda q_, k_, v_: JFA.flash_attention(  # noqa: E731
        q_, k_, v_, mask_kind=kind, window=window, mask_seq=mseq,
        block_q=FA_BLK, block_k=FA_BLK, interpret=True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return (out,) + vjp(jnp.asarray(do))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("kind", sorted(FA_CASES))
def test_flash_attention_matches_pallas(kind, G):
    Sq, Sk, window, mseq = FA_CASES[kind]
    rs = np.random.RandomState(50 + G)
    q, k, v, do = _fa_inputs(rs, G, Sq, Sk)
    want = _jax_fa(q, k, v, do, kind, window, mseq)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TFA.flash_attention(tq, tk, tv, mask_kind=kind, window=window,
                              mask_seq=mseq)
    out.backward(torch.from_numpy(do))
    for got, ref in zip((out, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   ATOL, RTOL)


def test_flash_attention_lse_and_empty_rows_match_pallas():
    """lse against ``_fwd_impl``; a two_pass query whose keys are cut off
    (Sk = S, no noisy keys: row 0 sees nothing) gives out = 0,
    lse ~ -1e30 and zero, finite gradients, as the Pallas kernels do."""
    rs = np.random.RandomState(60)
    q, k, v, do = _fa_inputs(rs, 1, 19, 19)
    cfg = TFA.FlashConfig(mask_kind="two_pass", mask_seq=19)
    jcfg = JFA.FlashConfig(mask_kind="two_pass", mask_seq=19, block_q=FA_BLK,
                           block_k=FA_BLK, interpret=True)
    _, lse_j = JFA._fwd_impl(*map(jnp.asarray, (q, k, v)), jcfg)
    out_t, lse_t = TFA.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                           cfg)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., :19],
                               ATOL, RTOL)
    assert np.all(out_t.numpy()[:, :, 0] == 0)
    assert np.all(lse_t.numpy()[:, :, 0] < -1e29)
    want = _jax_fa(q, k, v, do, "two_pass", None, 19)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    TFA.flash_attention(tq, tk, tv, mask_kind="two_pass",
                        mask_seq=19).backward(torch.from_numpy(do))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want[1:]):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), ATOL, RTOL)
    assert np.all(tq.grad.numpy()[:, :, 0] == 0)


def test_flash_attention_db_concat_first_noisy_row_sees_only_itself():
    S = 8
    rs = np.random.RandomState(61)
    q, k, v, _ = _fa_inputs(rs, 1, 2 * S, 2 * S)
    out = TFA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              mask_kind="db_concat", mask_seq=S)
    np.testing.assert_allclose(out.numpy()[:, :, S], v[:, :, S], ATOL, RTOL)
    mask = TFA.keep_mask(TFA.FlashConfig("db_concat", mask_seq=S), 2 * S,
                         2 * S)
    assert mask[S].nonzero().flatten().tolist() == [S]
    assert mask[S + 3].nonzero().flatten().tolist() == [0, 1, 2, S + 3]


def test_flash_attention_backward_runs_the_plain_bwd_functions(monkeypatch):
    """On CPU tensors the autograd.Function's backward calls the plain dq
    and dk/dv functions once each (never autograd through the forward)."""
    calls = []
    for name in ("_bwd_dq_ref", "_bwd_dkv_ref"):
        fn = getattr(TFA, name)
        monkeypatch.setattr(TFA, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    rs = np.random.RandomState(62)
    q, k, v, do = _fa_inputs(rs, 2, 12, 12)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TFA.flash_attention(tq, tk, tv, mask_kind="causal")
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    out.backward(torch.from_numpy(do))
    assert sorted(calls) == ["_bwd_dkv_ref", "_bwd_dq_ref"]


def test_flash_attention_config_rejects_unknown_masks():
    with pytest.raises(ValueError, match="unknown mask_kind"):
        TFA.FlashConfig(mask_kind="diagonal")
    with pytest.raises(ValueError, match="requires window"):
        TFA.FlashConfig(mask_kind="window")
    with pytest.raises(ValueError, match="requires mask_seq"):
        TFA.FlashConfig(mask_kind="db_concat")


# ---------------------------------------------------------------------------
# Fused Euler step: the plain versions against the Pallas kernel in
# interpret mode and ``ref.euler_reference``, values and jax.vjp grads. JAX
# tiles of 16 rows over S = 13 cover a padded tile; F may be the strided
# noisy half of a (B, 2S, d) stream, as the recurrent-depth sampler passes
# it. Tolerance 1e-6 in fp32; bf16 outputs within one rounding.
# ---------------------------------------------------------------------------

EULER_CASES = [(2, 16, 16, "fp32", False), (3, 13, 64, "fp32", False),
               (2, 13, 64, "fp32", True), (2, 16, 16, "bf16", False),
               (2, 13, 18, "fp32", True)]
EULER_SIG = (np.array([0.05, 2.0, 40.0], np.float32),
             np.array([0.01, 0.0, 25.0], np.float32))


def _euler_inputs(B, S, d, dtype, strided, seed):
    rs = np.random.RandomState(seed)
    z = rs.randn(B, S, d).astype(np.float32)
    f2 = rs.randn(B, 2 * S, d).astype(np.float32)
    g = rs.randn(B, S, d).astype(np.float32)
    if dtype == "bf16":
        z, f2, g = _bf16_round(z), _bf16_round(f2), _bf16_round(g)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tf2 = torch.from_numpy(f2).to(tdt)
    tf = tf2[:, S:] if strided else tf2[:, :S].contiguous()
    f = f2[:, S:] if strided else f2[:, :S]
    sig, sig_to = (x[:B] for x in EULER_SIG)
    return ((jnp.asarray(z, jdt), jnp.asarray(f, jdt), jnp.asarray(g, jdt),
             jnp.asarray(sig), jnp.asarray(sig_to)),
            (torch.from_numpy(z).to(tdt), tf, torch.from_numpy(g).to(tdt),
             torch.from_numpy(sig), torch.from_numpy(sig_to)))


@pytest.mark.parametrize("B,S,d,dtype,strided", EULER_CASES)
def test_fused_euler_matches_pallas(B, S, d, dtype, strided):
    (jz, jf, jg, jsig, jsto), (tz, tf, tg, tsig, tsto) = _euler_inputs(
        B, S, d, dtype, strided, seed=S + d)
    if strided:
        assert not tf.is_contiguous() and tf.stride(1) == d
    kern = lambda z, f, s: JAD.fused_euler(  # noqa: E731
        z, f, s, jsto, 0.5, block_rows=16, interpret=True)
    out_j, vjp = jax.vjp(kern, jz, jf, jsig)
    dz_j, df_j, dsig_j = vjp(jg)
    assert float(jnp.abs(dsig_j).max()) == 0.0
    ref_j = JREF.euler_reference(jz, jf, jsig, jsto, 0.5)
    tz.requires_grad_()
    tf.requires_grad_()
    tsig.requires_grad_()
    out_t = TAD.fused_euler(tz, tf, tsig, tsto, 0.5)
    assert out_t.dtype == tz.dtype and out_t.shape == tz.shape
    out_t.backward(tg)
    tol = dict(atol=1e-6, rtol=1e-6 if dtype == "fp32" else 2.0 ** -7)
    for want in (out_j, ref_j):
        np.testing.assert_allclose(out_t.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    for got, want in ((tz.grad, dz_j), (tf.grad, df_j)):
        assert got.dtype == tz.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    assert tsig.grad is None          # σ is schedule data: no cotangent


def test_euler_at_sigma_to_zero_is_the_denoiser():
    """σ_to = 0 gives D = c_skip z + c_out F, the last step of every
    chain."""
    _, (tz, tf, _, tsig, _) = _euler_inputs(3, 7, 16, "fp32", False, 1)
    out = TAD.fused_euler(tz, tf, tsig, torch.zeros(3), 0.5)
    want = TEDMC.denoise_combine(tz, tf, tsig[:, None, None], 0.5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_euler_coeffs_match_edm_preconditioning():
    """``euler_coeffs`` re-derives c_skip/c_out; pinned to
    ``core/edm.preconditioning`` (as the JAX package pins its
    ``_euler_coeffs``) and to the JAX kernel's own coefficients."""
    sigma = torch.tensor([0.05, 0.5, 2.0, 40.0])
    sigma_to = sigma * 0.3
    c_skip, c_out, _, _ = TEDMC.preconditioning(sigma, 0.5)
    a, b = TAD.euler_coeffs(sigma, sigma_to, 0.5)
    r = sigma_to / sigma
    np.testing.assert_allclose(a.numpy(), (r + (1 - r) * c_skip).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), ((1 - r) * c_out).numpy(),
                               rtol=1e-6)
    ja, jb = JAD._euler_coeffs(jnp.asarray(sigma.numpy()),
                               jnp.asarray(sigma_to.numpy()), 0.5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb)[:, 0], rtol=1e-6)


def test_fused_euler_backward_runs_the_plain_bwd_function(monkeypatch):
    calls = []
    fn = TAD.euler_bwd_ref
    monkeypatch.setattr(TAD, "euler_bwd_ref", lambda *a: (
        calls.append("euler_bwd_ref"), fn(*a))[1])
    _, (tz, tf, tg, tsig, tsto) = _euler_inputs(2, 5, 16, "fp32", True, 2)
    tz.requires_grad_()
    tf.requires_grad_()
    out = TAD.fused_euler(tz, tf, tsig, tsto, 0.5)
    assert type(out.grad_fn).__name__ == "_EulerBackward"
    out.backward(tg)
    assert calls == ["euler_bwd_ref"]
