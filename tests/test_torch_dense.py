"""PyTorch port: the dense-cache serving path against the JAX package on
the CPU.

The attention functions first: ``chunked_attention`` and its triangle
variant (fp32, GQA 2:1, lengths that are not multiples of the chunks,
causal and sliding-window masks) within 1e-5 of JAX's, and
``decode_attention`` through both routes (``ref``, the masked attend; and
``kernels``, the flash-decode plain version over the identity page view)
against JAX's reference route, without a window, on a ring before, at and
past the wrap, and over more than 4096 keys (the chunked route); a probe
leaves the cache bit-identical and a commit writes only its slot.

Then every family at a reduced size (stablelm, h2o-danube3 with its
64-token window, phi3.5-moe, llama-3.2-vision, zamba2, whisper, xlstm): the
dense ``init_cache`` leaves equal JAX's in shape and dtype; ``prefill``
(70-token prompts: past the window) and ``prefill_probe(k=1)`` within 1e-4
of JAX's, logits and every cache leaf; the port's per-token commits equal
its prefill within 2e-3, as JAX's own test holds them; and 4 greedy
``serve_step``s from the prefilled caches (the window families' seated in
their rings) give JAX's tokens on JAX's draws, through both routes. Last,
the conditioned families' dense path (``set_conditioning``, per-token
prompt commits, ``serve_step`` under ``cond_lengths``) gives the paged
engine's tokens, as ``tests/test_prefill.py`` holds JAX's dry-run path to
its engine. JAX's functions are jitted once a family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import DiffusionBlocksModel as JDBM
from repro.nn import attention as JA
from repro_torch import configs as TC
from repro_torch.bridge import params_from_jax
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.launch import serve as TS
from repro_torch.nn import attention as TA
from repro_torch.nn import cache as TKVC

torch.set_num_threads(1)

FAMILIES = {"stablelm": "stablelm-1.6b", "h2o": "h2o-danube-3-4b",
            "moe": "phi3.5-moe-42b-a6.6b", "vlm": "llama-3.2-vision-11b",
            "zamba2": "zamba2-7b", "whisper": "whisper-small",
            "xlstm": "xlstm-125m"}
B, S, NEW, SEED_RNG = 2, 70, 4, 7


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------

def _qkv(rs, Sq, Sk, H=4, KV=2, hd=16, B_=2):
    return (rs.randn(B_, Sq, H, hd).astype(np.float32),
            rs.randn(B_, Sk, KV, hd).astype(np.float32),
            rs.randn(B_, Sk, KV, hd).astype(np.float32))


MASKS = {"causal": (JA.causal_mask, TA.causal_mask),
         "window": (JA.sliding_window_mask(9), TA.sliding_window_mask(9)),
         "none": (None, None)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("Sq,Sk,qc,kc", [(37, 45, 16, 8), (20, 20, 7, 6)])
def test_chunked_attention_matches_jax(mask, Sq, Sk, qc, kc):
    q, k, v = _qkv(np.random.RandomState(Sq + Sk), Sq, Sk)
    qpos, kpos = np.arange(Sq) + (Sk - Sq), np.arange(Sk)
    jm, tm = MASKS[mask]
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jm, jnp.asarray(qpos),
                                jnp.asarray(kpos), qc, kc)
    got = TA.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm,
                               torch.from_numpy(qpos),
                               torch.from_numpy(kpos), qc, kc)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mask", ["causal", "window"])
def test_chunked_attention_triangle_matches_jax(mask):
    q, k, v = _qkv(np.random.RandomState(3), 48, 48)
    pos = np.arange(48)
    jm, tm = MASKS[mask]
    want = JA.chunked_attention_triangle(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
        jnp.asarray(pos), jnp.asarray(pos), 16, 12)
    got = TA.chunked_attention_triangle(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm,
        torch.from_numpy(pos), torch.from_numpy(pos), 16, 12)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="aligned"):
        TA.chunked_attention_triangle(torch.from_numpy(q[:, :40]),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), tm,
                                      torch.arange(40), torch.arange(48), 16)


def _decode_case(C, KV=2, G=2, hd=16, d=32, seed=0):
    """Random attention params, a token x and a full random cache (every
    slot filled, so masking errors show)."""
    rs = np.random.RandomState(seed)
    dims = (KV * G, KV, hd)
    p = {"wq": rs.randn(d, KV * G * hd), "wk": rs.randn(d, KV * hd),
         "wv": rs.randn(d, KV * hd), "wo": rs.randn(KV * G * hd, d)}
    p = {k: (0.2 * w).astype(np.float32) for k, w in p.items()}
    x = rs.randn(B, 1, d).astype(np.float32)
    cache = {n: rs.randn(B, C, KV, hd).astype(np.float32) for n in "kv"}
    return dims, p, x, cache


DECODE_CASES = ([(16, None, pos) for pos in (0, 5, 15)]
                + [(8, 8, pos) for pos in (3, 7, 8, 21)])


@pytest.mark.parametrize("C,window,pos", DECODE_CASES)
def test_decode_attention_matches_jax(C, window, pos):
    """Both routes within 1e-5 of JAX's reference route; the probe
    (``commit=False``) leaves the cache bit-identical, the commit writes
    JAX's new k/v at slot ``pos`` (``pos % C`` on the ring) and nothing
    else."""
    (H, KV, hd), p, x, cache = _decode_case(C)
    jd, td = JA.AttnDims(H, KV, hd), TA.AttnDims(H, KV, hd)
    want, jnew = JA.decode_attention(
        {k: jnp.asarray(w) for k, w in p.items()}, jnp.asarray(x), jd,
        {k: jnp.asarray(c) for k, c in cache.items()}, pos, window=window)
    tp = {k: torch.from_numpy(w) for k, w in p.items()}
    slot = pos % C
    for impl in ("ref", "kernels"):
        tc = {k: torch.from_numpy(c.copy()) for k, c in cache.items()}
        got, _ = TA.decode_attention(tp, torch.from_numpy(x), td, tc, pos,
                                     window=window, impl=impl, commit=False)
        _close(got, want, 1e-5, impl)
        for k in "kv":
            assert np.array_equal(tc[k].numpy(), cache[k]), (impl, k)
        got, _ = TA.decode_attention(tp, torch.from_numpy(x), td, tc, pos,
                                     window=window, impl=impl)
        _close(got, want, 1e-5, impl)
        for k in "kv":
            keep = np.arange(C) != slot
            assert np.array_equal(tc[k].numpy()[:, keep],
                                  cache[k][:, keep]), (impl, k)
            _close(tc[k][:, slot], np.asarray(jnew[k])[:, slot], 1e-5)


def test_decode_attention_past_4096_keys_takes_the_chunked_route():
    """A cache of more than 4096 keys: JAX's reference route attends in
    ``chunked_attention`` (q chunk 1, kv chunk 2048), and so does the
    port's; the kernel route agrees."""
    C, pos = 4100, 4097
    (H, KV, hd), p, x, cache = _decode_case(C, KV=1, G=2, hd=16, seed=5)
    want, _ = JA.decode_attention(
        {k: jnp.asarray(w) for k, w in p.items()}, jnp.asarray(x),
        JA.AttnDims(H, KV, hd), {k: jnp.asarray(c) for k, c in cache.items()},
        pos)
    for impl in ("ref", "kernels"):
        tc = {k: torch.from_numpy(c.copy()) for k, c in cache.items()}
        got, _ = TA.decode_attention(
            {k: torch.from_numpy(w) for k, w in p.items()},
            torch.from_numpy(x), TA.AttnDims(H, KV, hd), tc, pos, impl=impl,
            commit=False)
        _close(got, want, 1e-5, impl)
    with pytest.raises(ValueError, match="past a dense cache"):
        TA.decode_attention({k: torch.from_numpy(w) for k, w in p.items()},
                            torch.from_numpy(x), TA.AttnDims(H, KV, hd), tc,
                            C, impl="ref")


def test_dense_to_paged_is_a_view():
    """One page of C keys a slot: the pages are the cache's own storage,
    the table the identity."""
    k, v = torch.randn(3, 10, 2, 8), torch.randn(3, 10, 2, 8)
    pages, table = TKVC.dense_to_paged(k, v)
    assert pages.k.data_ptr() == k.data_ptr()
    assert pages.v.data_ptr() == v.data_ptr()
    assert pages.page_size == 10
    assert table.tolist() == [[0], [1], [2]] and table.dtype == torch.int32


# ---------------------------------------------------------------------------
# Every family
# ---------------------------------------------------------------------------

def family_cfg(name, configs=JC):
    """The family's reduced config from ``configs`` (JAX's or the port's):
    two blocks of units for every family."""
    cfg = configs.reduced(configs.get_config(FAMILIES[name]))
    if name == "vlm":            # two superblocks
        cfg = dataclasses.replace(cfg, n_layers=4)
    if name == "xlstm":          # two (sLSTM, mLSTM) pairs
        cfg = configs.reduced(configs.get_config(FAMILIES[name]),
                              n_layers=4)
    return cfg


def _randomise(tree, rs):
    """AdaLN heads, norm gains and biases random (they init to identity or
    zero), cross gates opened (tanh(2) = 0.96)."""
    for k, v in tree.items():
        if isinstance(v, dict) and k == "adaln":
            for kk in ("w", "b"):
                v[kk] = (0.02 * rs.randn(*v[kk].shape)).astype(np.float32)
        elif isinstance(v, dict) and k.startswith("ln"):
            for kk, base in (("g", 1.0), ("b", 0.0)):
                if kk in v:
                    v[kk] = (base + 0.1 * rs.randn(*v[kk].shape)
                             ).astype(np.float32)
        elif isinstance(v, dict):
            _randomise(v, rs)
        elif k == "xgate":
            tree[k] = np.full(v.shape, 2.0, np.float32)


def _aux(cfg, seed=9):
    rs = np.random.RandomState(seed)
    if cfg.family == "vlm":
        return {"image_embs": 0.5 * rs.randn(
            B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_embs": 0.5 * rs.randn(
            B, cfg.n_audio_frames, cfg.d_model).astype(np.float32)}
    return None


def _leaves(cache):
    """A cache's tensors as fp32 numpy in flatten order (the port's
    through ``cache_tensors``, JAX's through ``tree_leaves``)."""
    leaves = jax.tree_util.tree_leaves(cache)
    if torch.is_tensor(leaves[0]):
        return [_np(t) for t in TKVC.cache_tensors(cache)]
    return [np.asarray(x, np.float32) for x in leaves]


def _seat(dst, src):
    """Write a prefilled leaf (positions on axis -3) into a dense cache
    leaf: equal shapes copy; else the last C positions go to their slots
    p % C (a ring, or the first S slots of a longer cache)."""
    if dst.shape == src.shape:
        dst[...] = src
        return dst
    C, n = dst.shape[-3], src.shape[-3]
    for p in range(max(0, n - C), n):
        dst[..., p % C, :, :] = src[..., p, :, :]
    return dst


def _jax_draws(d, sigma_max):
    """Each serve step's rng and its initial z, as JAX's ``serve_step``
    splits and draws them."""
    rng, out = jax.random.PRNGKey(SEED_RNG), []
    for _ in range(NEW):
        rng, rs = jax.random.split(rng)
        r_noise, _ = jax.random.split(rs)
        out.append((rs, np.array(sigma_max * jax.random.normal(
            r_noise, (B, 1, d)))))
    return out


class Family:
    """JAX's model and the port's on the same random params, and JAX's
    results, each computed once: the prefill and the probe of one prompt
    batch, and 4 greedy serve steps from the prefilled cache."""

    def __init__(self, name):
        cfg = family_cfg(name)
        db = JC.DBConfig(num_blocks=2, overlap_gamma=0.1)
        self.jdbm = JDBM(cfg, db)
        tree = jax.tree_util.tree_map(
            np.asarray, self.jdbm.init(jax.random.PRNGKey(0)))
        _randomise(tree, np.random.RandomState(3))
        self.jp = jax.tree_util.tree_map(jnp.asarray, tree)
        self.tdbm = TDBM(family_cfg(name, TC),
                         TC.DBConfig(**dataclasses.asdict(db)))
        self.tp = params_from_jax(tree, "cpu", self.tdbm.model.spec)
        self.cfg = cfg
        rs = np.random.RandomState(11)
        self.tokens = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        self.aux = _aux(cfg)
        jaux = (None if self.aux is None else
                {k: jnp.asarray(a) for k, a in self.aux.items()})
        self.jlogits, self.jcache = jax.jit(self.jdbm.prefill)(
            self.jp, jnp.asarray(self.tokens), jaux)
        self.jprobe = jax.jit(
            lambda p, t, a: self.jdbm.prefill_probe(p, t, 1, a))(
                self.jp, jnp.asarray(self.tokens), jaux)
        self.draws = _jax_draws(cfg.d_model, db.sigma_max)
        step = jax.jit(self.jdbm.serve_step)
        cache = self.seated_jax()
        self.jtokens = []
        for t, (rng, _) in enumerate(self.draws):
            tok, cache = step(self.jp, cache, jnp.int32(S + t), rng)
            self.jtokens.append(np.asarray(tok))

    def seated_jax(self):
        dst = self.jdbm.model.init_cache(B, S + NEW, jnp.float32)
        return jax.tree_util.tree_map(
            lambda d, s: jnp.asarray(_seat(np.array(d), np.asarray(s))),
            dst, self.jcache)

    def taux(self):
        return (None if self.aux is None else
                {k: torch.from_numpy(a) for k, a in self.aux.items()})


_FAMILY_CACHE = {}


@pytest.fixture(params=sorted(FAMILIES))
def fam(request):
    if request.param not in _FAMILY_CACHE:
        _FAMILY_CACHE[request.param] = Family(request.param)
    return _FAMILY_CACHE[request.param]


def test_init_cache_matches_jax(fam):
    """Dense cache leaves of JAX's shapes, dtypes and values (bf16 and
    fp32 asked for; the recurrent states keep their own dtypes and init
    values), and a slice of units (``size``) leads with that many."""
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jax.tree_util.tree_leaves(
            fam.jdbm.model.init_cache(B, S + NEW, jdt))
        got = TKVC.cache_tensors(fam.tdbm.model.init_cache(
            B, S + NEW, tdt, device="cpu"))
        assert [tuple(w.shape) for w in want] == [tuple(g.shape)
                                                  for g in got]
        assert [str(w.dtype) for w in want] == [
            str(g.dtype).replace("torch.", "") for g in got]
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w, np.float32), _np(g))
    one = fam.tdbm.model.init_cache(B, 5, torch.float32, size=1,
                                    device="cpu")
    assert all(t.shape[0] == 1 for t in TKVC.cache_tensors(one))


@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_prefill_matches_jax(fam, impl):
    """Logits and every cache leaf within 1e-4 of JAX's (the kernels'
    plain versions on CPU tensors under ``kernels``)."""
    logits, cache = fam.tdbm.prefill(fam.tp, torch.from_numpy(fam.tokens),
                                     fam.taux(), impl=impl)
    _close(logits, fam.jlogits, 1e-4, "logits")
    want, got = _leaves(fam.jcache), _leaves(cache)
    assert [w.shape for w in want] == [g.shape for g in got]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(torch.from_numpy(g), w, 1e-4, f"leaf {i}")


def test_prefill_probe_matches_jax(fam):
    logits, sub = fam.tdbm.prefill_probe(fam.tp, torch.from_numpy(fam.tokens),
                                         1, fam.taux())
    _close(logits, fam.jprobe[0], 1e-4, "logits")
    want, got = _leaves(fam.jprobe[1]), _leaves(sub)
    assert [w.shape for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        _close(torch.from_numpy(g), w, 1e-4)


@pytest.mark.parametrize("name", ["stablelm", "xlstm"])
def test_forward_matches_jax(name):
    """``BaseModel.forward``: the whole stack in ``train`` gives JAX's
    logits within 1e-4; in ``prefill`` it also returns every unit's cache
    in ``init_cache``'s shapes."""
    fam = _FAMILY_CACHE.get(name) or Family(name)
    _FAMILY_CACHE[name] = fam
    want, _, _ = fam.jdbm.model.forward(
        fam.jp, jnp.asarray(fam.tokens),
        fam.jdbm.make_ctx(fam.jp, S, "train"))
    tok = torch.from_numpy(fam.tokens)
    got, none = fam.tdbm.model.forward(
        fam.tp, tok, fam.tdbm.make_ctx(fam.tp, S, "train", impl="ref"))
    _close(got, want, 1e-4)
    assert none is None
    _, cache = fam.tdbm.model.forward(
        fam.tp, tok, fam.tdbm.make_ctx(fam.tp, S, "prefill", impl="ref"))
    shapes = [t.shape for t in TKVC.cache_tensors(
        fam.tdbm.model.init_cache(B, S, torch.float32, device="cpu"))]
    assert [t.shape for t in TKVC.cache_tensors(cache)] == shapes


def _conditioned(fam, cache):
    aux = fam.taux()
    if aux is None:
        return
    m = fam.tdbm.model
    m.set_conditioning(fam.tp, cache, m.encode_conditioning(fam.tp, aux))


def test_per_token_commits_equal_prefill(fam):
    """S commits one token at a time (the reference route) fill the dense
    cache as ``prefill`` does: within 2e-3, as JAX's
    ``test_prefill_then_decode_consistency`` holds them (the window
    families' rings against the prefill's last positions, seated)."""
    m = fam.tdbm.model
    cache = m.init_cache(B, S, torch.float32, device="cpu")
    _conditioned(fam, cache)
    ctx = fam.tdbm.dense_ctx(0, impl="ref")
    tok = torch.from_numpy(fam.tokens)
    for t in range(S):
        ctx.pos = t
        fam.tdbm.commit_token(fam.tp, cache, tok[:, t:t + 1], ctx)
    _, pre = fam.tdbm.prefill(fam.tp, tok, fam.taux(), impl="ref")
    want = TKVC.cache_tensors(m.init_cache(B, S, torch.float32,
                                           device="cpu"))
    for i, (g, w, p) in enumerate(zip(TKVC.cache_tensors(cache), want,
                                      TKVC.cache_tensors(pre))):
        _close(g, _seat(w, p).numpy(), 2e-3, f"leaf {i}")


@pytest.mark.parametrize("impl", ["ref", "kernels"])
def test_denoising_probes_leave_the_cache_bit_identical(fam, impl):
    """The Euler chain's probes (``commit=False``) read the dense cache and
    write nothing: every leaf, KV and recurrent state alike, is
    bit-identical after it; the commit then changes the cache."""
    cache = fam.tdbm.model.init_cache(B, S + NEW, torch.float32,
                                      device="cpu")
    _, pre = fam.tdbm.prefill(fam.tp, torch.from_numpy(fam.tokens),
                              fam.taux(), impl=impl)
    for d, s in zip(TKVC.cache_tensors(cache), TKVC.cache_tensors(pre)):
        _seat(d, s)
    before = [t.clone() for t in TKVC.cache_tensors(cache)]
    ctx = fam.tdbm.dense_ctx(S, impl=impl)
    d_hat = fam.tdbm.denoise_next_token(fam.tp, cache, ctx,
                                        z0=fam.draws[0][1])
    assert torch.isfinite(d_hat).all()
    assert all(torch.equal(a, b) for a, b in
               zip(before, TKVC.cache_tensors(cache)))
    fam.tdbm.commit_token(fam.tp, cache,
                          torch.from_numpy(fam.tokens[:, :1]).long(), ctx)
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, TKVC.cache_tensors(cache)))


def test_serve_step_tokens_match_jax(fam):
    """4 greedy dense serve steps from the prefilled cache on JAX's draws:
    JAX's tokens, through the reference route and through the kernel
    route's plain versions."""
    _, pre = fam.tdbm.prefill(fam.tp, torch.from_numpy(fam.tokens),
                              fam.taux(), impl="ref")
    for impl in ("ref", "kernels"):
        cache = fam.tdbm.model.init_cache(B, S + NEW, torch.float32,
                                          device="cpu")
        for d, s in zip(TKVC.cache_tensors(cache), TKVC.cache_tensors(pre)):
            _seat(d, s)
        for t, (_, z0) in enumerate(fam.draws):
            tok, cache = fam.tdbm.serve_step(fam.tp, cache, S + t, z0=z0,
                                             impl=impl)
            assert tok.tolist() == fam.jtokens[t].tolist(), (impl, t)


# ---------------------------------------------------------------------------
# Conditioned families: the dense path against the paged engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vlm", "whisper"])
def test_conditioned_dense_path_matches_paged_engine(name):
    """One request (7 prompt tokens, 6 new) under conditioning: the dense
    path (``set_conditioning`` on ``init_cache``, the prompt committed a
    token at a time, ``serve_step`` under ``cond_lengths``) and the port's
    paged static engine on the same z give the same greedy tokens; the
    VLM's block is read under a ragged valid length."""
    fam = _FAMILY_CACHE.get(name) or Family(name)
    _FAMILY_CACHE[name] = fam
    dbm, params, cfg = fam.tdbm, fam.tp, fam.cfg
    key = "image_embs" if name == "vlm" else "audio_embs"
    cond_in = {key: torch.from_numpy(fam.aux[key][:1])}
    n_cond = cond_in[key].shape[1] - (3 if name == "vlm" else 0)
    clens = torch.full((1,), n_cond, dtype=torch.int32)
    prompt, new = fam.tokens[:1, :7], 6
    z = 80.0 * torch.randn((new, 1, 1, cfg.d_model),
                           generator=torch.Generator().manual_seed(4))
    for impl in ("ref", "kernels"):
        cache = dbm.model.init_cache(1, 7 + new, torch.float32, device="cpu")
        dbm.model.set_conditioning(
            params, cache, dbm.model.encode_conditioning(params, cond_in))
        ctx = dbm.dense_ctx(0, impl=impl, cond_lengths=clens)
        for t in range(7):
            ctx.pos = t
            dbm.commit_token(params, cache,
                             torch.from_numpy(prompt[:, t:t + 1]), ctx)
        dense = [dbm.serve_step(params, cache, 7 + t, z0=z[t], impl=impl,
                                cond_lengths=clens)[0].item()
                 for t in range(new)]
        eng = TS.get_engine(dbm, precision="fp32", impl=impl, chunk_size=4)
        out = eng.generate(params, prompt, new, z0=z,
                           aux_inputs={key: cond_in[key].numpy()},
                           cond_lengths=clens.numpy() if name == "vlm"
                           else None)
        assert dense == out[0, 7:].tolist(), impl
