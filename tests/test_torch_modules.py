"""PyTorch port: module-by-module parity with the JAX package on the CPU.

Configs, partition and precision; the parameter bridge; the layers
(norms, rope, MLP, embedding), the AdaLN conditioning, the paged cache
appends and one transformer layer in the paged ``decode`` and
``prefill_chunk`` modes, all on the same numpy-made inputs and bridged
params (AdaLN heads and norm gains randomised: at init they are the
identity and would test nothing). Tolerance atol = rtol = 1e-4 in fp32.

Also: the port and ``chip_smoke.py`` import neither JAX nor any module of
the JAX package.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import precision as JPREC
from repro.core import DiffusionBlocksModel as JDBM
from repro.core import partition as JPART
from repro.models import common as JCOM
from repro.nn import adaln as JAL
from repro.nn import cache as JKVC
from repro.nn import layers as JL
from repro_torch import configs as TC
from repro_torch import precision as TPREC
from repro_torch.bridge import params_from_jax
from repro_torch.core import partition as TPART
from repro_torch.core.blocks import DiffusionBlocksModel as TDBM
from repro_torch.models import common as TCOM
from repro_torch.nn import adaln as TAL
from repro_torch.nn import cache as TKVC
from repro_torch.nn import layers as TL

# small tensors: one torch thread is as fast, and the suite's xdist workers
# share the cores with JAX
torch.set_num_threads(1)
ATOL = RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]

TINY = JC.ModelConfig(name="tiny-decode", family="dense", n_layers=6,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=32)
TINY_SWA = dataclasses.replace(TINY, name="tiny-swa", sliding_window=5)
REDUCED = JC.reduced(JC.get_config("stablelm-1.6b"))
CFGS = {"tiny": TINY, "tiny_gqa_swa": TINY_SWA, "stablelm_reduced": REDUCED}


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), atol=atol, rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


def to_torch_cfg(cfg):
    return TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def models(cfg, blocks=3, seed=0):
    """(jax dbm, jax params, torch dbm, torch params): the JAX init bridged
    to torch, AdaLN heads and norm gains randomised with numpy."""
    db = JC.DBConfig(num_blocks=min(blocks, cfg.n_layers), overlap_gamma=0.1)
    jdbm = JDBM(cfg, db)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdbm.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 3)
    lay = tree["layers"]
    for k in ("w", "b"):
        lay["adaln"][k] = (0.02 * rs.randn(*lay["adaln"][k].shape)
                           ).astype(np.float32)
    for ln in ("ln1", "ln2"):
        for k, base in (("g", 1.0), ("b", 0.0)):
            if k in lay[ln]:
                lay[ln][k] = (base + 0.1 * rs.randn(*lay[ln][k].shape)
                              ).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tdbm = TDBM(to_torch_cfg(cfg), TC.DBConfig(**dataclasses.asdict(db)))
    return jdbm, jparams, tdbm, params_from_jax(tree, "cpu",
                                                tdbm.model.spec)


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    return (CFGS[request.param],) + models(CFGS[request.param])


# ---------------------------------------------------------------------------
# Imports, configs, partition, precision, bridge
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {n}"


def test_configs_are_copies():
    assert sorted(TC.ARCH_CONFIGS) == sorted(JC.ARCH_CONFIGS)
    for name, cfg in JC.ARCH_CONFIGS.items():
        assert dataclasses.asdict(TC.ARCH_CONFIGS[name]) == \
            dataclasses.asdict(cfg), name
        assert dataclasses.asdict(TC.reduced(TC.ARCH_CONFIGS[name])) == \
            dataclasses.asdict(JC.reduced(cfg)), name
    assert dataclasses.asdict(TC.DEFAULT_DB) == dataclasses.asdict(
        JC.DEFAULT_DB)


@pytest.mark.parametrize("blocks,partition", [(1, "equiprob"),
                                              (4, "equiprob"),
                                              (3, "uniform")])
def test_partition_matches(blocks, partition):
    jdb = JC.DBConfig(num_blocks=blocks, partition=partition,
                      overlap_gamma=0.1)
    tdb = TC.DBConfig(**dataclasses.asdict(jdb))
    np.testing.assert_array_equal(TPART.sigma_edges(tdb),
                                  JPART.sigma_edges(jdb))
    for b in range(blocks):
        assert TPART.block_qrange(tdb, b) == JPART.block_qrange(jdb, b)
    assert TPART.unit_ranges(24, blocks) == JPART.unit_ranges(24, blocks)


def test_precision_policies_match():
    for name in ("fp32", "bf16", "bf16_kvint8", "fp32_kvint8", "int8"):
        tp, jp = TPREC.get_policy(name), JPREC.get_policy(name)
        assert tp.name == jp.name and tp.kv_quantized == jp.kv_quantized
        assert str(tp.kv).split(".")[-1] == jnp.dtype(jp.kv).name
    for base, kvd in (("bf16", "int8"), ("fp32", "int8"), ("bf16", None),
                      ("bf16", "bf16")):
        assert TPREC.with_kv_dtype(base, kvd).name == \
            JPREC.with_kv_dtype(base, kvd).name


def test_bridge_maps_every_leaf(pair):
    cfg, jdbm, jparams, tdbm, tparams = pair
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    jshapes = {tuple(k.key for k in path): tuple(v.shape)
               for path, v in jleaves.items()}
    from repro_torch.nn.init import tree_items
    tshapes = {p: tuple(v.shape) for p, v in tree_items(tparams)}
    assert tshapes == jshapes
    assert {p: tuple(s.shape) for p, s in tree_items(tdbm.model.spec)} \
        == jshapes


def test_bridge_rejects_missing_and_extra_keys():
    _, jparams, tdbm, _ = models(TINY)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, "cpu", tdbm.model.spec)
    bad = dict(tree)
    del bad["head"]
    with pytest.raises(KeyError, match="head"):
        params_from_jax(bad, "cpu", tdbm.model.spec)
    bad = dict(tree, head={"w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, "cpu", tdbm.model.spec)


# ---------------------------------------------------------------------------
# Layers and AdaLN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm(kind):
    rs = np.random.RandomState(1)
    x = (3.0 * rs.randn(2, 5, 64) + 0.5).astype(np.float32)
    p = {"g": (1 + 0.1 * rs.randn(64)).astype(np.float32),
         "b": (0.1 * rs.randn(64)).astype(np.float32)}
    p = {k: v for k, v in p.items() if k in JL.norm_spec(64, kind)}
    close(TL.apply_norm({k: t(v) for k, v in p.items()}, t(x), kind),
          JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind))


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope(hd):
    rs = np.random.RandomState(2)
    x = rs.randn(3, 5, 2, hd).astype(np.float32)
    pos = (np.array([0, 7, 300])[:, None] + np.arange(5)).astype(np.int32)
    close(TL.apply_rope(t(x), t(pos), 10000.0),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp(kind):
    rs = np.random.RandomState(3)
    spec = JL.mlp_spec(32, 48, kind)
    p = {k: (rs.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in spec.items()}
    x = rs.randn(2, 3, 32).astype(np.float32)
    close(TL.apply_mlp({k: t(v) for k, v in p.items()}, t(x), kind),
          JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), kind))


def test_embedding_and_readout(pair):
    cfg, jdbm, jparams, tdbm, tparams = pair
    toks = np.array([[0, 3, cfg.vocab_size - 1]], np.int32)
    close(tdbm.model.embed(tparams, t(toks)),
          jdbm.model.embed(jparams, jnp.asarray(toks)))
    table = np.asarray(jparams["embed"]["table"])
    close(TL.l2_normalize_embeddings(t(table)),
          JL.l2_normalize_embeddings(jnp.asarray(table)))
    h = np.random.RandomState(4).randn(2, 1, cfg.d_model).astype(np.float32)
    close(tdbm.model.logits(tparams, t(h)),
          jdbm.model.logits(jparams, jnp.asarray(h)))


def test_sigma_embedding_and_mods(pair):
    cfg, jdbm, jparams, tdbm, tparams = pair
    sig = np.array([80.0, 1.3, 0.02], np.float32)
    c_t = tdbm.model.cond(tparams, torch.log(t(sig)))
    c_j = jdbm.model.cond(jparams, jnp.log(jnp.asarray(sig)))
    close(c_t, c_j)
    # angles reach |log(80)/4| * e^6 ~ 440 rad, where one fp32 ulp is 3e-5
    # and the two libraries' exp/cos/sin differ by an ulp or two
    close(TAL.fourier_features(torch.log(t(sig)) / 4, 256),
          JAL.fourier_features(jnp.log(jnp.asarray(sig)) / 4, 256),
          atol=5e-4, rtol=0)
    lay_t = {k: v[1] for k, v in tparams["layers"]["adaln"].items()}
    lay_j = {k: v[1] for k, v in jparams["layers"]["adaln"].items()}
    for mt, mj in zip(TAL.adaln_mods(lay_t, c_t, cfg.d_model),
                      JAL.adaln_mods(lay_j, c_j, cfg.d_model)):
        close(mt, mj)


@pytest.mark.parametrize("impl", ["kernels", "ref"])
def test_gate_and_modulate(impl):
    rs = np.random.RandomState(5)
    res, br, x = (rs.randn(3, 1, 32).astype(np.float32) for _ in range(3))
    g, sh, sc = ((0.1 * rs.randn(3, 1, 32)).astype(np.float32)
                 for _ in range(3))
    close(TAL.gate(t(res), t(br), t(g), impl=impl),
          JAL.gate(jnp.asarray(res), jnp.asarray(br), jnp.asarray(g)))
    close(TAL.gate(t(res), t(br), None), res + br)
    close(TAL.modulate(t(x), t(sh), t(sc)),
          JAL.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)))


# ---------------------------------------------------------------------------
# Paged cache appends (in place in the port, functional in JAX)
# ---------------------------------------------------------------------------

def _pools(rs, dtype, P=13, psz=4, KV=2, hd=8):
    k = rs.randn(P, psz, KV, hd).astype(np.float32)
    v = rs.randn(P, psz, KV, hd).astype(np.float32)
    if dtype == "int8":
        jk, ks = JKVC.quantize_pages(jnp.asarray(k))
        jv, vs = JKVC.quantize_pages(jnp.asarray(v))
        jp = JKVC.PagedKV(jk, jv, ks, vs)
    else:
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        jp = JKVC.PagedKV(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    return jp, _to_torch_pool(jp)


def _to_torch_pool(jp):
    def conv(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return t(np.asarray(a.astype(jnp.float32))).bfloat16()
        return t(np.asarray(a))
    return TKVC.PagedKV(conv(jp.k), conv(jp.v), conv(jp.k_scale),
                        conv(jp.v_scale))


def _assert_pools(tp, jp, dtype, skip_trash=True):
    """Live pages bit-identical (float) or within one quantisation step
    (int8, where rounding ties may break apart). The trash page takes
    colliding redirected writes whose winner is unspecified on both sides."""
    lo = 1 if skip_trash else 0
    for name in ("k", "v"):
        got = getattr(tp, name)[lo:].float().numpy()
        want = np.asarray(getattr(jp, name)[lo:].astype(jnp.float32))
        if dtype == "int8":
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)
    if dtype == "int8":
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tp, name)[lo:].numpy(),
                                       np.asarray(getattr(jp, name)[lo:]),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_append_paged(dtype):
    rs = np.random.RandomState(6)
    jp, tp = _pools(rs, dtype)
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    lengths = np.array([0, 5, 15], np.int32)
    active = np.array([True, False, True])
    k_new = rs.randn(3, 2, 8).astype(np.float32)
    v_new = rs.randn(3, 2, 8).astype(np.float32)
    jout = JKVC.append_paged(jp, jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(table), jnp.asarray(lengths),
                             jnp.asarray(active))
    tout = TKVC.append_paged(tp, t(k_new), t(v_new), t(table), t(lengths),
                             t(active))
    assert tout is tp                      # the port appends in place
    _assert_pools(tout, jout, dtype)
    if dtype != "int8":                    # the inactive slot wrote to trash
        np.testing.assert_array_equal(
            tout.k[0, 5 % 4].float().numpy(),
            np.asarray(jnp.asarray(k_new[1], jout.k.dtype).astype(
                jnp.float32)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_append_paged_chunk(dtype):
    rs = np.random.RandomState(7)
    jp, tp = _pools(rs, dtype)
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    lengths = np.array([0, 3, 6], np.int32)
    n_valid = np.array([5, 2, 0], np.int32)
    k_new = rs.randn(3, 5, 2, 8).astype(np.float32)
    v_new = rs.randn(3, 5, 2, 8).astype(np.float32)
    jout = JKVC.append_paged_chunk(jp, jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(table), jnp.asarray(lengths),
                                   jnp.asarray(n_valid))
    tout = TKVC.append_paged_chunk(tp, t(k_new), t(v_new), t(table),
                                   t(lengths), t(n_valid))
    _assert_pools(tout, jout, dtype)


def test_quantize_pages_matches():
    x = np.random.RandomState(8).randn(4, 4, 2, 8).astype(np.float32)
    x[1] = 0.0
    jq, js = JKVC.quantize_pages(jnp.asarray(x))
    tq, ts = TKVC.quantize_pages(t(x))
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert ts[1].item() == 0 and np.all(tq[1].numpy() == 0)


# ---------------------------------------------------------------------------
# One transformer layer over the paged cache
# ---------------------------------------------------------------------------

def _layer_inputs(cfg, rs, C):
    B, psz, npg = 3, 4, 4
    P = 1 + B * npg
    shape = (P, psz, cfg.n_kv_heads, cfg.head_dim)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    table = (1 + np.arange(B * npg, dtype=np.int32)).reshape(B, npg)
    h = rs.randn(B, C, cfg.d_model).astype(np.float32)
    return k, v, table, h


@pytest.mark.parametrize("mode", ["probe", "commit", "prefill_chunk"])
def test_tlayer_apply_paged(pair, mode):
    cfg, jdbm, jparams, tdbm, tparams = pair
    rs = np.random.RandomState(9)
    C = 5 if mode == "prefill_chunk" else 1
    k, v, table, h = _layer_inputs(cfg, rs, C)
    lengths = np.array([0, 6, 10], np.int32)
    u = 1
    jlp = jax.tree_util.tree_map(lambda p: p[u], jparams["layers"])
    tlp = tdbm.model.unit_params(tparams)[u]
    kw = dict(lengths=lengths, page_table=table)
    if mode == "probe":
        sig = np.array([3.0, 0.5, 20.0], np.float32)
        kw.update(cond=True, commit=False)
    elif mode == "commit":
        kw.update(active=np.array([True, False, True]), commit=True)
    else:
        kw.update(n_valid=np.array([5, 2, 0], np.int32))
    jmode = tmode = "prefill_chunk" if mode == "prefill_chunk" else "decode"

    def ctx_fields(conv):
        f = {key: conv(val) for key, val in kw.items()
             if key not in ("cond", "commit")}
        f["commit"] = kw.get("commit", True)
        return f

    jctx = JCOM.LayerCtx(cfg=cfg, mode=jmode, precision=JPREC.FP32,
                         **ctx_fields(jnp.asarray))
    tctx = TCOM.LayerCtx(cfg=tdbm.cfg, mode=tmode, precision=TPREC.FP32,
                         **ctx_fields(t))
    if kw.get("cond"):
        jctx.cond = jdbm.model.cond(jparams, jnp.log(jnp.asarray(sig)))
        tctx.cond = tdbm.model.cond(tparams, torch.log(t(sig)))
    jcache = JKVC.PagedKV(jnp.asarray(k), jnp.asarray(v))
    tcache = TKVC.PagedKV(t(k), t(v))
    jh, jnew, _ = JCOM.tlayer_apply(jlp, jnp.asarray(h), jctx, cache=jcache)
    th, tnew = TCOM.tlayer_apply(tlp, t(h), tctx, cache=tcache)
    if mode == "prefill_chunk":     # rows past n_valid are discarded garbage
        for b, n in enumerate(kw["n_valid"]):
            close(th[b, :n], np.asarray(jh)[b, :n])
    else:
        close(th, jh)
    close(tnew.k[1:], np.asarray(jnew.k)[1:])
    close(tnew.v[1:], np.asarray(jnew.v)[1:])
