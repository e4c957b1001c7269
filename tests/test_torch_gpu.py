"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the serving path and the training step through the kernels
against the same paths through the plain versions.

Every test is marked ``gpu`` and skips without a CUDA device. This file
imports neither JAX nor ``tests/conftest.py``'s helpers, so it runs on a
machine that has PyTorch and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance 2e-4 (absolute and relative): fp32 outputs from identical inputs,
summed in another order. TF32 is off, so fp32 products stay fp32.
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import DBConfig, TrainConfig, get_config, reduced
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.core import training as T
from repro_torch.kernels import edm_loss as EDM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import fused_adaln as AD
from repro_torch.launch import serve as S
from repro_torch.nn.init import tree_map
# the tensor-core kernels' shapes, shared with their CPU emulations
from torch_attention_cases import TC_BWD_CASES, TF32_FWD_CASES

TOL = 2e-4
SWEEP = [(G, w, dt) for G in (1, 2, 4) for w in (None, 5)
         for dt in (torch.float32, torch.bfloat16, torch.int8)]


@pytest.fixture
def cuda():
    """The card, TF32 off; skips without one (decided here, not at import,
    so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pool(gen, dtype, P, psz, kv, hd, dev):
    shape = (P, psz, kv, hd)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        return (k, v, torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3,
                torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3)
    return (torch.randn(shape, generator=gen, device=dev).to(dtype),
            torch.randn(shape, generator=gen, device=dev).to(dtype),
            None, None)


def _table(gen, B, npg, dev):
    return (1 + torch.randperm(B * npg, generator=gen, device=dev)
            ).to(torch.int32).reshape(B, npg)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FD.SUPPORTED_HD)
@pytest.mark.parametrize("G,window,dtype", SWEEP + [(6, 64, torch.bfloat16)])
def test_flash_decode_kernel(cuda, hd, G, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(hd + G)
    B, kv, psz, npg = 4, 3, 16, 40
    k, v, ks, vs = _pool(gen, dtype, 1 + B * npg, psz, kv, hd, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([0, 1, 300, 640], dtype=torch.int32, device=cuda)
    q = torch.randn(B, kv, G, hd, generator=gen, device=cuda)
    for qq in (q, q.bfloat16()):
        n0 = FD.flash_decode.launches
        out, lse = FD.flash_decode(qq, k, v, table, lens, window=window,
                                   k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert FD.flash_decode.launches == n0 + 1
        ro, rl = FD.flash_decode_ref(qq, k, v, table, lens, window=window,
                                     k_scale=ks, v_scale=vs)
        torch.testing.assert_close(out, ro, atol=TOL, rtol=TOL)
        torch.testing.assert_close(lse, rl, atol=TOL, rtol=TOL)
        assert (out[0] == 0).all() and (lse[0] < -1e29).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FD.SUPPORTED_HD)
@pytest.mark.parametrize("G,window,dtype", SWEEP)
@pytest.mark.parametrize("C", [1, 17, 64])
def test_flash_prefill_kernel(cuda, hd, G, window, dtype, C):
    gen = torch.Generator(device=cuda).manual_seed(hd + G + C)
    B, kv, psz, npg = 3, 2, 16, 24
    k, v, ks, vs = _pool(gen, dtype, 1 + B * npg, psz, kv, hd, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([0, 64, 300], dtype=torch.int32, device=cuda)
    q = torch.randn(B, C, kv, G, hd, generator=gen, device=cuda)
    for qq in (q, q.bfloat16()):
        # every pair but bf16 q over bf16 / int8 pages takes prefill_tf32
        tc = qq.dtype == torch.bfloat16 and dtype != torch.float32
        assert FP.prefill_route(qq.dtype, dtype) == ("tc" if tc else "tf32")
        n0 = FP.flash_prefill.launches
        out = FP.flash_prefill(qq, k, v, table, lens, window=window,
                               k_scale=ks, v_scale=vs)
        again = FP.flash_prefill(qq, k, v, table, lens, window=window,
                                 k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert FP.flash_prefill.launches == n0 + 2
        assert torch.equal(out, again)
        ref = FP.flash_prefill_ref(qq, k, v, table, lens, window=window,
                                   k_scale=ks, v_scale=vs)
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)


# (q dtype, page dtype, window): the 3xTF32 route's pairs, int8 windowed
TF32_PAIRS = [(torch.float32, torch.float32, None),
              (torch.float32, torch.bfloat16, None),
              (torch.float32, torch.int8, 37),
              (torch.bfloat16, torch.float32, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FD.SUPPORTED_HD)
@pytest.mark.parametrize("q_dtype,dtype,window", TF32_PAIRS)
def test_flash_prefill_tf32_skips_the_trash_page_and_replays(cuda, hd,
                                                             q_dtype, dtype,
                                                             window):
    """prefill_tf32_kernel with the table past each slot's allocation at a
    trash page (page 0) of NaN: equal to the plain version over a clean
    trash page; captured in a CUDA graph, every replay bit-equal to the
    eager call."""
    gen = torch.Generator(device=cuda).manual_seed(hd + 3)
    B, kv, G, psz, npg, C = 3, 2, 4, 16, 20, 64
    k, v, ks, vs = _pool(gen, dtype, 1 + B * npg, psz, kv, hd, cuda)
    lens = torch.tensor([0, 30, 200], dtype=torch.int32, device=cuda)
    table = _table(gen, B, npg, cuda)
    for b, n in enumerate(lens.tolist()):      # allocated: n + C keys
        table[b, -(-(n + C) // psz):] = 0
    dirty = [x.clone() for x in (k, v)]
    for x in dirty:
        x[0] = 127 if dtype == torch.int8 else float("nan")
    if ks is not None:
        ks, vs = ks.clone(), vs.clone()
        ks[0] = vs[0] = float("nan")
    clean = (k, v, None if ks is None else ks.nan_to_num(0.0),
             None if vs is None else vs.nan_to_num(0.0))
    q = torch.randn(B, C, kv, G, hd, generator=gen, device=cuda).to(q_dtype)
    assert FP.prefill_route(q.dtype, dtype) == "tf32"
    run = lambda: FP.flash_prefill(q, *dirty, table, lens,  # noqa: E731
                                   window=window, k_scale=ks, v_scale=vs)
    eager = run()
    torch.cuda.synchronize()
    want = FP.flash_prefill_ref(q, clean[0], clean[1], table, lens,
                                window=window, k_scale=clean[2],
                                v_scale=clean[3])
    torch.testing.assert_close(eager, want, atol=TOL, rtol=TOL)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def _paged_check(kind, q, pools, table, lens, window):
    """The kernel against its plain version at TOL; returns its outputs."""
    k, v, ks, vs = pools
    kern, ref = ((FD.flash_decode, FD.flash_decode_ref) if kind == "decode"
                 else (FP.flash_prefill, FP.flash_prefill_ref))
    got = kern(q, k, v, table, lens, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = ref(q, k, v, table, lens, window=window, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_paged_kernels_over_long_histories(cuda, hd, window, dtype):
    """Histories past 1000 keys (many 32- and 64-key tiles, ~100 pages):
    decode at B*KV = 6 pairs, split across blocks, and a 64-token chunk of
    4-member groups (256 rows a KV head) on both prefill routes."""
    gen = torch.Generator(device=cuda).manual_seed(hd + (window or 0))
    B, kv, G, psz, npg = 3, 2, 4, 16, 100
    pools = _pool(gen, dtype, 1 + B * npg, psz, kv, hd, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([0, 1100, 1530], dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = FD.max_tiles(npg * psz, window)
    assert window or FD.decode_splits(B * kv, tiles, sms) > 1
    q = torch.randn(B, kv, G, hd, generator=gen, device=cuda)
    for qq in (q, q.bfloat16()):
        out, lse = _paged_check("decode", qq, pools, table, lens, window)
        assert (out[0] == 0).all() and (lse[0] < -1e29).all()
    q5 = torch.randn(B, 64, kv, G, hd, generator=gen, device=cuda)
    for qq in (q5, q5.bfloat16()):
        _paged_check("prefill", qq, pools, table, lens, window)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 64])
def test_flash_prefill_tensor_cores_int8_hd120(cuda, window):
    """h2o-danube3's prefill case on the tensor-core route: C=64, G=4,
    hd 120 (rows padded to 128 dims), int8 pages with per-page scales."""
    gen = torch.Generator(device=cuda).manual_seed(120)
    B, kv, G, psz, npg = 4, 8, 4, 16, 34
    pools = _pool(gen, torch.int8, 1 + B * npg, psz, kv, 120, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([0, 64, 200, 448], dtype=torch.int32, device=cuda)
    q = torch.randn(B, 64, kv, G, 120, generator=gen,
                    device=cuda).bfloat16()
    assert FP.prefill_route(q.dtype, pools[0].dtype) == "tc"
    _paged_check("prefill", q, pools, table, lens, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
def test_paged_kernels_never_read_the_trash_page(cuda, dtype):
    """Table entries past a slot's allocation point at the trash page
    (page 0), here full of NaN: the kernels read only the visible keys, so
    their outputs equal the plain versions' over a clean trash page."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, kv, G, hd, psz, npg, C = 3, 2, 2, 64, 16, 12, 17
    k, v, ks, vs = _pool(gen, dtype, 1 + B * npg, psz, kv, hd, cuda)
    lens = torch.tensor([0, 30, 100], dtype=torch.int32, device=cuda)
    table = _table(gen, B, npg, cuda)
    for b, n in enumerate(lens.tolist()):      # allocated: n + C keys
        table[b, -(-(n + C) // psz):] = 0
    dirty = [x.clone() for x in (k, v)]
    for x in dirty:
        x[0] = 127 if dtype == torch.int8 else float("nan")
    if ks is not None:
        ks, vs = ks.clone(), vs.clone()
        ks[0] = vs[0] = float("nan")
    q = torch.randn(B, kv, G, hd, generator=gen, device=cuda).bfloat16()
    q5 = torch.randn(B, C, kv, G, hd, generator=gen, device=cuda).bfloat16()
    clean = (k, v, None if ks is None else ks.nan_to_num(0.0),
             None if vs is None else vs.nan_to_num(0.0))
    for kind, qq in (("decode", q), ("prefill", q5)):
        for qx in (qq, qq.float()):
            kern = FD.flash_decode if kind == "decode" else FP.flash_prefill
            ref = (FD.flash_decode_ref if kind == "decode"
                   else FP.flash_prefill_ref)
            got = kern(qx, *dirty, table, lens, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            want = ref(qx, clean[0], clean[1], table, lens,
                       k_scale=clean[2], v_scale=clean[3])
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_prefill_tensor_core_route_raises_on_a_misaligned_view(cuda):
    """A bf16 q (or page pool) whose base is not 16-byte aligned is refused
    on the tensor-core route: no launch, and no re-route to the 3xTF32
    kernel or the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, kv, G, hd, psz, npg, C = 2, 2, 1, 64, 16, 4, 8
    k, v, _, _ = _pool(gen, torch.bfloat16, 1 + B * npg, psz, kv, hd, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([0, 9], dtype=torch.int32, device=cuda)
    n = B * C * kv * G * hd
    flat = torch.randn(n + 8, generator=gen, device=cuda).bfloat16()
    q_off = flat[1:n + 1].view(B, C, kv, G, hd)       # base 2 bytes off
    assert FP.prefill_route(q_off.dtype, k.dtype) == "tc"
    flat_k = torch.randn(k.numel() + 8, generator=gen,
                         device=cuda).bfloat16()
    k_off = flat_k[4:k.numel() + 4].view(k.shape)     # base 8 bytes off
    q = q_off.clone()
    n0 = FP.flash_prefill.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        FP.flash_prefill(q_off, k, v, table, lens)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FP.flash_prefill(q, k_off, v, table, lens)
    assert FP.flash_prefill.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,positions", [(512, (100, 511, 512, 2000)),
                                              (None, (0, 100, 639))])
def test_dense_decode_kernel_route_on_a_ring(cuda, dtype, window, positions):
    """The dense cache's decode through the flash-decode kernel (the cache
    viewed as one page of C keys a slot; a ring un-rotated first) against
    the reference route on the card, at h2o-danube3's head layout (8 KV
    heads of 120, 4 queries each), before, at and past the ring's wrap;
    the kernel alone over the identity view against its plain version;
    probes write nothing. Tolerance 2e-4, plus one bf16 rounding."""
    from repro_torch.nn import attention as A
    from repro_torch.nn import cache as KVC
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, KV, G, hd = 3, 8, 4, 120
    C, d = window or 640, KV * G * hd
    dims = A.AttnDims(KV * G, KV, hd)
    p = {k: (torch.randn(d, n, generator=gen, device=cuda) / d ** 0.5
             ).to(dtype) for k, n in (("wq", d), ("wk", KV * hd),
                                      ("wv", KV * hd))}
    p["wo"] = torch.eye(d, device=cuda, dtype=dtype)
    cache = {k: torch.randn(B, C, KV, hd, generator=gen, device=cuda
                            ).to(dtype) for k in "kv"}
    before = {k: t.clone() for k, t in cache.items()}
    x = torch.randn(B, 1, d, generator=gen, device=cuda).to(dtype)
    tol = 2e-4 if dtype == torch.float32 else 2.0 ** -7
    for pos in positions:
        n0 = FD.flash_decode.launches
        got, _ = A.decode_attention(p, x, dims, cache, pos, window=window,
                                    impl="kernels", commit=False)
        assert FD.flash_decode.launches == n0 + 1
        want, _ = A.decode_attention(p, x, dims, cache, pos, window=window,
                                     impl="ref", commit=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=2e-4)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    pages, table = KVC.dense_to_paged(cache["k"], cache["v"])
    lens = torch.tensor([0, 1, C - 1], dtype=torch.int32, device=cuda)
    q = torch.randn(B, KV, G, hd, generator=gen, device=cuda).to(dtype)
    out, lse = FD.flash_decode(q, pages.k, pages.v, table, lens)
    ref_out, ref_lse = FD.flash_decode_ref(q, pages.k, pages.v, table, lens)
    torch.testing.assert_close(out, ref_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lse[1:], ref_lse[1:], rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_paged_kernels_replay_in_cuda_graphs(cuda):
    """Both wrappers captured in one CUDA graph (decode split across
    blocks with its merge kernel; prefill on the tensor-core route) give
    the eager results on every replay, and the plain versions' within
    TOL."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, kv, G, hd, psz, npg, C = 2, 4, 2, 64, 16, 100, 64
    k, v, _, _ = _pool(gen, torch.bfloat16, 1 + B * npg, psz, kv, hd, cuda)
    table = _table(gen, B, npg, cuda)
    lens = torch.tensor([700, 870], dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert FD.decode_splits(B * kv, FD.max_tiles(npg * psz, None), sms) > 1
    q = torch.randn(B, kv, G, hd, generator=gen, device=cuda).bfloat16()
    q5 = torch.randn(B, C, kv, G, hd, generator=gen, device=cuda).bfloat16()
    run = lambda: (FD.flash_decode(q, k, v, table, lens),  # noqa: E731
                   FP.flash_prefill(q5, k, v, table, lens))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        for x in (*captured[0], captured[1]):
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip((*captured[0], captured[1]),
                             (*eager[0], eager[1])):
            assert torch.equal(got, want)
    torch.testing.assert_close(eager[0], FD.flash_decode_ref(
        q, k, v, table, lens), atol=TOL, rtol=TOL)
    torch.testing.assert_close(eager[1], FP.flash_prefill_ref(
        q5, k, v, table, lens), atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 2048), (3, 65, 256)])
def test_gate_residual_kernel(cuda, xdt, gdt, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, _, d = shape
    res = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    br = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    heads = torch.randn(B, 6 * d, generator=gen, device=cuda).to(gdt)
    gate = heads[:, 2 * d:3 * d]                   # strided column slice
    out = AD.gate_residual(res, br, gate)
    torch.cuda.synchronize()
    # explicit round-to-nearest adds and multiplies: bit-equal to the plain
    torch.testing.assert_close(out, AD.gate_residual_ref(res, br, gate),
                               atol=0, rtol=0)


# (B, S, d, x dtype, gate dtype, gate column offset): the forward's vector
# paths at their edges. bf16 rows of a d that is a multiple of 4 but not of
# 8 (8-byte vectors); gate slices that are not aligned to the gate vector
# (one element off: scalar gate loads); S = 1; a ragged last row tile;
# more examples than one launch's grid holds (65535).
GATE_EDGES = [(8, 1, 2048, torch.float32, torch.float32, 1),
              (65537, 1, 4, torch.float32, torch.float32, 0),
              (8, 1, 2048, torch.bfloat16, torch.bfloat16, 0),
              (3, 5, 36, torch.bfloat16, torch.bfloat16, 0),
              (3, 5, 36, torch.bfloat16, torch.float32, 1),
              (2, 67, 20, torch.float32, torch.bfloat16, 1),
              (2, 67, 24, torch.bfloat16, torch.bfloat16, 3),
              (4, 33, 2048, torch.bfloat16, torch.float32, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d,xdt,gdt,off", GATE_EDGES)
def test_gate_residual_kernel_vector_edges(cuda, B, S, d, xdt, gdt, off):
    """The forward's 16- and 8-byte vector paths and its scalar gate path,
    bit-equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d + off)
    res = torch.randn(B, S, d, generator=gen, device=cuda).to(xdt)
    br = torch.randn(B, S, d, generator=gen, device=cuda).to(xdt)
    heads = torch.randn(B, 6 * d + 8, generator=gen, device=cuda).to(gdt)
    gate = heads[:, 2 * d + off:3 * d + off]
    n0 = AD.gate_residual_fwd.launches
    out = AD.gate_residual(res, br, gate)
    torch.cuda.synchronize()
    assert AD.gate_residual_fwd.launches == n0 + 1
    torch.testing.assert_close(out, AD.gate_residual_ref(res, br, gate),
                               atol=0, rtol=0)


def _heads(gen, B, d, dtype, dev):
    """A (B, 6d) AdaLN head output: the kernels read its column slices."""
    return (0.1 * torch.randn(B, 6 * d, generator=gen, device=dev)
            ).to(dtype)


def _bf16_close(got, want):
    """fp32 tolerance, plus one bf16 rounding of the output (the kernel and
    the plain version sum in another order)."""
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=rel)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 2048), (3, 130, 256),
                                   (2, 16, 64)])
def test_gate_residual_bwd_kernel(cuda, xdt, gdt, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, _, d = shape
    br = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    g = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    gate = _heads(gen, B, d, gdt, cuda)[:, 5 * d:]       # strided slice
    n0 = AD.gate_residual_bwd.launches
    d_br, d_gate = AD.gate_residual_bwd(br, gate, g)
    torch.cuda.synchronize()
    assert AD.gate_residual_bwd.launches == n0 + 1
    r_br, r_gate = AD.gate_residual_bwd_ref(br, gate, g)
    # d_branch: one exact product, rounded as the plain version rounds it
    torch.testing.assert_close(d_br, r_br, atol=0, rtol=0)
    assert d_gate.dtype == gdt
    _bf16_close(d_gate, r_gate)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 512, 2048), (3, 130, 256),
                                   (2, 17, 64)])
def test_ln_modulate_kernels(cuda, xdt, mdt, shape):
    """Forward and backward against the plain versions, mods as strided
    slices of one head output; x off-centre so the two-pass variance
    matters."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, _, d = shape
    x = (3.0 + torch.randn(shape, generator=gen, device=cuda)).to(xdt)
    g = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    heads = _heads(gen, B, d, mdt, cuda)
    shift, scale = heads[:, :d], heads[:, d:2 * d]
    n0 = (AD.ln_modulate_fwd.launches, AD.ln_modulate_bwd.launches)
    out = AD.ln_modulate_fwd(x, scale, shift)
    dx, dsc, dsh = AD.ln_modulate_bwd(x, scale, g)
    torch.cuda.synchronize()
    assert (AD.ln_modulate_fwd.launches, AD.ln_modulate_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    _bf16_close(out, AD.ln_modulate_ref(x, scale, shift))
    for got, want in zip((dx, dsc, dsh), AD.ln_modulate_bwd_ref(x, scale,
                                                                g)):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        _bf16_close(got, want)


# (B, S, d, x dtype, mod dtype, scale offset, shift offset, extra head
# columns): the ln-modulate forward at its edges. S = 1 and a ragged
# S = 130; bf16 rows of a d that is not a multiple of 8 (8-byte vectors);
# d = 384; d wider than 512 vectors (2 and 4 vectors a thread); scale and
# shift slices off their vector alignment or with an odd row stride
# (scalar loads); more examples than one launch's grid holds.
LN_FWD_EDGES = [(8, 1, 2048, torch.bfloat16, torch.float32, 0, 0, 0),
                (8, 130, 2048, torch.bfloat16, torch.float32, 0, 0, 0),
                (8, 130, 2048, torch.float32, torch.bfloat16, 0, 0, 0),
                (3, 130, 68, torch.bfloat16, torch.bfloat16, 0, 0, 8),
                (5, 33, 68, torch.bfloat16, torch.float32, 1, 3, 0),
                (4, 70, 384, torch.float32, torch.float32, 1, 1, 1),
                (4, 70, 384, torch.bfloat16, torch.bfloat16, 0, 2, 0),
                (2, 33, 6144, torch.bfloat16, torch.float32, 0, 0, 0),
                (2, 17, 6144, torch.float32, torch.bfloat16, 2, 1, 8),
                (2, 9, 8192, torch.float32, torch.float32, 0, 0, 0),
                (65537, 1, 4, torch.float32, torch.float32, 0, 0, 0)]


def _ln_fwd_case(dev, B, S, d, xdt, mdt, soff, hoff, extra, seed):
    """(x, scale, shift) on the card: x off-centre, scale and shift column
    slices of one (B, 6d + extra) head output at the given offsets."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 + torch.randn(B, S, d, generator=gen, device=dev)).to(xdt)
    heads = (0.1 * torch.randn(B, 6 * d + extra, generator=gen, device=dev)
             ).to(mdt)
    return x, heads[:, d + soff:2 * d + soff], heads[:, hoff:d + hoff]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d,xdt,mdt,soff,hoff,extra", LN_FWD_EDGES)
def test_ln_modulate_forward_at_its_edges(cuda, B, S, d, xdt, mdt, soff,
                                          hoff, extra):
    x, scale, shift = _ln_fwd_case(cuda, B, S, d, xdt, mdt, soff, hoff,
                                   extra, d + S + soff)
    n0 = AD.ln_modulate_fwd.launches
    out = AD.ln_modulate_fwd(x, scale, shift)
    torch.cuda.synchronize()
    assert AD.ln_modulate_fwd.launches == n0 + 1
    assert out.dtype == xdt and torch.isfinite(out).all()
    _bf16_close(out, AD.ln_modulate_ref(x, scale, shift))


@pytest.mark.gpu
@pytest.mark.parametrize("B,d,dt", [(8, 2048, torch.bfloat16),
                                    (8, 2048, torch.float32),
                                    (3, 384, torch.bfloat16)])
def test_ln_modulate_forward_at_one_tile_and_a_row_either_side(cuda, B, d,
                                                              dt):
    """S at the tile the forward's plan picks for S = 512, one row less and
    one row more, each against the plain version."""
    rows = AD.launch_plan("ln_modulate_fwd", B, 512, d, dt, torch.float32,
                          cuda)["tile_rows"]
    for S in (rows - 1, rows, rows + 1):
        x, scale, shift = _ln_fwd_case(cuda, B, S, d, dt, torch.float32, 0,
                                       0, 0, S)
        _bf16_close(AD.ln_modulate_fwd(x, scale, shift),
                    AD.ln_modulate_ref(x, scale, shift))


@pytest.mark.gpu
def test_ln_modulate_forward_is_deterministic_and_replays_in_a_graph(cuda):
    """Two calls give bit-equal outputs, and calls captured in one CUDA
    graph give the eager outputs on every replay."""
    cases = [_ln_fwd_case(cuda, 8, S, 2048, torch.bfloat16, torch.float32,
                          0, 0, 0, S) for S in (512, 130)]
    cases.append(_ln_fwd_case(cuda, 4, 70, 384, torch.float32,
                              torch.float32, 1, 1, 1, 7))

    def run():
        return [AD.ln_modulate_fwd(*c) for c in cases]

    eager = run()
    again = run()
    torch.cuda.synchronize()
    for a, b in zip(eager, again):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


# (B, S, d, x dtype, vector dtype, vector column offset, extra head
# columns): the redesigned AdaLN backwards at their edges. The two-pass
# main case and DiT-S/2's fp32 step; S = 1, 2 and 130 (a ragged last tile);
# bf16 rows of a d that is not a multiple of 8 (8-byte vectors); vector
# slices off their vector alignment or with an odd row stride (scalar
# loads); d wider than 512 vectors (2 and 4 vectors a thread, the last past
# 48 KB of shared memory); more examples than one launch's grid holds.
ADALN_BWD_EDGES = [(8, 512, 2048, torch.bfloat16, torch.float32, 0, 0),
                   (256, 256, 384, torch.float32, torch.float32, 0, 0),
                   (8, 1, 2048, torch.bfloat16, torch.bfloat16, 0, 0),
                   (8, 2, 2048, torch.float32, torch.float32, 0, 0),
                   (8, 130, 2048, torch.bfloat16, torch.float32, 0, 0),
                   (3, 130, 68, torch.bfloat16, torch.bfloat16, 0, 8),
                   (5, 33, 68, torch.bfloat16, torch.float32, 1, 0),
                   (4, 70, 384, torch.float32, torch.float32, 1, 1),
                   (4, 70, 384, torch.float32, torch.bfloat16, 3, 1),
                   (2, 57, 2048, torch.bfloat16, torch.bfloat16, 2, 8),
                   (2, 33, 6144, torch.bfloat16, torch.float32, 0, 0),
                   (2, 9, 8192, torch.float32, torch.float32, 0, 0),
                   (65537, 1, 4, torch.float32, torch.float32, 0, 0)]


def _adaln_bwd_case(dev, B, S, d, xdt, mdt, off, extra, seed):
    """(x, g, scale, gate) on the card: x off-centre, scale and gate column
    slices at offset off of one (B, 6d + extra) head output."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (2.0 + torch.randn(B, S, d, generator=gen, device=dev)).to(xdt)
    g = torch.randn(B, S, d, generator=gen, device=dev).to(xdt)
    heads = (0.1 * torch.randn(B, 6 * d + extra, generator=gen, device=dev)
             ).to(mdt)
    return x, g, heads[:, d + off:2 * d + off], \
        heads[:, 2 * d + off:3 * d + off]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d,xdt,mdt,off,extra", ADALN_BWD_EDGES)
def test_adaln_backward_kernels_at_their_edges(cuda, B, S, d, xdt, mdt, off,
                                               extra):
    """Both redesigned backwards against their plain versions: d_branch
    bit-equal, dx and the (B, d) sums within one bf16 rounding; one launch
    each, whatever the plan."""
    x, g, scale, gate = _adaln_bwd_case(cuda, B, S, d, xdt, mdt, off, extra,
                                        d + S + off)
    n0 = (AD.ln_modulate_bwd.launches, AD.gate_residual_bwd.launches)
    got_ln = AD.ln_modulate_bwd(x, scale, g)
    got_gate = AD.gate_residual_bwd(x, gate, g)
    torch.cuda.synchronize()
    assert (AD.ln_modulate_bwd.launches, AD.gate_residual_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    for got, want in zip(got_ln, AD.ln_modulate_bwd_ref(x, scale, g)):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        _bf16_close(got, want)
    r_br, r_gate = AD.gate_residual_bwd_ref(x, gate, g)
    torch.testing.assert_close(got_gate[0], r_br, atol=0, rtol=0)
    assert got_gate[1].dtype == mdt
    _bf16_close(got_gate[1], r_gate)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ln_modulate_bwd", "gate_residual_bwd"])
@pytest.mark.parametrize("B,d,dt", [(8, 2048, torch.bfloat16),
                                    (8, 2048, torch.float32),
                                    (1, 384, torch.float32)])
def test_adaln_backward_at_one_tile_and_a_row_either_side(cuda, name, B, d,
                                                         dt):
    """S at the tile the kernel's plan picks for S = 512, one row less and
    one row more, each against the plain version."""
    rows = AD.launch_plan(name, B, 512, d, dt, torch.float32,
                            cuda)["tile_rows"]
    kern, ref = getattr(AD, name), getattr(AD, name + "_ref")
    for S in (rows - 1, rows, rows + 1):
        x, g, scale, _ = _adaln_bwd_case(cuda, B, S, d, dt, torch.float32,
                                         0, 0, S)
        for got, want in zip(kern(x, scale, g), ref(x, scale, g)):
            _bf16_close(got, want)


@pytest.mark.gpu
def test_adaln_backward_is_deterministic_and_replays_in_a_graph(cuda):
    """Two calls give bit-equal results (the tiles' sums are combined in a
    fixed order), and both backwards captured in one CUDA graph give the
    eager results on every replay (the tickets are left at zero)."""
    cases = [_adaln_bwd_case(cuda, 8, S, 2048, torch.bfloat16,
                             torch.float32, 0, 0, S) for S in (512, 130)]
    cases.append(_adaln_bwd_case(cuda, 256, 256, 384, torch.float32,
                                 torch.float32, 0, 0, 7))

    def run():
        return [t for x, g, sc, gate in cases
                for t in (*AD.ln_modulate_bwd(x, sc, g),
                          *AD.gate_residual_bwd(x, gate, g))]

    eager = run()
    again = run()
    torch.cuda.synchronize()
    for a, b in zip(eager, again):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_ln_modulate_autograd_on_cuda(cuda, xdt):
    """Gradients reach x, scale and shift through the ln-modulate Function
    on CUDA tensors, by the backward kernel, and equal the plain
    versions'."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, S, d = 4, 70, 256
    x = (1.0 + torch.randn(B, S, d, generator=gen, device=cuda)).to(xdt) \
        .requires_grad_()
    heads = _heads(gen, B, d, torch.float32, cuda).requires_grad_()
    n0 = AD.ln_modulate_bwd.launches
    out = AD.ln_modulate(x, heads[:, d:2 * d], heads[:, :d])
    assert out.grad_fn is not None
    g = torch.randn(B, S, d, generator=gen, device=cuda).to(xdt)
    out.backward(g)
    torch.cuda.synchronize()
    assert AD.ln_modulate_bwd.launches == n0 + 1
    r_dx, r_sc, r_sh = AD.ln_modulate_bwd_ref(x.detach(),
                                              heads.detach()[:, d:2 * d], g)
    _bf16_close(x.grad, r_dx)
    _bf16_close(heads.grad[:, d:2 * d], r_sc)
    _bf16_close(heads.grad[:, :d], r_sh)
    assert (heads.grad[:, 2 * d:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("S,block_rows", [(512, 256), (130, 256), (130, 64),
                                          (16, 256)])
def test_edm_loss_kernels(cuda, S, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, d = 4, 256
    f, z, y = (torch.randn(B, S, d, generator=gen, device=cuda)
               for _ in range(3))
    sigma = torch.rand(B, generator=gen, device=cuda) * 3 + 0.01
    cs, co = EDM._coeffs(sigma, 0.5)
    br = min(block_rows, S)
    part = EDM.edm_loss_fwd(f, z, y, cs, co, br)
    g = torch.randn(part.shape, generator=gen, device=cuda)
    grads = EDM.edm_loss_bwd(f, z, y, cs, co, g, br)
    torch.cuda.synchronize()
    torch.testing.assert_close(part, EDM.edm_loss_partials_ref(
        f, z, y, cs, co, br), atol=TOL, rtol=TOL)
    # explicit round-to-nearest operations in the plain version's order
    for got, want in zip(grads, EDM.edm_loss_bwd_ref(f, z, y, cs, co, g,
                                                     br)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    # through the autograd.Function: grads of the scalar loss
    fs = [x.clone().requires_grad_() for x in (f, z, y)]
    n0 = (EDM.edm_loss_fwd.launches, EDM.edm_loss_bwd.launches)
    loss = EDM.edm_loss(*fs, sigma, 0.5)
    loss.backward()
    assert (EDM.edm_loss_fwd.launches, EDM.edm_loss_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    ref = [x.clone().requires_grad_() for x in (f, z, y)]
    c_skip, c_out = cs[:, None, None], co[:, None, None]
    want = ((ref[0] - (ref[2] - c_skip * ref[1]) / c_out) ** 2).mean()
    want.backward()
    torch.testing.assert_close(loss, want, atol=TOL, rtol=TOL)
    for a, r in zip(fs, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_gate_residual_autograd_on_cuda(cuda, xdt):
    """Gradients reach res, branch and the gate slice through the
    gate-residual Function on CUDA tensors, by the backward kernel, and
    equal the plain versions'; d res is the cotangent itself."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, S, d = 4, 70, 256
    res, br = (torch.randn(B, S, d, generator=gen, device=cuda).to(xdt)
               .requires_grad_() for _ in range(2))
    heads = _heads(gen, B, d, torch.float32, cuda).requires_grad_()
    n0 = AD.gate_residual_bwd.launches
    out = AD.gate_residual(res, br, heads[:, 2 * d:3 * d])
    assert out.grad_fn is not None
    g = torch.randn(B, S, d, generator=gen, device=cuda).to(xdt)
    out.backward(g)
    torch.cuda.synchronize()
    assert AD.gate_residual_bwd.launches == n0 + 1
    assert torch.equal(res.grad, g)
    r_br, r_gate = AD.gate_residual_bwd_ref(br.detach(),
                                            heads.detach()[:, 2 * d:3 * d], g)
    torch.testing.assert_close(br.grad, r_br, atol=0, rtol=0)
    _bf16_close(heads.grad[:, 2 * d:3 * d], r_gate)
    assert (heads.grad[:, :2 * d] == 0).all()


# (B, S, d, z dtype, F dtype, F strided): chip_smoke.py phase 3's cases (the
# DiT sampler at 256 samples, the recurrent sampler's strided F, bf16, a
# ragged S) and the 1-wide path (d not a multiple of 4)
EULER_SHAPES = [(256, 256, 16, torch.float32, torch.float32, False),
                (8, 512, 512, torch.float32, torch.float32, True),
                (8, 512, 512, torch.bfloat16, torch.bfloat16, False),
                (8, 512, 512, torch.float32, torch.bfloat16, True),
                (3, 130, 64, torch.float32, torch.float32, True),
                (2, 9, 18, torch.bfloat16, torch.bfloat16, True)]


def _euler_case(gen, B, S, d, zdt, fdt, strided, dev):
    z = torch.randn(B, S, d, generator=gen, device=dev).to(zdt)
    f2 = torch.randn(B, 2 * S, d, generator=gen, device=dev).to(fdt)
    f = f2[:, S:] if strided else f2[:, :S].contiguous()
    sigma = torch.rand(B, generator=gen, device=dev) * 40 + 0.01
    sigma_to = sigma * torch.rand(B, generator=gen, device=dev)
    sigma_to[0] = 0.0                         # the chain's last step
    return z, f, sigma, sigma_to


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d,zdt,fdt,strided", EULER_SHAPES)
def test_euler_kernels(cuda, B, S, d, zdt, fdt, strided):
    """Forward and backward against their plain versions: bit-equal (the
    same round-to-nearest operations in the same order)."""
    gen = torch.Generator(device=cuda).manual_seed(B + S + d)
    z, f, sigma, sigma_to = _euler_case(gen, B, S, d, zdt, fdt, strided,
                                        cuda)
    a, b = AD.euler_coeffs(sigma, sigma_to, 0.5)
    n0, m0 = AD.euler_fwd.launches, AD.euler_bwd.launches
    out = AD.euler_fwd(z, f, a, b)
    g = torch.randn(B, S, d, generator=gen, device=cuda).to(zdt)
    dz, df = AD.euler_bwd(g, a, b)
    torch.cuda.synchronize()
    assert (AD.euler_fwd.launches, AD.euler_bwd.launches) == (n0 + 1, m0 + 1)
    assert out.dtype == zdt and out.is_contiguous()
    torch.testing.assert_close(out, AD.euler_ref(z, f, a, b), atol=0, rtol=0)
    for got, want in zip((dz, df), AD.euler_bwd_ref(g, a, b)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_euler_autograd_on_cuda(cuda):
    """``torch.autograd.grad`` through ``fused_euler`` on the card runs the
    backward kernel and gives the plain versions' gradients; σ gets none."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    z, f, sigma, sigma_to = _euler_case(gen, 8, 512, 512, torch.float32,
                                        torch.float32, True, cuda)
    z.requires_grad_()
    f2 = f.detach().clone().requires_grad_()
    n0 = AD.euler_bwd.launches
    out = AD.fused_euler(z, f2, sigma, sigma_to, 0.5)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=gen, device=cuda)
    dz, df = torch.autograd.grad(out, (z, f2), g)
    torch.cuda.synchronize()
    assert AD.euler_bwd.launches == n0 + 1
    a, b = AD.euler_coeffs(sigma, sigma_to, 0.5)
    for got, want in zip((dz, df), AD.euler_bwd_ref(g, a, b)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_euler_rejects_what_the_kernel_does_not_take(cuda):
    z = torch.randn(2, 5, 16, device=cuda)
    a = torch.rand(2, device=cuda)
    with pytest.raises(TypeError, match="fp32"):
        AD.euler_fwd(z, z, a.double(), a)
    with pytest.raises(TypeError, match="bf16 F"):
        AD.euler_fwd(z.bfloat16(), z, a, a)
    with pytest.raises(ValueError, match="unit stride"):
        AD.euler_fwd(z, z.transpose(1, 2).contiguous().transpose(1, 2), a, a)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        AD.euler_fwd(z, z, a[:1], a)
    with pytest.raises(ValueError, match="CUDA"):
        AD.euler_fwd(z, z.cpu(), a, a)
    with pytest.raises(ValueError, match="contiguous"):
        AD.euler_bwd(z[:, ::2], a, a)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 2, 1, 96, device=cuda)
    pages = torch.randn(5, 4, 2, 96, device=cuda)
    table = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="head_dim"):
        FD.flash_decode(q, pages, pages, table, lens)
    q, pages = q[..., :64].contiguous(), pages[..., :64].contiguous()
    with pytest.raises(TypeError, match="int32"):
        FD.flash_decode(q, pages, pages, table.long(), lens)
    with pytest.raises(ValueError, match="scale"):
        FD.flash_decode(q, pages.to(torch.int8), pages.to(torch.int8),
                        table, lens)
    q5 = torch.randn(2, 1, 2, 1, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        FP.flash_prefill(q5, pages, pages, table, lens)
    # the row-wise kernels: (B, S, d) streams, (B, d) vectors
    x = torch.randn(2, 5, 64, device=cuda)
    vec = torch.randn(2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="multiple of 4"):
        AD.ln_modulate_fwd(x[..., :62].contiguous(), vec[:, :62],
                           vec[:, :62])
    with pytest.raises(ValueError, match="contiguous"):
        AD.ln_modulate_bwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                           vec, x)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        AD.ln_modulate_fwd(x, vec, vec.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        AD.gate_residual_fwd(x, x, torch.randn(64, 2, device=cuda).T)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        AD.gate_residual_bwd(x, vec, x.bfloat16())
    with pytest.raises(ValueError, match=r"\(B, d\)"):
        AD.gate_residual_bwd(x, vec[:1], x)
    cs = torch.rand(2, device=cuda) + 0.5
    with pytest.raises(TypeError, match="fp32"):
        EDM.edm_loss_fwd(x.bfloat16(), x, x, cs, cs)
    with pytest.raises(ValueError, match="contiguous"):
        EDM.edm_loss_fwd(x[:, ::2], x[:, ::2], x[:, ::2], cs, cs)
    with pytest.raises(ValueError, match="n_tiles"):
        EDM.edm_loss_bwd(x, x, x, cs, cs, torch.ones(2, 3, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "h2o-danube-3-4b"])
def test_serving_through_kernels_matches_plain_versions(cuda, arch):
    """The fp32 serving path through the kernels gives the plain versions'
    greedy tokens, and every kernel of the path was launched."""
    cfg = reduced(get_config(arch), n_layers=4, d_model=512, n_heads=8)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen,
                            device=cuda).cpu().numpy()
    z0 = dbm.db.sigma_max * torch.randn(6, 3, 1, cfg.d_model, generator=gen,
                                        device=cuda)
    outs = {}
    for impl in ("ref", "kernels"):
        K.reset_launch_counts()
        outs[impl] = S.generate(dbm, params, prompts, 6,
                                prompt_lengths=[40, 7, 23], precision="fp32",
                                impl=impl, chunk_size=16, z0=z0)
        counts = K.launch_counts()
        if impl == "ref":
            assert counts == {k: 0 for k in counts}
        else:
            L = cfg.n_layers
            assert counts == {**{k: 0 for k in counts},
                              "flash_decode": 6 * 2 * L,
                              "flash_prefill": 3 * L,
                              "gate_residual": 6 * 2 * L}
    assert torch.equal(outs["ref"], outs["kernels"])


def _serving_model(cuda):
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=4, d_model=512,
                  n_heads=8)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params


def _continuous(dbm, params, cuda, graphs, precision, **kw):
    """A drained continuous run: 6 ragged requests (3 opening with one
    shared 20-token prefix) on 3 slots; returns the batcher, its finished
    requests and its launch counts."""
    cb = S.ContinuousBatcher(
        dbm, params, num_slots=3, page_size=16, max_prompt=48, max_len=64,
        seg_len=4, chunk_size=16, precision=precision, prefix_cache=True,
        graphs=graphs, generator=torch.Generator(device=cuda).manual_seed(3),
        **kw)
    gen = torch.Generator().manual_seed(1)
    sys_p = torch.randint(0, dbm.cfg.vocab_size, (20,), generator=gen)
    for i, n in enumerate((40, 9, 23, 31, 12, 17)):
        p = torch.randint(0, dbm.cfg.vocab_size, (n,), generator=gen)
        cb.submit((torch.cat([sys_p, p])[:48] if i % 2 else p).numpy(), 12)
    K.reset_launch_counts()
    done = cb.run()
    torch.cuda.synchronize()
    return cb, done, K.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bf16", "bf16_kvint8", "fp32"])
def test_continuous_graph_segments_bit_equal_to_eager(cuda, precision):
    """The batcher's chunk steps and decode segments replayed from their
    CUDA graphs give the eager dispatches' tokens and a bit-equal pool
    (page 0, the trash page, takes racing writes of idle slots), and the
    launch counts equal the path's arithmetic with graphs on: a capture's
    launches are counted at each replay, its eager warm-up once."""
    dbm, params = _serving_model(cuda)
    L = dbm.cfg.n_layers
    runs = {g: _continuous(dbm, params, cuda, g, precision)
            for g in (False, True)}
    (ce, de, ne), (cg, dg, ng) = runs[False], runs[True]
    assert [r.out for r in dg] == [r.out for r in de]
    assert all(len(r.out) == 12 for r in dg)
    assert cg.prefix.hits >= 1 and cg.cow_copies >= 1
    for a, b in zip(_pool_tensors(cg.kv), _pool_tensors(ce.kv)):
        assert torch.equal(a[:, 1:], b[:, 1:])
    for cb, counts in ((ce, ne), (cg, ng)):
        decode = 2 * L * (cb.steps + cb.graph_warmups["segment"])
        prefill = L * (cb.ingest_dispatches + cb.graph_warmups["chunk"])
        assert counts == {**{k: 0 for k in counts}, "flash_decode": decode,
                          "gate_residual": decode, "flash_prefill": prefill}
    assert cg.graph_warmups == {"chunk": 1, "segment": 1}
    assert ce.graph_warmups == {"chunk": 0, "segment": 0}


def _pool_tensors(pkv):
    return [t for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
            if t is not None]


@pytest.mark.gpu
def test_continuous_pool_storage_survives_cow_restore_reset(cuda):
    """Copy-on-write, spill and restore (forced and under pool pressure)
    and the slot reset write into the pool's own storage: its tensors'
    addresses never change, so the captured segment stays valid, and the
    run still matches the eager one."""
    from repro_torch.nn import cache as KVC
    dbm, params = _serving_model(cuda)
    outs = {}
    for graphs in (False, True):
        cb = S.ContinuousBatcher(
            dbm, params, num_slots=3, page_size=16, max_prompt=48,
            max_len=64, seg_len=4, chunk_size=16, prefix_cache=True,
            total_pages=10, graphs=graphs,
            generator=torch.Generator(device=cuda).manual_seed(5))
        ptrs = KVC.pool_ptrs(cb.kv)
        gen = torch.Generator().manual_seed(2)
        sys_p = torch.randint(0, dbm.cfg.vocab_size, (24,), generator=gen)
        for i in range(5):
            p = torch.randint(0, dbm.cfg.vocab_size, (6,), generator=gen)
            cb.submit(torch.cat([sys_p, p]).numpy(), 16,
                      priority="interactive" if i == 3 else "batch")
        done, step = [], 0
        while cb.has_work():
            if step == 3 and cb.slot_req[0] is not None:
                cb.preempt(cb.slot_req[0].rid)
            done.extend(cb.step())
            cb.kv = dbm.model.reset_paged_slots(
                cb.kv, torch.ones(3, dtype=torch.bool))
            assert KVC.pool_ptrs(cb.kv) == ptrs
            step += 1
        assert cb.preemptions >= 1 and cb.restores == cb.preemptions
        assert cb.cow_copies >= 1
        assert len(cb.free_pages) + len(cb.page_refs) == cb.total_pages - 1
        outs[graphs] = sorted((r.rid, r.out) for r in done)
    assert outs[True] == outs[False]


@pytest.mark.gpu
def test_capture_of_a_launch_on_another_stream_raises(cuda, monkeypatch):
    """A launcher that put its kernel on the legacy default stream instead
    of the current one would run it once, outside the capture, and CUDA
    raises nothing (the capture stream does not synchronise with that
    one): the batcher's capture finds the kernel missing from the graph
    and raises."""
    dbm, params = _serving_model(cuda)
    real = FD._kernel()
    monkeypatch.setattr(FD, "_kernel", lambda: lambda *a: real(*a[:-1], 0))
    cb = S.ContinuousBatcher(dbm, params, num_slots=2, page_size=16,
                             max_prompt=32, max_len=48, seg_len=2,
                             chunk_size=16)
    with pytest.raises(RuntimeError, match="outside the capture stream"):
        cb.capture()
    torch.cuda.synchronize()


# kind -> (Sq, Sk, window, mask_seq); lengths that are not multiples of the
# kernels' 64-row tiles
FA_CASES = {"full": (100, 190, None, None), "causal": (200, 200, None, None),
            "window": (200, 200, 37, None), "db_concat": (260, 260, None, 130),
            "two_pass": (130, 260, None, 130)}


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype,hd", [(dt, hd) for dt, dims in
                                      FA.HEAD_DIMS.items() for hd in dims])
@pytest.mark.parametrize("kind", sorted(FA_CASES))
def test_flash_attention_kernels(cuda, kind, dtype, hd, G):
    """Forward (out, lse), dq and dk/dv against the plain versions, on
    (B, S, H, hd) tensors passed as transposed views, as the model does."""
    Sq, Sk, window, mseq = FA_CASES[kind]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(hd + G)
    B, KV = 2, 2
    mk = lambda S, H: torch.randn(B, S, H, hd, generator=gen, device=cuda  # noqa: E731
                                  ).to(dtype).transpose(1, 2)
    q, k, v, do = mk(Sq, KV * G), mk(Sk, KV), mk(Sk, KV), mk(Sq, KV * G)
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert n1[name] == n0[name] + 1
    assert out.stride() == q.stride() and dk.stride() == k.stride()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    rdelta = FA.attention_delta(ro, do)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, rl, rdelta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, rl, rdelta, cfg)
    # bf16 outputs round once, in another order than the plain version:
    # one bf16 ulp of the largest value
    tol = TOL if dtype == torch.float32 else 1e-2
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
def test_flash_attention_autograd_and_empty_rows(cuda):
    """Through the autograd.Function: a two_pass query whose keys are cut
    off (row 0 sees nothing) gives out = 0 and zero gradients, never NaN;
    grads match the plain versions'."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    S = 70
    q, k, v = (torch.randn(2, 4, S, 64, generator=gen, device=cuda
                           ).requires_grad_() for _ in range(3))
    do = torch.randn(2, 4, S, 64, generator=gen, device=cuda)
    out = FA.flash_attention(q, k, v, mask_kind="two_pass", mask_seq=S)
    out.backward(do)
    assert (out[:, :, 0] == 0).all() and (q.grad[:, :, 0] == 0).all()
    cfg = FA.FlashConfig("two_pass", mask_seq=S)
    ro, rl = FA.flash_attention_fwd_ref(q.detach(), k.detach(), v.detach(),
                                        cfg)
    want = FA.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      ro, rl, do, cfg)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_flash_attention_bf16_empty_row(cuda):
    """bf16 (the tensor-core forward): a two_pass query whose keys are cut
    off (row 0 sees nothing) gives out = 0 exactly and a finite lse at
    -1e30; the other rows match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    S = 70
    q, k, v = (torch.randn(2, 4, S, 64, generator=gen, device=cuda
                           ).bfloat16() for _ in range(3))
    cfg = FA.FlashConfig("two_pass", mask_seq=S)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    torch.cuda.synchronize()
    assert (out[:, :, 0] == 0).all()
    assert torch.isfinite(lse).all() and (lse[:, :, 0] <= -1e29).all()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    torch.testing.assert_close(out.float(), ro.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse, rl, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["causal", "db_concat"])
def test_flash_attention_bf16_long_ragged(cuda, kind):
    """Sq = Sk = 1000: sixteen 64-key tiles, more than the forward's two
    ring stages, the last one ragged; every kernel against its plain
    version as in test_flash_attention_kernels."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    S = 1000
    cfg = FA.FlashConfig(kind, mask_seq=S // 2 if kind == "db_concat"
                         else None)
    mk = lambda: torch.randn(1, S, 4, 64, generator=gen, device=cuda  # noqa: E731
                             ).bfloat16().transpose(1, 2)
    q, k, v, do = mk(), mk(), mk(), mk()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    rdelta = FA.attention_delta(ro, do)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, rl, rdelta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, rl, rdelta, cfg)
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.gpu
def test_flash_attention_bf16_refuses_unaligned_views(cuda):
    """The tensor-core forward copies 16-byte chunks: a bf16 tensor whose
    sequence stride is not a multiple of 8 elements, or whose base is not
    16-byte aligned, raises (no fallback); fp32 takes both."""
    cfg = FA.FlashConfig("causal")
    x = torch.randn(1, 2, 8, 64, device=cuda).bfloat16()
    odd = torch.randn(1, 2, 8, 68, device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError, match="bf16 k must start on a 16-byte"):
        FA.flash_attention_fwd(x, odd, x, cfg)
    shifted = torch.randn(2 * 8 * 64 + 1, device=cuda).bfloat16()[1:]
    with pytest.raises(ValueError, match="bf16 q must start on a 16-byte"):
        FA.flash_attention_fwd(shifted.view(1, 2, 8, 64), x, x, cfg)
    oddf = torch.randn(1, 2, 8, 68, device=cuda)[..., :64]
    FA.flash_attention_fwd(oddf, oddf, oddf, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TF32_FWD_CASES))
def test_flash_attention_bf16_hd120_gqa(cuda, name):
    """fwd_tc_kernel, dq_tc_kernel and dkv_tc_kernel at hd 120
    (h2o-danube3-4b's head dim, run in hd 128's tiles with a zero pad) and
    4 query heads a KV head: ragged S = 1000 (the last key tile 40 long),
    a window of 200 that binds, and a row that sees no key (out = 0, lse =
    -1e30, dq = 0), against the plain versions on the kernel forward's lse
    and delta (bf16 outputs: one rounding, as test_flash_attention_kernels
    holds them)."""
    kind, Sq, Sk, window, mseq = TF32_FWD_CASES[name]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(120 + Sq + Sk)
    B, KV, G = 2, 2, 4
    mk = lambda S, H: torch.randn(B, S, H, 120, generator=gen,  # noqa: E731
                                  device=cuda).bfloat16().transpose(1, 2)
    q, k, v, do = mk(Sq, KV * G), mk(Sk, KV), mk(Sk, KV), mk(Sq, KV * G)
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)
    if name == "two_pass, cut keys":
        assert (out[:, :, 0] == 0).all() and (lse[:, :, 0] <= -1e29).all()
        assert (dq[:, :, 0] == 0).all()


def _padded(gen, dev, dtype, B, S, H, fill):
    """(B, H, S, 120) views of (B, S, H, 128) buffers whose columns 120-127
    hold ``fill``, and the buffers."""
    buf = torch.randn(B, S, H, 128, generator=gen, device=dev).to(dtype)
    buf[..., 120:] = fill
    return buf[..., :120].transpose(1, 2), buf


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["window", "db_concat"])
def test_flash_attention_hd120_never_touches_columns_past_120(cuda, dtype,
                                                              kind):
    """q, k, v and dO as [..., :120] views of 128-wide buffers whose
    columns 120-127 hold NaN: the loaders must zero-fill the tiles' pad,
    never read it. out, dq, dk and dv written (through the kernels' own C
    entry points, as the wrappers launch them) into [..., :120] views of
    128-wide buffers holding a sentinel there: the stores must stop at 120.
    Results finite and equal to the plain versions', sentinels unchanged,
    G = 4."""
    cfg = FA.FlashConfig(kind, window=37 if kind == "window" else None,
                         mask_seq=130 if kind == "db_concat" else None)
    gen = torch.Generator(device=cuda).manual_seed(121)
    B, KV, G, S = 2, 2, 4, 260
    nan = float("nan")
    q, _ = _padded(gen, cuda, dtype, B, S, KV * G, nan)
    k, _ = _padded(gen, cuda, dtype, B, S, KV, nan)
    v, _ = _padded(gen, cuda, dtype, B, S, KV, nan)
    do, _ = _padded(gen, cuda, dtype, B, S, KV * G, nan)
    sentinel = 7.0
    (o, obuf), (dq, qbuf), (dk, kbuf), (dv, vbuf) = (
        _padded(gen, cuda, dtype, B, S, H, sentinel)
        for H in (KV * G, KV * G, KV, KV))
    lse = torch.empty(B, KV * G, S, device=cuda)
    FA._launch("flash_attention_fwd", "rt_flash_attention_fwd", q,
               FA._args(cfg, q, k, v=v, o=o, lse=lse), "fwd")
    delta = FA.attention_delta(o, do)
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dq", q,
               FA._args(cfg, q, k, v=v, dout=do, dq=dq, lse=lse,
                        delta=delta), "dq")
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dkv", q,
               FA._args(cfg, q, k, v=v, dout=do, dk=dk, dv=dv, lse=lse,
                        delta=delta), "dkv")
    torch.cuda.synchronize()
    for buf in (obuf, qbuf, kbuf, vbuf):
        assert (buf[..., 120:] == sentinel).all()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    for got, ref in zip((o, lse, dq, dk, dv), want):
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            _within_fp32_bound(got, ref)
        else:
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                       rtol=1e-2)


# (Sq, Sk) of the ``full`` kind with fewer or more keys than queries:
# whisper's cross-attention (the DB concat stream of 2 x 448 over 1500
# frames), fewer keys than one 64-key tile, and a ragged 130 keys under
# 1000 queries
FULL_SQ_SK = [(896, 1500), (64, 37), (1000, 130)]


def _full_check(got, want, dtype):
    for g, r in zip(got, want):
        if dtype == torch.float32:
            _within_fp32_bound(g, r)
        else:
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g.float(), r.float(), atol=1e-2,
                                       rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", FULL_SQ_SK)
def test_flash_attention_full_with_other_key_count(cuda, dtype, Sq, Sk):
    """The forward, dq and dk/dv kernels in the ``full`` kind (the
    encoder-decoder's cross-attention) at Sq != Sk, hd 64, 4 heads: the
    last key tile partial (or the only one), the dk/dv grid over Sk's tiles
    reading every query tile; against the plain versions on the kernel
    forward's lse and delta (indexed by Sq), as test_flash_attention_kernels
    holds them."""
    cfg = FA.FlashConfig("full")
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    B, H = 2, 4
    mk = lambda S: torch.randn(B, S, H, 64, generator=gen,  # noqa: E731
                               device=cuda).to(dtype).transpose(1, 2)
    q, k, v, do = mk(Sq), mk(Sk), mk(Sk), mk(Sq)
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    assert lse.shape == (B, H, Sq) and dk.shape == k.shape
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    _full_check((out, lse, dq, dk, dv), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", FULL_SQ_SK)
def test_flash_attention_full_never_touches_rows_past_the_sequences(
        cuda, dtype, Sq, Sk):
    """q, dO (rows past Sq) and k, v (rows past Sk) as [:, :S] views of
    buffers 70 rows longer whose extra rows hold NaN: the loaders must
    zero-fill a partial tile's rows past the sequence, never read them.
    out and dq (past Sq) and dk, dv (past Sk) written through the kernels'
    own C entry points into views of longer buffers holding a sentinel
    there: the stores must stop at the sequence. Results finite and equal
    to the plain versions', sentinels unchanged."""
    cfg = FA.FlashConfig("full")
    gen = torch.Generator(device=cuda).manual_seed(3 * Sq + Sk)
    B, H, extra = 2, 4, 70

    def rows(S, fill):
        buf = torch.randn(B, S + extra, H, 64, generator=gen,
                          device=cuda).to(dtype)
        buf[:, S:] = fill
        return buf[:, :S].transpose(1, 2), buf

    nan, sentinel = float("nan"), 7.0
    (q, _), (k, _), (v, _), (do, _) = (rows(S, nan)
                                       for S in (Sq, Sk, Sk, Sq))
    (o, obuf), (dq, qbuf), (dk, kbuf), (dv, vbuf) = (
        rows(S, sentinel) for S in (Sq, Sq, Sk, Sk))
    lse = torch.empty(B, H, Sq, device=cuda)
    FA._launch("flash_attention_fwd", "rt_flash_attention_fwd", q,
               FA._args(cfg, q, k, v=v, o=o, lse=lse), "fwd")
    delta = FA.attention_delta(o, do)
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dq", q,
               FA._args(cfg, q, k, v=v, dout=do, dq=dq, lse=lse,
                        delta=delta), "dq")
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dkv", q,
               FA._args(cfg, q, k, v=v, dout=do, dk=dk, dv=dv, lse=lse,
                        delta=delta), "dkv")
    torch.cuda.synchronize()
    for buf, S in ((obuf, Sq), (qbuf, Sq), (kbuf, Sk), (vbuf, Sk)):
        assert (buf[:, S:] == sentinel).all()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    _full_check((o, lse, dq, dk, dv), want, dtype)


# (Sq, Sk) of the ``full`` kind with 4 query heads a KV head at hd 128:
# the VLM's cross-attention (the DB concat stream of 2 x 512 queries over
# 1601 image tokens, one key in the last 64-key tile), one key past a tile,
# and one key under 130 queries
FULL_GQA_SQ_SK = [(1024, 1601), (64, 65), (130, 1)]


def _gqa_rows(gen, cuda, dtype, B, S, heads, extra=0, fill=None):
    """(B, heads, S, 128) views of (B, S + extra, heads, 128) buffers whose
    rows past S hold ``fill``; returns (view, buffer)."""
    buf = torch.randn(B, S + extra, heads, 128, generator=gen,
                      device=cuda).to(dtype)
    if extra:
        buf[:, S:] = fill
    return buf[:, :S].transpose(1, 2), buf


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", FULL_GQA_SQ_SK)
def test_flash_attention_full_gqa_hd128(cuda, dtype, Sq, Sk):
    """The forward, dq and dk/dv kernels in the ``full`` kind at Sq != Sk
    with 8 query heads on 2 KV heads of 128 (the VLM's GQA 4:1): dk and dv
    sum the group's 4 query heads over every query tile, lse and delta are
    read by the query head; against the plain versions on the kernel
    forward's lse and delta, and through the autograd Function
    (``flash_attention``) against the plain backward."""
    cfg = FA.FlashConfig("full")
    gen = torch.Generator(device=cuda).manual_seed(Sq + 7 * Sk)
    B, H, KV = 2, 8, 2
    q, k, v, do = (_gqa_rows(gen, cuda, dtype, B, S, h)[0]
                   for S, h in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H)))
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    assert lse.shape == (B, H, Sq) and dk.shape == k.shape == (B, KV, Sk,
                                                               128)
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    _full_check((out, lse, dq, dk, dv), want, dtype)
    qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(FA.flash_attention(qa, ka, va,
                                                 mask_kind="full"),
                              (qa, ka, va), do)
    ref = FA.flash_attention_bwd_ref(q, k, v, ro.to(dtype), rl, do, cfg)
    _full_check(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", FULL_GQA_SQ_SK)
def test_flash_attention_full_gqa_never_touches_rows_past_the_sequences(
        cuda, dtype, Sq, Sk):
    """The GQA 4:1 hd-128 ``full`` case with NaN in the rows past Sq of q
    and dO and past Sk of k and v (views of buffers 70 rows longer): every
    fill zero-fills the padded keys and masks them out of the softmax. out
    and dq past Sq and dk, dv past Sk written into views of longer buffers
    holding a sentinel there: the stores stop at the sequence. Results
    finite and equal to the plain versions', sentinels unchanged."""
    cfg = FA.FlashConfig("full")
    gen = torch.Generator(device=cuda).manual_seed(5 * Sq + Sk)
    B, H, KV, extra = 2, 8, 2, 70
    nan, sentinel = float("nan"), 7.0
    (q, _), (k, _), (v, _), (do, _) = (
        _gqa_rows(gen, cuda, dtype, B, S, h, extra, nan)
        for S, h in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H)))
    (o, obuf), (dq, qbuf), (dk, kbuf), (dv, vbuf) = (
        _gqa_rows(gen, cuda, dtype, B, S, h, extra, sentinel)
        for S, h in ((Sq, H), (Sq, H), (Sk, KV), (Sk, KV)))
    lse = torch.empty(B, H, Sq, device=cuda)
    FA._launch("flash_attention_fwd", "rt_flash_attention_fwd", q,
               FA._args(cfg, q, k, v=v, o=o, lse=lse), "fwd")
    delta = FA.attention_delta(o, do)
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dq", q,
               FA._args(cfg, q, k, v=v, dout=do, dq=dq, lse=lse,
                        delta=delta), "dq")
    FA._launch("flash_attention_bwd", "rt_flash_attention_bwd_dkv", q,
               FA._args(cfg, q, k, v=v, dout=do, dk=dk, dv=dv, lse=lse,
                        delta=delta), "dkv")
    torch.cuda.synchronize()
    for buf, S in ((obuf, Sq), (qbuf, Sq), (kbuf, Sk), (vbuf, Sk)):
        assert (buf[:, S:] == sentinel).all()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    want = (ro, rl, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)) + \
        FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    _full_check((o, lse, dq, dk, dv), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 600])
def test_moe_fwd_replays_in_a_cuda_graph(cuda, T):
    """``nn.moe.moe_fwd`` captured in a CUDA graph (no host sync: the
    routing, capacity and dispatch stay on the card) and replayed on new
    tokens in the captured buffer: bit-equal to the eager layer on those
    tokens. 8 tokens are phi3.5-moe's decode batch on 8 slots (capacity
    1 an expert), 600 shrink the group to 8; bf16, d 512, 16 experts of
    ff 256, top 2."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.nn import moe as M
    from repro_torch.nn.init import init_params
    cfg = MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25)
    gen = torch.Generator(device=cuda).manual_seed(T)
    params = init_params(M.moe_spec(512, 256, cfg, "swiglu"), gen,
                         torch.bfloat16)
    x = torch.randn(1, T, 512, generator=gen, device=cuda).to(torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        M.moe_fwd(params, x, cfg, "swiglu")          # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = M.moe_fwd(params, x, cfg, "swiglu")
    for seed in (1, 2):
        x.copy_(torch.randn(1, T, 512, generator=gen, device=cuda))
        graph.replay()
        want, want_aux = M.moe_fwd(params, x, cfg, "swiglu")
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(aux, want_aux)
        assert torch.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("name", sorted(TF32_FWD_CASES))
def test_flash_attention_tf32_forward(cuda, name, G, hd):
    """fwd_tf32_kernel (fp32, 3xTF32 on the tensor cores) against
    flash_attention_fwd_ref under the card check's fp32 bound, on inputs of
    scale 3 (where a plain tf32 product would miss it by far): ragged S =
    1000, GQA, a row that sees no key (out = 0, lse = -1e30)."""
    kind, Sq, Sk, window, mseq = TF32_FWD_CASES[name]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(hd + G + Sq + Sk)
    B, KV = 2, 2
    mk = lambda S, H: 3 * torch.randn(B, S, H, hd, generator=gen,  # noqa: E731
                                      device=cuda).transpose(1, 2)
    q, k, v = mk(Sq, KV * G), mk(Sk, KV), mk(Sk, KV)
    n0 = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    torch.cuda.synchronize()
    assert FA.flash_attention_fwd.launches == n0 + 1
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    for got, want in ((out, ro), (lse, rl)):
        err = (got - want).abs()
        assert torch.isfinite(got).all()
        assert (err <= TOL + TOL * want.abs()).all(), err.max().item()
    if name == "two_pass, cut keys":
        assert (out[:, :, 0] == 0).all() and (lse[:, :, 0] <= -1e29).all()


def _shifted(x: torch.Tensor, floats: int = 1) -> torch.Tensor:
    """A dense copy of the fp32 x that starts ``floats`` floats past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    return buf[floats:floats + x.numel()].view(x.shape).copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("layout", ["q shifted", "k, v shifted",
                                    "sequence stride hd + 2"])
def test_flash_attention_tf32_forward_4_byte_copies(cuda, layout, hd):
    """fp32 tensors the 16-byte copies cannot take (a base one float past a
    16-byte boundary, a sequence stride that is not a multiple of 4 floats)
    go through the 4-byte-copy instantiation: matched against the plain
    version under the card bound, never refused."""
    cfg = FA.FlashConfig("db_concat", mask_seq=100)
    gen = torch.Generator(device=cuda).manual_seed(hd)
    mk = lambda: torch.randn(2, 200, 4, hd, generator=gen,  # noqa: E731
                             device=cuda).transpose(1, 2)
    q, k, v = mk(), mk(), mk()
    if layout == "q shifted":
        q = _shifted(q.contiguous())
    elif layout == "k, v shifted":
        k, v = _shifted(k.contiguous()), _shifted(v.contiguous(), 3)
    else:
        wide = torch.randn(2, 4, 200, hd + 2, generator=gen, device=cuda)
        q = wide[..., :hd]
    assert not all(FA.tc_aligned(x.data_ptr(), x.stride(), 4)
                   for x in (q, k, v))
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    torch.cuda.synchronize()
    ro, rl = FA.flash_attention_fwd_ref(q, k, v, cfg)
    for got, want in ((out, ro), (lse, rl)):
        assert torch.isfinite(got).all()
        assert ((got - want).abs() <= TOL + TOL * want.abs()).all()


# the fp32 backward's inputs are of scale 2: its gradients' errors grow
# steeply with the scale, and at scale 3 the fp32 plain version itself misses
# the card bound against its formulas in fp64
# (tests/test_torch_attention_bwd_tf32.py); at 2 it is within half of it
TF32_BWD_SCALE = 2.0


def _within_fp32_bound(got, want):
    """chip_smoke.compare's bound for fp32 outputs: |err| <= 2e-4 +
    2e-4 |ref|."""
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (err <= TOL + TOL * want.abs()).all(), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("name", sorted(TF32_FWD_CASES))
def test_flash_attention_tf32_backward(cuda, name, G, hd):
    """dq_tf32_kernel and dkv_tf32_kernel (fp32, 3xTF32 on the tensor
    cores) against _bwd_dq_ref and _bwd_dkv_ref on the forward kernel's lse
    and delta, under the card check's fp32 bound: ragged S = 1000, GQA, a
    row that sees no key (dq = 0)."""
    kind, Sq, Sk, window, mseq = TF32_FWD_CASES[name]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(hd + G + Sq + Sk + 1)
    B, KV = 2, 2
    mk = lambda S, H: TF32_BWD_SCALE * torch.randn(  # noqa: E731
        B, S, H, hd, generator=gen, device=cuda).transpose(1, 2)
    q, k, v, do = mk(Sq, KV * G), mk(Sk, KV), mk(Sk, KV), mk(Sq, KV * G)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    n0 = K.launch_counts()
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    _within_fp32_bound(dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg))
    for got, want in zip((dk, dv), FA._bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   cfg)):
        _within_fp32_bound(got, want)
    if name == "two_pass, cut keys":
        assert (dq[:, :, 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.float32])
@pytest.mark.parametrize("layout", ["q shifted", "k, v shifted",
                                    "dO sequence stride hd + 2",
                                    "dq shifted", "dk shifted",
                                    "dv shifted"])
def test_flash_attention_tf32_backward_4_byte_copies(cuda, monkeypatch,
                                                     layout, hd):
    """fp32 inputs, dO or gradient buffers (``torch.empty_like`` replaced
    to make one) that the 16-byte copies cannot take go through the
    backward's 4-byte-copy instantiations: matched against the plain
    versions under the card bound, never refused."""
    cfg = FA.FlashConfig("db_concat", mask_seq=100)
    gen = torch.Generator(device=cuda).manual_seed(hd + 1)
    mk = lambda: torch.randn(2, 200, 4, hd, generator=gen,  # noqa: E731
                             device=cuda).transpose(1, 2)
    q, k, v, do = mk(), mk(), mk(), mk()
    if layout == "q shifted":
        q = _shifted(q.contiguous())
    elif layout == "k, v shifted":
        k, v = _shifted(k.contiguous()), _shifted(v.contiguous(), 3)
    elif layout == "dO sequence stride hd + 2":
        do = torch.randn(2, 4, 200, hd + 2, generator=gen,
                         device=cuda)[..., :hd]
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    if layout in ("dq shifted", "dk shifted", "dv shifted"):
        target = {"dq": q, "dk": k, "dv": v}[layout[:2]]
        empty_like = torch.empty_like
        monkeypatch.setattr(torch, "empty_like", lambda x: (
            _shifted(x) if x is target else empty_like(x)))
    else:
        assert not all(FA.tc_aligned(x.data_ptr(), x.stride(), 4)
                       for x in (q, k, v, do))
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    if layout.endswith("shifted") and layout[:2] in ("dq", "dk", "dv"):
        got = {"dq": dq, "dk": dk, "dv": dv}[layout[:2]]
        assert not FA.tc_aligned(got.data_ptr(), got.stride(), 4)
    _within_fp32_bound(dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg))
    for got, want in zip((dk, dv), FA._bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   cfg)):
        _within_fp32_bound(got, want)


@pytest.mark.gpu
def test_flash_attention_tf32_autograd_takes_a_4_byte_do(cuda):
    """torch.autograd.grad through fp32 flash_attention with a dO whose
    sequence stride is hd + 2 floats: the backward takes it as it is (no
    copy: its head dim is contiguous), runs both kernels and matches
    flash_attention_bwd_ref on the forward kernel's out and lse."""
    cfg = FA.FlashConfig("db_concat", mask_seq=96)
    gen = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda H: torch.randn(2, 192, H, 64, generator=gen,  # noqa: E731
                               device=cuda).transpose(1, 2)
    q, k, v = (mk(4).requires_grad_(), mk(2).requires_grad_(),
               mk(2).requires_grad_())
    do = torch.randn(2, 4, 192, 66, generator=gen, device=cuda)[..., :64]
    assert not FA.tc_aligned(do.data_ptr(), do.stride(), do.element_size())
    out = FA.flash_attention(q, k, v, mask_kind="db_concat", mask_seq=96)
    n0 = K.launch_counts()
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    o, lse = FA.flash_attention_fwd(q.detach(), k.detach(), v.detach(), cfg)
    want = FA.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                      lse, do, cfg)
    for got, ref in zip(grads, want):
        _within_fp32_bound(got, ref)


@pytest.mark.gpu
def test_flash_attention_rejects_what_the_kernels_do_not_take(cuda):
    cfg = FA.FlashConfig("causal")
    x = torch.randn(1, 2, 8, 96, device=cuda)
    with pytest.raises(NotImplementedError, match="head dim"):
        FA.flash_attention_fwd(x, x, x, cfg)
    x = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        FA.flash_attention_fwd(x, x.bfloat16(), x, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.randn(1, 2, 8, 128, device=cuda)[..., ::2]
        FA.flash_attention_fwd(y, y, y, cfg)
    with pytest.raises(ValueError, match="multiple of KV"):
        FA.flash_attention_fwd(torch.randn(1, 3, 8, 64, device=cuda), x, x,
                               cfg)


@pytest.mark.gpu
def test_flash_attention_bf16_hd32_is_refused(cuda):
    """hd 32 is instantiated for fp32 only: bf16 raises, with no fallback
    and no launch."""
    cfg = FA.FlashConfig("full")
    x = torch.randn(1, 2, 66, 32, device=cuda, dtype=torch.bfloat16)
    n0 = K.launch_counts()
    for call in (lambda: FA.flash_attention_fwd(x, x, x, cfg),
                 lambda: FA.flash_attention_bwd_dq(
                     x, x, x, x, torch.zeros(1, 2, 66, device=cuda),
                     torch.zeros(1, 2, 66, device=cuda), cfg)):
        with pytest.raises(NotImplementedError, match="head dim 32"):
            call()
    assert K.launch_counts() == n0


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV", [(4, 4, 4), (2, 4, 2)])
def test_flash_attention_tf32_hd32_vit_shape(cuda, B, H, KV):
    """fwd_tf32_kernel<32>, dq_tf32_kernel<32> and dkv_tf32_kernel<32> at
    ViT's sequence (1 + 64 patches + 1 label token = 66: the second 64-row
    tile of Q and of K holds 2 rows), ``full`` mask, against the plain
    versions under the card check's fp32 bound, and through autograd."""
    cfg = FA.FlashConfig("full")
    gen = torch.Generator(device=cuda).manual_seed(32 + KV)
    mk = lambda n: TF32_BWD_SCALE * torch.randn(  # noqa: E731
        B, 66, n, 32, generator=gen, device=cuda).transpose(1, 2)
    q, k, v, do = mk(H), mk(KV), mk(KV), mk(H)
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    for got, want in zip((out, lse), FA.flash_attention_fwd_ref(q, k, v,
                                                                cfg)):
        _within_fp32_bound(got, want)
    _within_fp32_bound(dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg))
    for got, want in zip((dk, dv), FA._bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   cfg)):
        _within_fp32_bound(got, want)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o = FA.flash_attention(*leaves, mask_kind="full")
    grads = torch.autograd.grad(o, leaves, do)
    for got, want in zip(grads, (dq, dk, dv)):
        assert torch.equal(got, want)


def _within_card_bound(got, want):
    """chip_smoke.compare's bound for bf16 outputs: |err| <= 2e-4 +
    2^-7 |ref| (fp32 sums in another order, one final rounding)."""
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= TOL + 2.0 ** -7 * want.float().abs()).all(), \
        err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("hd", FA.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("name", sorted(TC_BWD_CASES))
def test_flash_attention_tc_backward(cuda, name, G, hd):
    """dq_tc_kernel and dkv_tc_kernel (bf16) against _bwd_dq_ref and
    _bwd_dkv_ref on the kernel forward's lse and delta, under the card
    check's bound: ragged lengths, GQA, a row that sees no key."""
    kind, Sq, Sk, window, mseq = TC_BWD_CASES[name]
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(hd + G + Sq + Sk)
    B, KV = 2, 2
    mk = lambda S, H: torch.randn(B, S, H, hd, generator=gen, device=cuda  # noqa: E731
                                  ).bfloat16().transpose(1, 2)
    q, k, v, do = mk(Sq, KV * G), mk(Sk, KV), mk(Sk, KV), mk(Sq, KV * G)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    n0 = K.launch_counts()
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    _within_card_bound(dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg))
    for got, want in zip((dk, dv), FA._bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   cfg)):
        _within_card_bound(got, want)
    if name == "two_pass, cut keys":
        assert (dq[:, :, 0] == 0).all()


def _odd(x: torch.Tensor) -> torch.Tensor:
    """A dense copy of x that starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    return y.copy_(x)


@pytest.mark.gpu
def test_flash_attention_tc_backward_refuses_unaligned(cuda, monkeypatch):
    """The tensor-core backward copies 16-byte chunks: a bf16 dO, q, k or
    v at an odd address raises (no fallback), and so does a dq, dk or dv
    buffer at one (``torch.empty_like`` replaced to make one)."""
    cfg = FA.FlashConfig("causal")
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(1, 2, 80, 64, generator=gen, device=cuda
                               ).bfloat16() for _ in range(4))
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    args = {"q": q, "k": k, "v": v, "do": do}
    for name in args:
        bad = dict(args, **{name: _odd(args[name])})
        call = (bad["q"], bad["k"], bad["v"], bad["do"], lse, delta, cfg)
        with pytest.raises(ValueError, match=f"bf16 {name} must start"):
            FA.flash_attention_bwd_dq(*call)
        with pytest.raises(ValueError, match=f"bf16 {name} must start"):
            FA.flash_attention_bwd_dkv(*call)
    empty_like = torch.empty_like
    for name, target in (("dq", q), ("dk", k), ("dv", v)):
        monkeypatch.setattr(torch, "empty_like", lambda x, t=target: (
            _odd(x) if x is t else empty_like(x)))
        fn = (FA.flash_attention_bwd_dq if name == "dq"
              else FA.flash_attention_bwd_dkv)
        with pytest.raises(ValueError, match=f"bf16 {name} must start"):
            fn(q, k, v, do, lse, delta, cfg)


@pytest.mark.gpu
def test_flash_attention_autograd_copies_an_unaligned_do(cuda):
    """torch.autograd.grad through flash_attention (bf16) with a dO at an
    odd address: the backward copies it, runs both tensor-core kernels and
    matches flash_attention_bwd_ref on the forward kernel's out and lse."""
    cfg = FA.FlashConfig("db_concat", mask_seq=96)
    gen = torch.Generator(device=cuda).manual_seed(4)
    mk = lambda H: torch.randn(2, 192, H, 64, generator=gen, device=cuda  # noqa: E731
                               ).bfloat16().transpose(1, 2)
    q, k, v = (mk(4).requires_grad_(), mk(2).requires_grad_(),
               mk(2).requires_grad_())
    do = _odd(mk(4))
    assert not FA.tc_aligned(do.data_ptr(), do.stride(), do.element_size())
    out = FA.flash_attention(q, k, v, mask_kind="db_concat", mask_seq=96)
    n0 = K.launch_counts()
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert n1[n] == n0[n] + 1
    o, lse = FA.flash_attention_fwd(q.detach(), k.detach(), v.detach(), cfg)
    want = FA.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                      lse, do, cfg)
    for got, ref in zip(grads, want):
        _within_card_bound(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,arch", [
    pytest.param("db", "stablelm-1.6b", id="db"),
    pytest.param("e2e", "stablelm-1.6b", id="e2e"),
    pytest.param("db", "h2o-danube-3-4b", id="h2o-db"),
    pytest.param("e2e", "h2o-danube-3-4b", id="h2o-e2e"),
    pytest.param("db", "whisper-small", id="whisper-db"),
    pytest.param("e2e", "whisper-small", id="whisper-e2e"),
    pytest.param("db", "llama-3.2-vision-11b", id="vlm-db"),
    pytest.param("e2e", "llama-3.2-vision-11b", id="vlm-e2e"),
    pytest.param("db", "phi3.5-moe-42b-a6.6b", id="moe-db"),
    pytest.param("e2e", "phi3.5-moe-42b-a6.6b", id="moe-e2e")])
def test_train_step_through_kernels_matches_plain_versions(cuda, mode, arch):
    """One fp32 training step through the kernels and through the plain
    versions from the same params and draws: loss, grad norm and the
    updated params agree, and the launch counts are the path's
    arithmetic (one fwd, dq and dk/dv per layer). h2o-danube3-4b at hd 120
    with 8 query heads on 2 KV heads and its window cut to 64, which the
    96 tokens pass. whisper-small with 150 audio frames: per decoder layer
    a self and a cross call (the concat stream's 192 queries over 150
    keys), per encoder layer one ``full`` call over the frames; the
    encoder's moments agree as well. llama-3.2-vision-11b at 4 layers (2
    superblocks of a self and a cross layer, 8 query heads on 2 KV heads)
    over 130 image tokens, the cross gates opened: one call per layer, the
    cross layer's a ``full`` call over the images, its moments agree too.
    phi3.5-moe-42b-a6.6b at 4 layers of 4 experts: the aux loss in both
    losses."""
    h2o, audio = arch == "h2o-danube-3-4b", arch == "whisper-small"
    vlm = arch == "llama-3.2-vision-11b"
    cfg = reduced(get_config(arch), n_layers=4, d_model=960 if h2o else 512,
                  n_heads=8)
    assert cfg.head_dim == (120 if h2o else 64)
    if audio:
        cfg = dataclasses.replace(cfg, n_audio_frames=150)
    if vlm:
        cfg = dataclasses.replace(cfg, n_layers=4, n_image_tokens=130)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    master = dbm.init(gen)
    for lay in ([master["units"]["self"], master["units"]["cross"]] if vlm
                else [master["layers"]]):
        for k in ("w", "b"):
            lay["adaln"][k].normal_(0.0, 0.02, generator=gen)
    if vlm:
        master["units"]["cross"]["xgate"].fill_(1.0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen,
                           device=cuda)
    sigma = torch.rand(2, 1, 1, generator=gen, device=cuda) + 0.1
    eps = torch.randn(2, 96, cfg.d_model, generator=gen, device=cuda)
    kw = {"aux_inputs": {"audio_embs": torch.randn(
        2, cfg.n_audio_frames, cfg.d_model, generator=gen,
        device=cuda)}} if audio else {}
    if vlm:
        kw = {"aux_inputs": {"image_embs": torch.randn(
            2, cfg.n_image_tokens, cfg.d_model, generator=gen,
            device=cuda)}}
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    res = {}
    for impl in ("ref", "kernels"):
        params = tree_map(lambda _, x: x.clone(), master)
        if mode == "db":
            init, step = T.make_db_train_step(dbm, 1, tcfg, impl=impl)
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), tokens,
                                        sigma=sigma, eps=eps, **kw)
            n_layers = dbm.ranges[1][1] * (cfg.cross_attn_every or 1)
        else:
            init, step = T.make_e2e_train_step(dbm, tcfg, impl=impl)
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), tokens, **kw)
            n_layers = cfg.n_layers
        torch.cuda.synchronize()
        counts = K.launch_counts()
        calls = 2 * n_layers + cfg.n_encoder_layers if audio else n_layers
        expect = 0 if impl == "ref" else calls
        assert {k: counts[k] for k in counts if k.startswith("flash_att")} \
            == {k: expect for k in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")}
        if vlm:
            mus = [tree_map(lambda _, x: x[:, 0], opt.mu["units"]["self"][
                "attn"]), opt.mu["units"]["cross"]["attn"]]
        else:
            mus = [opt.mu["layers"]["attn"]]
        if audio:
            mus += [opt.mu["layers"]["xattn"], opt.mu["encoder"]["attn"]]
        res[impl] = (loss, m["grad_norm"], mus)
    (lr_, gr, mrs), (lk, gk, mks) = res["ref"], res["kernels"]
    assert torch.isfinite(lk) and abs(lk - lr_) <= 1e-4 * abs(lr_)
    assert abs(gk - gr) <= 1e-3 * abs(gr)
    for mr, mk in zip(mrs, mks):
        for name in ("wq", "wk", "wv"):   # first moments: 0.1 x the grads
            scale = mr[name].abs().max().item()
            torch.testing.assert_close(mk[name], mr[name],
                                       atol=1e-3 * scale, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["l2", "ce"])
def test_two_pass_step_through_kernels_matches_plain_versions(cuda, loss):
    """One fp32 two-pass DB step of reduced olmo-1b (non-parametric LN)
    through the kernels and through the plain versions from the same params
    and draws: loss, grad norm and first moments agree, and the launch
    counts are the path's arithmetic: per layer two attention calls (clean
    causal, noisy two_pass), whose backward runs for all but the last
    layer's clean call (its output reaches no loss), and two ln-modulate
    and two gate-residual calls on the noisy stream, forward and backward;
    one EDM loss forward and backward under l2."""
    cfg = reduced(get_config("olmo-1b"), n_layers=4, d_model=512, n_heads=4)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1,
                                             causal_mode="two_pass",
                                             loss=loss))
    gen = torch.Generator(device=cuda).manual_seed(0)
    master = dbm.init(gen)
    for k in ("w", "b"):
        master["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen,
                           device=cuda)
    sigma = torch.rand(2, 1, 1, generator=gen, device=cuda) + 0.1
    eps = torch.randn(2, 96, cfg.d_model, generator=gen, device=cuda)
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    res = {}
    for impl in ("ref", "kernels"):
        params = tree_map(lambda _, x: x.clone(), master)
        init, step = T.make_db_train_step(dbm, 1, tcfg, impl=impl)
        K.reset_launch_counts()
        params, opt, lv, m = step(params, init(params), tokens, sigma=sigma,
                                  eps=eps)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        n = dbm.ranges[1][1]
        l2 = int(loss == "l2")
        expect = {k: 0 for k in counts}
        if impl == "kernels":
            expect.update({"flash_attention_fwd": 2 * n,
                           "flash_attention_bwd_dq": 2 * n - 1,
                           "flash_attention_bwd_dkv": 2 * n - 1,
                           "ln_modulate_fwd": 2 * n,
                           "ln_modulate_bwd": 2 * n,
                           "gate_residual": 2 * n,
                           "gate_residual_bwd": 2 * n,
                           "edm_loss_fwd": l2, "edm_loss_bwd": l2})
        assert counts == expect
        res[impl] = (lv, m["grad_norm"], opt.mu["layers"])
    (lr_, gr, mr), (lk, gk, mk) = res["ref"], res["kernels"]
    assert torch.isfinite(lk) and abs(lk - lr_) <= 1e-4 * abs(lr_)
    assert abs(gk - gr) <= 1e-3 * abs(gr)
    for path in (("attn", "wq"), ("mlp", "wg"), ("adaln", "w")):
        a, r = mk[path[0]][path[1]], mr[path[0]][path[1]]
        scale = r.abs().max().item()
        torch.testing.assert_close(a, r, atol=1e-3 * scale, rtol=1e-3)


@pytest.mark.gpu
def test_dit_through_kernels_matches_plain_versions(cuda):
    """Reduced DiT-S/2 (4 layers, d 384, hd 64, 64 tokens of 16 dims), fp32:
    one DB step's loss and first moments and a blockwise sample through the
    kernels against the plain versions (``impl="ref"``), from the same
    params and draws; the sampler's launch counts are the path's
    arithmetic."""
    from repro_torch.configs import paper
    from repro_torch.core import dit as DIT
    from repro_torch.core import partition as PT
    cfg = reduced(paper.DIT_S2, n_layers=4, d_model=384, n_heads=6)
    dit = DIT.DiTDiffusionBlocks(cfg, paper.DIT_DB, data_dim=16, n_tokens=64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    master = dit.init(gen)
    for k in ("w", "b"):
        master["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    master["out_proj"]["w"].normal_(0.0, 0.05, generator=gen)
    y = torch.randn(4, 64, 16, generator=gen, device=cuda)
    sigma = torch.rand(4, 1, 1, generator=gen, device=cuda) * 3 + 0.1
    eps = torch.randn(4, 64, 16, generator=gen, device=cuda)
    z0 = 80.0 * torch.randn(4, 64, 16, generator=gen, device=cuda)
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    res = {}
    for impl in ("ref", "kernels"):
        params = tree_map(lambda _, x: x.clone(), master)
        init, step = DIT.make_db_step(dit, 0, tcfg, impl=impl)
        params, opt, loss, _ = step(params, init(params), y, sigma=sigma,
                                    eps=eps)
        K.reset_launch_counts()
        z, evals = dit.sample(master, 4, 6, z0=z0, impl=impl)
        torch.cuda.synchronize()
        res[impl] = (loss, opt.mu["layers"]["attn"]["wq"], z,
                     K.launch_counts())
    (lr_, mr, zr, cr), (lk, mk, zk, ck) = res["ref"], res["kernels"]
    assert all(v == 0 for v in cr.values())
    sched = PT.sampling_schedule(dit.db, 6)[:-1]
    evals = sum(dit.ranges[PT.block_of_sigma(dit.db, float(s))][1]
                for s in sched)
    assert ck["flash_attention_fwd"] == evals
    assert ck["gate_residual"] == 2 * evals and ck["euler_fwd"] == 6
    assert abs(lk - lr_) <= 1e-4 * abs(lr_)
    torch.testing.assert_close(mk, mr, atol=1e-3 * mr.abs().max().item(),
                               rtol=1e-3)
    torch.testing.assert_close(zk, zr, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_recurrent_through_kernels_matches_plain_versions(cuda):
    """Reduced Huginn (core 2 layers, d 256, hd 64, K 4), fp32: db_loss,
    baseline_loss and db_generate_logits through the kernels against the
    plain versions; the sampler reads F strided and launches K Euler
    steps."""
    from repro_torch.configs import paper
    from repro_torch.core import recurrent as REC
    cfg = reduced(paper.HUGINN, n_layers=2, d_model=256, n_heads=4, vocab=512)
    m = REC.RecurrentDepthModel(cfg, paper.HUGINN_DB, recurrence=4, bptt_k=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = m.init(gen)
    for k in ("w", "b"):
        params["core"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, 512, (2, 96), generator=gen, device=cuda)
    sigma = torch.rand(2, 1, 1, generator=gen, device=cuda) * 3 + 0.1
    eps = torch.randn(2, 96, 256, generator=gen, device=cuda)
    s0 = 0.5 * torch.randn(2, 96, 256, generator=gen, device=cuda)
    z0 = 80.0 * torch.randn(2, 96, 256, generator=gen, device=cuda)
    res = {}
    for impl in ("ref", "kernels"):
        K.reset_launch_counts()
        db = m.db_loss(params, tokens, sigma=sigma, eps=eps, impl=impl)[0]
        base = m.baseline_loss(params, tokens, s0=s0, impl=impl)[0]
        logits = m.db_generate_logits(params, tokens, z0=z0, impl=impl)
        torch.cuda.synchronize()
        res[impl] = (db, base, logits, K.launch_counts())
    (dr, br, lr_, cr), (dk, bk, lk, ck) = res["ref"], res["kernels"]
    assert all(v == 0 for v in cr.values())
    assert ck["euler_fwd"] == 4
    assert ck["flash_attention_fwd"] == (2 + 2 + 2) + (2 + 4 * 2 + 2) \
        + (2 + 4 * 2 + 2)
    for got, want in ((dk, dr), (bk, br)):
        assert abs(got - want) <= 1e-4 * abs(want)
    torch.testing.assert_close(lk, lr_, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# block-parallel engine, guard, checkpoints and the supervisor on the card
# ---------------------------------------------------------------------------

def _bp_model(cuda, n_layers=4, blocks=2):
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=n_layers,
                  d_model=512, n_heads=8)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=blocks,
                                             overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params, gen


def _bp_draws(dbm, gen, cuda, Bsz=2, S=96):
    return [(dbm.sample_block_sigma(gen, (Bsz, 1, 1), b, device=cuda),
             torch.randn(Bsz, S, dbm.cfg.d_model, generator=gen,
                         device=cuda)) for b in range(dbm.num_blocks)]


@pytest.mark.gpu
def test_block_parallel_batch_through_kernels_matches_plain_versions(cuda):
    """One fp32 engine batch (2 blocks of 2 layers) through the kernels and
    through the plain versions from the same params and draws: per-block
    losses, the updated params and the first moments agree; each block
    update launches one DB step's attention kernels."""
    from repro_torch.parallel import BlockParallelTrainer
    dbm, master, gen = _bp_model(cuda)
    tokens = torch.randint(0, dbm.cfg.vocab_size, (2, 96), generator=gen,
                           device=cuda)
    draws = _bp_draws(dbm, gen, cuda)
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    res = {}
    for impl in ("ref", "kernels"):
        params = tree_map(lambda _, x: x.clone(), master)
        tr = BlockParallelTrainer(dbm, tcfg, impl=impl)
        K.reset_launch_counts()
        state, losses, _ = tr.step(tr.init_state(params), tokens,
                                   draws=draws)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        expect = 0 if impl == "ref" else sum(s for _, s in dbm.ranges)
        assert {k: counts[k] for k in counts if k.startswith("flash_att")} \
            == {k: expect for k in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")}
        res[impl] = (losses, params, state.stack_opt.mu["layers"]["attn"])
    (lr_, pr, mr), (lk, pk, mk) = res["ref"], res["kernels"]
    assert torch.isfinite(lk).all()
    torch.testing.assert_close(lk, lr_, atol=0, rtol=1e-4)
    for (_, a), (_, b) in zip(T.tree_items(pk), T.tree_items(pr)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)
    for name in ("wq", "wk", "wv"):
        scale = mr[name].abs().max().item()
        torch.testing.assert_close(mk[name], mr[name], atol=1e-3 * scale,
                                   rtol=1e-3)


@pytest.mark.gpu
def test_block_parallel_guard_skips_on_the_card(cuda):
    """A NaN loss_mult on block 0 of a bf16 batch: its stack, moments and
    step counter stay bit-unchanged on the card, block 1 and the periphery
    move."""
    from repro_torch.parallel import BlockParallelTrainer
    dbm, params, gen = _bp_model(cuda)
    tokens = torch.randint(0, dbm.cfg.vocab_size, (2, 96), generator=gen,
                           device=cuda)
    tr = BlockParallelTrainer(dbm, TrainConfig(steps=10, warmup_steps=2),
                              precision="bf16")
    state = tr.init_state(params)
    before = [tree_map(lambda _, x: x.clone(), t)
              for t in tr.block_trees(state, 0)[:1]] + [
        tree_map(lambda _, x: x.clone(), state.stack_opt.mu)]
    b1 = params["layers"]["attn"]["wq"][2:].clone()
    emb = params["embed"]["table"].clone()
    state, losses, _ = tr.step(state, tokens, gen,
                               loss_mult=[float("nan"), 1.0])
    assert not torch.isfinite(losses[0]) and torch.isfinite(losses[1])
    assert tr.last_ok.tolist() == [False, True]
    assert state.stack_opt.step.tolist() == [0, 1]
    stack0 = tr.block_trees(state, 0)[0]
    for (_, a), (_, b) in zip(T.tree_items(stack0), T.tree_items(before[0])):
        assert torch.equal(a, b)
    pairs = list(zip(T.tree_items(state.stack_opt.mu),
                     T.tree_items(before[1])))
    assert all(torch.equal(a[0], b[0]) for (_, a), (_, b) in pairs)
    assert any(not torch.equal(a[1], b[1]) for (_, a), (_, b) in pairs)
    assert not torch.equal(params["layers"]["attn"]["wq"][2:], b1)
    assert not torch.equal(params["embed"]["table"], emb)


@pytest.mark.gpu
def test_checkpoint_round_trip_of_cuda_state(cuda, tmp_path):
    """A generation of CUDA trees (fp32, bf16, int32, AdamW state) saves
    and loads back bit-equal, on the card and on the host."""
    from repro_torch.checkpoint import CheckpointManager, tree_digest
    from repro_torch.optim import adamw
    gen = torch.Generator(device=cuda).manual_seed(3)
    tree = {"w": torch.randn(33, 17, generator=gen, device=cuda),
            "h": torch.randn(8, 5, generator=gen, device=cuda).bfloat16(),
            "i": torch.arange(7, device=cuda, dtype=torch.int32)}
    opt = adamw(1e-3)[0]({"w": tree["w"]})
    opt.mu["w"].normal_(generator=gen)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    g = mgr.save({"t": tree, "t.opt": opt}, {"it": 3})
    assert mgr.timings[-1]["op"] == "save" and mgr.timings[-1]["bytes"] > 0
    zeros = {"t": tree_map(lambda _, x: torch.zeros_like(x), tree),
             "t.opt": type(opt)(torch.zeros_like(opt.step),
                                {"w": torch.zeros_like(opt.mu["w"])},
                                {"w": torch.zeros_like(opt.nu["w"])})}
    for device in (None, "cpu"):
        trees, manifest = mgr.load_latest(zeros, device=device)
        assert manifest["generation"] == g
        assert trees["t"]["w"].device.type == (device or "cuda")
        assert trees["t"]["h"].dtype == torch.bfloat16
        assert tree_digest(trees["t"]) == tree_digest(tree)
        assert tree_digest(trees["t.opt"]) == tree_digest(opt)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["block-parallel", "db"])
def test_kill_then_resume_is_bit_identical_on_the_card(cuda, tmp_path, mode):
    """TrainRunner at a small size on the card (bf16 policy, draws from a
    CUDA generator, batches through HostDataLoader): a run killed after
    step/batch 3 and resumed from its checkpoints ends bit-equal to the
    uninterrupted run."""
    from repro_torch.checkpoint import tree_digest
    from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
    from repro_torch.launch.faults import make_injector
    from repro_torch.launch.trainrunner import TrainRunner
    dbm, master, _ = _bp_model(cuda)
    lm = MarkovLM(vocab_size=dbm.cfg.vocab_size, seed=7)
    steps = 8 if mode == "block-parallel" else 6

    def make_data(cur):
        src = lm.stream(2, 96) if cur is None else \
            MarkovStream.from_cursor(cur)
        return HostDataLoader(src, device=cuda)

    def run(d, faults, **kw):
        params = tree_map(lambda _, x: x.clone(), master)
        r = TrainRunner(dbm, TrainConfig(steps=steps, warmup_steps=2),
                        mode=mode, precision="bf16", ckpt_dir=str(d),
                        ckpt_every=2, log=lambda *a: None,
                        faults=make_injector(faults))
        _, hist = r.train(make_data,
                          torch.Generator(device=cuda).manual_seed(1),
                          params=params, **kw)
        return r, params, hist

    spec = {"grad_nan": {"at": [1]}}
    a, pa, ha = run(tmp_path / "a", spec)
    run(tmp_path / "b", spec, halt_after=3)
    c, pc, hc = run(tmp_path / "b", None, resume=True)
    assert tree_digest(pa) == tree_digest(pc)
    if mode == "block-parallel":
        assert tree_digest(a.state.stack_opt) == tree_digest(c.state.stack_opt)
        assert tree_digest(a.state.periph_opt) == \
            tree_digest(c.state.periph_opt)
        assert hc == ha[2 * dbm.num_blocks:]
    else:
        assert tree_digest(a.opt_states) == tree_digest(c.opt_states)
        assert hc == ha[2:]
    assert a.heartbeats == c.heartbeats


# ---------------------------------------------------------------------------
# The serving system on the card: the engine thread's graphs, and memory
# ---------------------------------------------------------------------------

def _server_batcher(dbm, params, cuda, seed, **kw):
    return S.ContinuousBatcher(
        dbm, params, **{**dict(num_slots=1, page_size=16, max_prompt=48,
                               max_len=64, seg_len=4, chunk_size=16,
                               precision="fp32", prefix_cache=True), **kw},
        generator=torch.Generator(device=cuda).manual_seed(seed))


@pytest.mark.gpu
def test_server_replays_graphs_captured_on_the_engine_thread(cuda,
                                                             monkeypatch):
    """The server's engine thread captures the batcher's two graphs (each
    capture checked against its counted launches) before ``start``
    returns, and replays them there; the streamed tokens equal a direct
    graphed ``step()`` loop's under the same generator seed."""
    import asyncio
    import threading
    from repro_torch.launch import server as SV
    dbm, params = _serving_model(cuda)
    seen = []
    for name in ("capture", "_dispatch"):
        real = getattr(S.ContinuousBatcher, name)

        def spy(self, *a, _real=real, _name=name, **k):
            seen.append((id(self), _name, threading.current_thread().name))
            return _real(self, *a, **k)
        monkeypatch.setattr(S.ContinuousBatcher, name, spy)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, dbm.cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in (37, 9)]
    cb = _server_batcher(dbm, params, cuda, 6)
    cb.capture()
    direct = []
    for p in prompts:
        cb.submit(p, 12)
        direct.append(cb.run()[0].out)

    async def main():
        cb = _server_batcher(dbm, params, cuda, 6)
        server = SV.InferenceServer(cb)
        await server.start()
        assert cb.graph_warmups == {"chunk": 1, "segment": 1}
        try:
            got = [(await SV.stream_generate("127.0.0.1", server.port, p,
                                             12))["ids"] for p in prompts]
        finally:
            await server.aclose()
        return id(cb), got

    sid, got = asyncio.run(main())
    assert got == direct and all(len(g) == 12 for g in got)
    mine = [(n, t) for i, n, t in seen if i == sid]
    assert mine[0] == ("capture", "engine") and len(mine) > 4
    assert {t for _, t in mine} == {"engine"}


@pytest.mark.gpu
def test_dropping_a_batcher_and_its_engines_frees_their_memory(cuda):
    """A graphed batcher that served, and a static ``generate`` (whose
    engine, memoized on the model, keeps its last pool), leave nothing
    allocated once their model and batcher are dropped: no reference cycle
    holds them, so no gc pass is needed (gc is off here). PyTorch's cuBLAS
    workspaces, one per (handle, stream), are freed before each reading."""
    import gc

    def served():
        dbm, params = _serving_model(cuda)
        cb = _server_batcher(dbm, params, cuda, 1, num_slots=2,
                             precision="bf16")
        for n in (30, 12):
            cb.submit(list(range(n)), 8)
        assert all(len(r.out) == 8 for r in cb.run())
        S.generate(dbm, params, [[1, 2, 3]], 4, page_size=16)

    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        before = torch.cuda.memory_allocated()
        served()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    assert after == before, (after - before) / 2**20


def _capture_race(cuda) -> None:
    """A CUDA call from another thread while the engine thread captures
    (here a device synchronize) raises in that thread, and the capture it
    would have broken fails too, so ``start`` raises."""
    import threading
    from repro_torch.launch import server as SV
    dbm, params = _serving_model(cuda)
    capturing, go = threading.Event(), threading.Event()
    serve = S.DecodeEngine._serve

    def held(self, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            go.wait(60)
        return serve(self, *a, **k)

    S.DecodeEngine._serve = held
    runner = SV.EngineRunner(_server_batcher(dbm, params, cuda, 0))
    started = []

    def start():
        try:
            runner.start()
            started.append(None)
        except RuntimeError as e:
            started.append(e)

    t = threading.Thread(target=start)
    t.start()
    try:
        assert capturing.wait(120)
        with pytest.raises(RuntimeError):
            torch.cuda.synchronize()
    finally:
        go.set()
        t.join(120)
    assert not t.is_alive() and isinstance(started[0], RuntimeError)


@pytest.mark.gpu
def test_torch_call_during_the_engine_capture_fails_loudly(cuda):
    """Nothing escapes the engine's graph silently: see ``_capture_race``.
    The race runs in a process of its own, since the capture it breaks
    leaves its stream unusable for whatever would run after it here."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    path = [os.path.join(here, os.pardir, "src"), here,
            os.environ.get("PYTHONPATH", "")]
    child = ("import os, sys, torch, test_torch_gpu as T\n"
             "torch.backends.cuda.matmul.allow_tf32 = False\n"
             "T._capture_race(torch.device('cuda'))\n"
             "print('capture race: failed loudly', flush=True)\n"
             "os._exit(0)  # no teardown over the broken capture\n")
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))
    assert r.returncode == 0 and "failed loudly" in r.stdout, (
        r.stdout[-4000:] + r.stderr[-4000:])


# ---------------------------------------------------------------------------
# Disaggregated serving on the card: a shared pool across engine threads
# ---------------------------------------------------------------------------

DG_KW = dict(num_slots=4, page_size=16, max_prompt=80, max_len=80,
             seg_len=4, chunk_size=16, precision="bf16")


def _keyed_draws(batcher):
    """Draws keyed by (request, position), so a request's tokens do not
    depend on which batcher, slot or step commits each of them. The draw
    reaches its batcher weakly: a cycle would leave the batcher's graphs to
    a gc pass, which can land in a later capture and break it."""
    import weakref
    ref = weakref.ref(batcher)
    d, sigma = batcher.dbm.cfg.d_model, batcher.dbm.db.sigma_max

    def draw(n):
        cb = ref()
        z = torch.zeros(n, cb.num_slots, 1, d)
        for s, req in enumerate(cb.slot_req):
            if req is None:
                continue
            for t in range(n):
                g = torch.Generator().manual_seed(
                    req.rid * 4096 + int(cb.lengths[s]) + t)
                z[t, s, 0] = torch.randn(d, generator=g)
        return (sigma * z).to(cb.device), None
    return draw


def _dg_prompts(dbm, n):
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, dbm.cfg.vocab_size, (int(k),), generator=gen)
            .tolist() for k in torch.randint(9, 49, (n,), generator=gen)]


def _dg_unified(dbm, params, cuda, prompts, max_new):
    """Every request at once on one graphed batcher of ``DG_KW``'s shape:
    {rid: tokens}."""
    cb = S.ContinuousBatcher(dbm, params, **DG_KW)
    cb.draw_segment = _keyed_draws(cb)
    for p in prompts:
        cb.submit(p, max_new)
    out = {r.rid: r.out for r in cb.run()}
    assert all(len(o) == max_new for o in out.values())
    return out


def _dg_wait(cond, timeout=120.0):
    import time
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out"
        time.sleep(0.005)


@pytest.mark.gpu
def test_disagg_page_handoff_bf16_busy_workers_match_unified(cuda):
    """bf16 page-handle migration while both workers are busy (the prefill
    worker's chunk graph writes pages on its stream while the decode
    worker's segment graph reads handed pages on its own): every request's
    tokens equal a unified batcher's under draws keyed by request and
    position, so no handed or recycled page was read before its writes
    landed. The first request stays paused on the decode worker until the
    others have been prefilled, so every later chunk runs while the decode
    worker holds a slot."""
    import weakref
    from repro_torch.launch.router import DisaggRouter
    dbm, params = _serving_model(cuda)
    prompts = _dg_prompts(dbm, 12)
    want = _dg_unified(dbm, params, cuda, prompts, 24)
    router = DisaggRouter(dbm, params, n_prefill=1, n_decode=1,
                          handoff="pages", **DG_KW)
    for w in router.workers:
        w.cb.draw_segment = _keyed_draws(w.cb)
    pf, dc = router.prefill_workers[0].cb, router.decode_workers[0].cb
    overlap, refs = [], (weakref.ref(pf), weakref.ref(dc))

    def spy():
        overlap.append(bool(refs[1]().active.any()))
        return S.ContinuousBatcher._chunk(refs[0]())
    pf._chunk = spy
    del pf, dc
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.start()
    try:
        rids = [router.submit(prompts[0], 24)]
        router.pause(rids[0])
        _dg_wait(lambda: any(r is not None and r.rid == rids[0]
                             for r in refs[1]().slot_req))
        rids += [router.submit(p, 24) for p in prompts[1:]]
        _dg_wait(lambda: refs[0]().migrated_out == len(prompts))
        router.resume(rids[0])
        _dg_wait(lambda: all(r in done for r in rids))
    finally:
        router.stop(60)
    assert {r: done[r].out for r in rids} == want
    # the first request's own chunks ran before the decode worker held it
    assert any(overlap) and all(overlap[overlap.index(True):])
    assert router.migrations == len(prompts)
    pool = router.pool
    assert len(pool.free_pages) + len(pool.page_refs) == pool.total_pages - 1


@pytest.mark.gpu
def test_extract_all_detach_from_another_thread_while_a_sibling_replays(
        cuda):
    """On a shared pool, a third thread detaches a batcher's active slots
    (``extract_all(detach=True)``: page handles, no copy) while its sibling
    replays its graphs on its engine thread; the sibling then serves the
    detached requests from the handed pages, and every request's tokens
    equal a unified run's under keyed draws."""
    import threading
    from repro_torch.launch import server as SV
    dbm, params = _serving_model(cuda)
    prompts = _dg_prompts(dbm, 8)
    want = _dg_unified(dbm, params, cuda, prompts, 24)
    pool = S.SharedPagePool(1 + 2 * 4 * 5)
    a, b = (S.ContinuousBatcher(dbm, params, shared_pool=pool, **DG_KW)
            for _ in range(2))
    for cb in (a, b):
        cb.draw_segment = _keyed_draws(cb)
        cb.capture()
    for p in prompts[:4]:
        a.submit(p, 24)
    for _ in range(4):
        a.step()
    assert a.active.all() and a.decode_dispatches >= 1
    b._next_rid = 4
    for p in prompts[4:]:
        b.submit(p, 24)
    runner = SV.EngineRunner(b)
    finished = []
    runner._finish = finished.append
    runner.start()
    try:
        _dg_wait(lambda: b.decode_dispatches >= 1)
        harvested = []
        t = threading.Thread(target=lambda: harvested.extend(
            a.extract_all(detach=True)))
        t.start()
        t.join(60)
        assert not t.is_alive() and len(harvested) == 4
        assert all(r.handoff_pages and r.spilled.n_pages == 0
                   for r in harvested)
        assert not a.active.any()
        for r in harvested:
            b.submit_request(r)
        runner.wake()
        _dg_wait(lambda: len(finished) == 8)
    finally:
        runner.stop(60)
    assert not runner._thread.is_alive() and not runner.crashes
    assert {r.rid: r.out for r in finished} == want
    assert b.restores == 4 and b.graph_warmups == {"chunk": 1, "segment": 1}
    assert len(pool.free_pages) == pool.total_pages - 1 and not pool.page_refs


@pytest.mark.gpu
def test_no_capture_after_router_start_across_a_worker_restart(
        cuda, monkeypatch):
    """The router's start captures every worker's two graphs, one worker
    after another; a decode worker killed mid-run (``worker_die``) and
    restarted serves again from the graphs it had: no capture happens after
    ``start``, and every request completes."""
    import threading
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.router import DisaggRouter
    dbm, params = _serving_model(cuda)
    captures, real = [], S.ContinuousBatcher._graph

    def spy(self, name):
        if name not in self._graphs:
            captures.append((id(self), name,
                             threading.current_thread().name))
        return real(self, name)
    monkeypatch.setattr(S.ContinuousBatcher, "_graph", spy)
    router = DisaggRouter(dbm, params, n_prefill=1, n_decode=2,
                          handoff="pages", restart_dead_after_s=0.1,
                          **DG_KW)
    decode0 = router.decode_workers[0]
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.start()
    at_start = list(captures)
    try:
        decode0.cb.faults = FaultInjector({"worker_die": {"at": [2]}})
        rids = [router.submit(p, 16) for p in _dg_prompts(dbm, 8)]
        _dg_wait(lambda: all(r in done for r in rids))
        _dg_wait(lambda: decode0.restarts == 1 and decode0.alive)
        served = decode0.cb.decode_dispatches
        rids += [router.submit(p, 16) for p in _dg_prompts(dbm, 8)]
        _dg_wait(lambda: all(r in done for r in rids))
    finally:
        router.stop(60)
    assert len(at_start) == 6 and captures == at_start
    assert all(w.cb.graph_warmups == {"chunk": 1, "segment": 1}
               for w in router.workers)
    assert router.failovers >= 1 and decode0.cb.decode_dispatches > served
    assert all(done[r].error is None and len(done[r].out) == 16
               for r in rids)


# ---------------------------------------------------------------------------
# The VLM: per-slot image blocks under the batcher's CUDA graphs
# ---------------------------------------------------------------------------

def _vlm_model(cuda):
    """llama-3.2-vision-11b's structure at 6 layers (2 superblocks of 2
    self + 1 cross), d 512, 8 heads of 64 on 2 KV heads (G = 4), 16 image
    tokens; the AdaLN heads randomised and the cross gates opened."""
    import dataclasses
    cfg = dataclasses.replace(
        reduced(get_config("llama-3.2-vision-11b"), d_model=512, n_heads=8),
        n_layers=6, cross_attn_every=3)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for part in ("self", "cross"):
        for k in ("w", "b"):
            params["units"][part]["adaln"][k].normal_(0.0, 0.02,
                                                      generator=gen)
    params["units"]["cross"]["xgate"].fill_(2.0)
    return dbm, params


def _vlm_images(dbm, n):
    gen = torch.Generator().manual_seed(7)
    return [{"image_embs": torch.randn(dbm.cfg.n_image_tokens - i,
                                       dbm.cfg.d_model, generator=gen)
                                 .numpy()} for i in range(n)]


def _vlm_run(dbm, params, cuda, graphs, image_b, preempt=False):
    """Two slots: request A with an image decodes; between two replays
    request B is admitted into the other slot with ``image_b`` (its block
    written in place, its ``cond_lengths`` set); A is preempted and
    restored once when ``preempt``. The pool's and blocks' addresses are
    checked after every step. Returns ({rid: tokens}, batcher)."""
    from repro_torch.nn import cache as KVC
    cb = S.ContinuousBatcher(
        dbm, params, num_slots=2, page_size=16, max_prompt=32, max_len=64,
        seg_len=4, chunk_size=16, prefix_cache=True, graphs=graphs,
        generator=torch.Generator(device=cuda).manual_seed(3))
    ptrs = KVC.pool_ptrs(cb.kv)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, dbm.cfg.vocab_size, (n,), generator=gen)
               .numpy() for n in (20, 13)]
    image_a = _vlm_images(dbm, 1)[0]
    cb.submit(prompts[0], 16, aux_inputs=image_a)
    done, step = [], 0
    while cb.has_work() or step < 3:
        if step == 2:
            assert cb.decode_dispatches >= 1
            cb.submit(prompts[1], 16, aux_inputs=image_b)
        if preempt and step == 3:
            cb.preempt(cb.slot_req[0].rid)
        done.extend(cb.step())
        assert KVC.pool_ptrs(cb.kv) == ptrs
        step += 1
    assert not cb.cond_lengths.any()
    return {r.rid: r.out for r in done}, cb


@pytest.mark.gpu
def test_vlm_image_admitted_between_replays_is_read(cuda):
    """A slot admitted with a new image between two graph replays reads it
    on the next replay: bf16 tokens equal the eager run's, and differ from
    the same schedule without the image; the pool's and image blocks'
    addresses hold across the conditioning writes, the resets and a
    preemption's restore."""
    dbm, params = _vlm_model(cuda)
    image_b = _vlm_images(dbm, 2)[1]
    graphed, cg = _vlm_run(dbm, params, cuda, True, image_b, preempt=True)
    eager, _ = _vlm_run(dbm, params, cuda, False, image_b, preempt=True)
    assert graphed == eager
    assert cg.preemptions == 1 and cg.restores == 1
    assert cg.graph_warmups == {"chunk": 1, "segment": 1}
    bare, _ = _vlm_run(dbm, params, cuda, True, None, preempt=True)
    assert bare[0] == graphed[0] and bare[1] != graphed[1]
    assert all(len(t) == 16 for t in graphed.values())


@pytest.mark.gpu
def test_vlm_unconditioned_rows_are_zero_under_a_graph(cuda):
    """``cross_attend`` captured in a CUDA graph over static buffers: rows
    whose ``cond_lengths`` is 0 give exactly 0 (no NaN), and a length
    written into the buffer between replays is read by the next replay
    (the plain call's values, within 2e-4)."""
    from repro_torch.nn.cache import cross_attend
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, H, KV, hd, Sk = 4, 8, 2, 64, 37
    q = torch.randn(B, 1, H, hd, generator=gen, device=cuda)
    k, v = (torch.randn(B, Sk, KV, hd, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([Sk, 0, 5, 0], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cross_attend(q, k.float(), v.float(), lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cross_attend(q, k.float(), v.float(), lens)
    for want in ([Sk, 0, 5, 0], [0, 9, 0, Sk]):
        lens.copy_(torch.tensor(want, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        for b, n in enumerate(want):
            if n == 0:
                assert (out[b] == 0).all()
            else:
                assert out[b].abs().max() > 0
        ref = cross_attend(q, k.float(), v.float(), lens.clone())
        assert (out - ref).abs().max() <= 2e-4 * (1 + ref.abs().max())


def _hybrid_model(cuda):
    """zamba2-7b's structure at 6 Mamba layers (2 units of 3 and the
    shared block), d 896, 8 heads of 112 (the paged kernels' hd 112), a
    64-key window; the AdaLN heads randomised."""
    import dataclasses
    cfg = dataclasses.replace(
        reduced(get_config("zamba2-7b"), d_model=896, n_heads=8),
        n_layers=6, attn_every=3)
    assert cfg.head_dim == 112
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for part in (params["units"]["mamba"], params["shared"]):
        for k in ("w", "b"):
            part["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params


def _hybrid_run(dbm, params, cuda, graphs, precision):
    """Five ragged requests on 2 slots (recycled: each admission resets
    the slot's Mamba rows), the first preempted once mid-decode (pages and
    Mamba rows spilled and restored); the state's and pool's addresses are
    checked after every step. Returns (batcher, {rid: tokens}, counts)."""
    from repro_torch.nn import cache as KVC
    cb = S.ContinuousBatcher(
        dbm, params, num_slots=2, page_size=16, max_prompt=80, max_len=112,
        seg_len=4, chunk_size=16, precision=precision, graphs=graphs,
        generator=torch.Generator(device=cuda).manual_seed(3))
    ptrs = KVC.pool_ptrs(cb.kv)
    gen = torch.Generator().manual_seed(1)
    for n in (70, 9, 33, 51, 12):
        cb.submit(torch.randint(0, dbm.cfg.vocab_size, (n,), generator=gen)
                  .numpy(), 24)
    K.reset_launch_counts()
    done, step = [], 0
    while cb.has_work():
        if step == 6 and cb.slot_req[0] is not None:
            cb.preempt(cb.slot_req[0].rid)
        done.extend(cb.step())
        assert KVC.pool_ptrs(cb.kv) == ptrs
        step += 1
    torch.cuda.synchronize()
    return cb, {r.rid: r.out for r in done}, K.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bf16", "bf16_kvint8", "fp32"])
def test_hybrid_graph_segments_bit_equal_to_eager(cuda, precision):
    """The hybrid through the batcher's CUDA graphs (the Mamba rows static
    buffers written in place, the shared block's paged attends at hd 112
    past the window): tokens, pages and Mamba rows bit-equal to the eager
    dispatches, a preemption restored, and the launch counts equal the
    path's arithmetic (per step, one decode launch per unit in the probes
    and one in the commit, and a gate per Mamba layer and two per shared
    application in the probes; per chunk, one prefill launch per unit)."""
    dbm, params = _hybrid_model(cuda)
    (ce, de, ne), (cg, dg, ng) = (_hybrid_run(dbm, params, cuda, g, precision)
                                  for g in (False, True))
    assert dg == de and all(len(t) == 24 for t in dg.values())
    assert cg.preemptions == 1 and cg.restores == 1
    for k in ("h", "conv"):
        assert torch.equal(cg.kv["mamba"][k], ce.kv["mamba"][k])
    for a, b in zip(_pool_tensors(cg.kv["shared_kv"]),
                    _pool_tensors(ce.kv["shared_kv"])):
        assert torch.equal(a[:, 1:], b[:, 1:])      # page 0: the trash page
    n_units, inner = dbm.model.n_units, dbm.model.inner
    for cb, counts in ((ce, ne), (cg, ng)):
        steps = cb.steps + cb.graph_warmups["segment"]
        want = {"flash_decode": 2 * n_units * steps,
                "gate_residual": n_units * (inner + 2) * steps,
                "flash_prefill": n_units * (cb.ingest_dispatches
                                            + cb.graph_warmups["chunk"])}
        assert counts == {**{k: 0 for k in counts}, **want}
    assert cg.graph_warmups == {"chunk": 1, "segment": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,Sq,Sk,window,mseq", [
    ("window", 512, 512, 4096, None), ("window", 300, 300, 64, None),
    ("causal", 512, 512, None, None), ("two_pass", 512, 1024, None, 512),
    ("two_pass", 130, 260, None, 130)])
def test_flash_attention_tf32_hd112_training_shapes(cuda, kind, Sq, Sk,
                                                    window, mseq):
    """The fp32 kernels' hd-112 instantiations (zamba2-7b's shared block in
    training) at its shapes, cut in batch and heads (the clean stream's
    4096 window at S 512, the noisy stream's 512 queries over 2 x 512 keys)
    and at ragged ones: forward, dq and dk/dv on (B, S, H, hd) views within
    the fp32 bound of their plain versions, one launch each."""
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    mk = lambda S: torch.randn(1, S, 4, 112, generator=gen,  # noqa: E731
                               device=cuda).transpose(1, 2)
    q, k, v, do = mk(Sq), mk(Sk), mk(Sk), mk(Sq)
    n0 = K.launch_counts()
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    assert all(n1[n] == n0[n] + 1 for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"))
    for got, want in zip((out, lse),
                         FA.flash_attention_fwd_ref(q, k, v, cfg)):
        _within_fp32_bound(got, want)
    _within_fp32_bound(dq, FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg))
    for got, want in zip((dk, dv),
                         FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)):
        _within_fp32_bound(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_hybrid_step_through_kernels_matches_plain_versions(cuda, mode):
    """The hybrid's training (``_hybrid_model``: 2 units of 3 Mamba layers
    and the shared block, d 896, 8 heads of 112, window 64): one fp32 DB
    step of each block (two-pass) and one e2e step, through the kernels and
    through the plain versions from the same params and draws: loss, grad
    norm and the first moments of the Mamba and shared leaves agree to
    1e-3, and the launch counts are the path's arithmetic (DB: per unit a
    window clean call and a two_pass noisy call, all but the last unit's
    clean call differentiated, and a gate-residual call per Mamba layer and
    two per shared application on the noisy stream, forward and backward;
    e2e: one window call per unit, differentiated, no gate kernel)."""
    dbm, master = _hybrid_model(cuda)
    cfg, inner = dbm.cfg, dbm.model.inner
    gen = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=gen,
                           device=cuda)
    sigma = torch.rand(2, 1, 1, generator=gen, device=cuda) + 0.1
    eps = torch.randn(2, 150, cfg.d_model, generator=gen, device=cuda)
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    blocks = range(dbm.num_blocks) if mode == "db" else [None]
    for b in blocks:
        res = {}
        for impl in ("ref", "kernels"):
            params = tree_map(lambda _, x: x.clone(), master)
            if mode == "db":
                init, step = T.make_db_train_step(dbm, b, tcfg, impl=impl)
                args, kw = (tokens,), {"sigma": sigma, "eps": eps}
                n = dbm.ranges[b][1]
                want = {"flash_attention_fwd": 2 * n,
                        "flash_attention_bwd_dq": 2 * n - 1,
                        "flash_attention_bwd_dkv": 2 * n - 1,
                        "gate_residual": (inner + 2) * n,
                        "gate_residual_bwd": (inner + 2) * n}
            else:
                init, step = T.make_e2e_train_step(dbm, tcfg, impl=impl)
                args, kw = (tokens,), {}
                want = {k: dbm.model.n_units for k in (
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")}
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), *args, **kw)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            assert counts == {**{k: 0 for k in counts},
                              **(want if impl == "kernels" else {})}
            res[impl] = (loss, m["grad_norm"], opt.mu)
        (lr_, gr, mr), (lk, gk, mk) = res["ref"], res["kernels"]
        assert torch.isfinite(lk) and abs(lk - lr_) <= 1e-3 * abs(lr_)
        assert torch.isfinite(gk) and abs(gk - gr) <= 1e-3 * abs(gr)
        for path in (("units", "mamba", "mixer", "in_proj", "w"),
                     ("units", "mamba", "mixer", "a_log"),
                     ("shared", "attn", "wq"), ("shared", "mlp", "wg")):
            a, r = mk, mr
            for key in path:
                a, r = a[key], r[key]
            scale = r.abs().max().item()
            torch.testing.assert_close(a, r, atol=1e-3 * scale, rtol=1e-3)


def _xlstm_model(cuda, n_layers=4):
    """xlstm-125m at full width (d 768, 4 heads: mLSTM head dim 384, sLSTM
    head dim 192) cut to ``n_layers`` (2 units by default) in 2 blocks;
    the AdaLN heads randomised."""
    import dataclasses
    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=n_layers)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dbm.init(gen)
    for kind in ("slstm", "mlstm"):
        for k in ("w", "b"):
            params["units"][kind]["adaln"][k].normal_(0.0, 0.02,
                                                      generator=gen)
    return dbm, params


@pytest.mark.gpu
def test_gate_residual_kernel_at_the_xlstm_probe_shape(cuda):
    """Row 3 at the xLSTM probes' shape: (8, 1, 768) fp32, the gate a
    column slice of the block's 3-mod AdaLN heads; bit-equal to the plain
    version, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    res, br = (torch.randn(8, 1, 768, generator=gen, device=cuda)
               for _ in range(2))
    heads = torch.randn(8, 3 * 768, generator=gen, device=cuda)
    gate = heads[:, 2 * 768:]
    n0 = K.launch_counts()["gate_residual"]
    out = AD.gate_residual(res, br, gate)
    torch.cuda.synchronize()
    assert K.launch_counts()["gate_residual"] == n0 + 1
    torch.testing.assert_close(out, AD.gate_residual_ref(res, br, gate),
                               atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_xlstm_decode_steps_on_the_card_match_the_cpu(cuda, kind):
    """The cells' decode steps at full width (plain torch on the card) over
    8 tokens from the init state against the same steps on the CPU: every
    output and state leaf within 2e-4 (TF32 off)."""
    from repro_torch.nn import xlstm as X
    dbm, params = _xlstm_model(cuda)
    cfg = dbm.cfg
    cell = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0])
            for k, v in params["units"][kind]["cell"].items()}
    cpu = tree_map(lambda _, x: x.cpu(), cell)
    H, d = cfg.n_heads, cfg.d_model
    if kind == "mlstm":
        init, step, width = X.mlstm_init_state, X.mlstm_decode_step, 2 * d
    else:
        init, step, width = X.slstm_init_state, X.slstm_decode_step, d
    sg, sc = init(8, H, width, device=cuda), init(8, H, width, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        x = torch.randn(8, 1, d, generator=gen)
        yg, sg = step(cell, x.to(cuda), H, cfg.xlstm, sg)
        yc, sc = step(cpu, x, H, cfg.xlstm, sc)
        for a, b in zip((yg, *sg), (yc, *sc)):
            torch.testing.assert_close(a.cpu(), b, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_two_pass_on_the_card_matches_the_cpu(cuda, kind):
    """The cells' two-pass functions at full width (plain torch on the card)
    over 600 tokens (past 512: the clean mLSTM in its chunked form, the
    history query over 3 chunks of 256) against the same calls on the
    CPU: both streams within 2e-4 (TF32 off)."""
    from repro_torch.nn import xlstm as X
    dbm, params = _xlstm_model(cuda)
    cfg = dbm.cfg
    cell = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0])
            for k, v in params["units"][kind]["cell"].items()}
    cpu = tree_map(lambda _, x: x.cpu(), cell)
    fn = getattr(X, f"{kind}_two_pass")
    gen = torch.Generator().manual_seed(2)
    xc, xn = (torch.randn(2, 600, cfg.d_model, generator=gen)
              for _ in range(2))
    with torch.no_grad():
        got = fn(cell, xc.to(cuda), xn.to(cuda), cfg.n_heads, cfg.xlstm)
        want = fn(cpu, xc, xn, cfg.n_heads, cfg.xlstm)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_xlstm_step_through_kernels_matches_plain_versions(cuda, mode):
    """The xLSTM's training (``_xlstm_model``: 2 units at full width in 2
    blocks): one fp32 DB step of each block (two-pass) and one e2e step,
    through the kernels and through the plain versions from the same
    params and draws: loss, grad norm and the first moment of every
    trained leaf within 1e-4 relative (a leaf: max |diff| over max |ref|;
    the cells are plain torch on both paths), and the launch counts the
    path's arithmetic (DB: two gate-residual calls a unit on the noisy
    stream, forward and backward; e2e: none, no σ)."""
    from repro_torch.nn.init import tree_items
    dbm, master = _xlstm_model(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, dbm.cfg.vocab_size, (2, 150), generator=gen,
                           device=cuda)
    sigma = torch.rand(2, 1, 1, generator=gen, device=cuda) + 0.1
    eps = torch.randn(2, 150, dbm.cfg.d_model, generator=gen, device=cuda)
    tcfg = TrainConfig(steps=10, warmup_steps=2, lr=1e-3)
    blocks = range(dbm.num_blocks) if mode == "db" else [None]
    for b in blocks:
        res = {}
        for impl in ("ref", "kernels"):
            params = tree_map(lambda _, x: x.clone(), master)
            if mode == "db":
                init, step = T.make_db_train_step(dbm, b, tcfg, impl=impl)
                kw = {"sigma": sigma, "eps": eps}
                n = 2 * dbm.ranges[b][1]
                want = {"gate_residual": n, "gate_residual_bwd": n}
            else:
                init, step = T.make_e2e_train_step(dbm, tcfg, impl=impl)
                kw, want = {}, {}
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), tokens, **kw)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            assert counts == {**{k: 0 for k in counts},
                              **(want if impl == "kernels" else {})}
            res[impl] = (loss, m["grad_norm"], dict(tree_items(opt.mu)))
        (lr_, gr, mr), (lk, gk, mk) = res["ref"], res["kernels"]
        assert torch.isfinite(lk) and abs(lk - lr_) <= 1e-4 * abs(lr_)
        assert torch.isfinite(gk) and abs(gk - gr) <= 1e-4 * abs(gr)
        assert sorted(mk) == sorted(mr)
        for path, r in mr.items():
            scale = r.abs().max().item()
            assert (mk[path] - r).abs().max().item() <= 1e-4 * scale, path


@pytest.mark.gpu
@pytest.mark.parametrize("commit", [False, True])
def test_xlstm_unit_through_kernels_matches_plain_versions(cuda, commit):
    """Both units at full width over 8 slots through ``impl="kernels"``
    against ``impl="ref"`` from the same state: a σ-conditioned probe (one
    gate-residual launch a block) or a commit with slot 3 inactive (no
    kernel: the commit's gates are plain adds); h and every state leaf
    within 2e-4, and the probe leaves the state bit-unchanged."""
    from repro_torch.models.common import LayerCtx
    from repro_torch.nn import cache as KVC
    dbm, params = _xlstm_model(cuda)
    m = dbm.model
    gen = torch.Generator(device=cuda).manual_seed(2)
    kv0 = m.init_paged_cache(8, 1, 16, device=cuda)
    for t in KVC.cache_tensors(kv0):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda).abs() + 0.5)
    h = torch.randn(8, 1, dbm.cfg.d_model, generator=gen, device=cuda)
    active = torch.ones(8, dtype=torch.bool, device=cuda)
    active[3] = False
    out = {}
    for impl in ("ref", "kernels"):
        kv = {k: tuple(t.clone() for t in v) for k, v in kv0.items()}
        ctx = LayerCtx(cfg=dbm.cfg, mode="decode", impl=impl, commit=commit,
                       active=active if commit else None)
        if not commit:
            ctx.cond = m.cond(params, torch.full((8,), 0.5, device=cuda))
        K.reset_launch_counts()
        hh, _ = m.apply_units(params, h, 0, m.n_units, ctx, kv,
                              [True, True] if commit else None)
        torch.cuda.synchronize()
        out[impl] = (hh, kv, K.launch_counts()["gate_residual"])
    (hr, kr, nr), (hk, kk, nk) = out["ref"], out["kernels"]
    assert nr == 0 and nk == (0 if commit else 2 * m.n_units)
    torch.testing.assert_close(hk, hr, atol=TOL, rtol=TOL)
    for a, b, c in zip(KVC.cache_tensors(kk), KVC.cache_tensors(kr),
                       KVC.cache_tensors(kv0)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
        if not commit:
            assert torch.equal(a, c)
        else:
            assert torch.equal(a[:, 3], c[:, 3])


def _xlstm_run(dbm, params, cuda, graphs):
    """Five ragged requests on 2 slots (recycled: each admission resets the
    slot's state to the init values), the first preempted once mid-decode
    (its state rows spilled and restored); the state's addresses checked
    after every step. Returns (batcher, {rid: tokens}, counts)."""
    from repro_torch.nn import cache as KVC
    cb = S.ContinuousBatcher(
        dbm, params, num_slots=2, page_size=16, max_prompt=80, max_len=112,
        seg_len=4, chunk_size=16, precision="bf16", graphs=graphs,
        generator=torch.Generator(device=cuda).manual_seed(3))
    ptrs = KVC.pool_ptrs(cb.kv)
    gen = torch.Generator().manual_seed(1)
    for n in (70, 9, 33, 51, 12):
        cb.submit(torch.randint(0, dbm.cfg.vocab_size, (n,), generator=gen)
                  .numpy(), 24)
    K.reset_launch_counts()
    done, step = [], 0
    while cb.has_work():
        if step == 6 and cb.slot_req[0] is not None:
            cb.preempt(cb.slot_req[0].rid)
        done.extend(cb.step())
        assert KVC.pool_ptrs(cb.kv) == ptrs
        step += 1
    torch.cuda.synchronize()
    return cb, {r.rid: r.out for r in done}, K.launch_counts()


@pytest.mark.gpu
def test_xlstm_graph_segments_bit_equal_to_eager(cuda):
    """The xLSTM (full width, 2 units) through the batcher's CUDA graphs
    (its state the graphs' static buffers, written in place; the chunk
    step a chain of per-token steps): tokens and state bit-equal to the
    eager dispatches, a preemption restored, and the launches the path's
    arithmetic (a gate-residual per block in the probes, per step; none in
    the chunk or the commit)."""
    from repro_torch.nn import cache as KVC
    dbm, params = _xlstm_model(cuda)
    (ce, de, ne), (cg, dg, ng) = (_xlstm_run(dbm, params, cuda, g)
                                  for g in (False, True))
    assert dg == de and all(len(t) == 24 for t in dg.values())
    assert cg.preemptions == 1 and cg.restores == 1
    for a, b in zip(KVC.cache_tensors(cg.kv), KVC.cache_tensors(ce.kv)):
        assert torch.equal(a, b)
    for cb, counts in ((ce, ne), (cg, ng)):
        steps = cb.steps + cb.graph_warmups["segment"]
        want = {"gate_residual": dbm.cfg.n_layers * steps}
        assert counts == {**{k: 0 for k in counts}, **want}
    assert cg.graph_warmups == {"chunk": 1, "segment": 1}


# ---------------------------------------------------------------------------
# the pod-per-block engine: 4 gloo ranks on the one card
# ---------------------------------------------------------------------------

MESH_POLICIES = ("replicate+psum-mean", "owner-broadcast",
                 "freeze-after-warmup")


def _mesh_model():
    """TINY8's widths (8 layers, d 64, vocab 64) with one head of 64, the
    attention kernels' head dim, in 4 blocks; fp32 params from seed 0 made
    on the CPU (the AdaLN heads randomised), as numpy."""
    from repro_torch.bridge import params_to_numpy
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), name="tiny8-hd64",
                              n_layers=8, d_model=64, n_heads=1,
                              n_kv_heads=1, head_dim=64, d_ff=128,
                              vocab_size=64)
    db = DBConfig(num_blocks=4, overlap_gamma=0.05)
    dbm = DiffusionBlocksModel(cfg, db)
    gen = torch.Generator().manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, {"cfg": dataclasses.asdict(cfg), "db": dataclasses.asdict(db),
                 "params": params_to_numpy(params)}


@pytest.mark.gpu
def test_mesh_step_on_the_card_matches_round_robin(cuda, tmp_path):
    """4 ranks on the one card (gloo), fp32 through the attention kernels:
    one step per periphery policy from the same params and draws against
    the round-robin engine on the card, within 1e-5 (the periphery mean's
    summation order is the only difference); the periphery bit-equal on
    every rank."""
    from torch_mesh_worker import spawn
    from repro_torch.bridge import params_from_jax
    from repro_torch.checkpoint import ckpt
    from repro_torch.parallel import BlockParallelTrainer
    dbm, model = _mesh_model()
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 64, (4, 16), generator=gen).numpy()
    draws = [(dbm.sample_block_sigma(gen, (4, 1, 1), b).numpy(),
              torch.randn(4, 16, 64, generator=gen).numpy())
             for b in range(4)]
    tcfg = TrainConfig(steps=8, batch_size=4, seq_len=16, lr=2e-3,
                       warmup_steps=2, log_every=0)
    tasks = [(p, {"kind": "steps", "model": model,
                  "tcfg": dataclasses.asdict(tcfg), "policy": p,
                  "precision": "fp32",
                  "steps": [{"tokens": tokens, "draws": draws}]})
             for p in MESH_POLICIES]
    res = spawn({"device": "cuda", "backend": "gloo", "tasks": tasks},
                tmp_path)
    for p in MESH_POLICIES:
        tr = BlockParallelTrainer(dbm, tcfg, periphery=p, precision="fp32")
        state = tr.init_state(params_from_jax(model["params"], cuda,
                                              dbm.model.spec))
        state, losses, gnorms = tr.step(state, tokens, draws=[
            tuple(torch.from_numpy(x) for x in d) for d in draws])
        want = {"params": tr.full_params(state), "stack_opt": state.stack_opt,
                "periph_opt": state.periph_opt}
        for out in res:
            assert out[p]["mesh_device"] == "cuda"   # the ranks' device
            got = out[p]["steps"][0]
            assert got["periph_digest"] == res[0][p]["steps"][0][
                "periph_digest"]
            torch.testing.assert_close(got["losses"], losses, rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(got["gnorms"], gnorms, rtol=1e-5,
                                       atol=1e-5)
            for part in want:
                w = dict(ckpt._items(want[part]))
                for key, x in ckpt._items(got[part]):
                    torch.testing.assert_close(
                        x.float(), w[key].float().cpu(), rtol=1e-5,
                        atol=1e-5, msg=f"{p} {part} {key}")


@pytest.mark.gpu
def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """NCCL with two ranks on one device fails with NCCL's own error; the
    port does not switch to gloo behind the caller's back."""
    if torch.cuda.device_count() > 1:
        pytest.skip("checks two ranks sharing one card")
    from torch_mesh_worker import spawn
    with pytest.raises(RuntimeError, match="Duplicate GPU|NCCL"):
        spawn({"device": "cuda", "backend": "nccl", "tasks": []}, tmp_path,
              world=2, timeout_s=120)
