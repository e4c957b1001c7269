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
@pytest.mark.parametrize("mode", ["db", "e2e"])
def test_train_step_through_kernels_matches_plain_versions(cuda, mode):
    """One fp32 training step through the kernels and through the plain
    versions from the same params and draws: loss, grad norm and the
    updated params agree, and the launch counts are the path's
    arithmetic (one fwd, dq and dk/dv per layer)."""
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=4, d_model=512,
                  n_heads=8)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=2, overlap_gamma=0.1))
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
        if mode == "db":
            init, step = T.make_db_train_step(dbm, 1, tcfg, impl=impl)
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), tokens,
                                        sigma=sigma, eps=eps)
            n_layers = dbm.ranges[1][1]
        else:
            init, step = T.make_e2e_train_step(dbm, tcfg, impl=impl)
            K.reset_launch_counts()
            params, opt, loss, m = step(params, init(params), tokens)
            n_layers = cfg.n_layers
        torch.cuda.synchronize()
        counts = K.launch_counts()
        expect = 0 if impl == "ref" else n_layers
        assert {k: counts[k] for k in counts if k.startswith("flash_att")} \
            == {k: expect for k in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")}
        res[impl] = (loss, m["grad_norm"], opt.mu["layers"]["attn"])
    (lr_, gr, mr), (lk, gk, mk) = res["ref"], res["kernels"]
    assert torch.isfinite(lk) and abs(lk - lr_) <= 1e-4 * abs(lr_)
    assert abs(gk - gr) <= 1e-3 * abs(gr)
    for name in ("wq", "wk", "wv"):   # first moments: 0.1 x the grads
        scale = mr[name].abs().max().item()
        torch.testing.assert_close(mk[name], mr[name], atol=1e-3 * scale,
                                   rtol=1e-3)


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
