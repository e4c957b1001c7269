"""Flash-decode over a paged KV pool: one query token per slot, split-KV
online softmax over the committed tokens (port of
``repro.kernels.flash_decode``; CUDA source ``csrc/flash_decode.cu``).

``flash_decode`` launches the Hopper kernel on CUDA tensors and runs
``flash_decode_ref``, its plain PyTorch version, on CPU tensors; it never
falls back from one to the other. It returns the partials ``(out, lse)``
over tokens ``idx < lengths[b]`` (and ``idx > lengths[b] - window``);
``combine_self`` folds in the current token's own k/v, as in JAX.

The kernel stages 32-key K/V tiles in a per-warp ring of shared memory
and picks its warps a block itself; ``decode_splits`` is the plain function
that sizes the rest of its launch (blocks per (slot, kv head)).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SUPPORTED_HD = (64, 120, 128)       # stablelm; h2o-danube3; olmo, qwen
MAX_GROUP = 8
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TILE_KEYS = 32           # keys of a warp's tile: one a lane
BLOCK_TILES = 16         # a split leaves a block at least this many tiles
MAX_SPLIT = 16
_FN = {}


def decode_splits(pairs: int, tiles: int, sms: int) -> int:
    """Blocks per (slot, kv head). One when the B * KV pairs alone give
    every SM a block; else enough for about two blocks an SM, but no more
    than leave each block BLOCK_TILES of the ``tiles`` key tiles a pair can
    have (at most MAX_SPLIT). ``tune_paged_decode.py`` times the split: a
    block's share must outweigh the merge launch, so a pair of 17 tiles
    (544 keys) runs fastest, or near it, as one block, and one of 128 or
    more runs 1.15-5.5x faster split."""
    if pairs >= sms:
        return 1
    want = -(-2 * sms // pairs)
    return max(1, min(want, tiles // BLOCK_TILES, MAX_SPLIT))


def max_tiles(n_keys: int, window: Optional[int]) -> int:
    """The most 32-key tiles a slot's visible keys can touch: all of the
    pool's ``n_keys``, or a window's ``window - 1`` keys, which may start
    mid-tile."""
    if window is None:
        return -(-n_keys // TILE_KEYS)
    return -(-min(n_keys, window - 1) // TILE_KEYS) + 1


def _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale):
    """Logical K/V per slot, fp32: (B, KV, L, hd) with L = npg * psz."""
    B, npg = page_table.shape
    _, psz, KV, hd = k_pages.shape
    tbl = page_table.long()
    kk = k_pages[tbl].float()                 # (B, npg, psz, KV, hd)
    vv = v_pages[tbl].float()
    if k_scale is not None:                   # per-page dequant
        kk = kk * k_scale.reshape(-1)[tbl][..., None, None, None]
        vv = vv * v_scale.reshape(-1)[tbl][..., None, None, None]
    L = npg * psz
    return (kk.reshape(B, L, KV, hd).permute(0, 2, 1, 3),
            vv.reshape(B, L, KV, hd).permute(0, 2, 1, 3))


def flash_decode_ref(q, k_pages, v_pages, page_table, lengths, *,
                     window: Optional[int] = None, k_scale=None,
                     v_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the gather reference of ``repro.nn.cache``
    (``_attend_pages_ref``) without the self column, returning the same
    ``(out, lse)`` partials as the kernel. Masked scores are a finite
    -1e30 and the normaliser is max(l, 1e-30), so an empty slot gives
    out = 0 and lse ~ -1e30."""
    B, KV, G, hd = q.shape
    kk, vv = _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    L = kk.shape[2]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kk) * scale
    idx = torch.arange(L, device=q.device)
    lens = lengths.long()[:, None]
    valid = idx[None, :] < lens
    if window is not None:
        valid &= idx[None, :] > lens - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.clamp(p.sum(-1), min=1e-30)
    out = torch.einsum("bkgs,bksd->bkgd", p, vv) / l[..., None]
    return out, m + torch.log(l)


def check_paged(name, q, k_pages, v_pages, page_table, lengths, window,
                k_scale, v_scale) -> None:
    """Raise on inputs the paged-attention kernels do not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    named = dict(k_pages=k_pages, v_pages=v_pages, page_table=page_table,
                 lengths=lengths, k_scale=k_scale, v_scale=v_scale)
    for what, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be fp32 or bf16, got {q.dtype}")
    if k_pages.dtype not in PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: pages must share one of "
                        f"{list(PAGE_DTYPES)}, got {k_pages.dtype} and "
                        f"{v_pages.dtype}")
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pages must be (P, psz, KV, hd) alike, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    P, _, KV, hd = k_pages.shape
    if hd not in SUPPORTED_HD:
        raise NotImplementedError(f"{name}: head_dim {hd} not in "
                                  f"{SUPPORTED_HD}")
    if q.shape[-1] != hd or q.shape[-3] != KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pages "
                         f"{tuple(k_pages.shape)}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError(f"{name}: int8 pages need k_scale and v_scale, "
                         "float pages take neither")
    if quantized:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.numel() != P \
                    or not s.is_contiguous():
                raise ValueError(f"{name}: scales must be contiguous fp32 "
                                 f"with one entry per page ({P})")
    B = q.shape[0]
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and lengths must be int32")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: page_table (B, npg) and lengths (B,) "
                         f"with B={B}")
    for what, t in dict(q=q, k_pages=k_pages, v_pages=v_pages,
                        page_table=page_table, lengths=lengths).items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in dict(q=q, k_pages=k_pages, v_pages=v_pages).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive or None")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel():
    if "fn" not in _FN:
        fn = _build.load("flash_decode").rt_flash_decode
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                       I, ctypes.c_float, I, I, P]
        fn.restype = I
        _FN["fn"] = fn
    return _FN["fn"]


def flash_decode(q, k_pages, v_pages, page_table, lengths, *,
                 window: Optional[int] = None, k_scale=None, v_scale=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-KV paged decode attention over committed tokens.

    q: (B, KV, G, hd) fp32 or bf16; k_pages/v_pages: (P, psz, KV, hd) fp32,
    bf16 or int8; page_table: (B, npg) int32 (entries past a slot's
    allocation point at the trash page); lengths: (B,) int32;
    k_scale/v_scale: per-page fp32 scales ((P,) or (P, 1, 1, 1)) of an int8
    pool. Returns out (B, KV, G, hd) fp32 and lse (B, KV, G) fp32.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                window=window, k_scale=k_scale,
                                v_scale=v_scale)
    check_paged("flash_decode", q, k_pages, v_pages, page_table, lengths,
                window, k_scale, v_scale)
    B, KV, G, hd = q.shape
    if G > MAX_GROUP:
        raise NotImplementedError(f"flash_decode: group {G} > {MAX_GROUP}")
    npg, psz = page_table.shape[1], k_pages.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = decode_splits(B * KV, max_tiles(npg * psz, window), sms)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    part = (torch.empty(B * KV * nsplit * G * (hd + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
            v_pages.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(part), B, KV, G, hd, npg, psz, window or 0,
            1.0 / (hd ** 0.5), PAGE_DTYPES[k_pages.dtype], nsplit,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out, lse


flash_decode.launches = 0


def combine_self(out, lse, s_self, v_self):
    """Merge the paged partial with the current token's own (k, v): a
    two-partial flash combine. ``s_self`` (B, KV, G) is the self score,
    ``v_self`` (B, KV, hd) its value; an empty cache (lse ~ -1e30) gives
    pure self-attention."""
    m = torch.maximum(lse, s_self)
    w_cache = torch.exp(lse - m)
    w_self = torch.exp(s_self - m)
    num = out * w_cache[..., None] + v_self[:, :, None, :] * w_self[..., None]
    return num / (w_cache + w_self)[..., None]
