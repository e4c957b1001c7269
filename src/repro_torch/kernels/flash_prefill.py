"""Chunked-prefill attention over a paged KV pool: a chunk of C query
tokens per slot attends [committed history || intra-chunk causal] in one
launch (port of ``repro.kernels.flash_prefill``; CUDA source
``csrc/flash_prefill.cu``).

The chunk occupies positions [lengths[b], lengths[b] + C) and its own k/v
are already in the pool; row r = i*G + g sees keys ``idx <= lengths[b] + i``
(and ``idx > lengths[b] + i - window``). ``flash_prefill`` launches a
Hopper kernel on CUDA tensors and runs ``flash_prefill_ref`` on CPU tensors.
Which kernel is a plain function of the dtypes (``prefill_route``), with no
fallback from one to the other, both on the tensor cores: bf16 q over bf16
or int8 pages goes to ``prefill_tc_kernel`` (bf16 products), fp32 q or fp32
pages to ``prefill_tf32_kernel`` (3xTF32 products, fp32 accuracy).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import (NEG_INF, PAGE_DTYPES,
                                              _gather_pages, _ptr,
                                              check_paged)

_FN = {}


def prefill_route(q_dtype: torch.dtype, page_dtype: torch.dtype) -> str:
    """``"tc"``: ``prefill_tc_kernel`` (bf16 q over bf16 or int8 pages, every
    bf16 policy); ``"tf32"``: ``prefill_tf32_kernel`` (fp32 q or fp32 pages,
    the fp32 and fp32_kvint8 policies)."""
    if q_dtype == torch.bfloat16 and page_dtype in (torch.bfloat16,
                                                    torch.int8):
        return "tc"
    return "tf32"


def flash_prefill_ref(q, k_pages, v_pages, page_table, lengths, *,
                      window: Optional[int] = None, k_scale=None,
                      v_scale=None) -> torch.Tensor:
    """Plain version: the gather reference of ``repro.nn.cache``
    (``_attend_prefill_ref``). Returns (B, C, KV, G, hd) fp32."""
    B, C, KV, G, hd = q.shape
    kk, vv = _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    L = kk.shape[2]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bckgd,bksd->bkgcs", q.float(), kk) * scale
    idx = torch.arange(L, device=q.device)
    qabs = lengths.long()[:, None] + torch.arange(C, device=q.device)
    valid = idx[None, None, :] <= qabs[:, :, None]          # (B, C, L)
    if window is not None:
        valid &= idx[None, None, :] > qabs[:, :, None] - window
    valid = valid[:, None, None, :, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgcs,bksd->bkgcd", p / l, vv)
    return out.permute(0, 3, 1, 2, 4)                        # (B,C,KV,G,hd)


def _kernel(route: str):
    """The C entry point of a route (both take the same arguments)."""
    if route not in _FN:
        name = f"rt_flash_prefill_{route}"
        fn = getattr(_build.load("flash_prefill"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, I, P]
        fn.restype = I
        _FN[route] = fn
    return _FN[route]


def flash_prefill(q, k_pages, v_pages, page_table, lengths, *,
                  window: Optional[int] = None, k_scale=None,
                  v_scale=None) -> torch.Tensor:
    """q: (B, C, KV, G, hd) fp32 or bf16 at positions lengths[b] + i, whose
    own k/v are already appended; pages, table, lengths and scales as in
    ``flash_decode``. Returns (B, C, KV, G, hd) fp32, fully normalised."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_pages, v_pages, page_table, lengths,
                                 window=window, k_scale=k_scale,
                                 v_scale=v_scale)
    if q.ndim != 5:
        raise ValueError(f"flash_prefill: q must be (B, C, KV, G, hd), got "
                         f"{tuple(q.shape)}")
    check_paged("flash_prefill", q, k_pages, v_pages, page_table, lengths,
                window, k_scale, v_scale)
    B, C, KV, G, hd = q.shape
    route = prefill_route(q.dtype, k_pages.dtype)
    out = torch.empty((B, C, KV, G, hd), dtype=torch.float32,
                      device=q.device)
    # check_paged holds both routes to 16-byte aligned, contiguous q and
    # pages, which is the layout both kernels' 16-byte copies need
    with torch.cuda.device(q.device):
        rc = _kernel(route)(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
            v_pages.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, C, KV, G, hd, page_table.shape[1], k_pages.shape[1],
            window or 0, 1.0 / (hd ** 0.5), PAGE_DTYPES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
