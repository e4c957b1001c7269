"""Paged KV cache for serving and the paged attends (port of
``repro.nn.cache``).

Keys and values live in a pool of fixed-size pages shared by every slot:

  pages      (n_units, P, page_size, KV, hd)  stacked over the model's units
  page_table (B, n_logical_pages) int32       physical page per logical page
  lengths    (B,) int32                       committed tokens per slot

Physical page 0 is the trash page: writes of inactive slots and of ragged
chunk tails are redirected there, so every append is one dense scatter.

Unlike the JAX package, whose arrays are immutable, the port appends IN
PLACE: ``append_paged`` and ``append_paged_chunk`` write into the pool they
are given and return it. A full-width pool is hundreds of MB per layer, and
a functional copy per appended token would dominate the step. Callers that
need the old pool (tests, the kernel cross-check) clone it first.

The gather references of JAX's ``_attend_pages_ref``/``_attend_prefill_ref``
are the kernels' plain versions (``flash_decode_ref``, ``flash_prefill_ref``):
``impl="ref"`` routes the attends through them on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_decode import (combine_self, flash_decode,
                                              flash_decode_ref)
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref
from repro_torch.nn import attention as A
from repro_torch.nn.layers import apply_rope, as_dtype

NEG_INF = -1e30
TRASH_PAGE = 0
DEFAULT_PAGE_SIZE = 16
KV_SCALE_DTYPE = torch.float32
IMPLS = A.IMPLS


@dataclasses.dataclass
class PagedKV:
    """A paged key/value pool. ``k``/``v`` are (*units, P, psz, KV, hd);
    ``k_scale``/``v_scale`` are present only for quantized (int8) pools:
    one fp32 scale per physical page, shaped (*units, P, 1, 1, 1) so the
    page axis lines up with the pages'. ``unit(u)``/``units(start, size)``
    give views that share storage with the pool."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def _map(self, fn) -> "PagedKV":
        return PagedKV(*(None if t is None else fn(t)
                         for t in (self.k, self.v, self.k_scale,
                                   self.v_scale)))

    def unit(self, u: int) -> "PagedKV":
        return self._map(lambda t: t[u])

    def units(self, start: int, size: int) -> "PagedKV":
        return self._map(lambda t: t[start:start + size])

    def clone(self) -> "PagedKV":
        return self._map(torch.clone)


def resolve_kv_dtype(dtype) -> torch.dtype:
    """Resolve a KV storage dtype spec (``'bf16' | 'int8' | torch dtype``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "fp32": torch.float32, "f32": torch.float32,
             "float32": torch.float32, "fp16": torch.float16,
             "float16": torch.float16, "int8": torch.int8}
    try:
        return table[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown KV dtype {dtype!r}") from None


def is_quantized_dtype(dtype) -> bool:
    return not resolve_kv_dtype(dtype).is_floating_point


def quantize_pages(x: torch.Tensor, dtype=torch.int8):
    """Per-page symmetric absmax quantization of (..., psz, KV, hd) float
    pages. Returns (q, scale) with scale fp32 (..., 1, 1, 1); all-zero
    pages get scale 0."""
    qmax = float(torch.iinfo(dtype).max)
    xf = x.float()
    absmax = xf.abs().amax(dim=(-3, -2, -1), keepdim=True)
    scale = absmax / qmax
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv), -qmax, qmax).to(dtype)
    return q, scale.to(KV_SCALE_DTYPE)


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_paged_kv(n_pages: int, page_size: int, dims: A.AttnDims,
                  dtype=torch.bfloat16, n_units: Optional[int] = None,
                  device="cuda") -> PagedKV:
    """A zeroed pool; ``n_units`` prepends the stacked unit axis."""
    dtype = resolve_kv_dtype(dtype)
    lead = () if n_units is None else (n_units,)
    shape = lead + (n_pages, page_size, dims.n_kv_heads, dims.head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if is_quantized_dtype(dtype):
        sshape = lead + (n_pages, 1, 1, 1)
        return PagedKV(k, v,
                       torch.zeros(sshape, dtype=KV_SCALE_DTYPE,
                                   device=device),
                       torch.zeros(sshape, dtype=KV_SCALE_DTYPE,
                                   device=device))
    return PagedKV(k, v)


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def identity_page_table(batch: int, pages_per_slot: int,
                        device="cuda") -> torch.Tensor:
    """Static allocation: slot b owns pages [1 + b*pps, 1 + (b+1)*pps) —
    page 0 stays reserved as the trash page."""
    return (1 + torch.arange(batch * pages_per_slot, dtype=torch.int32,
                             device=device)).reshape(batch, pages_per_slot)


def cache_bytes(pkv: PagedKV) -> int:
    """Total bytes of a pool: page bytes plus, for int8 pools, the fp32
    scales (each tensor at its own dtype's size)."""
    return sum(t.numel() * t.element_size()
               for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
               if t is not None)


def append_paged(pkv: PagedKV, k_new, v_new, page_table, lengths,
                 active=None) -> PagedKV:
    """Write one token's (k, v) per slot at logical position ``lengths[b]``,
    in place. k_new/v_new: (B, KV, hd). Inactive slots write to the trash
    page. Quantized pools requantize each touched page, zeroing positions
    past the new token first (stale data would inflate the scale)."""
    psz = pkv.page_size
    lens = lengths.long()
    logical = lens // psz
    slot = lens % psz
    phys = torch.gather(page_table.long(), 1, logical[:, None])[:, 0]
    if active is not None:
        phys = torch.where(active, phys, torch.full_like(phys, TRASH_PAGE))
    if not pkv.quantized:
        pkv.k[phys, slot] = k_new.to(pkv.k.dtype)
        pkv.v[phys, slot] = v_new.to(pkv.v.dtype)
        return pkv
    B = k_new.shape[0]
    rows = torch.arange(B, device=k_new.device)
    keep = (torch.arange(psz, device=k_new.device)[None, :]
            <= slot[:, None])[..., None, None]

    def one(pool, scale, new):
        pg = dequantize_pages(pool[phys], scale[phys])    # (B, psz, KV, hd)
        pg[rows, slot] = new.float()
        q, s = quantize_pages(torch.where(keep, pg, torch.zeros_like(pg)),
                              pool.dtype)
        pool[phys] = q
        scale[phys] = s

    one(pkv.k, pkv.k_scale, k_new)
    one(pkv.v, pkv.v_scale, v_new)
    return pkv


def append_paged_chunk(pkv: PagedKV, k_new, v_new, page_table, lengths,
                       n_valid) -> PagedKV:
    """Write a chunk of C tokens' (k, v) per slot in one scatter, in place:
    chunk token i of slot b lands at logical position ``lengths[b] + i``;
    tokens at i >= ``n_valid[b]`` go to the trash page. k_new/v_new:
    (B, C, KV, hd)."""
    B, C = k_new.shape[:2]
    psz = pkv.page_size
    dev = k_new.device
    lens = lengths.long()
    tbl = page_table.long()
    npg = tbl.shape[1]
    nv = n_valid.long()
    if not pkv.quantized:
        pos = lens[:, None] + torch.arange(C, device=dev)[None, :]
        logical = torch.clamp(pos // psz, 0, npg - 1)
        slot = pos % psz
        phys = torch.gather(tbl, 1, logical)                      # (B, C)
        valid = torch.arange(C, device=dev)[None, :] < nv[:, None]
        phys = torch.where(valid, phys, torch.full_like(phys, TRASH_PAGE))
        fp, fs = phys.reshape(-1), slot.reshape(-1)
        pkv.k[fp, fs] = k_new.reshape(B * C, *k_new.shape[2:]).to(pkv.k.dtype)
        pkv.v[fp, fs] = v_new.reshape(B * C, *v_new.shape[2:]).to(pkv.v.dtype)
        return pkv
    # Quantized pool: requantize every page the chunk touches (at most
    # C // psz + 1 per slot), zeroing everything past lengths + n_valid.
    npt = C // psz + 1
    base = lens // psz
    tlog = base[:, None] + torch.arange(npt, device=dev)            # (B, npt)
    tphys = torch.gather(tbl, 1, torch.clamp(tlog, 0, npg - 1))
    end = lens + nv
    real = tlog * psz < end[:, None]
    tphys = torch.where(real, tphys, torch.full_like(tphys, TRASH_PAGE))
    span = npt * psz
    rows = torch.arange(B, device=dev)[:, None]
    rel = (lens % psz)[:, None] + torch.arange(C, device=dev)
    keep = ((base[:, None] * psz + torch.arange(span, device=dev))
            < end[:, None])[..., None, None]                     # (B,span,1,1)
    fp = tphys.reshape(-1)

    def one(pool, scale, new):
        pg = dequantize_pages(pool[tphys], scale[tphys])  # (B,npt,psz,KV,hd)
        tail = pg.shape[3:]
        flat = pg.reshape(B, span, *tail)
        flat[rows, rel] = new.float()
        flat = torch.where(keep, flat, torch.zeros_like(flat))
        q, s = quantize_pages(flat.reshape(B, npt, psz, *tail), pool.dtype)
        pool[fp] = q.reshape(B * npt, psz, *tail)
        scale[fp] = s.reshape(B * npt, 1, 1, 1)

    one(pkv.k, pkv.k_scale, k_new)
    one(pkv.v, pkv.v_scale, v_new)
    return pkv


# ---------------------------------------------------------------------------
# Attend over the pool (committed tokens < lengths[b]) + the token's own k/v
# ---------------------------------------------------------------------------

def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def attend_paged(qg, pkv: PagedKV, page_table, lengths, k_self, v_self, *,
                 window: Optional[int] = None, impl: str = "kernels"):
    """qg: (B, KV, G, hd); k_self/v_self: (B, KV, hd). The paged partials come
    from ``flash_decode`` (``impl="kernels"``: the kernel on CUDA tensors,
    its plain version on CPU tensors) or straight from its plain version
    (``impl="ref"``); the current token's own k/v is folded in by
    ``combine_self``. Returns (B, KV, G, hd) fp32."""
    _check_impl(impl)
    fd = flash_decode if impl == "kernels" else flash_decode_ref
    out_p, lse = fd(qg, pkv.k, pkv.v, page_table, lengths, window=window,
                    k_scale=pkv.k_scale, v_scale=pkv.v_scale)
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    s_self = torch.einsum("bkgd,bkd->bkg", qg.float(),
                          k_self.float()) * scale
    return combine_self(out_p, lse, s_self, v_self.float())


def paged_decode_attention(params, x, dims: A.AttnDims, pkv: PagedKV, *,
                           lengths, page_table, active=None,
                           commit: bool = True,
                           window: Optional[int] = None,
                           impl: str = "kernels"):
    """One-token decode over one unit's paged pool. x: (B, 1, d); each
    slot's token sits at its own position ``lengths[b]``. ``commit=False``
    is the denoising probe: attend, never append. Returns (out, pkv)."""
    B = x.shape[0]
    q, k, v = A.project_qkv(params, x, dims)
    posv = lengths[:, None]
    q = apply_rope(q, posv, dims.rope_theta)
    k = apply_rope(k, posv, dims.rope_theta)
    KV, G, hd = dims.n_kv_heads, dims.q_per_kv, dims.head_dim
    qg = q[:, 0].reshape(B, KV, G, hd)
    k_self, v_self = k[:, 0], v[:, 0]
    out = attend_paged(qg, pkv, page_table, lengths, k_self, v_self,
                       window=window, impl=impl)
    out = out.reshape(B, 1, dims.n_heads * hd).to(x.dtype)
    out = out @ as_dtype(params["wo"], x.dtype)
    if commit:
        append_paged(pkv, k_self, v_self, page_table, lengths, active)
    return out, pkv


# ---------------------------------------------------------------------------
# Chunked prefill: the chunk's own k/v are appended FIRST, so one attend
# covers history + intra-chunk causal
# ---------------------------------------------------------------------------

def attend_prefill(qg, pkv: PagedKV, page_table, lengths, *,
                   window: Optional[int] = None, impl: str = "kernels"):
    """qg: (B, C, KV, G, hd) over the pool that already holds the chunk's
    own k/v: ``flash_prefill`` or its plain version. Returns fp32."""
    _check_impl(impl)
    fp = flash_prefill if impl == "kernels" else flash_prefill_ref
    return fp(qg, pkv.k, pkv.v, page_table, lengths, window=window,
              k_scale=pkv.k_scale, v_scale=pkv.v_scale)


def paged_prefill_attention(params, x, dims: A.AttnDims, pkv: PagedKV, *,
                            lengths, page_table, n_valid,
                            window: Optional[int] = None,
                            impl: str = "kernels"):
    """A chunk of C prompt tokens over one unit's paged pool. x: (B, C, d) at
    positions [lengths[b], lengths[b] + C). Rows past ``n_valid[b]`` are
    garbage the caller discards (their k/v went to the trash page).
    Returns (out (B, C, d), pkv)."""
    B, C = x.shape[:2]
    q, k, v = A.project_qkv(params, x, dims)
    posv = lengths[:, None] + torch.arange(C, dtype=lengths.dtype,
                                           device=x.device)[None, :]
    q = apply_rope(q, posv, dims.rope_theta)
    k = apply_rope(k, posv, dims.rope_theta)
    append_paged_chunk(pkv, k, v, page_table, lengths, n_valid)
    KV, G, hd = dims.n_kv_heads, dims.q_per_kv, dims.head_dim
    qg = q.reshape(B, C, KV, G, hd)
    out = attend_prefill(qg, pkv, page_table, lengths, window=window,
                         impl=impl)
    out = out.reshape(B, C, dims.n_heads * hd).to(x.dtype)
    return out @ as_dtype(params["wo"], x.dtype), pkv
