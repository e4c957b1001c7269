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

A model's serving cache is a PagedKV or a dict tree of PagedKV leaves and
dense per-slot tensors: the VLM keeps ``{"self": PagedKV (units, k_self,
P, psz, KV, hd), "cross": {"k", "v"} (units, slots, n_image_tokens, KV,
hd)}``, its fixed per-slot image blocks beside the pages (``cross_attend``
reads them under per-slot valid lengths), the encoder-decoder the same with
one self layer a unit and audio blocks of n_audio_frames, and the hybrid
keeps
``{"mamba": {"h", "conv"} (units, inner, slots, ...), "shared_kv": PagedKV
(units, P, psz, KV, hd)}``, its per-slot Mamba rows beside the shared
block's pages. The xLSTM's cache has no pages at all: ``{"mlstm": (C, n,
m), "slstm": (h, c, n, m)}``, tuples as JAX's, every leaf (units, slots,
...). ``cache_unit``/``cache_units`` slice any such tree by units (every
leaf leads with the unit axis); the dense leaves' slot axis is the
family's ``paged_state_axes``.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Dict, List, Optional, Tuple

import numpy as np
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
    page axis lines up with the pages'. ``cache_unit``/``cache_units``
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

    def clone(self) -> "PagedKV":
        return self._map(torch.clone)


def _map_cache(cache, fn):
    """``fn`` over every tensor of a cache tree (PagedKV leaves mapped
    tensor by tensor)."""
    if isinstance(cache, PagedKV):
        return cache._map(fn)
    if torch.is_tensor(cache):
        return fn(cache)
    if isinstance(cache, tuple):
        return tuple(_map_cache(v, fn) for v in cache)
    return {k: _map_cache(v, fn) for k, v in cache.items()}


def cache_unit(cache, u: int):
    """Unit ``u`` of a cache tree whose every tensor leads with the unit
    axis: views sharing storage with the cache."""
    return _map_cache(cache, lambda t: t[u])


def cache_units(cache, start: int, size: int):
    """Units [start, start + size) of a cache tree, as views."""
    return _map_cache(cache, lambda t: t[start:start + size])


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
                  dtype=torch.bfloat16, n_units=None,
                  device="cuda") -> PagedKV:
    """A zeroed pool; ``n_units`` (an int, or a tuple for nested stacks)
    prepends the stacked unit axes."""
    dtype = resolve_kv_dtype(dtype)
    lead = (() if n_units is None else
            tuple(n_units) if isinstance(n_units, tuple) else (n_units,))
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


def cache_bytes(cache) -> int:
    """Total bytes of a cache: page bytes plus, for int8 pools, the fp32
    scales, plus any dense per-slot blocks (each tensor at its own dtype's
    size)."""
    return sum(cache_bytes_by_dtype(cache).values())


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


def dense_to_paged(k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[PagedKV, torch.Tensor]:
    """View a dense (B, C, KV, hd) cache as pages with an identity table,
    so the flash-decode kernel serves the dense decode path too: one page
    of C keys a slot, so the pages ARE ``k`` and ``v`` (no copy; JAX pads C
    to 128-key pages, a copy a call, which the kernel here does not need:
    it takes any page size). The table (B, 1) int32 maps slot b to page b.
    No trash page: this view is never appended to."""
    table = torch.arange(k.shape[0], dtype=torch.int32,
                         device=k.device)[:, None]
    return PagedKV(k, v), table


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


# ---------------------------------------------------------------------------
# Page sharing and preemption: the device half (copy, reset, spill, restore)
# ---------------------------------------------------------------------------
#
# A decode segment on the card replays a CUDA graph that holds the pool's
# pointers, so every function here writes INTO the pool's storage (index
# copies, never a new tensor in its place).

# the page axis of a PagedKV tensor counted from the end: (*units, P, psz,
# KV, hd), and the scales (*units, P, 1, 1, 1) line up with it
PAGE_AXIS = -4


def _flatten(cache, path=()):
    """[(path, leaf)] of a model cache: PagedKV leaves and dense per-slot
    tensors, dict keys in sorted order and tuples in order (JAX's flatten
    order)."""
    if isinstance(cache, PagedKV) or torch.is_tensor(cache):
        return [(path, cache)]
    if isinstance(cache, tuple):
        return [item for i, c in enumerate(cache)
                for item in _flatten(c, path + (i,))]
    return [item for k in sorted(cache) for item in
            _flatten(cache[k], path + (k,))]


def _tensors(pkv: PagedKV) -> list:
    return [t for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
            if t is not None]


def cache_tensors(cache) -> list:
    """Every tensor of a cache in flatten order (a PagedKV's k, v and
    scales in turn)."""
    return [t for _, leaf in _flatten(cache)
            for t in (_tensors(leaf) if isinstance(leaf, PagedKV)
                      else [leaf])]


def pool_ptrs(cache) -> tuple:
    """The storage address of every tensor of a cache (pages and cross
    blocks): a captured decode segment stays valid only while these do not
    change."""
    return tuple(t.data_ptr() for t in cache_tensors(cache))


def paged_leaves(cache) -> list:
    """The PagedKV leaves of a cache in flatten order: what a
    ``SharedPagePool`` makes common (the dense per-slot leaves stay each
    batcher's own)."""
    return [leaf for _, leaf in _flatten(cache) if isinstance(leaf, PagedKV)]


def graft_paged(cache, leaves: list):
    """``cache`` with its PagedKV leaves replaced by ``leaves`` (same
    order), its dense leaves untouched: a reference swap, no copy."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, PagedKV):
            return next(it)
        if torch.is_tensor(node):
            return node
        if isinstance(node, tuple):
            return tuple(walk(n) for n in node)
        return {k: walk(node[k]) for k in sorted(node)}
    return walk(cache)


def cache_bytes_by_dtype(cache) -> dict:
    """{dtype name: bytes} over a cache's tensors: an int8 pool reports its
    fp32 scales beside its pages."""
    out: dict = {}
    for t in cache_tensors(cache):
        name = str(t.dtype).replace("torch.", "")
        out[name] = out.get(name, 0) + t.numel() * t.element_size()
    return out


def reset_slots(tree, init_tree, slot_mask: torch.Tensor, batch_axis: int):
    """Restore the masked slots' entries (along ``batch_axis``) of every
    tensor of ``tree`` to their values in ``init_tree``, in place (not to
    zero: an init value may be -1e30). For the per-slot dense state of a
    recycled slot; paged KV needs no reset."""
    for (_, cur), (_, init) in zip(_flatten(tree), _flatten(init_tree)):
        shape = [1] * cur.ndim
        shape[batch_axis] = slot_mask.shape[0]
        mask = slot_mask.to(cur.device).reshape(shape)
        cur.copy_(torch.where(mask, init.to(cur.device, cur.dtype), cur))
    return tree


def copy_pool_pages(cache, src: int, dst: int):
    """Copy physical page ``src`` onto ``dst`` in every PagedKV leaf of a
    cache, in place; a quantized pool moves each page's scale with it. The
    device half of copy-on-write. Dense leaves are untouched."""
    for _, leaf in _flatten(cache):
        if isinstance(leaf, PagedKV):
            for t in _tensors(leaf):
                t.select(t.ndim + PAGE_AXIS, dst).copy_(
                    t.select(t.ndim + PAGE_AXIS, src))
    return cache


_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 (which numpy lacks) as raw 2-byte void
    data, the layout ``np.savez`` gives JAX's bf16 arrays."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    if name == _BF16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.view(np.dtype(name)).copy())


@dataclasses.dataclass
class SpilledSlot:
    """Host snapshot of one slot's cache state: ``data[i]`` belongs to
    flattened leaf i, a tuple (k, v) of gathered pages for a PagedKV leaf
    (plus (k_scale, v_scale) for a quantized pool), or the slot's row of a
    dense leaf; CPU tensors. ``n_pages`` is the number of pages it covers.

    ``to_bytes``/``from_bytes`` are the wire format of
    ``repro.nn.cache.SpilledSlot``: an ``np.savez`` container (no pickle)
    with kinds and dtype names beside the arrays, bf16 as raw 2-byte data,
    so a snapshot crosses between the two packages."""
    data: list
    n_pages: int

    def to_bytes(self) -> bytes:
        arrays = {"n_pages": np.asarray(self.n_pages, np.int64)}
        kinds, dtypes = [], []
        for i, entry in enumerate(self.data):
            if isinstance(entry, tuple):
                kinds.append(2 if len(entry) == 4 else 1)
                dtypes.append(str(entry[0].dtype).replace("torch.", ""))
                arrays[f"k{i}"] = _to_numpy(entry[0])
                arrays[f"v{i}"] = _to_numpy(entry[1])
                if len(entry) == 4:
                    arrays[f"ks{i}"] = _to_numpy(entry[2])
                    arrays[f"vs{i}"] = _to_numpy(entry[3])
            else:
                kinds.append(0)
                dtypes.append(str(entry.dtype).replace("torch.", ""))
                arrays[f"d{i}"] = _to_numpy(entry)
        arrays["kinds"] = np.asarray(kinds, np.int8)
        arrays["dtypes"] = np.asarray(dtypes)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SpilledSlot":
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            kinds, dtypes = z["kinds"], z["dtypes"]
            data = []
            for i, kind in enumerate(kinds):
                name = str(dtypes[i])
                if kind == 0:
                    data.append(_from_numpy(z[f"d{i}"], name))
                    continue
                entry = (_from_numpy(z[f"k{i}"], name),
                         _from_numpy(z[f"v{i}"], name))
                if kind == 2:
                    entry += (_from_numpy(z[f"ks{i}"], "float32"),
                              _from_numpy(z[f"vs{i}"], "float32"))
                data.append(entry)
            return cls(data=data, n_pages=int(z["n_pages"]))


def _dense_slot_axis(path, dense_axes) -> int:
    for p in path:
        if p in dense_axes:
            return dense_axes[p]
    raise KeyError(
        f"dense cache leaf at {path} has no slot axis in paged_state_axes "
        f"{dense_axes}: the family must declare where its per-slot state "
        "lives before it can be spilled")


def spill_slot(cache, slot: int, page_ids, dense_axes=None) -> SpilledSlot:
    """Snapshot slot ``slot`` to host memory: its ``page_ids`` pages of every
    PagedKV leaf and its row of every dense leaf (at the axis
    ``dense_axes`` names). The cache is not modified."""
    dense_axes = dense_axes or {}
    data = []
    for path, leaf in _flatten(cache):
        if isinstance(leaf, PagedKV):
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=leaf.k.device)
            data.append(tuple(t.index_select(t.ndim + PAGE_AXIS, ids).cpu()
                              for t in _tensors(leaf)))
        else:
            ax = _dense_slot_axis(path, dense_axes)
            # a copy even on the CPU: the slot's row is reset in place at
            # the next admission, and a view would be reset with it
            data.append(leaf.select(ax, slot).to("cpu", copy=True))
    return SpilledSlot(data=data, n_pages=len(page_ids))


def restore_slot(cache, slot: int, page_ids, spilled: SpilledSlot,
                 dense_axes=None):
    """Write a ``spill_slot`` snapshot back, in place: its pages land in
    ``page_ids`` (ids may differ from the spill-time ones; the logical
    order is what matters) and its dense rows in slot ``slot``."""
    dense_axes = dense_axes or {}
    if len(page_ids) != spilled.n_pages:
        raise ValueError(f"restore got {len(page_ids)} pages for a "
                         f"{spilled.n_pages}-page spill")
    leaves = _flatten(cache)
    if len(leaves) != len(spilled.data):
        raise ValueError("cache structure changed between spill and restore")
    for (path, leaf), saved in zip(leaves, spilled.data):
        if isinstance(leaf, PagedKV):
            if not isinstance(saved, tuple):
                raise ValueError(
                    f"cache-state snapshot mismatch at {path}: the snapshot "
                    "holds a dense row where the target pool has a paged "
                    "leaf; spill and restore caches come from different "
                    "model families")
            _check_restore_dtypes(path, leaf, saved)
            if spilled.n_pages == 0:
                continue
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=leaf.k.device)
            for t, s in zip(_tensors(leaf), saved):
                t.index_copy_(t.ndim + PAGE_AXIS, ids, s.to(t.device))
        else:
            ax = _dense_slot_axis(path, dense_axes)
            leaf.select(ax, slot).copy_(saved.to(leaf.device, leaf.dtype))
    return cache


def _check_restore_dtypes(path, leaf: PagedKV, saved: tuple) -> None:
    """Refuse a snapshot whose pages have another storage dtype or
    quantization layout than the pool: reinterpreting its bytes would serve
    garbage KV."""
    have_scales = len(saved) == 4
    if saved[0].dtype != leaf.k.dtype or have_scales != leaf.quantized:
        def desc(dt, scaled):
            return (f"{str(dt).replace('torch.', '')} pages "
                    f"{'WITH' if scaled else 'without'} per-page scales")
        raise ValueError(
            f"cache-state dtype mismatch at {path}: snapshot carries "
            f"{desc(saved[0].dtype, have_scales)} but the target pool stores "
            f"{desc(leaf.k.dtype, leaf.quantized)}. The spilling and "
            "restoring pools must be built with the same --kv-dtype; "
            "re-prefill the request on the destination worker instead of "
            "migrating its cache state.")


# ---------------------------------------------------------------------------
# Conditioning memory (fixed per-slot cross-attention blocks)
# ---------------------------------------------------------------------------

def cross_attend(q, k, v, cond_lengths):
    """Cross-attention over a fixed per-slot conditioning block under a
    per-slot VALID length. q: (B, S, H, hd) un-roped queries; k/v: (B, Sk,
    KV, hd) the slot's memory, zero past ``cond_lengths[b]``. Padding is
    masked, not attended (zero keys would dilute the softmax), and a slot
    with ``cond_lengths[b] == 0`` (unconditioned) gets exactly 0 with no
    NaN: the row's max is floored at NEG_INF / 2, its masked weights
    zeroed and its sum floored at 1e-30, as JAX does (``torch.softmax``
    over an all-masked row would give NaN). fp32 inside; returns (B, S, H,
    hd) in q's dtype. Plain torch, as JAX's is plain jnp."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    valid = (torch.arange(Sk, device=q.device)[None, :]
             < cond_lengths.to(q.device)[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=q.device))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bkgqd", p / l, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def conditioning_fingerprint(aux_inputs) -> int:
    """Content hash of a request's aux conditioning inputs, folded into
    ``PrefixPageCache`` keys: the same text under different conditioning
    never shares prefix pages (every token's paged K/V passes through
    cross-attention to it), the same text and conditioning shares as text
    alone does. sha256 over each key in sorted order, ``str(shape)`` and
    the float32 bytes: the same int as JAX's for the same inputs. 0 for
    an unconditioned request (``None`` or an empty dict)."""
    import hashlib
    if not aux_inputs:
        return 0
    h = hashlib.sha256()
    for key in sorted(aux_inputs):
        x = aux_inputs[key]
        if torch.is_tensor(x):
            x = x.detach().cpu().float().numpy()
        arr = np.ascontiguousarray(np.asarray(x, np.float32))
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return int.from_bytes(h.digest()[:8], "big") or 1


# ---------------------------------------------------------------------------
# Shared-prefix page cache (host-side allocator metadata)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefixNode:
    """One cached page of prompt-prefix KV. Full-page nodes chain into a trie
    keyed by their page's token ids; a node may also carry TAIL candidates:
    partially filled pages whose leading tokens continue the chain."""
    page: int
    children: Dict[tuple, "_PrefixNode"] = dataclasses.field(
        default_factory=dict)
    tails: List[Tuple[int, np.ndarray]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class PrefixMatch:
    """A prefix-cache lookup: the shared physical ``pages`` (full pages,
    plus at most one partial tail page) and the prompt tokens they cover.
    ``tail_tokens`` > 0 means the last page is partial: the slot's first
    write lands inside it, so the scheduler copies it first."""
    pages: List[int]
    n_tokens: int
    tail_tokens: int


class PrefixPageCache:
    """Host-side shared-prefix registry over the physical page pool.

    Prompt prefixes are hashed at page granularity by token content: a trie
    node per full page (chained, so equal pages in other contexts never
    collide) plus partial-tail candidates for the page after a chain. The
    cache holds one refcount on every registered page, so it outlives its
    owner; the scheduler adds one ref per slot that maps it and frees a page
    when its count reaches zero. A page with refcount > 1 is read-only: a
    slot about to write into one gets a private copy first
    (``copy_pool_pages``).

    Each conditioning fingerprint (``conditioning_fingerprint``) owns its
    own trie root, so the same text under different images never shares a
    page; 0 is the root of unconditioned requests.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.roots: Dict[int, _PrefixNode] = {}
        self.hits = 0            # lookups that shared at least one page
        self.tokens_shared = 0   # prompt tokens served from shared pages

    def _root(self, cond_fp: int) -> _PrefixNode:
        if cond_fp not in self.roots:
            self.roots[cond_fp] = _PrefixNode(page=-1)
        return self.roots[cond_fp]

    def match(self, tokens, cond_fp: int = 0) -> PrefixMatch:
        """Longest shared prefix of ``tokens`` under ``cond_fp``. A pure
        lookup: no refcount is taken and no statistic moves (the caller
        counts ``hits``/``tokens_shared`` when it admits the match)."""
        node = self.roots.get(cond_fp)
        if node is None:
            return PrefixMatch(pages=[], n_tokens=0, tail_tokens=0)
        tokens = np.asarray(tokens)
        psz = self.page_size
        pages, n = [], 0
        while n + psz <= tokens.size:
            child = node.children.get(tuple(int(t)
                                            for t in tokens[n:n + psz]))
            if child is None:
                break
            node, n = child, n + psz
            pages.append(child.page)
        tail_tokens, best = 0, None
        rest = tokens[n:]
        for page, ttoks in node.tails:
            m = 0
            lim = min(ttoks.size, rest.size)
            while m < lim and int(ttoks[m]) == int(rest[m]):
                m += 1
            if m > tail_tokens:
                tail_tokens, best = m, page
        if best is not None and tail_tokens > 0:
            pages.append(best)
            n += tail_tokens
        return PrefixMatch(pages=pages, n_tokens=n, tail_tokens=tail_tokens)

    def insert(self, tokens, pages: List[int], refcount: Dict[int, int],
               cond_fp: int = 0) -> None:
        """Register a prefilled prompt's pages (``pages[i]`` backs tokens
        [i*psz, (i+1)*psz)): full pages extend the trie, a non-empty partial
        last page becomes a tail candidate; every newly registered page
        gains one cache-held ref. Pages already in the trie are left
        alone, and a root left empty is dropped again."""
        tokens = np.asarray(tokens)
        psz = self.page_size
        node, n, i = self._root(cond_fp), 0, 0
        while n + psz <= tokens.size:
            key = tuple(int(t) for t in tokens[n:n + psz])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(page=pages[i])
                node.children[key] = child
                refcount[pages[i]] = refcount.get(pages[i], 0) + 1
            node, n, i = child, n + psz, i + 1
        tail = tokens[n:]
        if tail.size and i < len(pages):
            if not any(np.array_equal(t, tail) for _, t in node.tails):
                node.tails.append((pages[i], tail.copy()))
                refcount[pages[i]] = refcount.get(pages[i], 0) + 1
        root = self.roots.get(cond_fp)
        if root is not None and not root.children and not root.tails:
            del self.roots[cond_fp]

    def evict(self, refcount: Dict[int, int], free_pages: List[int],
              need: int) -> int:
        """Drop cache-held refs until ``need`` pages are free, deepest trie
        nodes and tails first (roots in insertion order); pages whose count
        reaches zero go back on the free list, and emptied roots are
        pruned. Returns the pages freed."""
        freed = 0

        def drop(page):
            nonlocal freed
            refcount[page] -= 1
            if refcount[page] == 0:
                del refcount[page]
                free_pages.append(page)
                freed += 1

        def walk(node):
            for key in list(node.children):
                if len(free_pages) >= need:
                    return
                walk(node.children[key])
                child = node.children[key]
                if not child.children and not child.tails:
                    drop(child.page)
                    del node.children[key]
            while node.tails and len(free_pages) < need:
                page, _ = node.tails.pop()
                drop(page)

        for fp in list(self.roots):
            root = self.roots[fp]
            if len(free_pages) < need:
                walk(root)
            if not root.children and not root.tails:
                del self.roots[fp]
        return freed
