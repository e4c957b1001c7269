"""Flash attention with a hand-written backward (port of
``repro.kernels.flash_attention``; CUDA sources
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``).

Masks come from indices (no (S, S) mask in device memory). The kinds are the
ones the DiffusionBlocks training path uses:

  full       no masking (bidirectional)
  causal     kpos <= qpos
  window     causal sliding window of ``window`` keys
  db_concat  paper App. E.4 [clean || noisy] mask (mask_seq = S, streams 2S)
  two_pass   DB two-pass noisy-stream mask (keys = [clean || noisy_diag])

Layout: q (B, H, Sq, hd), k/v (B, KV, Sk, hd), H = KV * G; any strides with
a contiguous head dim (the model passes (B, S, H, hd) tensors as transposed
views, which the kernels read in place).

In bf16 all three kernels run on the tensor cores (``fwd_tc_kernel``,
``dq_tc_kernel``, ``dkv_tc_kernel``: mma.sync, ldmatrix, cp.async, with the
fp32 operands P and dS split into two bf16 terms each, so that the products
keep the reference's fp32 P and dS). They copy 16-byte chunks, so a bf16
tensor (input or output) that ``tc_aligned`` refuses raises; the autograd
backward first copies a ``dO`` it refuses. In fp32 all three run on the
tensor cores too (``fwd_tf32_kernel``, ``dq_tf32_kernel``,
``dkv_tf32_kernel``: each operand split into two tf32 terms and each product
taken three times, 3xTF32, which keeps fp32 accuracy); each copies 16-byte
chunks where ``tc_aligned`` admits all of its tensors (inputs, dO and
outputs), and single floats otherwise, so it takes every fp32 view. Head
dim 120 runs in hd 128's tiles, its rows zero-padded in shared memory
(``tile_dim``).

Three wrappers, one per kernel, each counting its launches in
``.launches``: ``flash_attention_fwd`` -> (out, lse), ``flash_attention_bwd_dq``
-> dq and ``flash_attention_bwd_dkv`` -> (dk, dv). On CUDA tensors they
launch the kernel or raise; on CPU tensors they run the plain versions
(``flash_attention_fwd_ref``, ``_bwd_dq_ref``, ``_bwd_dkv_ref``).
``flash_attention`` ties them together in a ``torch.autograd.Function``
whose backward calls the two backward wrappers, never autograd through the
forward.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MASK_KINDS = ("full", "causal", "window", "db_concat", "two_pass")
# head dims the kernels are instantiated for, by dtype: the fp32 kernels
# also at 32 (ViT) and 112 (zamba2-7b, which computes in fp32 under every
# policy); a 32-wide bf16 row is 4 16-byte chunks, which the tensor-core
# tiles' swizzle (``csrc/mma.cuh`` ``swizzle``) does not take. 120
# (h2o-danube3-4b) runs in hd 128's tiles (``tile_dim``)
HEAD_DIMS = {torch.float32: (32, 64, 112, 120, 128),
             torch.bfloat16: (64, 120, 128)}
_DTYPES = tuple(HEAD_DIMS)


def tile_dim(hd: int) -> int:
    """The width of a head-dim-``hd`` row in the kernels' shared tiles
    (``kTileDim`` in ``csrc/flash_attention.cuh``): hd itself, but 128 for
    hd 120, whose rows the loaders zero-pad and the epilogues store 120
    values of; the pitches, k steps and output tiles are then hd 128's."""
    return 128 if hd == 120 else hd


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    mask_kind: str = "causal"
    window: Optional[int] = None        # only for mask_kind == "window"
    mask_seq: Optional[int] = None      # S for db_concat / two_pass

    def __post_init__(self):
        # hard raises: an unchecked kind would fall through to bounds-only
        # masking, which is silent full attention
        if self.mask_kind not in MASK_KINDS:
            raise ValueError(f"unknown mask_kind {self.mask_kind!r}; "
                             f"one of {MASK_KINDS}")
        if self.mask_kind == "window" and self.window is None:
            raise ValueError("mask_kind='window' requires window")
        if self.mask_kind in ("db_concat", "two_pass") \
                and self.mask_seq is None:
            raise ValueError(f"mask_kind={self.mask_kind!r} requires "
                             "mask_seq")


def keep_mask(cfg: FlashConfig, seq_q: int, seq_k: int,
              device=None) -> torch.Tensor:
    """(Sq, Sk) bool keep-mask, as ``_tile_mask`` builds it per tile."""
    qpos = torch.arange(seq_q, device=device)[:, None]
    kpos = torch.arange(seq_k, device=device)[None, :]
    if cfg.mask_kind == "causal":
        return kpos <= qpos
    if cfg.mask_kind == "window":
        return (kpos <= qpos) & (kpos > qpos - cfg.window)
    if cfg.mask_kind == "db_concat":
        S = cfg.mask_seq
        q_clean, k_clean = qpos < S, kpos < S
        clean_clean = q_clean & k_clean & (kpos <= qpos)
        noisy_clean = (~q_clean) & k_clean & (kpos < qpos - S)
        noisy_self = (~q_clean) & (kpos == qpos)
        return clean_clean | noisy_clean | noisy_self
    if cfg.mask_kind == "two_pass":
        S = cfg.mask_seq
        return ((kpos < S) & (kpos < qpos)) | (kpos == qpos + S)
    return torch.ones(seq_q, seq_k, dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _expand_kv(x: torch.Tensor, G: int) -> torch.Tensor:
    return x if G == 1 else x.repeat_interleave(G, dim=1)


def _probs(q, k, lse, cfg):
    """P = exp(s - lse) where the mask keeps the pair, 0 elsewhere (fp32)."""
    G = q.shape[1] // k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = q.float() @ _expand_kv(k, G).float().transpose(-1, -2) * scale
    mask = keep_mask(cfg, q.shape[2], k.shape[2], q.device)
    return torch.where(mask, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=q.device))


def flash_attention_fwd_ref(q, k, v, cfg: FlashConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out like q, lse (B, H, Sq) fp32): masked softmax attention with
    finite -1e30 masks, so a row that sees no key gives out = 0, lse ~ -1e30
    (``_fwd_kernel``'s ``max(l, 1e-30)``)."""
    G = q.shape[1] // k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = q.float() @ _expand_kv(k, G).float().transpose(-1, -2) * scale
    mask = keep_mask(cfg, q.shape[2], k.shape[2], q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = (p @ _expand_kv(v, G).float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_dq_ref(q, k, v, do, lse, delta, cfg: FlashConfig) -> torch.Tensor:
    G = q.shape[1] // k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = _probs(q, k, lse, cfg)
    dp = do.float() @ _expand_kv(v, G).float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    return (ds @ _expand_kv(k, G).float()).to(q.dtype)


def _bwd_dkv_ref(q, k, v, do, lse, delta, cfg: FlashConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    p = _probs(q, k, lse, cfg)
    dp = do.float() @ _expand_kv(v, G).float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dk = ds.transpose(-1, -2) @ q.float()                 # (B, H, Sk, hd)
    dv = p.transpose(-1, -2) @ do.float()
    dk = dk.reshape(B, KV, G, Sk, hd).sum(2)
    dv = dv.reshape(B, KV, G, Sk, hd).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, Sq): the softmax-normaliser
    term of the backward (one torch reduction, as JAX computes it outside
    its kernels)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, cfg: FlashConfig):
    """(dq, dk, dv) by the plain dq and dk/dv functions."""
    delta = attention_delta(o, do)
    dk, dv = _bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    return _bwd_dq_ref(q, k, v, do, lse, delta, cfg), dk, dv


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_KIND_IDS = {k: i for i, k in enumerate(MASK_KINDS)}


class _TRef(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("ss", ctypes.c_longlong)]


class _FlashArgs(ctypes.Structure):
    _fields_ = ([(n, _TRef) for n in ("q", "k", "v", "o", "dout", "dq",
                                      "dk", "dv")]
                + [("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "B", "H", "KV", "Sq", "Sk", "hd", "mask_kind", "window",
                    "mask_seq", "bf16")]
                + [("scale", ctypes.c_float)])


_FN = {}


def _kernel(lib: str, sym: str):
    if sym not in _FN:
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[sym] = fn
    return _FN[sym]


def _tref(t: Optional[torch.Tensor]) -> _TRef:
    if t is None:
        return _TRef(None, 0, 0, 0)
    return _TRef(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _check(name, q, k, v, *more):
    """Raise on what the kernels do not take; returns (B, H, KV, Sq, Sk, hd)."""
    tensors = (q, k, v) + more
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v (and o, dO) must share fp32 or "
                        f"bf16, got {[t.dtype for t in tensors]}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if hd not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(f"{name}: head dim {hd}; the {q.dtype} "
                                  f"kernels take {HEAD_DIMS[q.dtype]}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if any(t.shape[2] == 0 for t in (q, k)):
        raise ValueError(f"{name}: empty sequence")
    return B, H, KV, Sq, Sk, hd


def tc_aligned(data_ptr: int, strides, element_size: int) -> bool:
    """Whether the tensor-core kernels can copy a (B, H, S, hd) tensor in
    16-byte chunks: its base address is 16-byte aligned and its batch, head
    and sequence strides (``strides[:3]``, in elements) are multiples of 16
    bytes (8 bf16 or 4 fp32 elements). The fp32 kernels make the same test
    in C (``copies16``) to choose their 16- or 4-byte copies."""
    return data_ptr % 16 == 0 and all(
        s * element_size % 16 == 0 for s in strides[:3])


def _check_tc_aligned(name, **tensors):
    for tname, t in tensors.items():
        if not tc_aligned(t.data_ptr(), t.stride(), t.element_size()):
            raise ValueError(
                f"{name}: bf16 {tname} must start on a 16-byte boundary and "
                "have batch, head and sequence strides that are multiples "
                "of 8 elements (the tensor-core kernel copies 16-byte "
                f"chunks); got address % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}")


def _args(cfg: FlashConfig, q, k, **tensors) -> _FlashArgs:
    B, H, Sq, hd = q.shape
    a = _FlashArgs()
    for n in ("q", "k", "v", "o", "dout", "dq", "dk", "dv"):
        setattr(a, n, _tref(q if n == "q" else k if n == "k"
                            else tensors.get(n)))
    a.lse = tensors["lse"].data_ptr()
    a.delta = tensors["delta"].data_ptr() if "delta" in tensors else None
    a.B, a.H, a.KV, a.Sq, a.Sk, a.hd = B, H, k.shape[1], Sq, k.shape[2], hd
    a.mask_kind = _KIND_IDS[cfg.mask_kind]
    a.window = cfg.window or 0
    a.mask_seq = cfg.mask_seq or 0
    a.bf16 = int(q.dtype == torch.bfloat16)
    a.scale = 1.0 / (hd ** 0.5)
    return a


def _launch(lib, sym, q, args: _FlashArgs, what: str) -> None:
    with torch.cuda.device(q.device):
        rc = _kernel(lib, sym)(ctypes.byref(args),
                               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, what)


def flash_attention_fwd(q, k, v, cfg: FlashConfig):
    """(out like q, lse (B, H, Sq) fp32), on the tensor cores. bf16 takes
    tensors that ``tc_aligned`` admits and raises on others; fp32 takes any
    (4-byte copies where ``tc_aligned`` refuses one)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, cfg)
    B, H, _, Sq, _, _ = _check("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)           # keeps q's strides (dense views)
    if q.dtype == torch.bfloat16:
        _check_tc_aligned("flash_attention_fwd", q=q, k=k, v=v, o=out)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    args = _args(cfg, q, k, v=v, o=out, lse=lse)
    _launch("flash_attention_fwd", "rt_flash_attention_fwd", q, args,
            "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg: FlashConfig):
    """dq like q, from the saved lse and delta = rowsum(dO * O), on the
    tensor cores. bf16 takes tensors that ``tc_aligned`` admits and raises
    on others; fp32 takes any (4-byte copies where ``tc_aligned`` refuses
    one)."""
    if q.device.type == "cpu":
        return _bwd_dq_ref(q, k, v, do, lse, delta, cfg)
    _check("flash_attention_bwd_dq", q, k, v, do)
    dq = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        _check_tc_aligned("flash_attention_bwd_dq", q=q, k=k, v=v, do=do,
                          dq=dq)
    args = _args(cfg, q, k, v=v, dout=do, dq=dq, lse=lse.contiguous(),
                 delta=delta.contiguous())
    _launch("flash_attention_bwd", "rt_flash_attention_bwd_dq", q, args,
            "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg: FlashConfig):
    """(dk, dv) like k and v, summed over each GQA group in the kernel (in
    fp32, rounded once), on the tensor cores; the layouts taken as for
    dq."""
    if q.device.type == "cpu":
        return _bwd_dkv_ref(q, k, v, do, lse, delta, cfg)
    _check("flash_attention_bwd_dkv", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        _check_tc_aligned("flash_attention_bwd_dkv", q=q, k=k, v=v, do=do,
                          dk=dk, dv=dv)
    args = _args(cfg, q, k, v=v, dout=do, dk=dk, dv=dv, lse=lse.contiguous(),
                 delta=delta.contiguous())
    _launch("flash_attention_bwd", "rt_flash_attention_bwd_dkv", q, args,
            "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg):
        out, lse = flash_attention_fwd(q, k, v, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not
                                  tc_aligned(do.data_ptr(), do.stride(),
                                             do.element_size())):
            # a layout the kernels cannot read in place: a fresh dense copy
            # (contiguous() would keep a dense tensor at an odd address)
            do = do.clone(memory_format=torch.contiguous_format)
        delta = attention_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.cfg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.cfg)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, mask_kind: str,
                    window: Optional[int] = None,
                    mask_seq: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd); H = KV * G. Returns like q.
    ``(mask_kind, window, mask_seq)`` is a ``FlashConfig``; the model's
    masks reach it through ``ops._route_mask``. Differentiable through the
    backward kernels (their plain versions on the CPU)."""
    cfg = FlashConfig(mask_kind=mask_kind, window=window, mask_seq=mask_seq)
    return _Flash.apply(q, k, v, cfg)
